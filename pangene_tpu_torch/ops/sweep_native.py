"""ctypes bindings for the native host runtime (native/pgsweep.c).

Covers the full per-genome hot path: shadow/isoform sweeps (with a cached
per-genome hot table), the fused round stage (shadow + walk + dedupe),
branch marking and locality tests, hash-table weak propagation, the
adaptive global arc merge (pairwise tree / k-way heap), representative
positions, greedy vertex selection, and the GFA L-line renderer. Same
in-place column updates and return counts as the NumPy paths,
IEEE-double predicates throughout. The library is compiled from
pgsweep.c on first use into the git-ignored build/pangene_tpu_torch/
directory (native/loader.build_so); ``available()`` gates dispatch so
environments without a compiler fall back to NumPy. ``n_calls`` counts
the C calls by entry, so a run can show that it took this path.
Differential tests: tests/test_torch_sweep_native.py holds every entry
against the JAX package's bindings and the port's NumPy branches;
tests/test_torch_engine_equiv.py pins whole runs byte-identical.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..core.data import DataSet, Genome
from ..options import PgOpt
from ..native.loader import build_so
from ..util import build_dir

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "pgsweep.c")
SO_NAME = "_pgsweep.so"
_lock = threading.Lock()
_lib = None
_failed = False

# C calls by entry since the last reset_counts()
ENTRIES = ("shadow", "flt_ov_isoform", "n_local_batch", "mark_branch",
           "walk_arcs", "round_genome", "rep_pos_rows", "merge_arcs_kway",
           "merge_arcs_native", "gen_vtx_greedy", "weak_hash_build",
           "propagate_weak_hash", "propagate_weak", "format_arcs")
n_calls = dict.fromkeys(ENTRIES, 0)


def reset_counts() -> None:
    for k in ENTRIES:
        n_calls[k] = 0

# pointer args are declared void* and passed as raw addresses: ctypes
# pointer-object construction per call is measurable in the round loop
_i32p = _i64p = _u8p = ctypes.c_void_p


def _get_lib():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = os.path.join(build_dir(), SO_NAME)
        if not os.path.exists(so) or \
                os.path.getmtime(so) < os.path.getmtime(_SRC):
            if not build_so(_SRC, so, libs=("-lm",)):
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _failed = True
            return None
        lib.pg_sweep_shadow.restype = ctypes.c_int64
        lib.pg_sweep_shadow.argtypes = [
            ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, _u8p, _u8p,
            _i64p, _i64p,
            _i32p, _i32p,
            _i32p, _u8p,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            _u8p, _i32p, _i32p,
        ]
        lib.pg_n_local_batch.restype = None
        lib.pg_n_local_batch.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _u8p, _i32p, _i32p, _i64p,
            _i64p, _i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _i32p,
        ]
        _u64p = ctypes.c_void_p
        lib.pg_walk_arcs.restype = ctypes.c_int64
        lib.pg_walk_arcs.argtypes = [
            ctypes.c_int64, _i64p,
            _u8p, _u8p, _i32p, _u8p, _i32p, _i64p,
            _i32p, _i32p, _i32p,
            _i32p, _i32p,
            ctypes.c_int32, ctypes.c_int32, _i32p,
            _u64p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.pg_merge_arcs.restype = ctypes.c_int64
        lib.pg_merge_arcs.argtypes = [
            ctypes.c_int64, _u64p, _i32p, _i32p, _i32p, _i32p,
            _u64p, _i32p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.pg_round_genome.restype = ctypes.c_int64
        lib.pg_round_genome.argtypes = [
            ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, _u8p, _u8p,
            _i64p, _i64p,
            _i32p, _i32p,
            _i32p, _u8p,
            ctypes.c_int32, ctypes.c_double,
            _u8p, _i32p, _i32p,
            ctypes.c_int32,
            _i64p,
            _i64p,
            _i32p,
            _i32p,
            ctypes.c_int32, ctypes.c_int32, _i32p,
            ctypes.c_void_p, _i32p, _i32p, _i32p, _i32p,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.pg_hot_size.restype = ctypes.c_int64
        lib.pg_hot_size.argtypes = []
        assert int(lib.pg_hot_size()) == _HOT_SIZE, \
            "hot_t layout drift: update _HOT_SIZE"
        lib.pg_wrec_size.restype = ctypes.c_int64
        lib.pg_wrec_size.argtypes = []
        assert int(lib.pg_wrec_size()) == _WREC_SIZE, \
            "wrec_t layout drift: update _WREC_SIZE"
        lib.pg_rep_pos.restype = ctypes.c_int64
        lib.pg_rep_pos.argtypes = [
            ctypes.c_int64, _u8p, _u8p, _i32p, _i32p, _i64p,
            _i32p, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i64p,
        ]
        lib.pg_merge_arcs_kway.restype = ctypes.c_int64
        lib.pg_merge_arcs_kway.argtypes = [
            ctypes.c_int32, _i64p,
            _u64p, _i32p, _i32p, _i32p, _i32p,
            _u64p, _i32p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.pg_merge_arcs_tree.restype = ctypes.c_int64
        lib.pg_merge_arcs_tree.argtypes = lib.pg_merge_arcs_kway.argtypes
        lib.pg_merge_arcs_tree_p.restype = ctypes.c_int64
        lib.pg_merge_arcs_tree_p.argtypes = [
            ctypes.c_int32, _i64p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            _u64p, _i32p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.pg_gen_vtx_greedy.restype = ctypes.c_int64
        lib.pg_gen_vtx_greedy.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            _i64p, _u64p, _u64p,
            ctypes.c_void_p, _u8p, ctypes.c_double,
            _i32p, _i32p, _i32p,
        ]
        lib.pg_weak_hash_build.restype = None
        lib.pg_weak_hash_build.argtypes = [
            ctypes.c_int64, _u64p, _u8p,
            ctypes.c_int64, _u64p, _u8p,
        ]
        lib.pg_propagate_weak_hash.restype = None
        lib.pg_propagate_weak_hash.argtypes = [
            ctypes.c_int64, _i64p,
            _u8p, _u8p,
            _i32p, _u8p, _i32p,
            _i32p, _i32p,
            ctypes.c_int64, _u64p, _u8p,
            _u8p,
        ]
        lib.pg_format_arcs.restype = ctypes.c_int64
        lib.pg_format_arcs.argtypes = [
            ctypes.c_int64, _u64p, _i32p,
            ctypes.c_char_p, _i64p, _i32p,
            _i32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.pg_free_text.restype = None
        lib.pg_free_text.argtypes = [ctypes.c_void_p]
        lib.pg_propagate_weak.restype = None
        lib.pg_propagate_weak.argtypes = [
            ctypes.c_int64, _i64p,
            _u8p, _u8p,
            _i32p, _u8p, _i32p,
            _i32p, _i32p,
            ctypes.c_int64, _u64p, _u8p,
            _u8p,
        ]
        lib.pg_mark_branch.restype = None
        lib.pg_mark_branch.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p, _i32p, _i32p,
            ctypes.c_int32, ctypes.c_int32,
            _u8p, _i32p, _i32p, _i64p,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _u8p, _i32p, _i64p,
        ]
        lib.pg_sweep_ov_isoform.restype = ctypes.c_int64
        lib.pg_sweep_ov_isoform.argtypes = [
            ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p,
            _i64p, _i64p,
            _i32p, _i32p,
            _i32p, _u8p,
            ctypes.c_int32,
            _u8p, _u8p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


_DEBUG_PTRS = bool(os.environ.get("PANGENE_DEBUG_PTRS"))


def _p(a: np.ndarray, dt, pt=None):
    """Raw data address. The caller MUST hold a reference to `a` for the
    duration of the C call — never pass a temporary (e.g. an
    ascontiguousarray copy) directly; bind it to a local first.
    Set PANGENE_DEBUG_PTRS=1 to re-enable dtype/contiguity validation."""
    if _DEBUG_PTRS:
        assert a.dtype == dt and a.flags.c_contiguous
    return a.ctypes.data


def _hit_addrs(h):
    """Identity-keyed per-column address cache: an entry is recomputed
    only when that column's ndarray OBJECT was replaced (set()/permute()
    swap arrays; in-place writes keep the buffer). The cache holds
    references to the arrays, which both keeps every address alive for
    the duration of any C call and makes the `is` check sound (a live
    reference cannot be collected and its identity reused). A
    version-keyed predecessor re-extracted all ~30 addresses whenever ANY
    column changed — measured ~15% of host wall at bench scale because
    flt/weak refresh every round."""
    ver = getattr(h, "_ver", 0)
    snap = getattr(h, "_addr_snap", None)
    if snap is None:
        snap = ({}, {}, [None])
        h._addr_snap = snap
    arrs, addr, seen_ver = snap
    if seen_ver[0] == ver:      # no set()/permute() since last extraction
        return addr
    for k, a in h.cols.items():
        if arrs.get(k) is not a:
            if _DEBUG_PTRS:
                assert a.flags.c_contiguous, k
            arrs[k] = a
            addr[k] = a.ctypes.data
    seen_ver[0] = ver
    return addr


def _addr_of(owner, attr: str, a: np.ndarray) -> int:
    """Identity-keyed single-array address cache on `owner`. Holds a
    reference to `a` (keeps the buffer alive for the C call)."""
    cache = getattr(owner, attr, None)
    if cache is None or cache[0] is not a:
        if _DEBUG_PTRS:
            assert a.flags.c_contiguous
        cache = (a, a.ctypes.data)
        setattr(owner, attr, cache)
    return cache[1]


def _c(a, dt):
    """Contiguous dtype-converted view/copy; bind the result to a local."""
    return np.ascontiguousarray(a, dt)


_EMPTY_I32 = np.zeros(1, np.int32)
_HOT_SIZE = 64  # sizeof(hot_t); validated against pg_hot_size() on load
_WREC_SIZE = 32  # sizeof(wrec_t); validated against pg_wrec_size() on load
_NO_HOTCACHE = bool(os.environ.get("PANGENE_NO_HOTCACHE"))
_NO_GEOCACHE = bool(os.environ.get("PANGENE_NO_GEOCACHE"))


def _exon_ptrs(g: Genome):
    eos, eoe = g.exon_os, g.exon_oe
    if len(eos) == 0:     # never dereferenced when all n_exon == 0
        eos = eoe = _EMPTY_I32
    return (_addr_of(g, "_eos_addr", eos),
            _addr_of(g, "_eoe_addr", eoe))


def _globals(d: DataSet):
    """Cached prot->gene and gene-preferred arrays (grow-only tables)."""
    pg = getattr(d, "_c_prot_gid", None)
    if pg is None or len(pg) != d.n_prot:
        pg = np.ascontiguousarray(d.prot_gid, np.int32)
        d._c_prot_gid = pg              # type: ignore[attr-defined]
    gp = getattr(d, "_c_gene_pref", None)
    if gp is None or len(gp) != d.n_gene:
        gp = np.ascontiguousarray(d.gene_preferred, np.uint8)
        d._c_gene_pref = gp             # type: ignore[attr-defined]
    if d.n_prot == 0:
        pg = _EMPTY_I32
    if d.n_gene == 0:
        gp = np.zeros(1, np.uint8)
    return pg, gp


def _global_addrs(d: DataSet):
    """(prot_gid, gene_pref) ADDRESSES, size-keyed: the tables are
    grow-only and fixed once parsing ends, so the round loop's thousands
    of lookups collapse to two int compares (measured ~2-3% of host wall
    as property-chain/len churn in _globals)."""
    cache = getattr(d, "_gaddr", None)
    np_, ng = d.n_prot, d.n_gene
    if cache is not None and cache[0] == np_ and cache[1] == ng:
        return cache[2], cache[3]
    pg, gp = _globals(d)
    cache = (np_, ng, _addr_of(d, "_pg_addr", pg),
             _addr_of(d, "_gp_addr", gp))
    d._gaddr = cache                    # type: ignore[attr-defined]
    return cache[2], cache[3]


def shadow(opt: PgOpt, d: DataSet, g: Genome, cal_dom_sc: bool) -> int:
    lib = _get_lib()
    h = g.hits
    n = len(h)
    if n == 0:
        return 0
    pga, gpa = _global_addrs(d)
    eos, eoe = _exon_ptrs(g)
    ad = _hit_addrs(h)
    n_calls["shadow"] += 1
    return int(lib.pg_sweep_shadow(
        n,
        ad["pid"], ad["rank"],
        ad["score_adj"], ad["score_ori"],
        ad["n_exon"], ad["off_exon"],
        ad["cid"],
        ad["rev"], ad["flt"],
        ad["weak_br"],
        ad["cs"], ad["ce"],
        eos, eoe,
        pga, gpa,
        1 if opt.check_strand else 0, float(opt.min_ov_ratio),
        1 if cal_dom_sc else 0,
        ad["shadow"],
        ad["pid_dom"], ad["score_dom"]))


def n_local_batch(opt: PgOpt, rep_pos, g1: np.ndarray,
                  g2: np.ndarray) -> np.ndarray:
    """Native pg_n_local over gene-pair batches (branch.c:31-46)."""
    lib = _get_lib()
    present, cid, rank, cm = rep_pos
    G, ng = present.shape
    out = np.empty(len(g1), np.int32)
    if len(g1) == 0:
        return out
    pres8 = np.ascontiguousarray(present).view(np.uint8).reshape(-1)
    g1c = np.ascontiguousarray(g1, np.int64)
    g2c = np.ascontiguousarray(g2, np.int64)
    cidc = _c(cid, np.int32).reshape(-1)
    rankc = _c(rank, np.int32).reshape(-1)
    cmc = _c(cm, np.int64).reshape(-1)
    n_calls["n_local_batch"] += 1
    lib.pg_n_local_batch(
        len(g1), G, ng,
        _p(pres8, np.uint8, _u8p),
        _p(cidc, np.int32, _i32p),
        _p(rankc, np.int32, _i32p),
        _p(cmc, np.int64, _i64p),
        _p(g1c, np.int64, _i64p), _p(g2c, np.int64, _i64p),
        int(opt.local_dist), int(opt.local_count),
        1 if opt.frag_mode else 0,
        _p(out, np.int32, _i32p))
    return out


def mark_branch(opt: PgOpt, rep_pos, x: np.ndarray, s1: np.ndarray,
                tgt_gid: np.ndarray, weak_br: np.ndarray,
                n_dist_loci: np.ndarray):
    """Native full branching-arc pass (branch.c:48-106). weak_br [n_arc]
    and n_dist_loci [n_seg, 2] are filled in place; returns
    (n_demoted, n_cut)."""
    lib = _get_lib()
    present, cid, rank, cm = rep_pos
    G, ng = present.shape
    n_flt = np.zeros(2, np.int64)
    if len(x) == 0:
        return 0, 0
    pres8 = np.ascontiguousarray(present).view(np.uint8).reshape(-1)
    s1c = _c(s1, np.int32)
    tgtc = _c(tgt_gid, np.int32)
    cidc = _c(cid, np.int32).reshape(-1)
    rankc = _c(rank, np.int32).reshape(-1)
    cmc = _c(cm, np.int64).reshape(-1)
    n_calls["mark_branch"] += 1
    lib.pg_mark_branch(
        len(x),
        _p(x, np.uint64, _u64p),
        _p(s1c, np.int32, _i32p),
        _p(tgtc, np.int32, _i32p),
        G, ng,
        _p(pres8, np.uint8, _u8p),
        _p(cidc, np.int32, _i32p),
        _p(rankc, np.int32, _i32p),
        _p(cmc, np.int64, _i64p),
        float(opt.branch_diff), float(opt.branch_diff_dist),
        float(opt.branch_diff_cut),
        int(opt.local_dist), int(opt.local_count),
        1 if opt.frag_mode else 0,
        _p(weak_br, np.uint8, _u8p),
        _p(n_dist_loci.reshape(-1), np.int32, _i32p),
        _p(n_flt, np.int64, _i64p))
    return int(n_flt[0]), int(n_flt[1])


_u64p = ctypes.c_void_p


def walk_arcs(d: DataSet, gen: Genome, g2s: np.ndarray, use_ori: bool,
              n_seg: int, view):
    """Native walk-extract + per-genome dedupe. Returns
    (x, n, dist, s1, s2, seg_cnt)."""
    lib = _get_lib()
    h = gen.hits
    n = len(h)
    pg, _ = _globals(d)
    cap = max(2 * (n - 1), 1) if n > 1 else 1
    out_x = np.empty(cap, np.uint64)
    out_n = np.empty(cap, np.int32)
    out_dist = np.empty(cap, np.int32)
    out_s1 = np.empty(cap, np.int32)
    out_s2 = np.empty(cap, np.int32)
    seg_cnt = np.zeros(max(n_seg, 1), np.int32)
    if n == 0:
        return (out_x[:0], out_n[:0], out_dist[:0], out_s1[:0], out_s2[:0],
                seg_cnt[:n_seg])
    g2sc = np.ascontiguousarray(g2s, np.int32)
    vp = _p(view, np.int64, _i64p) if view is not None else None
    n_calls["walk_arcs"] += 1
    m = int(lib.pg_walk_arcs(
        n, vp,
        _p(h.flt, np.uint8, _u8p), _p(h.shadow, np.uint8, _u8p),
        _p(h.pid, np.int32, _i32p), _p(h.rev, np.uint8, _u8p),
        _p(h.cid, np.int32, _i32p), _p(h.cm, np.int64, _i64p),
        _p(h.score_ori, np.int32, _i32p), _p(h.score_dom, np.int32, _i32p),
        _p(h.pid_dom0, np.int32, _i32p),
        _p(pg, np.int32, _i32p), _p(g2sc, np.int32, _i32p),
        1 if use_ori else 0, n_seg, _p(seg_cnt, np.int32, _i32p),
        _p(out_x, np.uint64, _u64p), _p(out_n, np.int32, _i32p),
        _p(out_dist, np.int32, _i32p),
        _p(out_s1, np.int32, _i32p), _p(out_s2, np.int32, _i32p)))
    assert m >= 0, "kept hit maps to deleted segment"
    return (out_x[:m], out_n[:m], out_dist[:m], out_s1[:m], out_s2[:m],
            seg_cnt[:n_seg])


def round_genome(opt: PgOpt, d: DataSet, gen: Genome, g2s: np.ndarray,
                 use_ori: bool, n_seg: int, view, run_shadow: bool):
    """Fused shadow(cal=0) + walk + dedupe for one genome, one C call.
    Returns (x, n, dist, s1, s2, seg_cnt) as slices of per-genome scratch
    buffers reused across rounds — callers that retain results past the
    next round for this genome must copy (ops/arcs.py's memo does not
    need to: a memo hit implies this function was not re-entered)."""
    lib = _get_lib()
    h = gen.hits
    n = len(h)
    # Prebuilt-argument fast path: every pointer in the 40-arg call is
    # stable within a (physical version, view) epoch — the column
    # addresses key on _ver (set()/permute() bump it), the hot/geo/wpack
    # buffers key on the same, and the scratch buffers are per-genome.
    # Only run_shadow and the g2s address change call-to-call, so the
    # whole ctypes argument vector is cached as prebuilt c_* instances
    # and two .value patches replace ~100us of per-call branching and
    # argument conversion (523 calls per small bench run).
    ver = getattr(h, "_ver", 0)
    fast = getattr(gen, "_rg_fast", None)
    if fast is not None and fast[0] == (
            ver, id(view), n_seg, use_ori, bool(opt.check_strand),
            float(opt.min_ov_ratio)):
        _, args, rs_c, g2s_c, hold, outs = fast
        g2sc = g2s if (g2s.dtype == np.int32 and g2s.flags.c_contiguous) \
            else _c(g2s, np.int32)
        hold["g2s"] = g2sc            # keep alive for the C call
        g2s_c.value = g2sc.ctypes.data
        rs_c.value = 1 if run_shadow else 0
        outs[5][:n_seg] = 0
        n_calls["round_genome"] += 1
        m = int(lib.pg_round_genome(*args))
        assert m >= 0, "kept hit maps to deleted segment"
        return (outs[0][:m], outs[1][:m], outs[2][:m], outs[3][:m],
                outs[4][:m], outs[5][:n_seg])
    pga, gpa = _global_addrs(d)
    cap = max(2 * (n - 1), 1) if n > 1 else 1
    buf = getattr(gen, "_round_buf", None)
    if buf is None or len(buf[0][0]) < cap or len(buf[0][5]) < max(n_seg, 1):
        arrs = (np.empty(cap, np.uint64), np.empty(cap, np.int32),
                np.empty(cap, np.int32), np.empty(cap, np.int32),
                np.empty(cap, np.int32), np.zeros(max(n_seg, 1), np.int32))
        buf = (arrs, tuple(a.ctypes.data for a in arrs))
        gen._round_buf = buf
    (out_x, out_n, out_dist, out_s1, out_s2, seg_cnt), buf_addr = buf
    seg_cnt[:n_seg] = 0
    if n == 0:
        return (out_x[:0], out_n[:0], out_dist[:0], out_s1[:0], out_s2[:0],
                seg_cnt[:n_seg])
    eos, eoe = _exon_ptrs(gen)
    g2sc = g2s if (g2s.dtype == np.int32 and g2s.flags.c_contiguous) \
        else _c(g2s, np.int32)
    vp = _addr_of(gen, "_view_addr", view) if view is not None else None
    # per-genome packed hot table: constants survive across rounds, only
    # flt/weak refresh; invalidated when the table is physically permuted.
    # Managed ONLY when the sweep actually runs — C packs it then; a
    # buffer must never be tagged valid without having been packed.
    hot_ptr = None
    hot_valid = 0
    if run_shadow and not _NO_HOTCACHE:
        ver = getattr(h, "_ver", 0)
        hot = getattr(gen, "_hot_buf", None)
        hot_valid = 1
        if hot is None or hot[1] != ver or len(hot[0]) < n * _HOT_SIZE:
            hot = (np.empty(max(n, 1) * _HOT_SIZE, np.uint8), ver)
            gen._hot_buf = hot
            hot_valid = 0
        hot_ptr = _p(hot[0], np.uint8, None)
    # per-genome pair-geometry cache (pgsweep.c:sweep_shadow_core contract):
    # recorded by C as a byproduct of the first hot-cached sweep, byte
    # lookups thereafter; version-keyed like the hot table.
    # state: 0 record-pending, 1 valid, -1 cap overflow (off for good)
    geo_off_ptr = geo_bytes_ptr = geo_state_ptr = None
    geo_cap = 0
    if hot_ptr is not None and not _NO_GEOCACHE:
        ver = getattr(h, "_ver", 0)
        geo = getattr(gen, "_geo_buf", None)
        geo_cap = 64 * max(n, 1)
        if geo is None or geo[3] != ver:
            geo = (np.empty(n + 1, np.int64), np.empty(geo_cap, np.uint8),
                   np.zeros(1, np.int32), ver)
            gen._geo_buf = geo
        geo_cap = len(geo[1])
        geo_off_ptr = _p(geo[0], np.int64, None)
        geo_bytes_ptr = _p(geo[1], np.uint8, None)
        geo_state_ptr = _p(geo[2], np.int32, None)
    # frozen walk-pack (pgsweep.c:wrec_t): the walk scan's round-invariant
    # fields laid out sequentially in cm order; valid while neither the
    # physical layout (_ver) nor the memoized view object changed. Only
    # meaningful with a stable view (view=None means the caller physically
    # re-sorts around this call).
    wpack_ptr = None
    wpack_valid = 0
    wscratch_ptr = None
    if view is not None and not _NO_HOTCACHE:
        ver = getattr(h, "_ver", 0)
        key = (ver, id(view))
        wp = getattr(gen, "_wpack_buf", None)
        wpack_valid = 1
        if wp is None or wp[1] != key or len(wp[0]) < n * _WREC_SIZE:
            wp = (np.empty(max(n, 1) * _WREC_SIZE, np.uint8), key, view)
            gen._wpack_buf = wp          # holds view alive for id() safety
            wpack_valid = 0
        wpack_ptr = _p(wp[0], np.uint8, None)
        wsc = getattr(gen, "_wscratch_buf", None)
        if wsc is None or len(wsc) < cap * 48:
            wsc = np.empty(max(cap, 1) * 48, np.uint8)
            gen._wscratch_buf = wsc
        wscratch_ptr = _p(wsc, np.uint8, None)
    ad = _hit_addrs(h)
    n_calls["round_genome"] += 1
    m = int(lib.pg_round_genome(
        n,
        ad["pid"], ad["rank"],
        ad["score_adj"], ad["score_ori"],
        ad["n_exon"], ad["off_exon"],
        ad["cid"],
        ad["rev"], ad["flt"],
        ad["weak_br"],
        ad["cs"], ad["ce"],
        eos, eoe,
        pga, gpa,
        1 if opt.check_strand else 0, float(opt.min_ov_ratio),
        ad["shadow"],
        ad["pid_dom"], ad["score_dom"],
        1 if run_shadow else 0,
        vp,
        ad["cm"],
        ad["pid_dom0"],
        _p(g2sc, np.int32, _i32p),
        1 if use_ori else 0, n_seg, buf_addr[5],
        buf_addr[0], buf_addr[1],
        buf_addr[2],
        buf_addr[3], buf_addr[4],
        hot_ptr, 1 if hot_valid else 0,
        geo_off_ptr, geo_bytes_ptr, geo_cap, geo_state_ptr,
        wpack_ptr, wpack_valid, wscratch_ptr))
    assert m >= 0, "kept hit maps to deleted segment"
    if run_shadow and view is not None and hot_ptr is not None \
            and wpack_ptr is not None:
        # this call just (re)built every cache for the epoch: hot packed,
        # wpack built (the walk always runs), geo recording owned by C —
        # so the prebuilt vector carries the valid flags as 1
        import ctypes as ct
        vptr = lambda a: ct.c_void_p(a)
        rs_c = ct.c_int32(1)
        g2s_c = vptr(g2sc.ctypes.data)
        args = (
            ct.c_int64(n),
            vptr(ad["pid"]), vptr(ad["rank"]),
            vptr(ad["score_adj"]), vptr(ad["score_ori"]),
            vptr(ad["n_exon"]), vptr(ad["off_exon"]),
            vptr(ad["cid"]),
            vptr(ad["rev"]), vptr(ad["flt"]),
            vptr(ad["weak_br"]),
            vptr(ad["cs"]), vptr(ad["ce"]),
            vptr(eos), vptr(eoe),
            vptr(pga), vptr(gpa),
            ct.c_int32(1 if opt.check_strand else 0),
            ct.c_double(float(opt.min_ov_ratio)),
            vptr(ad["shadow"]),
            vptr(ad["pid_dom"]), vptr(ad["score_dom"]),
            rs_c,
            vptr(vp),
            vptr(ad["cm"]),
            vptr(ad["pid_dom0"]),
            g2s_c,
            ct.c_int32(1 if use_ori else 0), ct.c_int32(n_seg),
            vptr(buf_addr[5]),
            vptr(buf_addr[0]), vptr(buf_addr[1]),
            vptr(buf_addr[2]),
            vptr(buf_addr[3]), vptr(buf_addr[4]),
            vptr(hot_ptr), ct.c_int32(1),
            vptr(geo_off_ptr), vptr(geo_bytes_ptr),
            ct.c_int64(geo_cap), vptr(geo_state_ptr),
            vptr(wpack_ptr), ct.c_int32(1), vptr(wscratch_ptr))
        gen._rg_fast = (
            (ver, id(view), n_seg, use_ori, bool(opt.check_strand),
             float(opt.min_ov_ratio)),
            args, rs_c, g2s_c,
            {"g2s": g2sc, "view": view},
            (out_x, out_n, out_dist, out_s1, out_s2, seg_cnt))
    return (out_x[:m], out_n[:m], out_dist[:m], out_s1[:m], out_s2[:m],
            seg_cnt[:n_seg])


def rep_pos_rows(d: DataSet, gen: Genome):
    """Native per-genome representative positions: compact
    (gid, cid, kept-rank, cm) rows for each gene with a kept hit.
    Output buffers are per-genome scratch reused across rounds — the
    single-slot memo in branch.gen_rep_pos replaces its stored rows
    whenever this is re-entered for the genome, so no stale slice
    outlives the overwrite."""
    lib = _get_lib()
    h = gen.hits
    n = len(h)
    # prebuilt-argument fast path (see round_genome): every argument is
    # stable within a physical-version epoch
    ver = getattr(h, "_ver", 0)
    fast = getattr(gen, "_rp_fast", None)
    if fast is not None and fast[0] == ver:
        args, (og, oc, orr, om) = fast[1], fast[2]
        n_calls["rep_pos_rows"] += 1
        m = int(lib.pg_rep_pos(*args))
        if m == 0:
            return None
        return og[:m], oc[:m], orr[:m], om[:m]
    pg, _ = _globals(d)
    cap = max(min(n, d.n_gene), 1)
    buf = getattr(gen, "_rep_buf", None)
    if buf is None or len(buf[0][0]) < cap:
        arrs = (np.empty(cap, np.int32), np.empty(cap, np.int32),
                np.empty(cap, np.int32), np.empty(cap, np.int64))
        buf = (arrs, tuple(a.ctypes.data for a in arrs))
        gen._rep_buf = buf
    (og, oc, orr, om), ba = buf
    if n == 0:
        return None
    ad = _hit_addrs(h)
    import ctypes as ct
    args = (ct.c_int64(n), ct.c_void_p(ad["flt"]), ct.c_void_p(ad["shadow"]),
            ct.c_void_p(ad["pid"]), ct.c_void_p(ad["cid"]),
            ct.c_void_p(ad["cm"]),
            ct.c_void_p(_addr_of(d, "_pg_addr", pg)), ct.c_int32(d.n_gene),
            ct.c_void_p(ba[0]), ct.c_void_p(ba[1]),
            ct.c_void_p(ba[2]), ct.c_void_p(ba[3]))
    gen._rp_fast = (ver, args, (og, oc, orr, om))
    n_calls["rep_pos_rows"] += 1
    m = int(lib.pg_rep_pos(*args))
    if m == 0:
        return None
    return og[:m], oc[:m], orr[:m], om[:m]


def merge_arcs_kway(per_genome):
    """Native k-way merge of per-genome x-sorted deduped arc lists.
    Returns (x, n_genome, tot_cnt, avg_dist, s1, s2)."""
    lib = _get_lib()
    offs = np.zeros(len(per_genome) + 1, np.int64)
    for i, p in enumerate(per_genome):
        offs[i + 1] = offs[i] + len(p[0])
    n_in = int(offs[-1])
    cap = max(n_in, 1)
    ox = np.empty(cap, np.uint64)
    ong = np.empty(cap, np.int32)
    otot = np.empty(cap, np.int32)
    oavg = np.empty(cap, np.int32)
    os1 = np.empty(cap, np.int32)
    os2 = np.empty(cap, np.int32)
    if n_in == 0:
        return ox[:0], ong[:0], otot[:0], oavg[:0], os1[:0], os2[:0]
    # tree merge (sequential scans, early aggregation) wins while the
    # working set is cache-resident; the k-way heap's smaller footprint
    # wins at millions of rows (measured crossover ~0.5M). The tree path
    # takes per-source POINTERS (pg_merge_arcs_tree_p), so the ~MBs/round
    # of np.concatenate the flat API needed are gone.
    if n_in < 500_000:
        n_src = len(per_genome)
        counts = np.array([len(p[0]) for p in per_genome], np.int64)
        PTRS = ctypes.c_void_p * n_src
        ptrs = [PTRS(*(p[c].ctypes.data for p in per_genome))
                for c in range(5)]
        n_calls["merge_arcs_kway"] += 1
        m = int(lib.pg_merge_arcs_tree_p(
            n_src, _p(counts, np.int64, _i64p),
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4],
            _p(ox, np.uint64, _u64p), _p(ong, np.int32, _i32p),
            _p(otot, np.int32, _i32p), _p(oavg, np.int32, _i32p),
            _p(os1, np.int32, _i32p), _p(os2, np.int32, _i32p)))
        return ox[:m], ong[:m], otot[:m], oavg[:m], os1[:m], os2[:m]
    x = np.concatenate([p[0] for p in per_genome])
    n = np.concatenate([p[1] for p in per_genome])
    dist = np.concatenate([p[2] for p in per_genome])
    s1 = np.concatenate([p[3] for p in per_genome])
    s2 = np.concatenate([p[4] for p in per_genome])
    n_calls["merge_arcs_kway"] += 1
    m = int(lib.pg_merge_arcs_kway(
        len(per_genome), _p(offs, np.int64, _i64p),
        _p(x, np.uint64, _u64p), _p(n, np.int32, _i32p),
        _p(dist, np.int32, _i32p),
        _p(s1, np.int32, _i32p), _p(s2, np.int32, _i32p),
        _p(ox, np.uint64, _u64p), _p(ong, np.int32, _i32p),
        _p(otot, np.int32, _i32p), _p(oavg, np.int32, _i32p),
        _p(os1, np.int32, _i32p), _p(os2, np.int32, _i32p)))
    return ox[:m], ong[:m], otot[:m], oavg[:m], os1[:m], os2[:m]


def merge_arcs_native(x, n, dist, s1, s2):
    """Native cross-genome arc merge on pre-concatenated per-genome lists.
    Returns (x, n_genome, tot_cnt, avg_dist, s1, s2)."""
    lib = _get_lib()
    n_in = len(x)
    cap = max(n_in, 1)
    ox = np.empty(cap, np.uint64)
    ong = np.empty(cap, np.int32)
    otot = np.empty(cap, np.int32)
    oavg = np.empty(cap, np.int32)
    os1 = np.empty(cap, np.int32)
    os2 = np.empty(cap, np.int32)
    if n_in == 0:
        return ox[:0], ong[:0], otot[:0], oavg[:0], os1[:0], os2[:0]
    nc = _c(n, np.int32)
    dc = _c(dist, np.int32)
    s1c = _c(s1, np.int32)
    s2c = _c(s2, np.int32)
    n_calls["merge_arcs_native"] += 1
    m = int(lib.pg_merge_arcs(
        n_in, _p(x, np.uint64, _u64p),
        _p(nc, np.int32, _i32p),
        _p(dc, np.int32, _i32p),
        _p(s1c, np.int32, _i32p),
        _p(s2c, np.int32, _i32p),
        _p(ox, np.uint64, _u64p), _p(ong, np.int32, _i32p),
        _p(otot, np.int32, _i32p), _p(oavg, np.int32, _i32p),
        _p(os1, np.int32, _i32p), _p(os2, np.int32, _i32p)))
    return ox[:m], ong[:m], otot[:m], oavg[:m], os1[:m], os2[:m]


def gen_vtx_greedy(ng: int, G: int, order: np.ndarray, x: np.ndarray,
                   y: np.ndarray, aux: np.ndarray, included: np.ndarray,
                   vtx_thresh: float):
    """Native greedy vertex selection. aux [ng, G] uint32 is mutated in
    place; returns (sel_gid, sel_dom, sel_sub) in selection order."""
    lib = _get_lib()
    sel = np.empty(max(ng, 1), np.int32)
    sdom = np.empty(max(ng, 1), np.int32)
    ssub = np.empty(max(ng, 1), np.int32)
    if ng == 0:
        return sel[:0], sdom[:0], ssub[:0]
    orderc = _c(order, np.int64)
    incc = _c(included, np.uint8)
    n_calls["gen_vtx_greedy"] += 1
    m = int(lib.pg_gen_vtx_greedy(
        ng, G,
        _p(orderc, np.int64, _i64p),
        _p(x, np.uint64, _u64p), _p(y, np.uint64, _u64p),
        _p(aux, np.uint32, None), _p(incc, np.uint8, _u8p),
        float(vtx_thresh),
        _p(sel, np.int32, _i32p), _p(sdom, np.int32, _i32p),
        _p(ssub, np.int32, _i32p)))
    return sel[:m], sdom[:m], ssub[:m]


def weak_hash_build(arc_xm: np.ndarray, arc_wm: np.ndarray):
    """Open-addressing table of the marked arcs, shared across genomes
    within one propagation round. Returns (keys, vals)."""
    lib = _get_lib()
    n = len(arc_xm)
    n_slots = 1
    while n_slots < 2 * max(n, 1):
        n_slots <<= 1
    keys = np.full(n_slots, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    vals = np.zeros(n_slots, np.uint8)
    if n:
        n_calls["weak_hash_build"] += 1
        lib.pg_weak_hash_build(n, _p(arc_xm, np.uint64, _u64p),
                               _p(arc_wm, np.uint8, _u8p),
                               n_slots, _p(keys, np.uint64, _u64p),
                               _p(vals, np.uint8, _u8p))
    return keys, vals


def propagate_weak_hash(d: DataSet, gen: Genome, g2s: np.ndarray,
                        view, tab) -> None:
    """Hash-probing weak propagation for one genome."""
    lib = _get_lib()
    h = gen.hits
    n = len(h)
    keys, vals = tab
    if n == 0:
        return
    # prebuilt-argument fast path (see round_genome): only g2s and the
    # round's hash table vary call-to-call within a (version, view) epoch
    ver = getattr(h, "_ver", 0)
    fast = getattr(gen, "_pw_fast", None)
    g2sc = g2s if (g2s.dtype == np.int32 and g2s.flags.c_contiguous) \
        else _c(g2s, np.int32)
    if fast is not None and fast[0] == (ver, id(view)):
        _, args, hold, g2s_c, nk_c, k_c, v_c = fast
        hold["g2s"], hold["tab"] = g2sc, tab
        g2s_c.value = g2sc.ctypes.data
        nk_c.value = len(keys)
        k_c.value = keys.ctypes.data
        v_c.value = vals.ctypes.data
        n_calls["propagate_weak_hash"] += 1
        lib.pg_propagate_weak_hash(*args)
        return
    pg, _ = _globals(d)
    vp = _addr_of(gen, "_view_addr", view) if view is not None else None
    ad = _hit_addrs(h)
    import ctypes as ct
    g2s_c = ct.c_void_p(_p(g2sc, np.int32, _i32p))
    nk_c = ct.c_int64(len(keys))
    k_c = ct.c_void_p(_p(keys, np.uint64, _u64p))
    v_c = ct.c_void_p(_p(vals, np.uint8, _u8p))
    args = (ct.c_int64(n), ct.c_void_p(vp),
            ct.c_void_p(ad["flt"]), ct.c_void_p(ad["shadow"]),
            ct.c_void_p(ad["pid"]), ct.c_void_p(ad["rev"]),
            ct.c_void_p(ad["cid"]),
            ct.c_void_p(_addr_of(d, "_pg_addr", pg)), g2s_c,
            nk_c, k_c, v_c,
            ct.c_void_p(ad["weak_br"]))
    if view is not None:
        gen._pw_fast = ((ver, id(view)), args,
                        {"g2s": g2sc, "tab": tab, "view": view},
                        g2s_c, nk_c, k_c, v_c)
    n_calls["propagate_weak_hash"] += 1
    lib.pg_propagate_weak_hash(*args)


def format_arcs(d: DataSet, seg_gid: np.ndarray, arcs) -> str:
    """Native L-line rendering. Returns the full text block."""
    lib = _get_lib()
    n_arc = len(arcs.x)
    if n_arc == 0:
        return ""
    nb = getattr(d, "_gene_name_blob", None)
    if nb is None or nb[3] != d.n_gene:
        names = [s.encode() for s in d.gene_name]
        blob = b"\0".join(names) + b"\0"
        lens = np.array([len(s) for s in names], np.int32)
        offs = np.concatenate(
            ([0], np.cumsum(lens[:-1].astype(np.int64) + 1))) \
            if len(names) else np.zeros(0, np.int64)
        nb = d._gene_name_blob = (blob, offs, lens, d.n_gene)
    blob, offs, lens, _n = nb
    sg = seg_gid if (seg_gid.dtype == np.int32
                     and seg_gid.flags.c_contiguous) \
        else _c(seg_gid, np.int32)
    outp = ctypes.c_void_p()
    n_calls["format_arcs"] += 1
    ln = int(lib.pg_format_arcs(
        n_arc, _p(arcs.x, np.uint64, _u64p), _p(sg, np.int32, _i32p),
        blob, _p(offs, np.int64, _i64p), _p(lens, np.int32, _i32p),
        _p(arcs.n_genome, np.int32, _i32p),
        _p(arcs.tot_cnt, np.int32, _i32p),
        _p(arcs.avg_dist, np.int32, _i32p),
        _p(arcs.s1, np.int32, _i32p), _p(arcs.s2, np.int32, _i32p),
        ctypes.byref(outp)))
    try:
        return ctypes.string_at(outp, ln).decode()
    finally:
        lib.pg_free_text(outp)


def propagate_weak(d: DataSet, gen: Genome, g2s: np.ndarray,
                   view, arc_x: np.ndarray, arc_w: np.ndarray) -> None:
    """Native arc->hit weak_br propagation; the kept walk is built inside
    C from flt/shadow through the cm-order view (None = cm-physical)."""
    lib = _get_lib()
    h = gen.hits
    n = len(h)
    if n == 0 or len(arc_x) == 0:
        return
    pg, _ = _globals(d)
    g2sc = g2s if (g2s.dtype == np.int32 and g2s.flags.c_contiguous) \
        else _c(g2s, np.int32)
    vp = _p(view, np.int64, _i64p) if view is not None else None
    n_calls["propagate_weak"] += 1
    lib.pg_propagate_weak(
        n, vp,
        _p(h.flt, np.uint8, _u8p), _p(h.shadow, np.uint8, _u8p),
        _p(h.pid, np.int32, _i32p), _p(h.rev, np.uint8, _u8p),
        _p(h.cid, np.int32, _i32p),
        _p(pg, np.int32, _i32p),
        _p(g2sc, np.int32, _i32p),
        len(arc_x), _p(arc_x, np.uint64, _u64p),
        _p(arc_w, np.uint8, _u8p),
        _p(h.weak_br, np.uint8, _u8p))


def flt_ov_isoform(opt: PgOpt, d: DataSet, g: Genome) -> int:
    lib = _get_lib()
    h = g.hits
    n = len(h)
    if n == 0:
        return 0
    pg, gp = _globals(d)
    eos, eoe = _exon_ptrs(g)
    n_calls["flt_ov_isoform"] += 1
    return int(lib.pg_sweep_ov_isoform(
        n,
        _p(h.pid, np.int32, _i32p), _p(h.rank, np.int32, _i32p),
        _p(h.score_adj, np.int32, _i32p),
        _p(h.n_exon, np.int32, _i32p), _p(h.off_exon, np.int32, _i32p),
        _p(h.cid, np.int32, _i32p), _p(h.rev, np.uint8, _u8p),
        _p(h.cs, np.int64, _i64p), _p(h.ce, np.int64, _i64p),
        eos, eoe,
        _p(pg, np.int32, _i32p), _p(gp, np.uint8, _u8p),
        1 if opt.check_strand else 0,
        _p(h.flt_iso_ov, np.uint8, _u8p), _p(h.flt, np.uint8, _u8p)))
