"""The genome mesh's kernels' plain versions (ops/mesh_kernels.py) against
the JAX package, on the CPU. Every comparison is exact (integers,
tolerance 0).

  protein_reduce   against JAX stacked.reduction_step on a one-device CPU
                   mesh, the same rows in the padded [G, H] stack and in the
                   flat layout (every genome's rows end to end, G = 1), under
                   fuzz: pids out of range (clamped), negative and zero
                   scores, every row filtered, n_prot 1, an empty genome,
                   rising scores, one pid for every row, 60,000 proteins,
                   no single-exon row counted; each state held to its edge;
                   and post_reductions_sharded's stacking of one rank's
                   genomes: the ranks' partials make the whole; its
                   bound in chip_smoke.py counts only the bytes it reads;
  the exchange     exchange_pack, exchange_window and exchange_finish
                   against a numpy transcription of the JAX lines they
                   replace (pangene_tpu/parallel/device_loop.py:325-348,
                   :377-405) on every state of testing.exchange_calls, each
                   rank, pack's bounds plane against JAX's start and cnt,
                   finish fed those bounds reading only the slots sent;
                   the whole exchange against the replicated lean merge;
                   the bounds in chip_smoke.py count only what the kernels
                   read; and the aten operations exchange_merge dispatches
                   a round outside the kernels' wrappers and the
                   collectives, at world 3 on the loop's own inputs.
"""
import ctypes
import json

import numpy as np
import pytest
import torch

from pangene_tpu.parallel import stacked as jst
from pangene_tpu.parallel.mesh import make_mesh as jax_mesh
from pangene_tpu.parallel.mesh import put_sharded as jax_put
from pangene_tpu_torch import pipeline
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.ops import mesh_kernels as mk
from pangene_tpu_torch.ops import pseudo as pseudo_ops
from pangene_tpu_torch.options import PgOpt
from pangene_tpu_torch.parallel import mesh
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.testing import (EXCHANGE_STATES, REDUCE_CASES,
                                       exchange_calls, reduction_inputs,
                                       synth_paf_files)

KSENT = lk.KSENT_I
SENT = lk.SENT_I
CPU = torch.device("cpu")

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# protein_reduce
# ---------------------------------------------------------------------------

def jax_reduce(cols, flt, n_rows, P):
    """JAX stacked.reduction_step on a one-device mesh: seven arrays."""
    m = jax_mesh(1)
    G, H = flt.shape
    valid = np.arange(H)[None, :] < n_rows[:, None]
    outs = jst.reduction_step(*[jax_put(c, m) for c in cols],
                              jax_put(flt, m), jax_put(valid, m), n_prot=P,
                              mesh=m)
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("which", REDUCE_CASES)
def test_protein_reduce_plain_equals_jax(which, layout):
    want = jax_reduce(*reduction_inputs(which))
    cols, flt, n_rows, P = reduction_inputs(which, flat=layout == "flat")
    t = torch.from_numpy
    args = [t(c) for c in cols] + [t(flt), t(n_rows)]
    before = dict(mk.n_calls["protein_reduce"])
    max_so, sums = mk.protein_reduce(*args, n_prot=P)
    assert mk.n_calls["protein_reduce"] == {
        "kernel": before["kernel"], "plain": before["plain"] + 1}
    got = [max_so] + list(sums)
    assert max_so.dtype == torch.int32 and sums.dtype == torch.int64
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), k
    # reduction_step (one rank) returns the same seven
    for g, w in zip(st.reduction_step(*args, n_prot=P), want):
        assert np.array_equal(g.numpy(), w)
    # each state holds its edge
    cnt0, cnt1, sum0, sum1, rep_sum, rep_cnt = want[1:]
    assert np.array_equal(rep_cnt, cnt0 + cnt1)
    if which == "all_filtered":
        assert not any(w.any() for w in want[1:]) and want[0].any()
    elif which == "scores_le_zero":
        assert not want[0].any() and want[1].any()
    elif which == "ascending_scores":
        # score_ori 1, 2, ... along the valid rows: the largest is the count
        assert want[0].max() == int(n_rows.sum())
    elif which == "one_protein_all_rows":
        assert np.flatnonzero(want[0]).tolist() == [1234] and P > 1234
        assert rep_cnt[1234] == rep_cnt.sum() > 0
    elif which == "r0_none_multi":
        assert not cnt0.any() and not sum0.any() and cnt1.any()
        assert np.array_equal(rep_cnt, cnt1)
    elif which == "wide":
        assert P >= 60_000 and np.count_nonzero(want[0]) > 0.99 * P


def test_wide_case_outnumbers_the_resident_blocks():
    """The wide case's rows (flat) make more blocks of protein_reduce (a
    thread a row) than an H100 holds at once: more rows than its 132 SMs
    of 2,048 resident threads each, twice over."""
    cols, flt, n_rows, P = reduction_inputs("wide", flat=True)
    assert int(n_rows[0]) > 2 * 132 * 2048


def chip_smoke():
    """chip_smoke.py as a module (its bounds are plain functions)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("which", REDUCE_CASES)
def test_reduction_bound_counts_what_is_read(which, layout):
    """chip_smoke.reduction_bound_bytes, protein_reduce's least bytes:
    pid, score_ori and rank at every valid row, flt only at a valid rank-0
    row, n_exon and score_adj only at a valid rank-0 unfiltered row,
    nothing of a row past n_rows; n_rows and the outputs."""
    cs = chip_smoke()
    cols, flt, n_rows, P = reduction_inputs(which, flat=layout == "flat")
    t = torch.from_numpy
    args = [t(c) for c in cols] + [t(flt), t(n_rows)]
    G, H = flt.shape
    rank = cols[4]
    valid = np.arange(H)[None, :] < n_rows[:, None]
    r0 = valid & (rank == 0)
    n_valid, n_r0, n_kept = (int(valid.sum()), int(r0.sum()),
                             int((r0 & (flt == 0)).sum()))
    assert n_valid > 0 and 0 < n_r0 < n_valid
    got = cs.reduction_bound_bytes(*args, P)
    # no row below n_rows: n_rows and the outputs alone
    none = cs.reduction_bound_bytes(*args[:6], torch.zeros_like(args[6]), P)
    assert none == 4 * G + 52 * P
    assert got - none == 12 * n_valid + n_r0 + 8 * n_kept
    # every row of rank 1: no flt, n_exon or score_adj read
    ones = cs.reduction_bound_bytes(*args[:4], torch.ones_like(args[4]),
                                    *args[5:], P)
    assert ones - none == 12 * n_valid
    # the padded stack's noise past n_rows is not counted
    if layout == "padded":
        fc, ff, fn, _ = reduction_inputs(which, flat=True)
        assert n_valid < G * H
        assert got == cs.reduction_bound_bytes(
            *[t(c) for c in fc], t(ff), t(fn), P) + 4 * (G - 1)


C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long*": ctypes.c_void_p}


def test_mesh_entries_match_the_source():
    """Every C entry that mesh_kernels.load binds is defined in
    csrc/mesh_round.cu with that return type and those argument types, and
    the source defines no other (the library is built only on the card, so
    this is the check the CPU can make)."""
    import re
    src = open(mk._SRC).read()
    found = {}
    for ret, name, params in re.findall(
            r'extern "C" (int|long long) (pg_\w+)\(([^)]*)\)', src):
        types = [re.sub(r"\s*\w+$", "", p.strip())
                 for p in params.split(",")]
        found[name] = (C_TYPES[ret], [C_TYPES[t] for t in types])
    assert found == mk.ENTRIES


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_bound_counts_what_is_read(which):
    """chip_smoke.exchange_bound_bytes, the least bytes of exchange_pack
    and exchange_finish: pack reads each key it sends and its row's s1 (12
    bytes) and writes the [nd, 2, C] plane, the flag, the pair plane and the
    bounds plane; finish reads n_out, a live table row's two words, the
    bounds plane and each sent slot's key and reply, and writes 12 bytes a
    table row and each sent key's pair slot. Neither counts an unsent
    slot's key: noise there leaves finish's count as it was."""
    cs = chip_smoke()
    meta, calls = exchange(which)
    nd, C, NL, A = meta["nd"], meta["C"], meta["NL"], meta["A"]
    for r, call in enumerate(calls):
        args, kw = call["pack"]
        smask = jax_pack(*numpy_args(args), **kw)[3]
        n_sent = int(smask.sum())
        got = mk.exchange_pack(*args, **kw)
        assert cs.exchange_bound_bytes("pack", args, kw, got) == (
            12 * n_sent + 16 * nd * C + 8 + 4 * (NL + 1) + 4 * (nd + 1)), r
        fargs, fkw = call["finish"]
        n_live = min(int(fargs[1]), A)
        want = 16 * n_live + 8 + 4 * (nd + 1) + 16 * n_sent + 12 * A
        outs = mk.exchange_finish(*fargs[:4], fargs[4].clone(), fargs[5],
                                  **fkw)
        assert cs.exchange_bound_bytes("finish", fargs, fkw, outs) == want
        noisy = fargs[2].clone()
        noisy[:, 0][torch.from_numpy(~smask)] = 5
        assert cs.exchange_bound_bytes("finish", (*fargs[:2], noisy,
                                                  *fargs[3:]), fkw,
                                       outs) == want
        if which == "all_sentinel":
            assert n_sent == 0 and n_live == 0
        else:
            assert 0 < n_sent < nd * C


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five genomes: at world 2 the padded axis has one genome of padding."""
    d = tmp_path_factory.mktemp("torch_mesh_kernels")
    return synth_paf_files(str(d), n_genome=5, n_gene=150, n_iso=3, seed=23)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_reductions_each_rank_stacks_its_genomes(corpus, world):
    """Rank r stacks the rows of genomes [r G_loc, (r + 1) G_loc) of the
    padded axis (mesh.put_sharded's partition) end to end; the ranks'
    maxima and sums make the host loops' values."""
    opt = PgOpt(engine="sharded", device="cpu")
    d = pipeline.read_all(opt, corpus)
    P = max(d.n_prot, 1)
    G_loc = mesh.pad_genomes(d.n_genome, mesh.Mesh(world, 0, CPU, None,
                                                   None)) // world
    total = None
    for r in range(world):
        m = mesh.Mesh(world, r, CPU, None, None)
        buf, N = st.stack_reductions(d, m, pin=False)
        mine = d.genomes[r * G_loc:(r + 1) * G_loc]
        n = sum(g.n_hit for g in mine)
        assert N == max(n, 1) and buf.nbytes == 4 * (1 + 5 * N) + N
        cols = st.reduction_views(torch.from_numpy(buf), N)
        assert int(cols[6][0]) == n
        for k, name in enumerate(st.REDUCTION_COLS):
            assert cols[k].shape == (1, N)
            assert np.array_equal(cols[k][0, :n].numpy(), np.concatenate(
                [g.hits.cols[name] for g in mine] + [np.zeros(0, np.int32)]))
        assert np.array_equal(cols[5][0, :n].numpy(), np.concatenate(
            [g.hits.flt for g in mine] + [np.zeros(0, np.uint8)]))
        outs = [o.numpy() for o in st.reduction_step(*cols, n_prot=P)]
        total = outs if total is None else (
            [np.maximum(total[0], outs[0])]
            + [a + b for a, b in zip(total[1:], outs[1:])])
    mx = total[0][:d.n_prot]
    z = ((total[5].astype(np.uint64) << np.uint64(32))
         + total[6].astype(np.uint64))[:d.n_prot]
    hc, hs = pseudo_ops.joint_counts(d)
    assert np.array_equal(mx, pseudo_ops.max_score_ori(d))
    assert np.array_equal(z, pseudo_ops.representative_sums(d))
    assert np.array_equal(np.stack(total[1:3], 1)[:d.n_prot], hc)
    assert np.array_equal(np.stack(total[3:5], 1)[:d.n_prot], hs)
    assert mx.max() > 0 and hc.sum() > 0


# ---------------------------------------------------------------------------
# the bucket exchange: numpy transcriptions of the JAX lines
# ---------------------------------------------------------------------------

def jax_pack(kps_l, s1f, *, nd, cap, jb, shift, two_s, rank):
    """device_loop.py:325-348 in numpy: (k_send, s1_send, ovf_x, smask,
    orig_row, start, cnt)."""
    NL = kps_l.shape[0]
    base = rank * NL
    validl = kps_l != KSENT
    v_of = kps_l >> shift
    dest = np.clip((v_of * nd) // two_s, 0, nd - 1).astype(np.int32)
    cnt = np.zeros(nd, np.int32)
    np.add.at(cnt, dest, validl.astype(np.int32))
    start = np.concatenate([np.zeros(1, np.int32),
                            np.cumsum(cnt)[:-1].astype(np.int32)])
    ovf_x = np.any(cnt > cap)
    cc = np.arange(cap, dtype=np.int32)[None, :]
    gidx = np.clip(start[:, None] + cc, 0, NL - 1)
    smask = cc < cnt[:, None]
    k_g = kps_l[gidx]
    k_send = np.where(smask, k_g, KSENT)
    orig_row = np.clip((k_g & ((1 << jb) - 1)) - base, 0, NL - 1) \
        .astype(np.int32)
    s1_send = np.where(smask, s1f[orig_row], 0)
    return k_send, s1_send, ovf_x, smask, orig_row, start, cnt


def jax_window(per_rank, vw_f, s1_loc, reply_loc, got_k, *, rank, A, jb):
    """device_loop.py:377-401 in numpy, the fold's outputs given: (vw plane,
    s1 plane (int32), n_out, reply by received position)."""
    nouts, ovf = per_rank[0::2], per_rank[1::2]
    nd = nouts.shape[0]
    off = np.sum(np.where(np.arange(nd) < rank, nouts, 0))
    n_out = np.int64(A + 1) if ovf.astype(np.int32).sum() > 0 \
        else np.sum(nouts)
    RL = vw_f.shape[0]
    lv = np.arange(RL) < nouts[rank]
    start = min(max(int(off), 0), A)        # dynamic_update_slice's clamp

    def put(vals, dt):
        z = np.zeros(A + RL, dt)
        z[start:start + RL] = np.where(lv, vals, 0).astype(dt)
        return z[:A]
    va = (got_k >> jb) != (KSENT >> jb)
    out_gl = (off + reply_loc.astype(np.int64)).astype(np.int32)
    return (put(vw_f, np.int64), put(s1_loc, np.int32), n_out,
            np.where(va, out_gl, 0).astype(np.int32))


def numpy_args(args):
    return [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]


_exchanges = {}


def exchange(which):
    if which not in _exchanges:
        _exchanges[which] = exchange_calls(which, 3, CPU)
    return _exchanges[which]


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_pack_equals_jax_lines(which):
    meta, calls = exchange(which)
    for r, call in enumerate(calls):
        args, kw = call["pack"]
        k_send, s1_send, ovf = jax_pack(*numpy_args(args), **kw)[:3]
        before = dict(mk.n_calls["exchange_pack"])
        send, got_ovf, pair, _ = mk.exchange_pack(*args, **kw)
        assert mk.n_calls["exchange_pack"]["plain"] == before["plain"] + 1
        assert send.shape == (meta["nd"], 2, meta["C"])
        assert send.dtype == torch.int64 and got_ovf.dtype == torch.int64
        assert np.array_equal(send[:, 0].numpy(), k_send), r
        assert np.array_equal(send[:, 1].numpy(), s1_send), r
        assert int(got_ovf) == int(ovf), r
        assert pair.dtype == torch.int32 and pair.shape == (meta["NL"] + 1,)
        assert not pair.any()


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_window_equals_jax_lines(which):
    meta, calls = exchange(which)
    for r, call in enumerate(calls):
        args, kw = call["window"]
        vw, s1, n_out, reply = jax_window(*numpy_args(args), jb=meta["JB"],
                                          **kw)
        table, got_reply, got_n_out = mk.exchange_window(*args, **kw)
        assert table.dtype == torch.int64 and table.shape == (2, meta["A"])
        assert np.array_equal(table[0].numpy(), vw), r
        assert np.array_equal(table[1].numpy(), s1.astype(np.int64)), r
        assert got_n_out.dtype == torch.int64 and int(got_n_out) == n_out
        assert got_reply.dtype == torch.int32
        assert np.array_equal(got_reply.numpy(), reply), r


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_finish_equals_jax_lines(which):
    meta, calls = exchange(which)
    NL = meta["NL"]
    for r, call in enumerate(calls):
        args, kw = call["finish"]
        table, n_out, _, reply, _, _ = numpy_args(args)
        smask, orig_row = jax_pack(*numpy_args(call["pack"][0]),
                                   **call["pack"][1])[3:5]
        live = np.arange(meta["A"]) < n_out
        want_vw = np.where(live, table[0], SENT)
        want_s1 = np.where(live, table[1].astype(np.int32), 0)
        want_pair = np.zeros(NL + 1, np.int32)
        want_pair[np.where(smask, orig_row, NL).reshape(-1)] = reply
        args = list(args)
        args[4] = args[4].clone()
        arc_vw, arc_s1, pair = mk.exchange_finish(*args, **kw)
        assert arc_vw.dtype == torch.int64 and arc_s1.dtype == torch.int32
        assert np.array_equal(arc_vw.numpy(), want_vw), r
        assert np.array_equal(arc_s1.numpy(), want_s1), r
        assert pair.dtype == torch.int32 and pair.shape == (NL,)
        assert np.array_equal(pair.numpy(), want_pair[:NL]), r


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_pack_bounds_equal_jax_start_cnt(which):
    """exchange_pack's bounds plane is JAX's start (device_loop.py:335-337)
    followed by the valid keys' count: bounds[t + 1] - bounds[t] is JAX's
    cnt, the finish's sent slots min(cnt, C) JAX's smask."""
    meta, calls = exchange(which)
    nd, C = meta["nd"], meta["C"]
    for r, call in enumerate(calls):
        args, kw = call["pack"]
        _, _, _, smask, _, start, cnt = jax_pack(*numpy_args(args), **kw)
        bounds = mk.exchange_pack(*args, **kw)[3]
        assert bounds.dtype == torch.int32 and bounds.shape == (nd + 1,)
        b = bounds.numpy()
        assert np.array_equal(b[:nd], start), r
        assert np.array_equal(np.diff(b), cnt), r
        assert b[nd] == int((args[0] != KSENT).sum()), r
        sent = np.arange(C)[None, :] < np.minimum(np.diff(b), C)[:, None]
        assert np.array_equal(sent, smask), r
        # the finish's arguments carry the same plane
        assert torch.equal(call["finish"][0][5], bounds), r


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_finish_reads_only_the_slots_sent(which):
    """exchange_finish takes the slots sent from pack's bounds, not from
    the keys: with every unsent slot's key and reply made noise (a valid
    key of another row, a reply that is not 0), its outputs are the JAX
    lines' still."""
    meta, calls = exchange(which)
    rng = np.random.default_rng(11)
    for r, call in enumerate(calls):
        args, kw = call["finish"]
        table, n_out, send, reply, pair, bounds = args
        smask = jax_pack(*numpy_args(call["pack"][0]),
                         **call["pack"][1])[3]
        unsent = torch.from_numpy(~smask)
        noisy = send.clone()
        noisy[:, 0][unsent] = torch.from_numpy(rng.integers(
            0, 1 << 40, int(unsent.sum())))
        noise_reply = reply.clone()
        noise_reply[unsent.reshape(-1)] = 7
        want = mk.exchange_finish(table, n_out, send, reply, pair.clone(),
                                  bounds, **kw)
        got = mk.exchange_finish(table, n_out, noisy, noise_reply,
                                 pair.clone(), bounds, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), r
        if which != "all_sentinel":
            assert unsent.any() and (noisy[:, 0] != KSENT).all()


@pytest.mark.parametrize("which", EXCHANGE_STATES)
def test_exchange_states_hold_their_edges(which):
    """Each state is the edge it is named for."""
    meta, calls = exchange(which)
    nd, A, C = meta["nd"], meta["A"], meta["C"]
    sends = [mk.exchange_pack_plain(*c["pack"][0], **c["pack"][1])
             for c in calls]
    valid = [(s[0][:, 0] != KSENT).sum(1) for s in sends]   # [nd] a rank
    ovf = [int(s[1]) for s in sends]
    per_rank = calls[0]["window"][0][0].reshape(nd, 2)
    offs = torch.cumsum(per_rank[:, 0], 0) - per_rank[:, 0]
    n_out = int(calls[0]["finish"][0][1])
    if which == "overflow":
        assert any(ovf) and n_out == A + 1
        # one destination over the bucket, the others within it
        full = {t for v in valid for t in range(nd) if v[t] == C}
        assert full == {0}
    else:
        assert not any(ovf) and n_out == int(per_rank[:, 0].sum())
    if which == "all_sentinel":
        assert n_out == 0 and all(int(v.sum()) == 0 for v in valid)
    else:
        assert all(int(v.sum()) > 0 for v in valid)
    if which == "one_dest":
        assert C == meta["NL"]
        assert len({t for v in valid for t in range(nd) if v[t]}) == 1
    if which == "window_past_A":
        assert int(offs[-1]) > A and n_out > A
    elif which in ("ordinary", "one_dest", "empty_middle"):
        assert 0 < n_out <= A
    if which == "empty_middle":
        # destination 1 gets nothing from any rank, 0 and 2 get keys from
        # every rank: an empty run between two that are not
        for s_, v in zip(sends, valid):
            b = s_[3]
            assert int(v[1]) == 0 and int(v[0]) > 0 and int(v[2]) > 0
            assert int(b[1]) == int(b[2]) > int(b[0]) == 0


@pytest.mark.parametrize("which", [s for s in EXCHANGE_STATES
                                   if s != "overflow"])
def test_exchange_equals_replicated_merge(which):
    """Without an overflow, the ranks' exchange gives what the replicated
    lean merge (every rank's keys gathered, one sort, one fold over the
    table of A rows) gives: the same arc table and n_out on every rank,
    and each rank's pair slots its window of the replicated pair plane."""
    meta, calls = exchange(which)
    NL, A, nd = meta["NL"], meta["A"], meta["nd"]
    keys = torch.cat([c["pack"][0][0] for c in calls])
    s1 = torch.cat([c["pack"][0][1] for c in calls])
    vw, s1_arc, n_out, pair = lk.merge_fold_plain(
        torch.sort(keys).values, s1, jb=meta["JB"], gb=meta["GB"], cap=A)
    for r, c in enumerate(calls):
        args, kw = c["finish"]
        args = list(args)
        args[4] = args[4].clone()
        got_vw, got_s1, got_pair = mk.exchange_finish_plain(*args, **kw)
        assert int(args[1]) == int(n_out), r
        assert torch.equal(got_vw, vw) and torch.equal(got_s1, s1_arc), r
        assert torch.equal(got_pair, pair[r * NL:(r + 1) * NL]), r
    if which != "all_sentinel":
        assert int(n_out) > nd


# ---------------------------------------------------------------------------
# the exchange's host operations a round
# ---------------------------------------------------------------------------

# aten operations exchange_merge dispatches a round outside the kernels'
# wrappers and the collectives (the two sorts, the received plane's two
# columns, the all_gather's stack, views): 10 measured when the packing,
# the window and the reply, and the finish became kernels (88 before, the
# same count on the torch operations they replaced), plus 2
EXCHANGE_OPS_CEILING = 12

EXCHANGE_OPS = r"""
import json, sys
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.ops import mesh_kernels as mk
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh as M
d = sys.argv[1]
z = np.load(d + "/in.npz")
cfg = dl.Cfg(**json.load(open(d + "/cfg.json")))
m = M.make_mesh(0, "cpu")
count, inside, rounds = [0], [0], [0]


class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not inside[0]:
            count[0] += 1
        return func(*args, **(kwargs or {}))


def wrapped(fn):
    def call(*a, **kw):
        inside[0] += 1
        try:
            return fn(*a, **kw)
        finally:
            inside[0] -= 1
    return call


lk.merge_fold = wrapped(lk.merge_fold)
for name in mk.n_calls:
    setattr(mk, name, wrapped(getattr(mk, name)))
for name in ("all_to_all", "all_gather", "psum"):
    setattr(M, name, wrapped(getattr(M, name)))
exchange_merge = dl.exchange_merge


def counted(*a, **kw):
    rounds[0] += 1
    with Count():
        return exchange_merge(*a, **kw)


dl.exchange_merge = counted
outs = dl.schedule(*[z["a%d" % i] for i in range(19)], cfg=cfg, mesh=m)
np.savez(d + "/out%d.npz" % m.rank, *outs)
json.dump(dict(loop=lk.n_calls, mesh=mk.n_calls, exchange_ops=count[0],
               exchange_rounds=rounds[0]),
          open(d + "/calls%d.json" % m.rank, "w"))
M.shutdown()
"""


@pytest.fixture(scope="module")
def loop_corpus(tmp_path_factory):
    """The corpus of tests/test_torch_mesh.py."""
    d = tmp_path_factory.mktemp("torch_mesh_kernels_loop")
    return synth_paf_files(str(d), n_genome=10, n_gene=250, n_iso=3, seed=17)


def test_exchange_ops_a_round(loop_corpus, tmp_path):
    """At world 3 on the loop's inputs from the JAX _schedule: every lean
    in-loop merge goes through the exchange's three entries (their plain
    versions here), all 20 outputs equal JAX's on every rank, and the
    exchange dispatches at most EXCHANGE_OPS_CEILING aten operations a
    round outside them and the collectives (recorded in each rank's calls
    JSON)."""
    import test_torch_mesh as tm
    from pangene_tpu_torch.parallel import device_loop as dl
    world = 3
    cap = tm.jax_capture(loop_corpus, world)
    np.savez(tmp_path / "in.npz", **{"a%d" % i: a
                                     for i, a in enumerate(cap["inputs"])})
    cfg = dl.cfg_from(cap["cfg"])
    assert cfg.a2a_cap > 0
    (tmp_path / "cfg.json").write_text(json.dumps(cfg._asdict()))
    tm.launch_script(EXCHANGE_OPS, world, [str(tmp_path)])
    n_merge = None
    for r in range(world):
        calls = json.loads((tmp_path / ("calls%d.json" % r)).read_text())
        z = np.load(tmp_path / ("out%d.npz" % r))
        for i, (name, w) in enumerate(zip(tm.OUT_NAMES, cap["outputs"])):
            assert np.array_equal(z["arr_%d" % i], w), (r, name)
        rounds = calls["exchange_rounds"]
        # one lean merge a round that walked, the full tail apart
        assert rounds == calls["loop"]["merge_fold"]["plain"] - 1 > 0
        assert n_merge in (None, rounds)
        n_merge = rounds
        for name in ("exchange_pack", "exchange_window", "exchange_finish"):
            assert calls["mesh"][name] == {"kernel": 0, "plain": rounds}
        assert 0 < calls["exchange_ops"] / rounds <= EXCHANGE_OPS_CEILING, \
            calls["exchange_ops"]
