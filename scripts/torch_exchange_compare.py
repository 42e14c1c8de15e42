#!/usr/bin/env python3
"""The bucket exchange's exchange_pack and exchange_finish against their
first form (the one that made the nd run bounds by binary search in every
block, and whose finish read the key of every slot), in turns on one card,
on the same arguments:

    python3 scripts/torch_exchange_compare.py [--shapes big,northstar]
        [--variants a,b] [--also NAME=PATH]

The arguments are rank 0's of testing.exchange_calls("ordinary", 17) at
the world-4 shapes of the big and north-star loops (SHAPES: G_loc genomes
of H rows a rank, the loop's S and A), as chip_smoke.py phase 4e makes
them. The first form's two kernels are kept here as source text
(FIRST_FORM) and built by nvcc into build/exchange_compare/first/; this
checkout's csrc/mesh_round.cu is built into build/exchange_compare/change/,
each of VARIANTS (textual substitutions of it) and each --also source (a
mesh_round.cu with these C entries) into build/exchange_compare/<name>/
(scripts/torch_compare_builds.py: one nvcc a source, all started
together). Every exact build's pack and
finish must equal the plain versions (ops/mesh_kernels.py) on the
arguments; then they take turns, first, change, --also, variants, and the
same again in reverse, each the device time of 200 launches in one CUDA
graph (chip_smoke.graph_ms; pack through one scratch, as the loop calls
it). Bounds are
chip_smoke.exchange_bound_bytes' (the keys sent only) beside the first
form's count (every slot's key for finish). Prints the card, each build's
ptxas lines, a line a shape and kernel, and last EXCHANGE=<json>.
"""
import argparse
import ctypes
import json
import os
import sys

from torch_compare_builds import (ROOT, build_all, card_line, chip_smoke,
                                  turns, write_source, write_variants)

# the loops' world-4 shapes: rank r of 4 holds G_loc = G / 4 genomes of
# the loop's H rows (big: G 64, H 10,240, S 10,000, A 327,680; the north
# star: G 100, H 18,944, S 19,000, A 831,488; chip_smoke.py's CORPORA)
SHAPES = {"big": dict(G_loc=16, H=10240, S=10000, A=327680),
          "northstar": dict(G_loc=25, H=18944, S=19000, A=831488)}
SEED = 17
# this checkout's variants: name -> (the kernel it is for, exact,
# substitutions (old, new) of csrc/mesh_round.cu, each old found at least
# once). An exact variant must equal the plain version; the others cut a
# phase out (their outputs are wrong) and are timed only, to split the
# kernel's time: pack returning at once (the launch alone), taking its
# tickets but no tile, without its fill tiles, without the s1 gather,
# without the key tiles' stores, without zeroing the pair plane; finish
# returning at once, without its table tiles, without its slot tiles,
# without the scatter (its loads kept), with the scatter made a coalesced
# store. Exact: poll32 polls a bound every 32 ns (no back-off);
# fill_rows16 makes fill tiles of 4,096 slots; finish scatters by a plain
# store (finish_store), an atomicAdd (finish_add) or an atomicExch
# (finish_exch) instead of its atomicMax.
_PACK_TILES = ("    if (tk < a.n_key)\n"
               "      pack_keys(a, tk * kExTile, th, sb, sh);\n"
               "    else\n"
               "      pack_fill(a, (tk - a.n_key) * kFillTile, sb);")
_SCATTER = "      atomicMax(a.pair + row, rep[r]);"
VARIANTS = {
    "poll32": ("pack", True, (("ns = ns < 256 ? 2 * ns : ns",
                               "ns = ns < 32 ? 2 * ns : ns"),)),
    "fill_rows16": ("pack", True, (("constexpr int kFillRows = 8;",
                                    "constexpr int kFillRows = 16;"),)),
    "pack_empty": ("pack", False, ((
        "exchange_pack_kernel(PackArgs a) {",
        "exchange_pack_kernel(PackArgs a) {\n  if (a.NL > 0) return;"),)),
    "pack_tickets": ("pack", False, ((_PACK_TILES, ""),)),
    "pack_no_fill": ("pack", False, ((
        "__device__ void pack_fill(const PackArgs& a, long long j0, int* sb) {",
        "__device__ void pack_fill(const PackArgs& a, long long j0, int* sb) {"
        "\n  if (j0 >= 0) return;"),)),
    "pack_no_s1": ("pack", False, (("v1[r] = __ldg(a.s1 + row);",
                                    "v1[r] = static_cast<int32_t>(row);"),)),
    "pack_no_store": ("pack", False, ((
        "    out[0] = key[r];\n    out[a.C] = v1[r];",
        "    if (c < 0) {\n      out[0] = key[r];\n      out[a.C] = v1[r];"
        "\n    }"),)),
    "pack_no_pair": ("pack", False, (("    a.pair[p] = 0;\n", ""),)),
    "finish_store": ("finish", True, ((_SCATTER,
                                       "      a.pair[row] = rep[r];"),)),
    "finish_add": ("finish", True, ((
        _SCATTER, "      atomicAdd(a.pair + row, rep[r]);"),)),
    "finish_exch": ("finish", True, ((
        _SCATTER, "      atomicExch(a.pair + row, rep[r]);"),)),
    "finish_empty": ("finish", False, ((
        "exchange_finish_kernel(FinishArgs a) {",
        "exchange_finish_kernel(FinishArgs a) {\n  if (a.A > 0) return;"),)),
    "finish_no_table": ("finish", False, ((
        "  long long w = blockIdx.x;",
        "  long long w = blockIdx.x + a.n_table;"),)),
    "finish_no_slots": ("finish", False, ((
        "  const long long n_work = a.n_table + (total + kExTile - 1) / "
        "kExTile;", "  const long long n_work = a.n_table;"),)),
    "finish_no_scatter": ("finish", False, ((
        _SCATTER, "      if (rep[r] == 0x7fffffff) a.pair[row] = rep[r];"),)),
    "finish_coalesced": ("finish", False, ((
        _SCATTER,
        "      a.pair[i % (a.NL + 1)] = rep[r] ^ static_cast<int32_t>(row);"),
        )),
}

# The first form's exchange_pack and exchange_finish with their C entries
# (csrc/mesh_round.cu as the bucket exchange's kernels were first written).
FIRST_FORM = r"""#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks a SM the grid-stride kernels ask for at most (132 SMs)
constexpr int kMaxBlocks = 132 * 8;
constexpr int64_t kKSent = int64_t(1) << 62;       // an invalid row's key
constexpr int64_t kSent = (int64_t(1) << 62) - 1;  // an empty table slot

int grid_of(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// floor(x / d) for d > 0, as XLA's and torch's integer // of int64
__device__ __forceinline__ long long floor_div(long long x, long long d) {
  const long long q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ int dest_of(int64_t key, int shift, int nd,
                                       long long two_s) {
  const long long t = floor_div((key >> shift) * nd, two_s);
  return static_cast<int>(t < 0 ? 0 : (t > nd - 1 ? nd - 1 : t));
}

// The first position in [0, n) whose key is KSENT or goes to destination
// t or later (n when none), by a 32-way search of one warp; every lane
// returns it.
__device__ int run_bound(const int64_t* keys, int n, int t, int shift,
                         int nd, long long two_s) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // positions before lo fail; the answer <= hi
  while (lo < hi) {
    const long long len = hi - lo;
    const long long step = len <= 32 ? 1 : (len + 31) / 32;
    const long long p = lo + lane * step;
    bool hit = false;
    if (p < hi) {
      const int64_t k = keys[p];
      hit = k >= kKSent || dest_of(k, shift, nd, two_s) >= t;
    }
    // the ballot is the warp's: every lane takes the same branch
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (bal == 0) {
      // every probe failed: the answer is past the last one below hi
      const long long m = (len - 1) / step;
      lo += (m < 31 ? m : 31) * step + 1;
    } else {
      const int f = __ffs(bal) - 1;
      if (f == 0) return static_cast<int>(lo);
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
    }
  }
  return static_cast<int>(lo);
}

struct PackArgs {
  const int64_t* keys;      // [NL] sorted
  const int32_t* s1;        // [NL] by local row
  int NL, nd, C, jb, shift;
  long long two_s, base;
  int64_t* send;            // [nd, 2, C]
  int64_t* ovf;             // scalar
  int32_t* pair;            // [NL + 1], zeroed here
};

__global__ void __launch_bounds__(kThreads) exchange_pack_kernel(PackArgs a) {
  // bound[t]: the start of destination t's run, t = 0 .. nd (bound[nd]:
  // the first sentinel)
  extern __shared__ int bound[];
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) bound[0] = 0;
  for (int t = 1 + warp; t <= a.nd; t += kWarps) {
    const int b = run_bound(a.keys, a.NL, t, a.shift, a.nd, a.two_s);
    if ((threadIdx.x & 31) == 0) bound[t] = b;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t over = 0;
    for (int t = 0; t < a.nd; ++t)
      over |= bound[t + 1] - bound[t] > a.C;
    *a.ovf = over;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long slots = static_cast<long long>(a.nd) * a.C;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  for (long long j = first; j < slots; j += stride) {
    const int t = static_cast<int>(j / a.C);
    const int c = static_cast<int>(j - static_cast<long long>(t) * a.C);
    int64_t key = kKSent, s1 = 0;
    if (c < bound[t + 1] - bound[t]) {
      key = a.keys[bound[t] + c];
      long long row = (key & mask) - a.base;
      row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
      s1 = a.s1[row];
    }
    int64_t* out = a.send + 2LL * t * a.C + c;
    out[0] = key;
    out[a.C] = s1;
  }
  for (long long j = first; j <= a.NL; j += stride) a.pair[j] = 0;
}

struct FinishArgs {
  const int64_t* table;     // [2, A] summed over the ranks
  const int64_t* n_out;     // scalar
  const int64_t* send;      // [nd, 2, C] this rank's send plane
  const int32_t* reply;     // [nd * C] the arc rows returned to the slots
  int A, nd, C, NL, jb;
  long long base;
  int64_t* arc_vw;          // [A]
  int32_t* arc_s1;          // [A]
  int32_t* pair;            // [NL + 1], zeroed by exchange_pack
};

__global__ void __launch_bounds__(kThreads)
exchange_finish_kernel(FinishArgs a) {
  const long long n_out = *a.n_out;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long p = first; p < a.A; p += stride) {
    const bool live = p < n_out;
    a.arc_vw[p] = live ? a.table[p] : kSent;
    a.arc_s1[p] = live ? static_cast<int32_t>(a.table[a.A + p]) : 0;
  }
  const long long slots = static_cast<long long>(a.nd) * a.C;
  const int64_t mask = (int64_t(1) << a.jb) - 1;
  for (long long j = first; j < slots; j += stride) {
    const int t = static_cast<int>(j / a.C);
    const int c = static_cast<int>(j - static_cast<long long>(t) * a.C);
    const int64_t key = a.send[2LL * t * a.C + c];
    if (key == kKSent) continue;
    long long row = (key & mask) - a.base;
    row = row < 0 ? 0 : (row > a.NL - 1 ? a.NL - 1 : row);
    a.pair[row] = a.reply[j];
  }
}

}  // namespace

// The send plane of NL sorted lean keys (int64, KSENT at the end) and
// their rows' s1 (int32 [NL], by local row) for nd destinations of C
// slots on `stream`: send int64 [nd, 2, C] (keys, s1), ovf int64 scalar,
// pair int32 [NL + 1] zeroed. dest = clip((key >> shift) * nd // two_s, 0,
// nd - 1); a key's origin row is (key & (2^jb - 1)) - base. Returns
// cudaGetLastError(), or cudaErrorInvalidValue on a bad shape.
extern "C" int pg_exchange_pack(const void* keys, const void* s1, int NL,
                                int nd, int C, int jb, int shift,
                                long long two_s, long long base, void* send,
                                void* ovf, void* pair, void* stream) {
  if (NL < 1 || nd < 1 || C < 1 || two_s < 1 || jb < 1 || jb > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  a.keys = static_cast<const int64_t*>(keys);
  a.s1 = static_cast<const int32_t*>(s1);
  a.NL = NL;
  a.nd = nd;
  a.C = C;
  a.jb = jb;
  a.shift = shift;
  a.two_s = two_s;
  a.base = base;
  a.send = static_cast<int64_t*>(send);
  a.ovf = static_cast<int64_t*>(ovf);
  a.pair = static_cast<int32_t*>(pair);
  const long long n = static_cast<long long>(nd) * C;
  const int grid = grid_of(n > NL + 1LL ? n : NL + 1LL);
  exchange_pack_kernel<<<grid, kThreads, (nd + 1) * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The arc table and the pair slots on `stream`: table int64 [2, A] (summed
// over the ranks), n_out int64 scalar, this rank's send int64 [nd, 2, C],
// the returned reply int32 [nd * C]. Writes arc_vw int64 [A], arc_s1 int32
// [A] and pair int32 [NL + 1] at the origin rows of the keys sent (zeroed
// before by pg_exchange_pack). Returns cudaGetLastError(), or
// cudaErrorInvalidValue on a bad shape.
extern "C" int pg_exchange_finish(const void* table, const void* n_out,
                                  const void* send, const void* reply, int A,
                                  int nd, int C, int NL, int jb,
                                  long long base, void* arc_vw, void* arc_s1,
                                  void* pair, void* stream) {
  if (A < 1 || nd < 1 || C < 1 || NL < 1 || jb < 1 || jb > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs a;
  a.table = static_cast<const int64_t*>(table);
  a.n_out = static_cast<const int64_t*>(n_out);
  a.send = static_cast<const int64_t*>(send);
  a.reply = static_cast<const int32_t*>(reply);
  a.A = A;
  a.nd = nd;
  a.C = C;
  a.NL = NL;
  a.jb = jb;
  a.base = base;
  a.arc_vw = static_cast<int64_t*>(arc_vw);
  a.arc_s1 = static_cast<int32_t*>(arc_s1);
  a.pair = static_cast<int32_t*>(pair);
  const long long n = static_cast<long long>(nd) * C;
  exchange_finish_kernel<<<grid_of(n > A ? n : A), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
"""


class FirstForm:
    """The first form's two kernels through their C entries."""

    def __init__(self, so):
        lib = ctypes.CDLL(so)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pg_exchange_pack.restype = i
        lib.pg_exchange_pack.argtypes = [vp] * 2 + [i] * 5 + [ll] * 2 + \
            [vp] * 4
        lib.pg_exchange_finish.restype = i
        lib.pg_exchange_finish.argtypes = [vp] * 4 + [i] * 5 + [ll] + [vp] * 4
        self.lib = lib

    def pack(self, keys, s1, nd, cap, jb, shift, two_s, rank):
        import torch
        NL = keys.shape[0]
        send = torch.empty((nd, 2, cap), dtype=torch.int64,
                           device=keys.device)
        ovf = torch.empty((), dtype=torch.int64, device=keys.device)
        pair = torch.empty(NL + 1, dtype=torch.int32, device=keys.device)
        args = [keys.data_ptr(), s1.data_ptr(), NL, nd, cap, jb, shift,
                two_s, rank * NL, send.data_ptr(), ovf.data_ptr(),
                pair.data_ptr()]
        outs = (send, ovf, pair)
        return launcher(self.lib.pg_exchange_pack, args,
                        (keys, s1) + outs), outs

    def finish(self, table, n_out, send, reply, pair, bounds, jb, rank):
        import torch
        A = table.shape[1]
        nd, _, C = send.shape
        NL = pair.shape[0] - 1
        arc_vw = torch.empty(A, dtype=torch.int64, device=table.device)
        arc_s1 = torch.empty(A, dtype=torch.int32, device=table.device)
        args = [table.data_ptr(), n_out.data_ptr(), send.data_ptr(),
                reply.data_ptr(), A, nd, C, NL, jb, rank * NL,
                arc_vw.data_ptr(), arc_s1.data_ptr(), pair.data_ptr()]
        return (launcher(self.lib.pg_exchange_finish, args,
                         (table, n_out, send, reply, pair, arc_vw, arc_s1)),
                (arc_vw, arc_s1, pair[:NL]))


class Change:
    """This checkout's kernels (or a variant's) through their C entries,
    pack through one scratch."""

    def __init__(self, so, nd, device):
        import torch
        from pangene_tpu_torch.ops import mesh_kernels as mk
        self.lib = mk.load(so)
        n = self.lib.pg_exchange_scratch(nd)
        self.scratch = torch.zeros(n // 8, dtype=torch.int64, device=device)

    def pack(self, keys, s1, nd, cap, jb, shift, two_s, rank):
        import torch
        NL = keys.shape[0]
        dev = keys.device
        send = torch.empty((nd, 2, cap), dtype=torch.int64, device=dev)
        ovf = torch.empty((), dtype=torch.int64, device=dev)
        pair = torch.empty(NL + 1, dtype=torch.int32, device=dev)
        bounds = torch.empty(nd + 1, dtype=torch.int32, device=dev)
        args = [keys.data_ptr(), s1.data_ptr(), NL, nd, cap, jb, shift,
                two_s, rank * NL, send.data_ptr(), ovf.data_ptr(),
                pair.data_ptr(), bounds.data_ptr(), self.scratch.data_ptr()]
        outs = (send, ovf, pair, bounds)
        return (launcher(self.lib.pg_exchange_pack, args,
                         (keys, s1, self.scratch) + outs), outs)

    def finish(self, table, n_out, send, reply, pair, bounds, jb, rank):
        import torch
        A = table.shape[1]
        nd, _, C = send.shape
        NL = pair.shape[0] - 1
        arc_vw = torch.empty(A, dtype=torch.int64, device=table.device)
        arc_s1 = torch.empty(A, dtype=torch.int32, device=table.device)
        args = [table.data_ptr(), n_out.data_ptr(), send.data_ptr(),
                reply.data_ptr(), bounds.data_ptr(), A, nd, C, NL, jb,
                rank * NL, arc_vw.data_ptr(), arc_s1.data_ptr(),
                pair.data_ptr()]
        return (launcher(self.lib.pg_exchange_finish, args,
                         (table, n_out, send, reply, pair, bounds, arc_vw,
                          arc_s1)),
                (arc_vw, arc_s1, pair[:NL]))


def launcher(fn, args, tensors):
    """A launch of `fn` on the current stream; it holds `tensors`, the
    memory behind the pointers in `args`."""
    import torch

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("exchange kernel launch: CUDA error %d" % err)
    launch.tensors = tensors
    return launch


def first_form_bound_bytes(name, args, got):
    """The first form's bound count: finish charged every slot's key."""
    from pangene_tpu_torch.ops.loop_kernels import KSENT_I
    if name == "pack":
        send = got[0]
        nd, _, C = send.shape
        n_sent = int((send[:, 0] != KSENT_I).sum())
        return n_sent * 12 + nd * 2 * C * 8 + 8 + (args[0].shape[0] + 1) * 4
    table, n_out, send = args[:3]
    A = table.shape[1]
    n_sent = int((send[:, 0] != KSENT_I).sum())
    return (min(int(n_out), A) * 16 + 8 + send[:, 0].numel() * 8
            + n_sent * 8 + A * 12)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="big,northstar")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=PATH: another csrc/mesh_round.cu of this "
                    "interface (pg_exchange_scratch), built and timed beside")
    a = ap.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    from pangene_tpu_torch.ops import mesh_kernels as mk
    from pangene_tpu_torch.testing import exchange_calls
    smi = card_line()
    print("card: " + smi, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    cs = chip_smoke("chip_smoke_exchange")
    out_root = os.path.join(ROOT, "build", "exchange_compare")
    src = os.path.join(ROOT, "pangene_tpu_torch", "csrc", "mesh_round.cu")
    variants = [v for v in a.variants.split(",") if v]
    also = dict(x.split("=", 1) for x in a.also)
    sources = {"first": write_source(out_root, "first", "mesh_first.cu",
                                     FIRST_FORM), "change": src}
    sources.update((name, os.path.abspath(path))
                   for name, path in also.items())
    sources.update(write_variants(
        src, {name: VARIANTS[name][2] for name in variants}, out_root))
    sos = build_all(sources, out_root, "exchange")
    result = {"card": smi, "shapes": {}}
    for shape_name in a.shapes.split(","):
        shape = SHAPES[shape_name]
        meta, calls = exchange_calls("ordinary", SEED, dev, nd=4, **shape)
        nd = meta["nd"]
        kits = {"first": FirstForm(sos["first"])}
        for name in ["change"] + list(also) + variants:
            kits[name] = Change(sos[name], nd, dev)
        rec = result["shapes"][shape_name] = dict(
            meta, n_sent=cs.exchange_sent(calls[0]["finish"][0][5],
                                          meta["C"]),
            launch=mk.launch_shape(meta["NL"], nd, meta["C"], meta["A"]))
        for kname in ("pack", "finish"):
            args, kw = calls[0][kname]
            want = getattr(mk, "exchange_%s_plain" % kname)(
                *cs.fresh_args(kname, args), **kw)
            launches = {}
            for who, kit in kits.items():
                if who in VARIANTS and VARIANTS[who][0] != kname:
                    continue
                if kname == "pack":
                    launch, outs = kit.pack(*args, **kw)
                else:
                    launch, outs = kit.finish(*cs.fresh_args(kname, args),
                                              **kw)
                launch()
                torch.cuda.synchronize()
                exact = who not in VARIANTS or VARIANTS[who][1]
                for k, (x, y) in enumerate(zip(outs, want)):
                    if exact and (x.dtype != y.dtype
                                  or not torch.equal(x, y)):
                        raise AssertionError("%s %s %s != plain: output %d"
                                             % (who, shape_name, kname, k))
                launches[who] = launch
            ms = turns(cs, launches, 2)
            got = mk.exchange_pack(*args, **kw) if kname == "pack" else None
            nbytes = cs.exchange_bound_bytes(kname, args, kw, got)
            old = first_form_bound_bytes(kname, args, got)
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            rec[kname] = dict(ms=ms, bound_ms=bound, bytes=nbytes,
                              first_form_bound_ms=old / cs.HBM_BYTES_PER_S
                              * 1e3, first_form_bytes=old)
            print("%s exchange_%s (NL %d, C %d, A %d, %d keys sent): %s ms; "
                  "bound %.6f ms (%d bytes; the first form's count %.6f, "
                  "%d bytes); each exact build == plain" % (
                      shape_name, kname, meta["NL"], meta["C"], meta["A"],
                      rec["n_sent"], json.dumps(ms), bound, nbytes,
                      old / cs.HBM_BYTES_PER_S * 1e3, old), flush=True)
        for kit in kits.values():
            if isinstance(kit, Change) and kit.scratch.any():
                raise AssertionError("a pack left its scratch dirty")
    print("EXCHANGE=" + json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
