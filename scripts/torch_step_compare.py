#!/usr/bin/env python3
"""Two checkouts of the PyTorch / CUDA port on one card, in turns: the
device loop's warm block_ms and run_s on chip_smoke.py's big and
north-star corpora, and the per-round path's (PANGENE_DEVICE_LOOP=0)
step_s and block_ms on big. Run from the root of a checkout (the corpora
are drawn as chip_smoke.py draws them, or taken from its cache,
build/chip_smoke/):

    python3 scripts/torch_step_compare.py --parent archive_check/parent

(unpack the parent there with `git archive <commit> | tar -x -C
archive_check/parent`). The turns are parent, change, change, parent, each
a process of its own that imports its checkout's package only; in a turn
every path runs twice on the card and the second (warm) run is kept. Each
run's GFA md5 must be the corpus's. Prints the card, one JSON line a turn
and, last, the per-checkout best of each number.

With --kernels it compares the two checkouts' step kernels instead, in one
process on the same captured arguments:

    python3 scripts/torch_step_compare.py --parent archive_check/parent \
        --kernels

Each checkout's csrc/step_round.cu is built by nvcc into a build directory
of its own (build/step_compare/parent/, build/step_compare/change/) and
called through its C entries (the tiled form's, or the one-block-a-genome
form's before it). The arguments are those of the per-round step
(PANGENE_DEVICE_LOOP=0) on the final state of big's and the north star's
runs (chip_smoke.step_stack, the inputs step_on_stack hands the kernels)
and of big's first 16 genomes, a mesh rank's shard (STACKS). step_walk and
step_dedupe of the two take turns, parent, change, change, parent, each
the device time of 200 launches in one CUDA graph; both must equal the
plain versions. Beside them this checkout's variants (VARIANTS: textual
substitutions of its source, each built into build/step_compare/<name>/):
the walk with its gene counters cut, the 1,024-position tile as 128
threads x 8 positions or 512 x 2, and launch bounds asking ptxas for
other resident blocks a SM (the walk 1 or 8, the dedupe 6). Prints the card, each build's
registers, a line a stack and kernel, and last KERNELS=<json>.
"""
import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (corpus, path, environment) of a turn, in order
RUNS = (("big", "loop", {}), ("big", "rounds", {"PANGENE_DEVICE_LOOP": "0"}),
        ("northstar", "loop", {}))
# the per-kernel mode's stacks: (label, corpus, the first genomes or all)
STACKS = (("big", "big", None), ("northstar", "northstar", None),
          ("big_shard16", "big", 16))
# the per-kernel mode's variants of this checkout's step_round.cu: name ->
# (the kernels it is timed for, substitutions (old, new): every occurrence
# of old, at least one)
VARIANTS = {
    "no_counters": (("step_walk",), (
        ("if (kept[q] && lane == __ffs(peers) - 1) {", "if (false) {"),)),
    "threads128": (("step_walk", "step_dedupe"), (
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
        ("constexpr int kRows = 4;", "constexpr int kRows = 8;"))),
    "threads512": (("step_walk", "step_dedupe"), (
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
        ("constexpr int kRows = 4;", "constexpr int kRows = 2;"))),
    "walk_blocks1": (("step_walk",), (
        ("constexpr int kWalkBlocks = 6;", "constexpr int kWalkBlocks = 1;"),)),
    "walk_blocks8": (("step_walk",), (
        ("constexpr int kWalkBlocks = 6;", "constexpr int kWalkBlocks = 8;"),)),
    "dedupe_blocks6": (("step_dedupe",), (
        ("constexpr int kDedupeBlocks = 1;",
         "constexpr int kDedupeBlocks = 6;"),)),
}


def chip_smoke():
    """This checkout's chip_smoke.py (its corpora), whatever the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_corpora", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root):
    """One turn: the RUNS of the checkout at `root`, twice each; prints
    one JSON line."""
    sys.path.insert(0, root)
    import torch
    from pangene_tpu_torch import cli
    from pangene_tpu_torch.parallel import device_loop as dl
    from pangene_tpu_torch.parallel import stacked as st
    cs = chip_smoke()
    out = {"root": root, "runs": {}}
    for name, path, env in RUNS:
        files, _, _ = cs.make_corpus(name, None)
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        for rep in range(2):
            md5 = hashlib.md5()

            class Sink:
                def write(self, text):
                    md5.update(text.encode())
                    return len(text)

                def flush(self):
                    pass
            dl.LAST.clear()
            st.LAST.clear()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(Sink()):
                cli.main(["--engine", "sharded", "-v", "0"] + files)
            wall = time.monotonic() - t0
            if md5.hexdigest() != cs.CORPORA[name].md5:
                raise AssertionError("%s %s: md5 %s" % (name, path,
                                                         md5.hexdigest()))
        for k, v in env.items():
            old_v = old[k]
            if old_v is None:
                del os.environ[k]
            else:
                os.environ[k] = old_v
        if path == "loop":
            last = dl.LAST
            if last.get("engaged") is not True:
                raise AssertionError("%s: the loop did not engage" % name)
            rec = {k: last[k] for k in ("run_s", "host_syncs", "block_ms",
                                        "rounds_total", "sweep_launches")}
        else:
            rec = {k: st.LAST[k] for k in ("rounds", "step_s", "pull_s",
                                           "block_ms", "sweep_launches")}
            rec["step_s_a_round"] = st.LAST["step_s"] / st.LAST["rounds"]
        rec["wall_s"] = round(wall, 3)
        out["runs"]["%s_%s" % (name, path)] = rec
    print("TURN=" + json.dumps(out))


class StepLib:
    """One checkout's step kernels through their C entries, built from its
    source into `out_dir`: the tiled form (pg_step_shape: the walk's
    scratch after its counts in one buffer, a scratch for the dedupe) or
    the one-block-a-genome form before it (the seen bits in a global
    scratch only past shared memory; no dedupe scratch)."""

    def __init__(self, src, out_dir):
        from pangene_tpu_torch.ops.sweep_kernel import nvcc_command
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, "libstep_round.so")
        r = subprocess.run(nvcc_command(src, so), capture_output=True,
                           text=True)
        if r.returncode:
            raise SystemExit("nvcc %s: %s" % (src, r.stderr[-3000:]))
        # ptxas: each kernel's registers, spills and shared memory
        self.ptxas = [ln.strip() for ln in r.stderr.splitlines()
                      if "Compiling entry" in ln or "Used" in ln
                      or "spill" in ln]
        lib = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.tiled = hasattr(lib, "pg_step_shape")
        lib.pg_step_walk.restype = i
        lib.pg_step_walk.argtypes = [vp] * 12 + [i] * 4 + [vp] * 8
        lib.pg_step_walk_scratch.restype = ctypes.c_longlong
        lib.pg_step_walk_scratch.argtypes = [i] * (3 if self.tiled else 2)
        lib.pg_step_dedupe.restype = i
        lib.pg_step_dedupe.argtypes = [vp] * 6 + [i] * 2 + [vp] * (
            7 if self.tiled else 6)
        if self.tiled:
            lib.pg_step_dedupe_scratch.restype = ctypes.c_longlong
            lib.pg_step_dedupe_scratch.argtypes = [i, i]
        self.lib = lib

    @staticmethod
    def _launcher(fn, args, tensors):
        """A launch of `fn` on the current stream; it holds `tensors`, the
        memory behind the pointers in `args`."""
        import torch

        def launch():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError("step kernel launch: CUDA error %d" % err)
        launch.tensors = tensors
        return launch

    def walk(self, cols, perm, flt, shadow, g2s, use_ori):
        """(a function that launches step_walk, its outputs)."""
        import torch
        bc = cols.batch
        G, H = flt.shape
        n = g2s.shape[0]
        new = lambda *shape, dt: torch.empty(shape, dtype=dt,
                                             device=flt.device)
        akey = new(G, 2 * H, dt=torch.int64)
        pair_ok = new(G, H, dt=torch.uint8)
        dist, s1, s2 = (new(G, H, dt=torch.int32) for _ in range(3))
        if self.tiled:
            nb = self.lib.pg_step_walk_scratch(G, H, n)
            buf = new(2 * n + nb // 4, dt=torch.int32)
            counts, scratch = buf[:2 * n].view(2, n), buf[2 * n:]
        else:
            nb = self.lib.pg_step_walk_scratch(G, n)
            counts = new(2, n, dt=torch.int32)
            scratch = new(nb, dt=torch.uint8) if nb else None
        p = lambda t: None if t is None else t.data_ptr()
        args = [p(perm), p(flt), p(shadow), p(bc.n_rows), p(bc.cid),
                p(bc.gid), p(bc.rev), p(cols.score_ori), p(cols.score_dom),
                p(cols.dom_gid), p(cols.cm), p(g2s), G, H, n, int(use_ori),
                p(akey), p(pair_ok), p(dist), p(s1), p(s2), p(counts),
                p(scratch)]
        outs = (akey, pair_ok, dist, s1, s2, counts)
        return (self._launcher(self.lib.pg_step_walk, args,
                               (cols, perm, flt, shadow, g2s, scratch)
                               + outs), outs)

    def dedupe(self, xs, aperm, pair_ok, dist, s1, s2):
        """(a function that launches step_dedupe, its outputs)."""
        import torch
        G, A = xs.shape
        H = A // 2
        new = lambda dt: torch.empty((G, A), dtype=dt, device=xs.device)
        uniq_x, dsum = new(torch.int64), new(torch.int64)
        cnt, m1, m2 = new(torch.int32), new(torch.int32), new(torch.int32)
        args = [t.data_ptr() for t in (xs, aperm, pair_ok, dist, s1, s2)]
        args += [G, H] + [t.data_ptr() for t in (uniq_x, cnt, dsum, m1, m2)]
        scratch = None
        if self.tiled:
            scratch = torch.empty(self.lib.pg_step_dedupe_scratch(G, H) // 8,
                                  dtype=torch.int64, device=xs.device)
            args.append(scratch.data_ptr())
        outs = (uniq_x, cnt, dsum, m1, m2)
        return (self._launcher(self.lib.pg_step_dedupe, args,
                               (xs, aperm, pair_ok, dist, s1, s2, scratch)
                               + outs), outs)


def kernels(parent, smi):
    """The per-kernel mode (module docstring)."""
    import torch
    sys.path.insert(0, ROOT)
    from pangene_tpu_torch.ops import step_kernels as stkk
    from pangene_tpu_torch.ops import sweep_kernel as sk
    from pangene_tpu_torch.options import PgOpt
    from pangene_tpu_torch.parallel import stacked as st
    cs = chip_smoke()
    cs.DEVICE = "cuda"
    dev = torch.device("cuda")
    src = os.path.join("pangene_tpu_torch", "csrc", "step_round.cu")
    libs = {label: StepLib(os.path.join(root, src), os.path.join(
        ROOT, "build", "step_compare", label))
        for label, root in (("parent", parent), ("change", ROOT))}
    with open(os.path.join(ROOT, src)) as fp:
        text = fp.read()
    for name, (_, subs) in VARIANTS.items():
        vtext = text
        for old, new in subs:
            if old not in vtext:
                raise SystemExit("variant %s: %r not found" % (name, old))
            vtext = vtext.replace(old, new)
        d = os.path.join(ROOT, "build", "step_compare", name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "step_round.cu"), "w") as fp:
            fp.write(vtext)
        libs[name] = StepLib(os.path.join(d, "step_round.cu"), d)
    for name, lib in libs.items():
        print("ptxas %s: %s" % (name, " | ".join(lib.ptxas)), flush=True)
    use_ori = PgOpt(device="cuda").use_ori_for_branch
    graphs = {}
    os.environ["PANGENE_DEVICE_LOOP"] = "0"
    names = sorted({c for _, c, _ in STACKS})
    draws = {name: cs.start_draw(name) for name in names}
    for name in names:
        files, _, _ = cs.make_corpus(name, draws[name])
        gfa, graphs[name] = cs.run_cli(files, "sharded")
        md5 = hashlib.md5(gfa.encode()).hexdigest()
        if md5 != cs.CORPORA[name].md5:
            raise AssertionError("%s: md5 %s" % (name, md5))
    del os.environ["PANGENE_DEVICE_LOOP"]
    out = {"card": smi, "stacks": {}}
    for label, cname, g_loc in STACKS:
        cols, flt, weak, shadow, g2s, W = cs.step_stack(
            st, graphs[cname], dev, g_loc)
        _, _, key = sk.sweep_round_step(cols.batch, flt, weak, W, False, 0.5,
                                        shadow, cols.cm)
        perm = torch.sort(key, dim=1, stable=True).indices
        wargs = (cols, perm, flt, shadow, g2s)
        walk = stkk.step_walk_plain(*wargs, use_ori=use_ori)
        xs, aperm = torch.sort(walk[0], dim=1, stable=True)
        dargs = (xs, aperm) + tuple(walk[1:5])
        plain = {"step_walk": walk,
                 "step_dedupe": stkk.step_dedupe_plain(*dargs)}
        least = cs.step_bound_bytes(cols, perm, flt, shadow, g2s, use_ori,
                                    walk[1])
        G, H = flt.shape
        rec = out["stacks"][label] = {"G": G, "H": H, "n_gene": g2s.shape[0]}
        for name in ("step_walk", "step_dedupe"):
            launches = {}
            for who, lib in libs.items():
                if who in VARIANTS and name not in VARIANTS[who][0]:
                    continue
                launch, outs = (lib.walk(*wargs, use_ori) if name ==
                                "step_walk" else lib.dedupe(*dargs))
                launch()
                torch.cuda.synchronize()
                # (the walk without counters: every output but the counts)
                n_out = 5 if who == "no_counters" else len(outs)
                for k, (a, b) in enumerate(zip(outs[:n_out], plain[name])):
                    if not torch.equal(a, b):
                        raise AssertionError("%s %s %s != plain: output %d"
                                             % (who, label, name, k))
                launches[who] = launch
            order = list(launches)
            ms = {who: [] for who in order}
            for who in order + order[::-1]:
                ms[who].append(cs.graph_ms(launches[who], cs.TIMED_LAUNCHES))
            bound = least[name] / cs.HBM_BYTES_PER_S * 1e3
            rec[name] = dict(ms, bound_ms=bound, bytes=least[name])
            print("%s %s (G %d H %d): %s ms, bound %.6f ms (bytes); each == "
                  "plain" % (label, name, G, H, json.dumps(ms), bound),
                  flush=True)
    print("KERNELS=" + json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--worker")
    ap.add_argument("--kernels", action="store_true")
    a = ap.parse_args()
    if a.worker:
        return worker(os.path.abspath(a.worker))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card: " + smi, flush=True)
    if a.kernels:
        return kernels(os.path.abspath(a.parent), smi)
    cs = chip_smoke()
    names = sorted({name for name, _, _ in RUNS})
    draws = {name: cs.start_draw(name) for name in names}
    for name in names:
        _, draw_s, _ = cs.make_corpus(name, draws[name])
        print("corpus %s: %s" % (name, "cached" if draw_s is None
                                 else "drawn in %.3f s" % draw_s), flush=True)
    parent = os.path.abspath(a.parent)
    turns = []
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", root], cwd=root, capture_output=True,
                           text=True, timeout=900)
        if r.returncode:
            raise SystemExit("%s turn exited %d: %s" % (
                label, r.returncode, r.stderr[-3000:]))
        line = [x for x in r.stdout.splitlines() if x.startswith("TURN=")]
        turn = json.loads(line[-1][len("TURN="):])
        turn["label"] = label
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    best = {}
    for turn in turns:
        b = best.setdefault(turn["label"], {})
        for key, rec in turn["runs"].items():
            for k, v in rec.items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        name = "%s.%s.%s" % (key, k, kk)
                        b[name] = min(b.get(name, vv), vv)
                elif isinstance(v, float):
                    name = "%s.%s" % (key, k)
                    b[name] = min(b.get(name, v), v)
    print("BEST=" + json.dumps(best))


if __name__ == "__main__":
    sys.exit(main())
