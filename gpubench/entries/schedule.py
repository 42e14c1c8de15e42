"""Entry `schedule`: the device-resident pruning schedule (phases 2+3 of
pg_graph_gen) of pangene_tpu_torch, as one repetition of the window.

Set-up runs the port's own pipeline up to the schedule's inputs:
pipeline.read_all, graph.post.post_process, phase 1 as graph.build.graph_gen
runs it before the loop (the pseudo filter, gen_vtx, flag_vtx, the vertex
filter, ops.arcs.gen_arc_loop), then parallel.device_loop.pack_host into
pinned memory. One repetition is what graph_gen_device does between its pack
and its apply (parallel/device_loop.py, graph_gen_device): upload the packed
blocks (the first five with mesh.put_sharded, the next six with
non_blocking copies), schedule_device(..., stats=), read the overflow flag,
the selective pull of the 20 outputs, a synchronise. The packed inputs are
not changed by a schedule, so every repetition does the same work."""
from __future__ import annotations

import numpy as np


class Entry:
    # the schedule's outputs, for the comparison (first four: hit planes)
    N_OUT = 20

    def __init__(self, opt, files, run):
        import torch
        from pangene_tpu_torch import pipeline
        from pangene_tpu_torch.graph import build
        from pangene_tpu_torch.graph.graphdata import Graph
        from pangene_tpu_torch.graph.post import post_process
        from pangene_tpu_torch.graph.vertex import gen_vtx
        from pangene_tpu_torch.ops import arcs
        from pangene_tpu_torch.parallel import device_loop as dl
        from pangene_tpu_torch.parallel import mesh as M
        self.torch, self.dl, self.M = torch, dl, M
        with run.span("parse"):
            d = pipeline.read_all(opt, files)
        with run.span("post"):
            post_process(opt, d)
        with run.span("phase1"):
            q = Graph(d)
            build.set_filter(d, "pseudo", 1)
            gen_vtx(opt, q)
            q.flag_vtx()
            build.set_filter_eq0(d, "vtx")
            arcs.gen_arc_loop(opt, q)
        self.mesh = M.make_mesh(opt.n_devices, opt.device)
        self.device = self.mesh.device
        self.cuda = self.device.type == "cuda"
        with run.span("pack"):
            pk = dl.pack_host(opt, q, pin=self.cuda)
        if isinstance(pk, str):
            raise RuntimeError("the device loop cannot take this graph: "
                               + pk)
        self.pk = pk
        run.shape = dict(pk.cfg._asdict(), G=d.n_genome,
                         kept_rows=int(sum(len(k) for k in pk.kept_idx)))

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def once(self, run, stats=None):
        """One schedule, upload to pull; returns the 20 host arrays."""
        torch, dl, M, pk = self.torch, self.dl, self.M, self.pk
        N = dl.N_DEVICE_INPUTS
        with run.span("upload"):
            on_dev = [M.put_sharded(a, self.mesh, 1) for a in pk.inputs[:5]] \
                + [torch.from_numpy(a).to(self.device, non_blocking=True)
                   for a in pk.inputs[5:N]]
            self._sync()
        with run.span("run"):
            outs = dl.schedule_device(*on_dev, *pk.inputs[N:-1],
                                      bool(pk.inputs[-1]), cfg=pk.cfg,
                                      stats=stats, mesh=self.mesh)
            bool(outs[-1].item())
        with run.span("pull"):
            host = [M.pull_global(o, self.mesh) if i < 4
                    else o.cpu().numpy() if not 15 <= i < 19
                    else np.zeros((0,) + tuple(o.shape[1:]), np.int32)
                    for i, o in enumerate(outs)]
            self._sync()
        return host

    def close(self):
        self.pk = None


# the comparison that decides `correct`: every number must be 0
CHECKS = ("hit_mismatch", "seg_mismatch", "arc_mismatch", "overflow")


def reference(cfg: dict, seed: int):
    from ..reference import answer
    return answer.loop(cfg, seed)


def compare(outs, ans) -> dict:
    from ..reference import compare as cmp
    return cmp.compare_loop(outs, ans)
