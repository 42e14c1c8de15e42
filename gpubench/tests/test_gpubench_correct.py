"""The correctness check on the CPU at a tiny size: the port's schedule
(its plain PyTorch versions) equals the reference; the check fails on the
control and on each fault the cell can have; nothing of the program or of
JAX reaches the reference."""
import ast
import copy
import os
import sys

import numpy as np
import pytest

from gpubench import control, run as R
from gpubench.harness import Run
from gpubench.inputs import synth

TINY = {"human100.loop": dict(n_genome=10, n_gene=300),
        "ecoli50.loop": dict(n_genome=12, n_gene=900, n_core=200,
                             per_genome=300),
        "human2.loop": dict(n_gene=600)}


def cell_of(name, **draw):
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = copy.deepcopy(R.load_json(R.HERE, "configs",
                                    cell["config"] + ".json"))
    cfg["draw"].update(TINY[name], **draw)
    traffic = R.load_json(R.HERE, "traffic", cell["traffic"] + ".json")
    return bench, cell, cfg, traffic


def run_tiny(tmp_path, name, seed, wrap=None, trace=False, **draw):
    bench, cell, cfg, traffic = cell_of(name, **draw)
    traffic = dict(traffic, warm_reps=1, trace_reps=2)
    files = synth.write_corpus(synth.shape_of(cfg), seed,
                               str(tmp_path / "paf"))
    return R.run_cell(bench, cell, cfg, traffic, seed, 0.8, trace, files,
                      Run(), device="cpu", wrap=wrap, tmp=str(tmp_path))


@pytest.mark.parametrize("name,seed", [
    ("human100.loop", 2**31 + 3), ("human100.loop", 17),
    ("ecoli50.loop", 2**32 + 5), ("human2.loop", 2**31 + 77)])
def test_port_equals_reference(tmp_path, name, seed):
    res = run_tiny(tmp_path, name, seed)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["info"]["compared"] >= 2
    assert list(res)[-1] == "checks"


def test_traced_run_reports_per_layer(tmp_path):
    res = run_tiny(tmp_path, "human100.loop", 41, trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert m["host_syncs.loop"]["value"] > 0
    assert m["parse_s"]["value"] > 0 and m["pack_s"]["value"] > 0
    assert "schedule_ms" not in m
    assert res["device"]["window_s"] > 0


class Faulty:
    """The entry with its outputs (or inputs) broken underneath."""

    def __init__(self, entry, fault):
        self.e, self.fault = entry, fault

    def __getattr__(self, k):
        return getattr(self.e, k)

    def once(self, run, stats=None):
        e = self.e
        if self.fault == "half":
            # half of the genomes left out: their rows invalid on entry
            pk = e.pk
            saved = pk.inputs[3].copy()
            G = pk.inputs[3].shape[1]
            from pangene_tpu_torch.parallel.device_loop import PACK_U8
            pk.inputs[3][PACK_U8.index("valid"), G // 2:] = 0
            try:
                return e.once(run, stats)
            finally:
                pk.inputs[3][...] = saved
        outs = e.once(run, stats)
        outs = [np.array(o) for o in outs]
        if self.fault == "unchanged":
            # the state handed back as it came in: the entry planes and
            # phase 1's arc table
            from pangene_tpu_torch.parallel.device_loop import (PACK_I32,
                                                                PACK_U8)
            i32, u8 = e.pk.inputs[0], e.pk.inputs[3]
            outs[0] = u8[PACK_U8.index("flt")].copy()
            outs[1] = u8[PACK_U8.index("weak_br")].copy()
            outs[2] = u8[PACK_U8.index("shadow")].copy()
            outs[3] = i32[PACK_I32.index("pid_dom")].copy()
            outs[4] = np.ones_like(outs[4])
            outs[7] = np.array(e.pk.inputs[7])
            outs[8] = np.array(e.pk.inputs[8])
        elif self.fault == "altered":
            j = int(np.flatnonzero(outs[8] > 0)[0])
            outs[8][j] += 1          # one arc's score
        return outs


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(tmp_path, fault):
    res = run_tiny(tmp_path, "human100.loop", 2**31 + 9,
                   wrap=lambda e: Faulty(e, fault))
    assert not res["correct"]
    assert sum(c["value"] for c in res["checks"].values()) > 0


@pytest.mark.parametrize("name", ["human100.loop", "ecoli50.loop",
                                  "human2.loop"])
def test_control_is_not_correct(name):
    _, _, cfg, _ = cell_of(name, n_genome=16, n_gene=600)
    got = control.control(cfg, 2**31 + 1)
    assert got["arc_mismatch"] + got["hit_mismatch"] + got["seg_mismatch"] > 0


def test_forbidden_modules_by_whole_name(monkeypatch):
    for k in [k for k in sys.modules
              if k.split(".")[0] in R.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "pangene_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pangene_tpu.ops.fake", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert R.forbidden_modules() == ["jax", "pangene_tpu"]


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for sub in ("reference", "inputs"):
        d = os.path.join(R.HERE, sub)
        for fn in os.listdir(d):
            if fn.endswith(".py"):
                mods = set(imports_of(os.path.join(d, fn)))
                assert not mods & {"pangene_tpu_torch", "pangene_tpu", "jax",
                                   "jaxlib", "flax", "torch"}, fn


def test_harness_imports_no_jax():
    for root, _, fns in os.walk(R.HERE):
        for fn in fns:
            if fn.endswith(".py"):
                mods = set(imports_of(os.path.join(root, fn)))
                assert not mods & {"pangene_tpu", "jax", "jaxlib", "flax"}, fn
