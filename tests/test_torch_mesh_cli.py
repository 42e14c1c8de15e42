"""The port's CLI on the genome mesh, end to end on the CPU: `--device cpu
--engine sharded --devices N`, its ranks processes of their own joined by
gloo, against the JAX package's --engine sharded on N virtual devices, byte
for byte. Each rank reports what it built (testing.rank_report_main): every
rank's GFA md5 must be the JAX package's, the path must be the one claimed
(the loop engaged, or the per-round path's 17 rounds), the loop's shape the
JAX loop's, and no rank may load jax or pangene_tpu. Every launch has a
timeout of its own (testing.run_ranks).
"""
import hashlib
import io
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu.parallel import device_loop as jdl
from pangene_tpu_torch import cli, util
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.testing import (run_ranks, synth_paf_files,
                                       wide_paf_files)

REPO = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus shape of tests/test_distributed.py."""
    d = tmp_path_factory.mktemp("torch_mesh_cli")
    return synth_paf_files(str(d), n_genome=8, n_gene=120, n_iso=2, seed=9)


@pytest.fixture(scope="module")
def few(tmp_path_factory):
    """Fewer genomes than ranks: one rank holds padding alone."""
    d = tmp_path_factory.mktemp("torch_mesh_few")
    return synth_paf_files(str(d), n_genome=3, n_gene=120, n_iso=2, seed=5)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """Branch groups of 80 arcs in the loop's branch rounds."""
    return wide_paf_files(str(tmp_path_factory.mktemp("torch_mesh_wide")))


_jax = {}


def jax_sharded(files, nd):
    """The JAX package's --engine sharded GFA on nd virtual devices, and its
    device loop's LAST."""
    key = (tuple(files), nd)
    if key not in _jax:
        jutil.verbose = 0
        out = io.StringIO()
        try:
            jpipeline.run(JaxOpt(engine="sharded", n_devices=nd), files,
                          out=out)
        finally:
            jutil.verbose = 3
        _jax[key] = (out.getvalue(), dict(jdl.LAST))
    return _jax[key]


def port_shape(jlast):
    """The JAX loop's shape less its branch window D, which the port's
    loop does not have."""
    return {k: v for k, v in jlast["shape"].items() if k != "D"}


def md5(text):
    return hashlib.md5(text.encode()).hexdigest()


def ranks(world, files, **env):
    e = dict(os.environ, OMP_NUM_THREADS="1", PANGENE_PARSE_WORKERS="1",
             **env)
    return run_ranks(world, ["--device", "cpu", "--engine", "sharded",
                             "--devices", str(world), "-v", "1"] + files,
                     env=e, cwd=str(REPO))


@pytest.mark.parametrize("world,loop", [(2, "1"), (4, "1"), (2, "0")],
                         ids=["2", "4", "2-per-round"])
def test_cli_mesh_equals_jax(corpus, world, loop):
    gfa, jlast = jax_sharded(corpus, world)
    reports = ranks(world, corpus, PANGENE_DEVICE_LOOP=loop)
    assert [r["rank"] for r in reports] == list(range(world))
    for rep in reports:
        assert rep["md5"] == md5(gfa)
        assert rep["foreign_modules"] == []
        assert rep["plain_calls"] > 0 and rep["kernel_launches"] == 0
        assert rep["mesh"]["calls"].get("psum", 0) > 0
        if loop == "1":
            last = rep["LAST"]
            assert last["engaged"] is True and rep["rounds_LAST"] == {}
            assert last["shape"] == port_shape(jlast)
            assert last["shard_merge"] == jlast["shard_merge"] == (world > 2)
            assert last["collective_calls"] > 0
        else:
            assert rep["LAST"] == {}
            assert rep["rounds_LAST"]["rounds"] == 17
            assert rep["rounds_LAST"]["shape"]["n_devices"] == world
            assert rep["rounds_LAST"]["const_uploads"] == 1


def test_cli_mesh_fewer_genomes_than_ranks(few):
    gfa, jlast = jax_sharded(few, 4)
    reports = ranks(4, few)
    assert jlast["shape"]["Gp"] == 4
    for rep in reports:
        assert rep["md5"] == md5(gfa)
        assert rep["LAST"]["engaged"] is True
        assert rep["LAST"]["shape"] == port_shape(jlast)


def test_cli_mesh_wide_group(wide):
    """Two ranks on a corpus whose branch rounds meet a group of 80 arcs
    (the JAX package's loop falls back there, its window being 64): the
    split branch entries take it on the wide path at every rank, the loop
    stays engaged and every rank's bytes are the JAX package's."""
    gfa, jlast = jax_sharded(wide, 2)
    assert jlast["engaged"] is False
    for rep in ranks(2, wide):
        assert rep["md5"] == md5(gfa)
        last = rep["LAST"]
        assert last["engaged"] is True
        assert last["branch_max_group"] == 80 > lk.WIDE_ROWS
        assert last["branch_wide_groups"] >= 1


def test_only_rank_0_writes(corpus, tmp_path):
    """--save-hits and --profile at two ranks: rank 0 writes the checkpoint
    and the trace, rank 1 says it is not traced; the checkpoint resumes to
    the same GFA."""
    hits, prof = tmp_path / "hits.npz", tmp_path / "prof"
    reports = run_ranks(2, ["--device", "cpu", "--devices", "2", "-v", "3",
                            "--save-hits", str(hits), "--profile", str(prof)]
                        + corpus, env=dict(os.environ, OMP_NUM_THREADS="1",
                                           PANGENE_PARSE_WORKERS="1"),
                        cwd=str(REPO))
    gfa = jax_sharded(corpus, 2)[0]
    assert [r["md5"] for r in reports] == [md5(gfa)] * 2
    assert "tracing rank 0 only" in reports[0]["stderr"]
    assert "rank 1 not traced" in reports[1]["stderr"]
    assert "saved post-ingest tensors" in reports[0]["stderr"]
    assert "saved post-ingest tensors" not in reports[1]["stderr"]
    assert (prof / "pangene_trace.json").stat().st_size > 0
    again = ranks(2, ["--load-hits", str(hits)])
    assert [r["md5"] for r in again] == [md5(gfa)] * 2


def test_cli_one_device_makes_no_collective(corpus, capsys):
    """--devices 1 (and 0) without a launch: no process group, no
    collective call, the one-device loop."""
    mesh.reset_counts()
    for n in ("1", "0"):
        capsys.readouterr()
        cli.main(["--device", "cpu", "--devices", n, "-v", "0"] + corpus)
        assert capsys.readouterr().out == jax_sharded(corpus, 1)[0]
        assert dl.LAST["engaged"] is True
        assert dl.LAST["shape"]["n_devices"] == 1
        assert dl.LAST["collective_calls"] == 0
    assert mesh.LAST["calls"] == {} and mesh.LAST["staged_bytes"] == 0
    assert not torch.distributed.is_initialized()
    util.verbose = 3


def test_cli_starts_its_ranks(corpus):
    """--devices 2 without a launcher: the CLI starts two ranks of itself;
    rank 0 writes the GFA to the CLI's stdout, each rank logs its place in
    the mesh."""
    r = subprocess.run(
        [sys.executable, "-m", "pangene_tpu_torch.cli", "--device", "cpu",
         "--devices", "2", "-v", "3"] + corpus, cwd=str(REPO),
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == jax_sharded(corpus, 2)[0]
    assert "rank 0 of 2 on cpu (gloo)" in r.stderr
    assert "rank 1 of 2 on cpu (gloo)" in r.stderr


def test_cli_failing_ranks_fail_the_run(tmp_path):
    """Ranks that raise end the CLI's run with a nonzero code and no
    output."""
    r = subprocess.run(
        [sys.executable, "-m", "pangene_tpu_torch.cli", "--device", "cpu",
         "--devices", "2", "-v", "0", "--load-hits",
         str(tmp_path / "missing.npz")], cwd=str(REPO),
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode != 0 and r.stdout == ""
    assert "ranks exited" in r.stderr and "missing.npz" in r.stderr


def test_devices_flag(corpus, monkeypatch, capsys):
    assert cli.parse_args(["x.paf"])[0].n_devices == 0
    assert cli.parse_args(["--devices", "3", "x.paf"])[0].n_devices == 3
    # the host engines and --engine device do not read it: no ranks start

    def no_launch(*a, **kw):
        raise AssertionError("a launch under a host engine")

    monkeypatch.setattr(mesh, "launch", no_launch)
    cli.main(["--engine", "host", "--devices", "4", "-v", "0"] + corpus)
    assert capsys.readouterr().out == jax_sharded(corpus, 1)[0]
    util.verbose = 3
