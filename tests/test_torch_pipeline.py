"""End to end: the port's CLI on the CPU (--device cpu) against the JAX
package, byte for byte.

The port's default engine is "sharded" (the device-resident loop); the
per-genome engine (--engine device) mirrors pangene_tpu's engine="jax".
Option sets the JAX engines share with the host engine are checked against
the faster host engine. The 16-genome synthetic corpus
is checked against the reference binary's GFA (tests/golden). A run must
not load jax or pangene_tpu, and without a CUDA device it must not start
unless the caller names the CPU.
"""
import ast
import contextlib
import gzip
import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.options import PgOpt
from pangene_tpu.testing import synth_paf_files as jax_synth
from pangene_tpu_torch import cli, util
from pangene_tpu_torch.testing import synth_paf_files

REPO = pathlib.Path(__file__).resolve().parent.parent

# small tensors: one torch thread per test process, so that several test
# workers on one machine do not contend for its cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_equiv")
    return synth_paf_files(str(d), n_genome=6, n_gene=300, n_iso=3, seed=3)


def run_port(argv, capsys):
    capsys.readouterr()
    cli.main(["--device", "cpu", "-v", "0"] + argv)
    return capsys.readouterr().out


def run_jax(files, engine, flag=0, **kw):
    jutil.verbose = 0
    out = io.StringIO()
    opt = PgOpt(engine=engine, **kw)
    opt.flag |= flag
    jpipeline.run(opt, files, out=out)
    return out.getvalue()


def test_synth_corpus_matches_jax_generator(tmp_path):
    a = synth_paf_files(str(tmp_path / "a"), n_genome=2, n_gene=40, seed=9)
    b = jax_synth(str(tmp_path / "b"), n_genome=2, n_gene=40, seed=9)
    for x, y in zip(a, b):
        assert gzip.open(x).read() == gzip.open(y).read()


@pytest.mark.parametrize("argv,kw", [([], {}),
                                     (["-f", "0.3"], {"min_ov_ratio": 0.3})])
def test_cli_vs_jax_device_engine(corpus, capsys, argv, kw):
    want = run_jax(corpus, "jax", **kw)
    assert run_port(["--engine", "device"] + argv + corpus, capsys) == want


def test_default_engine_is_sharded(corpus, capsys):
    """No --engine: the device-resident loop runs and gives the per-genome
    engine's bytes."""
    from pangene_tpu_torch.options import PgOpt as TorchOpt
    from pangene_tpu_torch.parallel import device_loop
    assert TorchOpt().engine == "sharded"
    assert cli.parse_args(["x.paf"])[0].engine == "sharded"
    device_loop.LAST.clear()
    got = run_port(corpus, capsys)
    assert device_loop.LAST["engaged"] is True
    assert got == run_port(["--engine", "device"] + corpus, capsys)


@pytest.mark.parametrize("engine", ["sharded", "device"])
def test_profile_writes_trace_and_same_gfa(corpus, capsys, tmp_path, engine):
    from pangene_tpu_torch.pipeline import TRACE_NAME
    from pangene_tpu_torch.util import trace_device_summary
    want = run_port(["--engine", engine] + corpus, capsys)
    out = tmp_path / "prof"
    got = run_port(["--engine", engine, "--profile", str(out)] + corpus,
                   capsys)
    assert got == want
    trace = out / TRACE_NAME
    assert trace.stat().st_size > 1000
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # a run on the CPU has no device event
    assert trace_device_summary(str(trace)) == {"busy_s": 0.0, "n_events": 0,
                                                "top": []}


def test_trace_device_summary(tmp_path):
    """Busy time is the union of the device intervals; operations rank by
    their summed time."""
    from pangene_tpu_torch.util import trace_device_summary
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        ev("kernel", "a", 0, 10), ev("kernel", "b", 5, 10),
        ev("gpu_memcpy", "copy", 100, 4), ev("kernel", "a", 200, 1),
        ev("cpu_op", "aten::add", 0, 1000),
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 0}]}))
    got = trace_device_summary(str(trace), top=2)
    assert got["n_events"] == 4
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["top"] == [["a", pytest.approx(11e-6), 2],
                          ["b", pytest.approx(10e-6), 1]]


@pytest.mark.parametrize("argv,flag,kw", [
    (["-S"], 0x100, {}),
    (["--ori-sc"], 0x80, {}),
    (["-a2"], 0, {"min_arc_cnt": 2}),
    (["-E"], 0x200, {}),
    (["-J"], 0x40, {}),
    (["--bed=raw"], 0x1, {}),
    (["--bed=flag"], 0x4, {}),
    (["--bed=walk"], 0x2, {}),
])
def test_cli_options_vs_host(corpus, capsys, argv, flag, kw):
    want = run_jax(corpus, "host", flag=flag, **kw)
    assert run_port(argv + corpus, capsys) == want


def test_sequential_parse_vs_host(corpus, capsys, monkeypatch):
    """One parse worker: files are parsed in the main process, in order."""
    want = run_jax(corpus, "host")
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    assert run_port(corpus, capsys) == want


@pytest.mark.parametrize("torch_loaded,cuda_initialised,want", [
    (False, False, "fork"), (False, True, "fork"), (True, False, "fork"),
    (True, True, "spawn")])
def test_parse_start_method(monkeypatch, torch_loaded, cuda_initialised,
                            want):
    """The parse pool forks, as the JAX package's does, unless this process
    has initialised CUDA."""
    from pangene_tpu_torch.pipeline import parse_start_method
    monkeypatch.setattr(torch.cuda, "is_initialized",
                        lambda: cuda_initialised)
    if not torch_loaded:
        monkeypatch.delitem(sys.modules, "torch")
    assert parse_start_method() == want


@pytest.mark.parametrize("engine", ["sharded", "host"])
def test_parse_pool_from_a_torch_main(corpus, tmp_path, engine):
    """Four parse workers under a main that imports torch first, as
    chip_smoke.py does: the pool forks (CUDA is not initialised) and the
    GFA is the JAX package's."""
    gfa = tmp_path / "out.gfa"
    code = (
        "import json, sys\n"
        "import torch\n"
        "from pangene_tpu_torch import cli, util\n"
        "sys.stdout = open(%r, 'w')\n"
        "cli.main(['--device', 'cpu', '--engine', %r, '-v', '0'] + %r)\n"
        "sys.stdout.close()\n"
        "sys.stderr.write('POOL=' + json.dumps("
        "util.stage_stats.get('parse_pool')) + '\\n')\n"
        % (str(gfa), engine, corpus))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="1",
                                PANGENE_PARSE_WORKERS="4"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "POOL=\"fork\"" in r.stderr.splitlines()
    assert gfa.read_text() == run_jax(corpus, "host")


def test_synth16_golden(tmp_path, capsys):
    files = synth_paf_files(str(tmp_path), n_genome=16, n_gene=500,
                            n_iso=3, seed=42)
    want = gzip.open(REPO / "tests" / "golden" / "synth16.gfa.gz",
                     "rt").read()
    assert run_port(files, capsys) == want


def test_load_hits_from_jax_checkpoint(corpus, capsys, tmp_path):
    ckpt = str(tmp_path / "hits.npz")
    jutil.verbose = 0
    out = io.StringIO()
    jpipeline.run(PgOpt(engine="host"), corpus, out=out, save_hits=ckpt)
    assert run_port(["--load-hits", ckpt], capsys) == out.getvalue()


def test_run_loads_neither_jax_nor_pangene_tpu(corpus, tmp_path):
    """In a fresh process: another test in this worker may have loaded jax.
    All four paths run: the per-genome engine, the device-resident loop,
    with PANGENE_DEVICE_LOOP=0 the per-round device step, and the host
    engine on the native runtime (which must leave CUDA uninitialised);
    then the toolkit's `call` and `gfa2matrix` on the GFA built."""
    gfa = [tmp_path / "device.gfa", tmp_path / "sharded.gfa",
           tmp_path / "rounds.gfa", tmp_path / "host.gfa"]
    code = (
        "import json, os, sys\n"
        "import torch\n"
        "from pangene_tpu_torch import cli\n"
        "from pangene_tpu_torch.ops import sweep_native\n"
        "from pangene_tpu_torch.parallel import device_loop, stacked\n"
        "for engine, loop, path in zip(('device', 'sharded', 'sharded', "
        "'host'), '1101', %r):\n"
        "    os.environ['PANGENE_DEVICE_LOOP'] = loop\n"
        "    sys.stdout = open(path, 'w')\n"
        "    sweep_native.reset_counts()\n"
        "    cli.main(['--device', 'cpu', '--engine', engine, '-v', '0']"
        " + %r)\n"
        "    sys.stdout.close()\n"
        "    if engine == 'sharded' and loop == '1':\n"
        "        sys.stderr.write('ENGAGED=' + json.dumps("
        "device_loop.LAST.get('engaged')) + '\\n')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pangene_tpu')]\n"
        "sys.stderr.write('MODULES=' + json.dumps(bad) + '\\n')\n"
        "sys.stderr.write('ROUNDS=' + json.dumps("
        "stacked.LAST.get('rounds')) + '\\n')\n"
        "sys.stderr.write('NATIVE=' + json.dumps("
        "sweep_native.n_calls) + '\\n')\n"
        "sys.stderr.write('CUDA_INIT=' + json.dumps("
        "torch.cuda.is_initialized()) + '\\n')\n"
        "from pangene_tpu_torch.tools import cli as tools\n"
        "for cmd in ('call', 'gfa2matrix'):\n"
        "    sys.stdout = open(%r + '.' + cmd, 'w')\n"
        "    tools.main([cmd, %r])\n"
        "    sys.stdout.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pangene_tpu')]\n"
        "sys.stderr.write('TOOL_MODULES=' + json.dumps(bad) + '\\n')\n"
        % ([str(p) for p in gfa], corpus, str(gfa[3]), str(gfa[3])))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]

    def reported(key):
        line = [x for x in r.stderr.splitlines() if x.startswith(key + "=")]
        return json.loads(line[-1][len(key) + 1:])

    assert reported("MODULES") == []
    assert reported("ENGAGED") is True
    assert reported("ROUNDS") == 17
    native = reported("NATIVE")
    assert native["round_genome"] > 0 and native["shadow"] > 0
    assert reported("CUDA_INIT") is False
    want = run_jax(corpus, "host")
    for path in gfa:
        assert path.read_text() == want
    assert reported("TOOL_MODULES") == []
    from pangene_tpu.tools.cli import main as jax_tools
    for cmd in ("call", "gfa2matrix"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_tools([cmd, str(gfa[3])])
        assert (tmp_path / ("host.gfa." + cmd)).read_text() == out.getvalue()


def test_ranks_load_neither_jax_nor_pangene_tpu(corpus):
    """Two ranks of a launch (as torchrun, or the CLI's --devices 2, starts
    them), each a fresh process that builds the graph over the gloo mesh:
    neither loads jax or pangene_tpu, and both build the JAX package's
    bytes."""
    from pangene_tpu_torch.testing import run_ranks
    reports = run_ranks(2, ["--device", "cpu", "--devices", "2", "-v", "1"]
                        + corpus, env=dict(os.environ, OMP_NUM_THREADS="1"),
                        cwd=str(REPO))
    want = hashlib.md5(run_jax(corpus, "host").encode()).hexdigest()
    for r, rep in enumerate(reports):
        assert rep["rank"] == r and rep["world"] == 2
        assert rep["foreign_modules"] == []
        assert rep["LAST"]["engaged"] is True
        assert rep["LAST"]["shape"]["n_devices"] == 2
        assert rep["md5"] == want


def test_no_module_imports_jax_or_pangene_tpu():
    files = sorted((REPO / "pangene_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    rel = {str(p.relative_to(REPO)) for p in files}
    assert {"pangene_tpu_torch/parallel/device_loop.py",
            "pangene_tpu_torch/parallel/stacked.py",
            "pangene_tpu_torch/parallel/mesh.py",
            "pangene_tpu_torch/ops/softfloat.py",
            "pangene_tpu_torch/ops/loop_kernels.py",
            "pangene_tpu_torch/ops/device.py",
            "pangene_tpu_torch/ops/sweep_native.py",
            "pangene_tpu_torch/ops/sweep_vec.py",
            "pangene_tpu_torch/ops/sweep.py",
            "pangene_tpu_torch/tools/cli.py",
            "pangene_tpu_torch/tools/gfa.py",
            "pangene_tpu_torch/tools/netgraph.py"} <= rel
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "pangene_tpu"), \
                    "%s imports %s" % (path, name)


def test_cli_without_cuda_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-v", "0"] + corpus)


def test_cli_rejects_unknown_device(corpus):
    with pytest.raises(SystemExit):
        cli.main(["--device", "tpu"] + corpus)


@pytest.fixture(autouse=True)
def _quiet():
    yield
    util.verbose = 3
    jutil.verbose = 3
