"""End-to-end engine equivalence of the port on the CPU: pipeline.run of
pangene_tpu_torch under every engine and path gives the JAX package's "host"
engine output byte for byte, on the synthetic corpus of
tests/test_engine_equiv.py (6 genomes x 300 genes, seed 3) under its three
option sets, and the reference binary's GFA on tests/golden/synth16.gfa.gz.

Port configurations: the host engines ("host" = the native runtime,
"host-vec", "host-ref"), "sharded" with the device loop, with
PANGENE_DEVICE_LOOP=0 (the per-round path) and with a forced loop fallback,
and "device"; the card engines on --device cpu (the kernels' plain
versions). Runs that should take the native runtime (ops/sweep_native.py)
must show calls in its counter: as in the JAX package, "sharded" sweeps
single genomes in C, and only "device" sweeps them through the kernel's
plain version. A host-engine run touches no CUDA state. Options go through
each package's own cli.parse_args; tests/test_torch_single_exon.py and
tests/test_torch_pressure.py use the same runners (run_port, jax_outputs).
"""
import gzip
import io
import pathlib

import pytest
import torch

from pangene_tpu import cli as jcli
from pangene_tpu import pipeline as jpipeline
from pangene_tpu import util as jutil
from pangene_tpu.options import PgOpt as JaxOpt
from pangene_tpu_torch import cli, pipeline, util
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.ops import sweep_native as sn
from pangene_tpu_torch.options import PgOpt
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import stacked as st
from pangene_tpu_torch.testing import synth_paf_files

REPO = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

# name: the CLI's options, through each package's own cli.parse_args
OPTION_SETS = {"default": [], "f0.3": ["-f0.3"], "ori-sc": ["--ori-sc"]}
# the single-genome sweeps in C
NATIVE_SWEEPS = ("shadow", "flt_ov_isoform")
# the native entries that only a graph with arcs reaches
NATIVE_ARCS = ("mark_branch", "propagate_weak_hash", "format_arcs")
EMPTY_GRAPH = {"engaged": False, "reason": "empty graph"}
# name: (engine, environment, the native entries the run must call)
CONFIGS = {
    "host": ("host", {}, NATIVE_SWEEPS + ("round_genome", "mark_branch")),
    "host-vec": ("host-vec", {}, ("mark_branch",)),
    "host-ref": ("host-ref", {}, ("mark_branch",)),
    "sharded": ("sharded", {}, NATIVE_SWEEPS + ("round_genome",
                                                "gen_vtx_greedy")),
    "rounds": ("sharded", {"PANGENE_DEVICE_LOOP": "0"},
               NATIVE_SWEEPS + ("mark_branch", "propagate_weak_hash")),
    "fallback": ("sharded", {"PANGENE_DEVLOOP_MAX_A": "1"},
                 NATIVE_SWEEPS + ("round_genome", "mark_branch",
                                  "propagate_weak_hash")),
    "device": ("device", {}, ("mark_branch", "format_arcs")),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine_equiv")
    return synth_paf_files(str(d), n_genome=6, n_gene=300, n_iso=3, seed=3)


def run_jax_host(argv, files):
    """pangene_tpu's --engine host GFA, options through its cli.parse_args."""
    opt, files, extras = jcli.parse_args(list(argv) + ["--engine", "host"]
                                         + list(files))
    jutil.verbose = 0
    out = io.StringIO()
    jpipeline.run(opt, files, out=out, **extras)
    return out.getvalue()


def jax_outputs(files, option_sets):
    """run_jax_host's GFA by option set, parsing in the main process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PANGENE_PARSE_WORKERS", "1")
        return {name: run_jax_host(argv, files)
                for name, argv in option_sets.items()}


@pytest.fixture(scope="module")
def jax_host(corpus):
    """The JAX package's "host" engine output, by option set."""
    return jax_outputs(corpus, OPTION_SETS)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # parse in the main process: no worker pool for a few small files
    monkeypatch.setenv("PANGENE_PARSE_WORKERS", "1")
    util.verbose = 0
    yield
    util.verbose = 3
    jutil.verbose = 3


def run_port(argv, files, config, monkeypatch, empty=False):
    """pangene_tpu_torch's GFA on the CPU under `config` (CONFIGS), options
    `argv` through its cli.parse_args; asserts the path the run took: the
    native entries it must call, the per-genome sweep's plain version under
    "device" alone, and which of the loop (device_loop.LAST) and the
    per-round path (stacked.LAST) ran, with the per-round path's round count
    (2 + -T, or 1 + -T after the loop's phase 1). `empty`: the options leave
    a graph without segments, so the loop must report "empty graph", the
    host rounds run, the arcs' native entries are not reached and the GFA is
    empty."""
    engine, env, entries = CONFIGS[config]
    for k in ("PANGENE_DEVICE_LOOP", "PANGENE_DEVLOOP_MAX_A"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sn.reset_counts()
    sk.reset_counts()
    dl.LAST.clear()
    st.LAST.clear()
    opt, files, extras = cli.parse_args(
        list(argv) + ["--engine", engine, "--device", "cpu"] + list(files))
    util.verbose = 0
    out = io.StringIO()
    pipeline.run(opt, files, out=out, **extras)
    gfa = out.getvalue()
    assert (gfa == "") == empty, (config, argv, len(gfa))
    for e in entries:
        if not (empty and e in NATIVE_ARCS):
            assert sn.n_calls[e] > 0, (config, e, sn.n_calls)
    # the per-genome sweep: through the kernel's plain version under
    # "device" only, never in C there
    plain = list(sk.n_plain_calls.values())
    if engine == "device":
        assert min(plain) > 0, sk.n_plain_calls
        assert [sn.n_calls[e] for e in NATIVE_SWEEPS] == [0, 0], sn.n_calls
    else:
        assert plain == [0, 0], (config, sk.n_plain_calls)
    rounds = 2 + opt.n_branch_flt
    if config in ("host", "host-vec", "host-ref", "device"):
        assert dl.LAST == {} and st.LAST == {}, (dl.LAST, st.LAST)
    elif config == "rounds":
        assert dl.LAST == {} and st.LAST["rounds"] == rounds, st.LAST
    elif config == "sharded" and not empty:
        assert dl.LAST["engaged"] is True and st.LAST == {}, dl.LAST
    else:
        # a fallback: the loop's reason, then the host rounds' device steps
        if empty:
            assert dl.LAST == EMPTY_GRAPH, dl.LAST
        else:
            assert dl.LAST["engaged"] is False, dl.LAST
            assert dl.LAST["reason"].startswith("arc capacity 1 <"), dl.LAST
        assert st.LAST["rounds"] == rounds - 1, st.LAST
    return gfa


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("options", list(OPTION_SETS))
def test_port_equals_jax_host(corpus, jax_host, monkeypatch, options,
                              config):
    got = run_port(OPTION_SETS[options], corpus, config, monkeypatch)
    assert got == jax_host[options]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_synth16_golden(tmp_path_factory, monkeypatch, config):
    d = tmp_path_factory.getbasetemp() / "torch_engine_equiv16"
    if not d.exists():
        synth_paf_files(str(d), n_genome=16, n_gene=500, n_iso=3, seed=42)
    files = sorted(str(p) for p in d.iterdir() if p.name.endswith(".paf.gz"))
    want = gzip.open(REPO / "tests" / "golden" / "synth16.gfa.gz",
                     "rt").read()
    assert run_port([], files, config, monkeypatch) == want


def test_host_engine_touches_no_cuda(corpus, jax_host, monkeypatch):
    """A host engine reads no opt.device: with the default "cuda" and any
    use of torch.cuda made to fail, it runs and gives the right bytes, and
    CUDA stays uninitialised. A card engine still raises without a card."""
    def touched(*a, **kw):
        raise AssertionError("a host engine touched torch.cuda")
    monkeypatch.setattr(torch.cuda, "is_available", touched)
    monkeypatch.setattr(torch.cuda, "_lazy_init", touched)
    for engine in ("host", "host-vec"):
        out = io.StringIO()
        pipeline.run(PgOpt(engine=engine), corpus, out=out)
        assert out.getvalue() == jax_host["default"]
    assert not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run(PgOpt(engine="sharded"), corpus, out=io.StringIO())


def test_debug_gene_vs_jax(corpus):
    """graph/build.debug_gene, the reference's developer hook, writes the
    JAX package's Z lines for the vertex genes of the final graph."""
    import contextlib
    from pangene_tpu.graph.build import debug_gene as jdebug_gene
    from pangene_tpu_torch.graph.build import debug_gene
    q = pipeline.run(PgOpt(engine="host"), corpus, out=io.StringIO())
    jutil.verbose = 0
    jq = jpipeline.run(JaxOpt(engine="host"), corpus, out=io.StringIO())
    names = [q.d.gene_name[g] for g in q.seg_gid[::7]]
    got, want = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(got):
        for name in names:
            debug_gene(q, name)
    with contextlib.redirect_stderr(want):
        for name in names:
            jdebug_gene(jq, name)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("Z\t") >= len(names)
