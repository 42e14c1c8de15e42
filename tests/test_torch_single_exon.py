"""The port on the single-exon shape (the bacterial / miniprot -S shape of
BASELINE.md), on the CPU: every port engine and path against pangene_tpu's
--engine host, byte for byte, on synth_paf_files(..., n_iso=1,
single_exon=True) corpora.

* 20 genomes x 120 genes, seed 77 (the corpus tests/test_golden_random.py
  holds the JAX package to the reference binary on), options [], -J, -E and
  -J -a2, under the port's host engine, the device loop (sharded), the
  per-round path (PANGENE_DEVICE_LOOP=0), a forced loop fallback
  (PANGENE_DEVLOOP_MAX_A=1) and the per-genome engine (device). Under -E
  every gene is single-exon in every genome, so the graph is empty: the
  loop reports the fallback "empty graph" and the host rounds run, as in the
  JAX package; the GFA is empty on both sides.
* 40 x 800, seed 13, -J and [], under the loop and the per-round path: the
  loop at more than toy scale on one-exon rows.

Options go through each package's own cli.parse_args, and every port run
asserts the path it took (test_torch_engine_equiv.run_port).
"""
import pytest
import torch

from pangene_tpu_torch.testing import synth_paf_files
from test_torch_engine_equiv import _env, jax_outputs, run_port  # noqa: F401

torch.set_num_threads(1)

# of test_torch_engine_equiv.CONFIGS
CONFIGS = ["host", "sharded", "rounds", "fallback", "device"]
OPTIONS = {"default": [], "J": ["-J"], "E": ["-E"], "J-a2": ["-J", "-a2"]}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(files, the JAX host GFA by option set) of the 20 x 120 corpus."""
    d = tmp_path_factory.mktemp("torch_single_exon_20_120")
    files = synth_paf_files(str(d), n_genome=20, n_gene=120, n_iso=1,
                            seed=77, single_exon=True)
    return files, jax_outputs(files, OPTIONS)


MID_OPTIONS = {"J": ["-J"], "default": []}


@pytest.fixture(scope="module")
def mid(tmp_path_factory):
    """(files, the JAX host GFA by option set) of the 40 x 800 corpus."""
    d = tmp_path_factory.mktemp("torch_single_exon_40_800")
    files = synth_paf_files(str(d), n_genome=40, n_gene=800, n_iso=1,
                            seed=13, single_exon=True)
    return files, jax_outputs(files, MID_OPTIONS)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("options", list(OPTIONS))
def test_single_exon_port_equals_jax_host(toy, monkeypatch, options, config):
    files, want = toy
    got = run_port(OPTIONS[options], files, config, monkeypatch,
                   empty=options == "E")
    assert got == want[options]


@pytest.mark.parametrize("config", ["sharded", "rounds"])
@pytest.mark.parametrize("options", list(MID_OPTIONS))
def test_single_exon_loop_above_toy_scale(mid, monkeypatch, options, config):
    files, want = mid
    got = run_port(MID_OPTIONS[options], files, config, monkeypatch)
    assert got and got == want[options]
