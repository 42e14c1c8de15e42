"""The port's thresholds under pressure, at more than toy scale, on the CPU:
the options that make the high-occurrence deletes, the annealing rounds and
the branch cuts fire (tests/test_golden_random.py holds the JAX package to
the reference binary on the same corpora and options), with the port's
device loop and per-round path against pangene_tpu's --engine host, byte
for byte.

* 16 genomes x 1,200 genes, seed 5: -c1, -g4 -r1, -b0.02 -y0.05, -T7 -c3
  and -F -p0.1, under the loop and the per-round path (-T7 runs 9 rounds
  there, not 17);
* seeds 21 and 87 at the same size: -c1 and -T7 -c3 under the loop;
* 32 x 4,000, seed 19: -c1 -g8 and -T20 -F under the loop.

Options go through each package's own cli.parse_args, and every port run
asserts the path it took (test_torch_engine_equiv.run_port).
"""
import pytest

from pangene_tpu_torch.testing import synth_paf_files
from test_torch_engine_equiv import _env, jax_outputs, run_port  # noqa: F401

OPTIONS = {"c1": ["-c1"], "g4-r1": ["-g4", "-r1"],
           "b0.02-y0.05": ["-b0.02", "-y0.05"], "T7-c3": ["-T7", "-c3"],
           "F-p0.1": ["-F", "-p0.1"]}
SEED_OPTIONS = {k: OPTIONS[k] for k in ("c1", "T7-c3")}
MID_OPTIONS = {"c1-g8": ["-c1", "-g8"], "T20-F": ["-T20", "-F"]}


def _corpus(tmp_path_factory, n_genome, n_gene, seed, option_sets):
    d = tmp_path_factory.mktemp("torch_pressure_%d_%d_%d"
                                % (n_genome, n_gene, seed))
    files = synth_paf_files(str(d), n_genome=n_genome, n_gene=n_gene,
                            n_iso=3, seed=seed)
    return files, jax_outputs(files, option_sets)


@pytest.fixture(scope="module")
def pressure(tmp_path_factory):
    """(files, the JAX host GFA by option set) of 16 x 1,200, seed 5."""
    return _corpus(tmp_path_factory, 16, 1200, 5, OPTIONS)


@pytest.fixture(scope="module", params=[21, 87])
def pressure_seeded(request, tmp_path_factory):
    """The same size on two more seeds."""
    return _corpus(tmp_path_factory, 16, 1200, request.param, SEED_OPTIONS)


@pytest.fixture(scope="module")
def pressure_mid(tmp_path_factory):
    """32 x 4,000, seed 19."""
    return _corpus(tmp_path_factory, 32, 4000, 19, MID_OPTIONS)


@pytest.mark.parametrize("config", ["sharded", "rounds"])
@pytest.mark.parametrize("options", list(OPTIONS))
def test_pressure_port_equals_jax_host(pressure, monkeypatch, options,
                                       config):
    files, want = pressure
    got = run_port(OPTIONS[options], files, config, monkeypatch)
    assert got and got == want[options]


@pytest.mark.parametrize("options", list(SEED_OPTIONS))
def test_pressure_more_seeds(pressure_seeded, monkeypatch, options):
    files, want = pressure_seeded
    got = run_port(SEED_OPTIONS[options], files, "sharded", monkeypatch)
    assert got and got == want[options]


@pytest.mark.parametrize("options", list(MID_OPTIONS))
def test_pressure_midscale(pressure_mid, monkeypatch, options):
    files, want = pressure_mid
    got = run_port(MID_OPTIONS[options], files, "sharded", monkeypatch)
    assert got and got == want[options]
