"""The port's toolkit (pangene_tpu_torch.tools) against the JAX package's
(pangene_tpu.tools), byte for byte, on in-repo inputs.

Every subcommand but `version` runs through both packages' `main` on the
same arguments and must write the same stdout and stderr: `call` (plain,
`--sym`, `--sym -p -s` and the debugging printers), `call2html`,
`calldiff`, `gfa2matrix` (plain, `-c`, `-d` with `-p`), `outgroup`,
`getaa`, `flt-mmseqs` (plain, `-v`, `-q`) and `bed2paf`, and each usage
text. Inputs: the C4 graphs and synth16 of tests/golden, a GFA the port
builds from a small synthetic corpus, random graphs from
tests/test_bubble_golden.py, and the synthetic annotation, mmseqs, BED and
FAI files of tests/test_tools.py. The port's `call` is also held against
the independent oracle (tests/bubble_oracle.py) and the pinned C4 golden;
the reference's test/bubble fixtures run where they exist. `version`
prints the port's own version.

Run on the CPU: python -m pytest tests/test_torch_tools.py -q
"""
import contextlib
import gzip
import io
import pathlib
import random

import pytest

from bubble_oracle import OGfa, call_oracle, seg_classes
from pangene_tpu.tools.cli import main as jax_main
from pangene_tpu_torch import cli as port_cli
from pangene_tpu_torch import util
from pangene_tpu_torch.options import PG_REF_VERSION, PG_VERSION
from pangene_tpu_torch.testing import synth_paf_files
from pangene_tpu_torch.tools.cli import _getopt
from pangene_tpu_torch.tools.cli import main as port_main
from pangene_tpu_torch.tools.gfa import GFA
from pangene_tpu_torch.tools.netgraph import NetGraph
from test_bubble_golden import BUBBLE, _random_gfa

GOLDEN = pathlib.Path(__file__).parent / "golden"
C4_GFAS = sorted(p.name for p in GOLDEN.glob("C4*.gfa"))
# the reference's bubble fixtures, named by their pinned goldens
FIXTURES = sorted({p.name.split(".")[0] for p in (GOLDEN / "bubble").iterdir()
                   if not p.name.startswith("C4.")})
# random graphs (tests/test_bubble_golden.py:_random_gfa, seeded as below):
# bubbles without walks (0, 2, 4), bubbles with alleles (34 ... 154), none
# (1, 3, 5)
RANDOM_SEEDS = [0, 2, 4, 34, 45, 52, 61, 66, 154, 1, 3, 5]
CALL_MODES = {"plain": [], "sym": ["--sym"], "pst": ["--sym", "-p", "-s"]}


def run(main, argv):
    """(return code, stdout, stderr) of one toolkit main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def same(argv):
    """The port's output for `argv`, after checking it equals the JAX
    package's byte for byte."""
    got = run(port_main, argv)
    assert got == run(jax_main, argv), argv
    return got[1]


@pytest.fixture(scope="module")
def gfas(tmp_path_factory):
    """name -> path of every GFA input: the C4 graphs, synth16, a GFA the
    port builds (--device cpu, default engine) from a small corpus, and
    random graphs."""
    d = tmp_path_factory.mktemp("torch_tools")
    paths = {n: str(GOLDEN / n) for n in C4_GFAS}
    paths["synth16"] = str(GOLDEN / "synth16.gfa.gz")
    files = synth_paf_files(str(d / "corpus"), n_genome=6, n_gene=300,
                            n_iso=3, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PANGENE_PARSE_WORKERS", "1")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port_cli.main(["--device", "cpu", "-v", "0"] + files)
        util.verbose = 3
    paths["port_built"] = str(d / "port_built.gfa")
    pathlib.Path(paths["port_built"]).write_text(buf.getvalue())
    for seed in RANDOM_SEEDS:
        rng = random.Random(seed)
        text = _random_gfa(rng, n_seg=rng.randrange(5, 14),
                           n_extra=rng.randrange(2, 10),
                           n_walk=rng.randrange(0, 5))
        paths["random%d" % seed] = str(d / ("random%d.gfa" % seed))
        pathlib.Path(paths["random%d" % seed]).write_text(text)
    return paths


@pytest.fixture(scope="module")
def calls(gfas, tmp_path_factory):
    """name -> path of the port's `call` output on each GFA input (with
    `--sym` for the random graphs, which list one link of each pair)."""
    d = tmp_path_factory.mktemp("torch_tools_calls")
    out = {}
    for name, path in gfas.items():
        sym = ["--sym"] if name.startswith("random") else []
        out[name] = str(d / (name + ".call.txt"))
        pathlib.Path(out[name]).write_text(same(["call"] + sym + [path]))
    return out


@pytest.fixture(scope="module")
def side_files(tmp_path_factory):
    """The synthetic inputs of tests/test_tools.py, with a few more records
    so that every branch of each subcommand is taken."""
    d = tmp_path_factory.mktemp("torch_tools_side")

    def write(name, text):
        (d / name).write_text(text)
        return str(d / name)

    attrs = ('gene_id "%s"; %sprotein_id "%s"; %sgene_biotype "%s"; '
             'transcript_biotype "%s";%s')
    rows = [("chr1", "G1", 'gene_name "GENE1"; ', "P1",
             'protein_version "2"; ', "protein_coding", "protein_coding", ""),
            ("chrM", "GM", "", "PM", "", "protein_coding", "protein_coding",
             ""),
            ("chr2", "G2", "", "P2", "", "protein_coding",
             "nonsense_mediated_decay", ""),
            ("chr3", "G3", 'gene_name "RT"; ', "P3", "", "protein_coding",
             "protein_coding", ' tag "readthrough_transcript";'),
            ("chr4", "G4", 'gene_name "CAN"; ', "P4", 'protein_version "1"; ',
             "protein_coding", "protein_coding", ' tag "Ensembl_canonical";'),
            ("chr5", "G5", "", "P5", "", "lncRNA", "lncRNA", "")]
    gtf = "#comment\nchr1\tx\texon\t1\t9\t.\t+\t.\tgene_id \"G1\";\n"
    for chrom, gid, gname, pid, pver, gtype, ttype, tag in rows:
        gtf += "%s\tx\tCDS\t1\t9\t.\t+\t0\t%s\n" % (
            chrom, attrs % (gid, gname, pid, pver, gtype, ttype, tag))
    faa = "".join(">%s desc\nMKV\nLLA\n" % p for p in
                  ("P1.2", "PM", "P2", "P3", "P4.1", "P5", "PX"))
    mm = []
    for k, (fid, aln, mism, gap, qs, qe, ts, te, qlen, tlen) in enumerate([
            ("0.95", 100, 2, 0, 1, 100, 1, 100, 100, 100),
            ("0.95", 50, 30, 10, 1, 50, 1, 50, 200, 200),
            ("0.85", 100, 5, 1, 1, 100, 3, 102, 100, 110),
            ("0.99", 80, 0, 0, 11, 90, 1, 80, 100, 80),
            ("0.92", 120, 4, 2, 1, 120, 1, 118, 125, 121)]):
        mm.append("\t".join(map(str, [
            "Q%d:1" % k, "T%d:1" % k, fid, aln, mism, gap, qs, qe, ts, te,
            "1e-10", 90, qlen, tlen])))
    bed = ("c1\t10\t100\tG1:P1\t50\t+\nc2\t20\t120\tG1:P2\t60\t+\n"
           "c1\t200\t300\tG2:P3\t70\t+\nc2\t210\t330\tG2:P4\t40\t-\n"
           "c1\t400\t500\tG3:P5\t10\t+\nc1\t600\t700\tG3:P6\t20\t+\n"
           "c9\t1\t2\tG4:P7\t5\t+\nc2\t800\t900\tG5:P8\t5\t+\n")
    return {
        "gtf": write("a.gtf", gtf), "faa": write("a.faa", faa),
        "mmseqs": write("mm.txt", "\n".join(mm) + "\n"),
        "bed": write("x.bed", bed), "fai1": write("1.fai", "c1\t1000\n"),
        "fai2": write("2.fai", "c2\t2000\n"),
        "outgroup": write("og.txt",
                          "GRCh38#0\nCHM13#0 extra\nasm1#1\nasm4#0\n\n"),
        "clstr": write("c4.clstr", (
            ">Cluster 0\n0\t1744aa, >C4A:ENSP00000396688.2... *\n"
            "1\t1744aa, >C4B:ENSP00000415941.2... at 99.9%\n"
            ">Cluster 1\n0\t396aa, >DXO:ENSP00000364505.3... *\n"
            ">Cluster 2\n0\t10aa, >NOPE:X... at 50%\n"))}


def gfa_names():
    return (C4_GFAS + ["synth16", "port_built"]
            + ["random%d" % s for s in RANDOM_SEEDS])


@pytest.mark.parametrize("mode", list(CALL_MODES))
@pytest.mark.parametrize("name", gfa_names())
def test_call_equals_jax(gfas, name, mode):
    same(["call"] + CALL_MODES[mode] + [gfas[name]])


@pytest.mark.parametrize("flags", [["-b"], ["-e"], ["-d"], ["-w"],
                                   ["-m", "2"], ["-p"], ["-p", "-s"],
                                   ["-p", "-s", "-r", "GRCh38#0"]],
                         ids=" ".join)
@pytest.mark.parametrize("name", ["C4.gfa", "C4.J.gfa", "random154"])
def test_call_options_equal_jax(gfas, name, flags):
    same(["call"] + flags + [gfas[name]])


def test_call_c4_golden_and_oracle(gfas):
    text = (GOLDEN / "C4.gfa").read_text()
    got = same(["call", gfas["C4.gfa"]])
    assert got == (GOLDEN / "bubble" / "C4.call.txt").read_text()
    assert_oracle(text, got, sym=False)


def records(text):
    return [line for line in text.split("\n")
            if line and not line.startswith("CC")]


def norm_cec(lines):
    """The cec column renumbered by first appearance (tests/
    test_bubble_golden.py): class numbers depend on the traversal."""
    m = {}
    out = []
    for line in lines:
        t = line.split("\t")
        if t[0] in ("BB", "FB"):
            t[3] = m.setdefault(t[3], str(len(m)))
        out.append("\t".join(t))
    return out


def assert_oracle(text, got, sym):
    """The port's `call` output and its cycle-equivalence partition against
    the independent oracle."""
    assert norm_cec(records(got)) == norm_cec(call_oracle(text, sym))
    g = GFA().from_string(text)
    if sym:
        g.symmetrize()
    NetGraph(g, False, None).mark_cec()
    ours = [s.cec for s in g.seg]
    orcl = seg_classes(OGfa(text, sym))
    assert [c < 0 for c in ours] == [c is None for c in orcl]
    for i in range(len(ours)):
        for j in range(i + 1, len(ours)):
            if ours[i] >= 0 and ours[j] >= 0:
                assert (ours[i] == ours[j]) == (orcl[i] == orcl[j]), (i, j)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_call_random_graph_oracle(gfas, seed):
    path = gfas["random%d" % seed]
    assert_oracle(pathlib.Path(path).read_text(),
                  same(["call", "--sym", path]), sym=True)


def test_call_port_built_oracle(gfas):
    path = gfas["port_built"]
    assert_oracle(pathlib.Path(path).read_text(), same(["call", path]),
                  sym=False)


@pytest.mark.parametrize("mode", list(CALL_MODES))
@pytest.mark.parametrize("fixture", FIXTURES)
def test_reference_bubble_fixture(fixture, mode):
    fx = BUBBLE / (fixture + ".gfa")
    if not fx.exists():
        pytest.skip("reference bubble fixtures not available")
    suffix = {"plain": ".call.txt", "sym": ".call-sym.txt",
              "pst": ".call-pst.txt"}[mode]
    got = same(["call"] + CALL_MODES[mode] + [str(fx)])
    assert got == (GOLDEN / "bubble" / (fixture + suffix)).read_text()
    if mode != "pst":
        assert_oracle(fx.read_text(), got, sym=mode == "sym")


@pytest.mark.parametrize("flags", [[], ["-c"]], ids=["plain", "c"])
@pytest.mark.parametrize("name", gfa_names())
def test_gfa2matrix_equals_jax(gfas, name, flags):
    out = same(["gfa2matrix"] + flags + [gfas[name]])
    assert out.startswith("Gene")


@pytest.mark.parametrize("flags", [["-d"], ["-c", "-d"], ["-p", "-d"]],
                         ids=" ".join)
def test_gfa2matrix_paralogs_equal_jax(gfas, side_files, flags):
    same(["gfa2matrix"] + flags + [side_files["clstr"], gfas["C4.gfa"]])


@pytest.mark.parametrize("flags", [[], ["-e", "/v", "-g", "g1"], ["-g", "g2"]],
                         ids=["plain", "e-g", "g"])
@pytest.mark.parametrize("name", ["C4.gfa", "C4.a2.gfa", "port_built",
                                  "random154"])
def test_call2html_equals_jax(calls, name, flags):
    same(["call2html"] + flags + [calls[name]])


@pytest.mark.parametrize("pair", [("C4.gfa", "C4.gfa"),
                                  ("C4.gfa", "C4.a2.gfa"),
                                  ("C4.J.gfa", "C4.gfa"),
                                  ("random34", "random154"),
                                  ("port_built", "synth16")],
                         ids="-".join)
def test_calldiff_equals_jax(calls, pair):
    same(["calldiff", calls[pair[0]], calls[pair[1]]])


@pytest.mark.parametrize("name", ["C4.gfa", "C4.E.gfa", "random34",
                                  "random154", "port_built"])
def test_outgroup_equals_jax(calls, side_files, name):
    same(["outgroup", calls[name], side_files["outgroup"]])


@pytest.mark.parametrize("flags", [[], ["-s", "hs"], ["-e"], ["-r"], ["-c"],
                                   ["-e", "-r", "-s", "x"]], ids=" ".join)
def test_getaa_equals_jax(side_files, flags):
    same(["getaa"] + flags + [side_files["gtf"], side_files["faa"]])


def test_getaa_test_tools_case(tmp_path):
    """The exact inputs of tests/test_tools.py::test_getaa."""
    gtf = tmp_path / "a.gtf"
    gtf.write_text(
        'chr1\tx\tCDS\t1\t9\t.\t+\t0\tgene_id "G1"; gene_name "GENE1"; '
        'protein_id "P1"; protein_version "2"; '
        'gene_biotype "protein_coding";\n'
        'chrM\tx\tCDS\t1\t9\t.\t+\t0\tgene_id "GM"; protein_id "PM"; '
        'gene_biotype "protein_coding";\n')
    faa = tmp_path / "a.faa"
    faa.write_text(">P1.2 desc\nMKV\n>PM.1\nMAA\n")
    assert same(["getaa", str(gtf), str(faa)]) == ">GENE1:P1.2 chr1\nMKV\n"


@pytest.mark.parametrize("flags", [[], ["-v"], ["-q"], ["-q", "-v"],
                                   ["-s", "0.8"], ["-q", "-s", "0.9"]],
                         ids=" ".join)
def test_flt_mmseqs_equals_jax(side_files, flags):
    same(["flt-mmseqs"] + flags + [side_files["mmseqs"]])


def test_bed2paf_equals_jax(side_files):
    out = same(["bed2paf", side_files["bed"], side_files["fai1"],
                side_files["fai2"]])
    assert out.startswith(
        "c1\t1000\t10\t100\t+\tc2\t2000\t20\t120\t50\t60\t60\tpn:Z:G1\n")


def test_bed2paf_gzip_inputs_equal_jax(side_files, tmp_path):
    """readlines opens .gz inputs transparently."""
    paths = []
    for key in ("bed", "fai1", "fai2"):
        p = tmp_path / (pathlib.Path(side_files[key]).name + ".gz")
        p.write_bytes(gzip.compress(
            pathlib.Path(side_files[key]).read_bytes()))
        paths.append(str(p))
    assert same(["bed2paf"] + paths) == same(
        ["bed2paf", side_files["bed"], side_files["fai1"], side_files["fai2"]])


@pytest.mark.parametrize("argv", [[], ["call"], ["call2html"], ["calldiff"],
                                  ["calldiff", "x"], ["getaa"], ["outgroup"],
                                  ["gfa2matrix"], ["flt-mmseqs"], ["bed2paf"],
                                  ["bed2paf", "a", "b"]], ids=" ".join)
def test_usage_equals_jax(argv):
    same(argv)


def test_unknown_command_raises():
    with pytest.raises(SystemExit, match="unrecognized command: nope"):
        port_main(["nope"])


def test_version_is_the_ports():
    rc, out, _ = run(port_main, ["version"])
    assert rc == 0
    assert out == "%s (toolkit parity with pangene.js %s)\n" % (
        PG_VERSION, PG_REF_VERSION)
    assert PG_VERSION.endswith("-torch")


@pytest.mark.parametrize("argv,optstr", [
    (["-bd", "in.gfa"], "bedpm:wr:s"), (["-wm50", "x"], "bedpm:wr:s"),
    (["-m", "50", "x"], "bedpm:wr:s"),
    (["-b", "--", "-d", "y"], "bedpm:wr:s"),
    (["-z", "--long", "f"], "bedpm:wr:s"),
    (["a", "-e", "b", "-m7"], "bedpm:wr:s"),
    (["-m"], "bedpm:wr:s"), (["-s", "0.5", "-qv", "f"], "s:qv")])
def test_getopt_equals_jax(argv, optstr):
    from pangene_tpu.tools.cli import _getopt as jax_getopt
    assert _getopt(argv, optstr) == jax_getopt(argv, optstr)
