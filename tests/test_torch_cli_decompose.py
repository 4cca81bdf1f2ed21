"""The rest of the ``vcf`` command line against stoat_tpu's: the
decomposition alone (case 3), the decomposition's flags ``-r``, ``-i``,
``-y`` and ``-l``, ``-m``, ``-t`` and ``-V``, and the invalid argument
combinations (a run without a phenotype among them).

Both CLIs run in process on the same inputs (tests/test_cli_decompose.py's
three-bubble chain, a self-loop bubble and chip_smoke.py's nested graph);
their output directories are compared byte for byte.
"""

import importlib.util
import os

import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu_torch import cli as torch_cli
from test_cli_decompose import build_fixture
from test_graph_decompose import build_gfa

INVALID = "[stoat vcf] Invalid argument combination provided."


def _tree(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = fh.read()
    return out


def _both(tmp_path, argv, name, device=("--device", "cpu")):
    """Run ``argv`` through both CLIs; returns {package: output files}."""
    trees = {}
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("torch", torch_cli, list(device))):
        out = str(tmp_path / f"{pkg}_{name}")
        assert cli.main([*argv, "-o", out, *extra]) == 0
        trees[pkg] = _tree(out)
    return trees


def _loop_graph(tmp_path):
    """tests/test_decompose_zoo.py's loop_simple, snarl 2_5 with a self
    loop on node 3, whose traversals depend on -y and which -l 4 rejects,
    then a plain bubble 6_9 that every setting keeps."""
    return build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "T"), (4, "GG"), (5, "AAAA"),
         (6, "TTTT"), (7, "A"), (8, "C"), (9, "GGGG")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 3, "+"), (3, "+", 5, "+"), (4, "+", 5, "+"),
         (5, "+", 6, "+"), (6, "+", 7, "+"), (6, "+", 8, "+"),
         (7, "+", 9, "+"), (8, "+", 9, "+")],
        [("ref", "1+,2+,3+,5+,6+,7+,9+")])


def _nested_graph(tmp_path):
    """chip_smoke.write_graph's graph: nested snarls with many children
    (-i), haplotype paths beside the ``ref`` path (-r)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.write_graph(str(tmp_path / "nested"), 120, 6)["gfa"]


def test_case3_decomposition_alone_byte_identical(tmp_path):
    """``vcf -p G -d D``: snarl_analyse.tsv and its companion, and nothing
    else, as stoat_tpu writes them (tests/test_cli_decompose.py:61).  The
    decomposition needs no device: the default --device cuda is not
    resolved, so it runs on a machine without a card too."""
    gfa, dist, _vcf, _pheno = build_fixture(tmp_path)
    trees = _both(tmp_path, ["vcf", "-p", gfa, "-d", dist], "case3",
                  device=())
    assert "snarl_analyse.tsv" in trees["jax"]
    assert b"1_4" in trees["jax"]["snarl_analyse.tsv"]
    assert trees["torch"] == trees["jax"]


@pytest.mark.parametrize("graph,flags", [
    ("loop", []), ("loop", ["-y", "2"]), ("loop", ["-l", "4"]),
    ("nested", ["-i", "2"]), ("nested", ["-r", "CHR"]),
    ("nested", ["-r", "CHR", "-i", "3", "-y", "2", "-l", "40"])])
def test_decomposition_flags_byte_identical(tmp_path, graph, flags):
    """-r (reference paths), -i (children), -y (cycles) and -l (path
    length) reach the decomposition as in stoat_tpu; each changes the
    output against the defaults, so the flag really arrived."""
    gfa = _loop_graph(tmp_path) if graph == "loop" else \
        _nested_graph(tmp_path)
    chr_file = tmp_path / "chr.txt"
    chr_file.write_text("ref\n")
    flags = [str(chr_file) if f == "CHR" else f for f in flags]
    argv = ["vcf", "-p", gfa, "-d", gfa]
    trees = _both(tmp_path, [*argv, *flags], "flags")
    assert trees["torch"] == trees["jax"]
    if flags and "-r" not in flags:
        defaults = _both(tmp_path, argv, "defaults")
        assert defaults["torch"] != trees["torch"]


def test_case2_with_decomposition_flags_byte_identical(tmp_path):
    """-p -d with a GWAS and the decomposition's flags: the snarl file
    and the binary table (tests/test_cli_decompose.py:101)."""
    gfa, dist, vcf, pheno = build_fixture(tmp_path, n_samples=60, seed=3)
    chr_file = tmp_path / "chr.txt"
    chr_file.write_text("ref\n")
    trees = _both(tmp_path, ["vcf", "-p", gfa, "-d", dist, "-v", vcf, "-b",
                             pheno, "-r", str(chr_file), "-i", "3", "-y",
                             "2", "-l", "100", "-I", "2", "-H", "2", "-M",
                             "0.0"], "case2")
    assert trees["torch"]["binary_table_vcf.tsv"].count(b"\n") == 4
    assert trees["torch"] == trees["jax"]


@pytest.mark.parametrize("case", ["no phenotype", "no vcf", "dist alone",
                                  "binary and eqtl", "nothing"])
def test_invalid_combinations_exit_1_with_stoat_tpus_message(tmp_path,
                                                             capsys, case):
    """Every combination outside stoat_tpu's three cases exits 1 with its
    message, and writes nothing (stoat_tpu/cli.py:146-169); a run without
    a phenotype is one of them, not an unported mode."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=40,
                         seed=5, n_chroms=2)
    s, v = ["-s", paths["snarl"]], ["-v", paths["vcf"]]
    argv = ["vcf", *{
        "no phenotype": [*s, *v],
        "no vcf": [*s, "-b", paths["binary"]],
        "dist alone": ["-d", paths["snarl"]],
        "binary and eqtl": [*s, *v, "-b", paths["binary"], "-e",
                            paths["qtl"], "-G", paths["gene_position"]],
        "nothing": []}[case]]
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--device", "cpu"])):
        out = tmp_path / name
        assert cli.main([*argv, "-o", str(out), *extra]) == 1
        err = capsys.readouterr().err
        assert INVALID in err and "Case 3 (snarl path decomposition)" in err
        assert "ROADMAP" not in err
        assert not out.exists()


def test_make_bed_threads_and_verbosity(tmp_path, capsys, monkeypatch):
    """-m is parsed and unused, -t sets the native cores' thread count
    and -V the log level, as in stoat_tpu; the table is the same bytes."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=20,
                         seed=2)
    monkeypatch.delenv("STOAT_THREADS", raising=False)
    argv = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-b",
            paths["binary"]]
    plain = _both(tmp_path, argv, "plain")
    capsys.readouterr()
    out = str(tmp_path / "flags")
    assert torch_cli.main([*argv, "-m", "-t", "3", "-V", "2", "-o", out,
                           "--device", "cpu"]) == 0
    assert os.environ["STOAT_THREADS"] == "3"
    assert "[INFO] Starting GWAS analysis" in capsys.readouterr().err
    assert _tree(out) == plain["jax"]
    assert torch_cli.main([*argv, "-V", "0", "-o", str(tmp_path / "quiet"),
                           "--device", "cpu"]) == 0
    assert "[INFO]" not in capsys.readouterr().err
