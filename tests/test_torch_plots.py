"""``plot`` in the port (``stoat_tpu_torch/plots.py``) against stoat_tpu's:
the same p-values read from a results TSV, and the same file names written
for every plot kind (PNG bytes may differ).

Ports tests/test_cli_extras.py's test_plot_subcommand and
test_plot_histogram_scatter_report.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu import plots as jax_plots
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch import plots as torch_plots


def _report_tsv(path):
    with open(path, "w") as fh:
        fh.write("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tP\n")
        for i in range(40):
            fh.write(f"ref\t{100+i*10}\t{105+i*10}\t{i}_{i+1}\t1,1\t"
                     f"{0.01 + 0.02*i:.4f}\n")
    return str(path)


def test_plot_subcommand(tmp_path):
    """tests/test_cli_extras.py:125 on the port: qq, manhattan and boxplot
    write PNGs from a ``vcf -q -T 1.0`` run of the port."""
    pytest.importorskip("matplotlib")
    paths = make_fixture(str(tmp_path), n_samples=24, n_snarls=10, seed=11)
    out = str(tmp_path / "res")
    assert torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                           "-q", paths["quantitative"], "-T", "1.0", "-o",
                           out, "--device", "cpu"]) == 0
    tsv = os.path.join(out, "quantitative_table_vcf.tsv")
    tables = os.path.join(out, "regression")
    assert os.listdir(tables), "no -T tables dumped"

    qq = str(tmp_path / "qq.png")
    man = str(tmp_path / "man.png")
    box = str(tmp_path / "box")
    assert torch_cli.main(["plot", "qq", "-t", tsv, "-o", qq]) == 0
    assert torch_cli.main(["plot", "manhattan", "-t", tsv, "-o", man]) == 0
    assert torch_cli.main(["plot", "boxplot", "-d", tables,
                           "-p", paths["quantitative"], "-o", box]) == 0
    for f in (qq, man):
        with open(f, "rb") as fh:
            assert fh.read(8).startswith(b"\x89PNG")
    boxes = os.listdir(box)
    assert boxes
    with open(os.path.join(box, boxes[0]), "rb") as fh:
        assert fh.read(8).startswith(b"\x89PNG")


def test_plot_histogram_scatter_report(tmp_path):
    """tests/test_cli_extras.py:157 on the port."""
    pytest.importorskip("matplotlib")
    tsv = _report_tsv(tmp_path / "r.tsv")
    out1 = tmp_path / "h.png"
    assert torch_cli.main(["plot", "histogram", "-t", tsv, "-o", str(out1),
                           "--x-col", "5", "--bins", "10"]) == 0
    assert out1.stat().st_size > 0
    out2 = tmp_path / "s.png"
    assert torch_cli.main(["plot", "scatter", "-t", tsv, "-o", str(out2),
                           "--x-col", "1", "--y-col", "5", "--color-col",
                           "0"]) == 0
    assert out2.stat().st_size > 0
    rep = tmp_path / "rep"
    assert torch_cli.main(["plot", "report", "-t", tsv, "-o", str(rep)]) == 0
    made = sorted(p.name for p in rep.iterdir())
    assert made == ["report_manhattan.png", "report_pvalue_hist.png",
                    "report_qq.png"]


@pytest.mark.parametrize("mode,column", [
    ("b", None), ("b", "P_CHI2"), ("q", None), ("q", "RSQUARE")])
def test_read_pvalues_equal_stoat_tpu(tmp_path, mode, column):
    """read_pvalues gives stoat_tpu's arrays on a port table (with NA
    rows: a binary table's filtered snarls)."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=40,
                         seed=5, n_chroms=2)
    flag = ["-b", paths["binary"]] if mode == "b" else \
        ["-q", paths["quantitative"]]
    out = str(tmp_path / "out")
    assert torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                           *flag, "-o", out, "--device", "cpu"]) == 0
    tsv = os.path.join(out, "binary_table_vcf.tsv" if mode == "b"
                       else "quantitative_table_vcf.tsv")
    ours = torch_plots.read_pvalues(tsv, column)
    theirs = jax_plots.read_pvalues(tsv, column)
    assert ours[0].tobytes() == theirs[0].tobytes() and ours[0].size > 10
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[2], theirs[2])
    with pytest.raises(ValueError, match="NOPE"):
        torch_plots.read_pvalues(tsv, "NOPE")


KINDS = {
    "qq": lambda tsv, tables, pheno, out: ["-t", tsv, "-o", out + ".png"],
    "manhattan": lambda tsv, tables, pheno, out: ["-t", tsv, "-o",
                                                  out + ".png"],
    "boxplot": lambda tsv, tables, pheno, out: ["-d", tables, "-p", pheno,
                                                "-o", out],
    "histogram": lambda tsv, tables, pheno, out: ["-t", tsv, "-o",
                                                  out + ".png", "--x-col",
                                                  "5", "--log-y"],
    "scatter": lambda tsv, tables, pheno, out: ["-t", tsv, "-o",
                                                out + ".png", "--x-col", "1",
                                                "--y-col", "5"],
    "report": lambda tsv, tables, pheno, out: ["-t", tsv, "-o", out],
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plot_kinds_write_the_same_files(tmp_path, monkeypatch, kind):
    """Every ``plot`` kind through both CLIs, each from its own directory:
    the same exit code and the same file names."""
    pytest.importorskip("matplotlib")
    paths = make_fixture(str(tmp_path / "data"), n_samples=24, n_snarls=10,
                         seed=11)
    res = str(tmp_path / "res")
    assert torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                           "-q", paths["quantitative"], "-T", "1.0", "-o",
                           res, "--device", "cpu"]) == 0
    tsv = os.path.join(res, "quantitative_table_vcf.tsv")
    written = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        argv = KINDS[kind](tsv, os.path.join(res, "regression"),
                           paths["quantitative"], "plot")
        assert cli.main(["plot", kind, *argv]) == 0
        written[name] = sorted(
            os.path.relpath(os.path.join(d, f), tmp_path / name)
            for d, _, files in os.walk(tmp_path / name) for f in files)
    assert written["torch"] == written["jax"]
    assert written["torch"]


@pytest.mark.parametrize("argv", [
    ["plot", "boxplot", "-o", "x"], ["plot", "qq", "-o", "x.png"],
    ["plot", "violin", "-o", "x"], ["plot", "qq", "-t", "missing.tsv",
                                    "-o", "x.png"]])
def test_plot_errors_match_stoat_tpu(tmp_path, monkeypatch, capsys, argv):
    """Missing inputs and an unknown kind: the same exit code and error
    text in both packages."""
    monkeypatch.chdir(tmp_path)
    got = []
    for cli in (jax_cli, torch_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(list(argv))
        err = capsys.readouterr().err.strip().splitlines()
        code = e.value.code
        got.append((code, code if isinstance(code, str)
                    else err[-1].split("error: ")[-1]))
    assert got[0] == got[1]
    assert not os.listdir(tmp_path)
