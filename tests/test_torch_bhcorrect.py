"""``BHcorrect`` in the port: ``python -m stoat_tpu_torch BHcorrect`` and
its modules (``corrections.py``, ``post.py``) against stoat_tpu's on the
same inputs.

Ports tests/test_cli_extras.py's test_bhcorrect_subcommand and
test_adjusted_column_for_mode_matches_layouts; the adjustments are held
bitwise, the rewritten TSV and ``top_variant.tsv`` byte for byte.
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu import corrections as jax_corrections
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.corrections import adjust_pvalues_bh, adjusted_holm
from stoat_tpu_torch.formatting import set_precision, string_to_pvalue


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp("bh")
    return make_fixture(str(tmpdir), n_samples=40, n_snarls=14, seed=17)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_bhcorrect_subcommand(fixture, tmp_path):
    """tests/test_cli_extras.py:24 on the port: the adjusted column of a
    ``vcf -b`` table is set_precision of the BH adjustment of its P_CHI2
    column, and top_variant.tsv is written."""
    out = str(tmp_path / "bh")
    assert torch_cli.main(["vcf", "-s", fixture["snarl"], "-v",
                           fixture["vcf"], "-b", fixture["binary"], "-o",
                           out, "--device", "cpu"]) == 0
    tsv = os.path.join(out, "binary_table_vcf.tsv")
    with open(tsv) as fh:
        fh.readline()
        before = [line.rstrip("\n").split("\t") for line in fh
                  if line.strip()]
    raw_p = np.array([string_to_pvalue(r[6]) for r in before])
    expected_adj = adjust_pvalues_bh(raw_p)

    assert torch_cli.main(["BHcorrect", "-t", tsv, "-p", "7", "-a", "8",
                           "-o", out]) == 0
    with open(tsv) as fh:
        fh.readline()
        after = [line.rstrip("\n").split("\t") for line in fh
                 if line.strip()]
    assert len(after) == len(before) > 5
    for row, adj in zip(after, expected_adj):
        assert row[7] == set_precision(float(adj))
    assert os.path.exists(os.path.join(out, "top_variant.tsv"))


def test_adjusted_column_for_mode_matches_layouts():
    """tests/test_cli_extras.py:184: the mode -> adjusted-column map points
    at each layout's P column (0-indexed)."""
    from stoat_tpu_torch.post import adjusted_column_for_mode
    assert adjusted_column_for_mode("binary") == 6          # P_CHI2
    assert adjusted_column_for_mode("eqtl") == 6            # P
    assert adjusted_column_for_mode("quantitative") == 5    # P
    assert adjusted_column_for_mode("binary_covar") == 5
    with pytest.raises(ValueError):
        adjusted_column_for_mode("lmm")


def test_pinned_bh_oracle():
    """The reference's pinned example (post_processing_unit.cpp:12-46)."""
    got = adjust_pvalues_bh(np.array([0.01, 0.04, 0.03, 0.002, 0.05]))
    np.testing.assert_allclose(got, [0.025, 0.05, 0.05, 0.01, 0.05],
                               rtol=0, atol=1e-15)
    assert adjust_pvalues_bh(np.array([])).shape == (0,)


def _pvector(seed, n):
    """Uniform p-values with ties, exact zeros and ones."""
    rng = np.random.default_rng(seed)
    p = rng.random(n)
    p[rng.random(n) < 0.1] = 0.0
    p[rng.random(n) < 0.1] = 1.0
    tied = rng.random(n) < 0.3
    p[tied] = rng.choice(p, tied.sum())
    p[rng.random(n) < 0.05] = 1e-300
    return p


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 100), (3, 5000)])
def test_corrections_bitwise_stoat_tpu(seed, n):
    """adjust_pvalues_bh and adjusted_holm equal stoat_tpu's bit for bit,
    on one vector and (Holm) on a batch of rows."""
    p = _pvector(seed, n)
    for ours, theirs in (
            (adjust_pvalues_bh, jax_corrections.adjust_pvalues_bh),
            (adjusted_holm, jax_corrections.adjusted_holm)):
        a, b = ours(p), theirs(p)
        assert a.dtype == b.dtype == np.float64
        assert a.tobytes() == b.tobytes()
    batch = np.stack([_pvector(seed + 10 * k, n) for k in range(4)])
    assert adjusted_holm(batch).tobytes() == \
        jax_corrections.adjusted_holm(batch).tobytes()


def _table(mode, paths, out, cli, *device):
    covar = ["-c", paths["covariate"], "-C", "AGE,SEX"]
    pheno = {"b": ["-b", paths["binary"]],
             "q": ["-q", paths["quantitative"]],
             "b_c": ["-b", paths["binary"], *covar]}[mode]
    assert cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                     *pheno, "-o", out, *device]) == 0
    name = "quantitative" if mode == "q" else "binary"
    return os.path.join(out, f"{name}_table_vcf.tsv")


@pytest.mark.parametrize("mode,p_col,adj_col", [
    ("b", 7, 8), ("b", 6, 7), ("q", 6, 7), ("b_c", 6, 7)])
def test_rewritten_tsv_byte_identical(tmp_path, mode, p_col, adj_col):
    """BHcorrect through both CLIs, each on its own package's table of the
    same fixture (the tables are byte-identical): the rewritten TSV and
    top_variant.tsv are byte for byte stoat_tpu's."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=120,
                         n_snarls=60, seed=3, n_chroms=2)
    files = {}
    for name, cli, device in (("jax", jax_cli, ()),
                              ("torch", torch_cli, ("--device", "cpu"))):
        out = str(tmp_path / name)
        tsv = _table(mode, paths, out, cli, *device)
        files[name] = tsv
        assert cli.main(["BHcorrect", "-t", tsv, "-p", str(p_col), "-a",
                         str(adj_col), "-o", out, "-v", "top.tsv"]) == 0
    assert _read(files["torch"]) == _read(files["jax"])
    assert _read(files["torch"]).count(b"\n") > 40
    top = [_read(os.path.join(os.path.dirname(f), "top.tsv"))
           for f in (files["torch"], files["jax"])]
    assert top[0] == top[1]
    assert not os.path.exists(files["torch"] + ".bh_tmp")


def test_significant_rows_byte_identical(tmp_path):
    """A table with p-values far below 1e-5, NA cells and ties: both
    packages write the same rewritten TSV and the same significant rows."""
    rng = np.random.default_rng(4)
    header = "#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\tP_FISHER\t" \
             "P_CHI2\tGROUP_PATHS\tDEPTH\n"
    lines = []
    for i in range(300):
        p = ["NA", "0", "1", "1e-300", set_precision(rng.random() ** 12),
             "0.05"][i % 6]
        lines.append(f"ref\t{i}\t{i + 5}\t{i}_{i + 1}\t1,1\t{p}\t{p}\t"
                     f"3:4,5:6\t1\n")
    src = tmp_path / "t.tsv"
    src.write_text(header + "".join(lines))
    out = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(src, d / "t.tsv")
        assert cli.main(["BHcorrect", "-t", str(d / "t.tsv"), "-p", "7",
                         "-a", "8", "-o", str(d)]) == 0
        out[name] = (_read(d / "t.tsv"), _read(d / "top_variant.tsv"))
    assert out["torch"] == out["jax"]
    assert out["torch"][1].count(b"\n") > 50


@pytest.mark.parametrize("argv", [
    ["BHcorrect", "-t", "x.tsv", "-p", "7"],
    ["BHcorrect", "-t", "missing.tsv", "-p", "7", "-a", "8"],
    ["BHcorrect", "-t", "x.tsv", "-p", "seven", "-a", "8"]])
def test_bhcorrect_errors_match_stoat_tpu(tmp_path, argv, capsys,
                                          monkeypatch):
    """A missing flag, a missing file and a bad column: the same exit code
    and error text in both packages, and the TSV untouched."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "x.tsv").write_text("#CHR\tP\nref\t0.5\n")
    got = []
    for cli in (jax_cli, torch_cli):
        try:
            rc = cli.main(list(argv))
        except SystemExit as e:
            rc = e.code
        err = capsys.readouterr().err
        got.append((rc if isinstance(rc, int) else 1,
                    str(rc) if not isinstance(rc, int) else
                    err.strip().splitlines()[-1].split("error: ")[-1]))
    assert got[0] == got[1]
    assert got[0][0] != 0
    assert (tmp_path / "x.tsv").read_text() == "#CHR\tP\nref\t0.5\n"


@pytest.mark.parametrize("seed,n", [(5, 1), (6, 50), (7, 3000)])
def test_smoke_bh_reference_bitwise(seed, n):
    """chip_smoke.py's few-line BH (phase 4's check of BHcorrect on the
    card's machine) equals stoat_tpu's adjust_pvalues_bh bit for bit."""
    from test_torch_cli import _chip_smoke
    p = _pvector(seed, n)
    assert _chip_smoke().bh_reference(p).tobytes() == \
        jax_corrections.adjust_pvalues_bh(p).tobytes()
