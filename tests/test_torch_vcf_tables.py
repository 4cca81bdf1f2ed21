"""The ``-T`` regression tables: the port's table view of the design and
its CLI against the JAX package.

The table view (norm = each kept column's dosage times the row's
reciprocal, and kept) of ``quant_design_plain`` is held bit for bit to
stoat_tpu's ``_design_packed_body`` on the same packed words.  Whole CLI
runs with ``-T`` (tests/test_cli_extras.py:87, in every mode) write
stoat_tpu's bytes: the main tables and every file under ``regression/``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu.pipeline import quantitative as jq
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.convert import DeviceChunk
from stoat_tpu_torch.pipeline import quantitative as tq
from stoat_tpu_torch.pipeline import runner as torch_runner
from test_torch_quant import _words_case
from test_torch_vcf_modes import write_kinship

TH = (3, 5, 0.05)
BT, QT = "binary_table_vcf.tsv", "quantitative_table_vcf.tsv"
ET, LT = "eqtl_table_vcf.tsv", "lmm_table_vcf.tsv"
COVAR = ["-C", "AGE,SEX"]
# each mode's phenotype flags, its tables, and whether it writes
# regression tables
MODES = {
    "q": (lambda p: ["-q", p["quantitative"]], (QT,), True),
    "qc": (lambda p: ["-q", p["quantitative"], "-c", p["covariate"],
                      *COVAR], (QT,), True),
    "bc": (lambda p: ["-b", p["binary"], "-c", p["covariate"], *COVAR],
           (BT,), True),
    "lmm": (lambda p: ["-q", p["quantitative"], "-k", p["kinship"],
                       "--lmm"], (LT,), True),
    "bq": (lambda p: ["-b", p["binary"], "-q", p["quantitative"]],
           (BT, QT), True),
    "b": (lambda p: ["-b", p["binary"]], (BT,), False),
    "e": (lambda p: ["-e", p["qtl"], "-G", p["gene_position"]], (ET,),
          False),
}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _tree(directory):
    """{file name: bytes} of a directory."""
    return {name: _read(os.path.join(directory, name))
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("all_rows", [False, True])
@pytest.mark.parametrize("seed,H,C", [(0, 80, 0), (1, 96, 2), (2, 46, 1)])
def test_table_view_matches_jax(seed, H, C, all_rows):
    """norm and kept of the plain design, bit for bit, on random packed
    words and snarls with -1 padding, empty and invalid paths; the design
    itself is unchanged by the table view."""
    words, idx, valid = _words_case(seed, H=H)
    rng = np.random.default_rng(seed + 30)
    P, S, Pmax = idx.shape[0], 48, 5
    sidx = rng.integers(0, P, (S, Pmax)).astype(np.int32)
    sidx[np.arange(Pmax)[None, :] >= rng.integers(1, Pmax + 1, S)[:, None]] \
        = -1
    covar = rng.standard_normal((H // 2, C))
    want = jq._design_packed_body(
        jnp.asarray(words), jnp.asarray(idx), jnp.asarray(valid),
        jnp.asarray(sidx), jnp.asarray(covar), *map(jnp.float64, TH),
        n_haplotypes=H, with_covar=C > 0, all_rows=all_rows)
    chunk = DeviceChunk(torch.from_numpy(words.view(np.int32).copy()),
                        torch.from_numpy(idx), torch.from_numpy(valid),
                        torch.from_numpy(sidx))
    got = tq.quant_design_plain(chunk, torch.from_numpy(covar), *TH, H,
                                all_rows=all_rows, tables=True)
    norm, jnorm = got["norm"].numpy(), np.asarray(want["norm"])
    assert norm.shape == (S, H // 2, Pmax) and norm.dtype == np.float64
    np.testing.assert_array_equal(norm.view(np.uint64),
                                  jnorm.view(np.uint64))
    np.testing.assert_array_equal(got["kept"].numpy(),
                                  np.asarray(want["kept"]))
    assert got["kept"].any() and not got["kept"].all()
    plain = tq.quant_design_plain(chunk, torch.from_numpy(covar), *TH, H,
                                  all_rows=all_rows)
    assert sorted(plain) == sorted(tq.DESIGN_KEYS)
    for key in tq.DESIGN_KEYS:
        assert torch.equal(got[key], plain[key]), key


@pytest.mark.parametrize("threshold", ["1.0", "0.05"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_table_threshold_cli_byte_identical(tmp_path, mode, threshold):
    """``vcf ... -T t`` with both CLIs: the main tables and the list and
    bytes of ``regression/`` equal stoat_tpu's.  At t = 1.0 every tested
    snarl of a regression mode has a table; ``-b`` and eQTL make the
    directory and write none."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=30,
                         seed=17, n_chroms=2)
    paths["kinship"] = write_kinship(tmp_path / "kin.tsv", paths["samples"])
    pheno, tables, regression = MODES[mode]
    argv = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], *pheno(paths),
            "-T", threshold]
    outs = {}
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("torch", torch_cli, ["--device", "cpu"])):
        outs[pkg] = str(tmp_path / pkg)
        assert cli.main([*argv, "-o", outs[pkg], *extra]) == 0
    for table in tables:
        want = _read(os.path.join(outs["jax"], table))
        assert want.count(b"\n") > 5, table
        assert _read(os.path.join(outs["torch"], table)) == want, table
    want = _tree(os.path.join(outs["jax"], "regression"))
    assert _tree(os.path.join(outs["torch"], "regression")) == want
    if regression and threshold == "1.0":
        assert len(want) > 5
        assert all(t.startswith(b"sample_name\t") for t in want.values())
    if not regression:
        assert want == {}


def test_table_threshold_gathers_only_significant_rows(tmp_path,
                                                       monkeypatch):
    """With -T the runner copies the table view's rows of the snarls that
    pass the threshold, and no others: at t = 0.05 fewer rows than
    snarls, each one's P below t."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=40,
                         seed=3)
    asked = []
    real = torch_runner._write_quant_family

    def spy(outf, chrom, snarls, res, **k):
        rows = res.tables.rows
        res.tables.rows = lambda s: (asked.append(
            [float(res["p"][i]) for i in s]), rows(s))[1]
        return real(outf, chrom, snarls, res, **k)
    monkeypatch.setattr(torch_runner, "_write_quant_family", spy)
    out = str(tmp_path / "out")
    assert torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                           "-q", paths["quantitative"], "-T", "0.05", "-o",
                           out, "--device", "cpu"]) == 0
    gathered = [p for chunk in asked for p in chunk]
    assert 0 < len(gathered) < 40 and all(p < 0.05 for p in gathered)
    assert len(os.listdir(os.path.join(out, "regression"))) == len(gathered)


@pytest.mark.parametrize("threshold", ["0", "1.5", "-0.5"])
def test_table_threshold_out_of_range(tmp_path, threshold):
    """-T outside (0, 1] is refused before any output, as stoat_tpu
    refuses it (stoat_tpu/cli.py:125-126)."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=8,
                         seed=1)
    argv = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-q",
            paths["quantitative"], "-T", threshold, "-o",
            str(tmp_path / "out")]
    for cli, extra in ((jax_cli, []), (torch_cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=r"Table threshold must be in"):
            cli.main([*argv, *extra])
    assert not (tmp_path / "out").exists()
