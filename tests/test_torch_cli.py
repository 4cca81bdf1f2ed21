"""End-to-end parity: ``python -m stoat_tpu_torch vcf -b ... --device cpu``
writes the same bytes as ``python -m stoat_tpu vcf -b ...``.

Both CLIs run in process, through each package's ``cli.main``, on
fixtures made by ``tests/fixtures.make_fixture`` from a seed.
"""

import importlib.util
import os

import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.pipeline import runner as torch_runner

TSV = "binary_table_vcf.tsv"


def _args(paths, out, *extra):
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-b",
            paths["binary"], "-o", out, *extra]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("n_samples,n_chroms", [(40, 1), (200, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cli_byte_identical(tmp_path, seed, n_samples, n_chroms):
    paths = make_fixture(str(tmp_path / "data"), n_samples=n_samples,
                         n_snarls=40, seed=seed, n_chroms=n_chroms)
    jax_out = str(tmp_path / "jax")
    torch_out = str(tmp_path / "torch")
    assert jax_cli.main(_args(paths, jax_out)) == 0
    assert torch_cli.main(_args(paths, torch_out, "--device", "cpu")) == 0
    want = _read(os.path.join(jax_out, TSV))
    assert want.count(b"\n") > 10          # rows, not just the header
    assert _read(os.path.join(torch_out, TSV)) == want


def _chip_smoke():
    """chip_smoke.py at the root of the repository, as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed,n_samples,n_chroms,thresholds", [
    (0, 40, 1, (3, 5, 0.05)), (1, 200, 2, (3, 5, 0.05)),
    (2, 60, 2, (59, 5, 0.3))])
def test_smoke_reference_rows_match_stoat_tpu(tmp_path, seed, n_samples,
                                              n_chroms, thresholds):
    """chip_smoke.py checks the card's TSV row by row against a numpy
    reference built from the VCF text; that reference writes the rows
    stoat_tpu writes, filtered snarls included."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=n_samples,
                         n_snarls=40, seed=seed, n_chroms=n_chroms)
    min_ind, min_hap, maf = thresholds
    out = str(tmp_path / "jax")
    assert jax_cli.main(_args(paths, out, "-I", str(min_ind), "-H",
                              str(min_hap), "-M", str(maf))) == 0
    lines = _read(os.path.join(out, TSV)).decode().splitlines()[1:]
    want = [(c[0], c[3], c[7]) for c in (l.split("\t") for l in lines)]
    rows, filtered = _chip_smoke().reference_rows(paths, min_ind, min_hap,
                                                  maf)
    assert rows == want
    assert len(rows) + len(filtered) == 40
    if thresholds[0] == 59:
        assert rows and filtered           # the filter really ran


def test_cli_thresholds_byte_identical(tmp_path):
    """-M/-I/-H reach the filter exactly as in stoat_tpu."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=30,
                         seed=5)
    extra = ["-M", "0.2", "-I", "20", "-H", "50"]
    assert jax_cli.main(_args(paths, str(tmp_path / "j"), *extra)) == 0
    assert torch_cli.main(_args(paths, str(tmp_path / "t"), *extra,
                                "--device", "cpu")) == 0
    assert _read(str(tmp_path / "t" / TSV)) == \
        _read(str(tmp_path / "j" / TSV))


def test_cli_resume_after_interrupt(tmp_path, monkeypatch):
    """A run cut after its first chromosome, resumed with --resume, ends
    byte-identical to stoat_tpu, without analysing that chromosome
    again."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=36,
                         seed=2, n_chroms=3)
    jax_out = str(tmp_path / "jax")
    assert jax_cli.main(_args(paths, jax_out)) == 0

    real = torch_runner._dispatch_chromosome
    seen = []

    def crash_after_first(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        if len(seen) == 2:
            raise RuntimeError("simulated crash")
        return real(outf, output_tsv, chrom, *a, **k)

    torch_out = str(tmp_path / "torch")
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome",
                        crash_after_first)
    with pytest.raises(RuntimeError, match="simulated crash"):
        torch_cli.main(_args(paths, torch_out, "--device", "cpu"))
    tsv = os.path.join(torch_out, TSV)
    progress = torch_runner._read_progress(tsv)
    assert list(progress) == seen[:1]

    seen.clear()
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome",
                        _spy(real, seen))
    assert torch_cli.main(_args(paths, torch_out, "--device", "cpu",
                                "--resume")) == 0
    assert seen == ["ref1", "ref2"]
    assert _read(tsv) == _read(os.path.join(jax_out, TSV))


def _spy(real, seen):
    def spy(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        return real(outf, output_tsv, chrom, *a, **k)
    return spy


@pytest.mark.parametrize("argv", [
    ["vcf", "-q", "x"], ["vcf", "-c", "x", "-C", "AGE"], ["vcf", "--lmm"],
    ["vcf", "--permutations", "10"], ["vcf", "-T", "0.01"],
    ["vcf", "--no-such-flag"], ["graph"], ["BHcorrect"]])
def test_unported_modes_exit_nonzero_naming_roadmap(argv, capsys):
    assert torch_cli.main(argv) != 0
    assert "ROADMAP.md" in capsys.readouterr().err


def test_cli_decomposition_case2_byte_identical(tmp_path):
    """-p/-d: the reused decomposition feeds the port's GWAS; both the
    snarl file and the binary table match stoat_tpu's."""
    from test_cli_decompose import build_fixture

    gfa, dist, vcf, pheno = build_fixture(tmp_path, n_samples=60, seed=3)
    outs = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert cli.main(["vcf", "-p", gfa, "-d", dist, "-v", vcf, "-b",
                         pheno, "-o", out, *extra]) == 0
        outs[name] = {f: _read(os.path.join(out, f))
                      for f in ("snarl_analyse.tsv", TSV)}
    assert outs["torch"][TSV].count(b"\n") > 1
    assert outs["torch"] == outs["jax"]
