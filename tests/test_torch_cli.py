"""End-to-end parity: ``python -m stoat_tpu_torch vcf -b|-q ... --device
cpu`` (with or without ``-c -C``) writes the same bytes as ``python -m
stoat_tpu vcf -b|-q ...``.

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
QTSV = "quantitative_table_vcf.tsv"


def _args(paths, out, *extra):
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-b",
            paths["binary"], "-o", out, *extra]


def _mode_args(mode, paths, out, *extra):
    """(argv, table name) of a run in ``mode``: "b" (binary), "bc" (binary
    with the AGE and SEX covariates: logistic regression), "q"
    (quantitative) or "qc" (quantitative with the covariates)."""
    covar = (["-c", paths["covariate"], "-C", "AGE,SEX"]
             if mode in ("bc", "qc") else [])
    if mode in ("b", "bc"):
        return _args(paths, out, *covar, *extra), TSV
    return (["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-q",
             paths["quantitative"], *covar, "-o", out, *extra], QTSV)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("n_samples,n_chroms,mode", [
    pytest.param(n, c, mode, id=f"{n}-{c}" + ("" if mode == "b" else
                                                f"-{mode}"))
    for mode in ("b", "bc", "q", "qc") for n, c in ((40, 1), (200, 2))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cli_byte_identical(tmp_path, seed, n_samples, n_chroms, mode):
    paths = make_fixture(str(tmp_path / "data"), n_samples=n_samples,
                         n_snarls=40, seed=seed, n_chroms=n_chroms)
    jax_out = str(tmp_path / "jax")
    torch_out = str(tmp_path / "torch")
    argv, table = _mode_args(mode, paths, jax_out)
    assert jax_cli.main(argv) == 0
    argv, _ = _mode_args(mode, paths, torch_out, "--device", "cpu")
    assert torch_cli.main(argv) == 0
    want = _read(os.path.join(jax_out, table))
    assert want.count(b"\n") > 10          # rows, not just the header
    assert _read(os.path.join(torch_out, table)) == want


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
    _resume_after_interrupt(tmp_path, monkeypatch, "b")


def test_cli_quantitative_resume_after_interrupt(tmp_path, monkeypatch):
    """--resume of a ``vcf -q -c -C AGE,SEX`` run."""
    _resume_after_interrupt(tmp_path, monkeypatch, "qc")


def test_cli_binary_covar_resume_after_interrupt(tmp_path, monkeypatch):
    """--resume of a ``vcf -b -c -C AGE,SEX`` run."""
    _resume_after_interrupt(tmp_path, monkeypatch, "bc")


def _resume_after_interrupt(tmp_path, monkeypatch, mode):
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=36,
                         seed=2, n_chroms=3)
    jax_out = str(tmp_path / "jax")
    argv, table = _mode_args(mode, paths, jax_out)
    assert jax_cli.main(argv) == 0

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
        torch_cli.main(_mode_args(mode, paths, torch_out, "--device",
                                  "cpu")[0])
    tsv = os.path.join(torch_out, table)
    progress = torch_runner._read_progress(tsv)
    assert list(progress) == seen[:1]

    seen.clear()
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome",
                        _spy(real, seen))
    assert torch_cli.main(_mode_args(mode, paths, torch_out, "--device",
                                     "cpu", "--resume")[0]) == 0
    assert seen == ["ref1", "ref2"]
    assert _read(tsv) == _read(os.path.join(jax_out, table))


def _spy(real, seen):
    def spy(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        return real(outf, output_tsv, chrom, *a, **k)
    return spy


@pytest.mark.parametrize("argv", [
    ["vcf", "-g"], ["simulate"],
    ["vcf", "--gaf"], ["plot", "manhattan"], ["BHcorrect", "-t", "x"],
    ["vcf", "--no-such-flag"], ["truth"], ["BHcorrect"],
    ["simulate", "-o", "x"], ["plot", "qq"]])
def test_unported_modes_exit_nonzero_naming_roadmap(argv, tmp_path, capsys,
                                                    monkeypatch):
    """The argvs that the port once refused (the GAF output, the simulate,
    truth, BHcorrect and plot subcommands) now run as stoat_tpu runs them,
    each package from its own directory: the same exit code, the same
    error text (argparse's, or stoat_tpu's logged message) and, for
    ``simulate``, the same files byte for byte.  An option that
    stoat_tpu's vcf does not have either stays refused with argparse's
    code, naming the option."""
    runs = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        try:
            rc = cli.main(list(argv))
        except SystemExit as e:
            rc = e.code
        err = capsys.readouterr().err
        text = [line.split("error: ")[-1] for line in err.splitlines()
                if line and not line.startswith(("usage:", " "))]
        files = {os.path.relpath(os.path.join(d, f), tmp_path / name):
                 _read(os.path.join(d, f))
                 for d, _, fs in os.walk(tmp_path / name) for f in fs}
        runs[name] = (rc, text, files)
    assert runs["torch"][0] == runs["jax"][0]
    assert "ROADMAP.md" not in " ".join(runs["torch"][1])
    if argv[1:] == ["--no-such-flag"]:
        assert runs["torch"][0] == 2
        assert "unrecognized arguments: --no-such-flag" in \
            runs["jax"][1][-1]
        assert "unrecognized arguments: --no-such-flag" in \
            runs["torch"][1][-1]
        return
    assert runs["torch"][1] == runs["jax"][1]
    assert runs["torch"][2] == runs["jax"][2]
    if argv[0] == "simulate":
        assert runs["torch"][0] == 0 and len(runs["torch"][2]) == 6
    else:
        assert runs["torch"][0] != 0 and runs["torch"][1]
        assert not runs["torch"][2]


@pytest.mark.parametrize("case", ["lmm without -k", "lmm with -b",
                                  "lmm with -b -q"])
def test_lmm_flag_rules_exit_before_any_output(tmp_path, case):
    """--lmm needs -k and a quantitative phenotype alone
    (stoat_tpu/cli.py:219-221, 240-242): the port exits non-zero before it
    writes anything, on either device."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=8,
                         seed=1)
    kin = str(tmp_path / "kin.tsv")
    with open(kin, "w") as fh:
        fh.write("id\t" + "\t".join(paths["samples"]) + "\n")
    pheno = {"lmm without -k": ["-q", paths["quantitative"]],
             "lmm with -b": ["-b", paths["binary"], "-k", kin],
             "lmm with -b -q": ["-b", paths["binary"], "-q",
                                paths["quantitative"], "-k", kin]}[case]
    out = tmp_path / "out"
    for device in ("cpu", "cuda"):
        with pytest.raises(SystemExit) as e:
            torch_cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                            *pheno, "--lmm", "-o", str(out), "--device",
                            device])
        assert e.value.code not in (0, None) and "--lmm requires" in \
            str(e.value.code)
        assert not out.exists()


def test_covariate_needs_its_column_names(tmp_path):
    """-c without -C is an error, as in stoat_tpu/cli.py:136-140."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=8,
                         seed=1)
    argv, _ = _mode_args("q", paths, str(tmp_path / "out"), "-c",
                         paths["covariate"], "--device", "cpu")
    assert torch_cli.main(argv) == 1
    assert jax_cli.main(argv[:-2]) == 1
    assert not (tmp_path / "out").exists()


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
