"""End-to-end pipeline tests: CLI -> output TSV vs the scalar oracle.

Runs the full `stoat vcf` flow (snarl file + VCF + phenotype) on a
synthetic fixture and cross-checks every output row against the independent
per-snarl scalar implementation in tests/reference_impl.py — the same
cross-validation strategy the reference uses (tests/regression/).

The JAX suite's tests (tests/test_end_to_end.py) on the port: its CLI runs
with ``--device cpu`` (:func:`cli_main`, which the other ported oracle
files share), and ``stoat_tpu``'s CLI runs the same command into a twin
directory, where it must write every file byte for byte.  The dual's
single pass, its covariates and the secondary dict's validation are
tests/test_torch_vcf_modes.py's.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stoat_tpu import cli as jax_cli
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.formatting import set_precision
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix

from fixtures import make_fixture
import reference_impl as R

CPU = torch.device("cpu")
# suffix of the directory (or file) that stoat_tpu's run of a command writes
TWIN = "_stoat_tpu"
# matplotlib's PNG bytes differ between the packages' runs; only their
# names are compared (tests/test_torch_plots.py)
IMAGE_EXTENSIONS = (".png", ".pdf", ".svg")


def twin_of(path: str) -> str:
    stem, ext = os.path.splitext(path)
    return f"{stem}{TWIN}{ext}" if ext else path + TWIN


def _files(root: str):
    if os.path.isfile(root):
        return {"": root}
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, names in os.walk(root) for f in names}


def assert_same_outputs(out: str, twin: str) -> None:
    """Every file under ``out`` (a directory or one file) is under
    ``twin`` with the same bytes, and no other."""
    ours, theirs = _files(out), _files(twin)
    assert sorted(ours) == sorted(theirs)
    for rel, path in ours.items():
        if path.endswith(IMAGE_EXTENSIONS):
            continue
        assert filecmp.cmp(path, theirs[rel], shallow=False), rel


def cli_main(argv) -> int:
    """``python -m stoat_tpu_torch`` on ``argv`` (``vcf`` and ``graph`` with
    ``--device cpu``), then ``python -m stoat_tpu`` on the same argv with
    the ``-o`` path, and every argument under it, moved to its twin
    (:func:`twin_of`): the same exit code, and the same files.  Returns
    the port's exit code."""
    argv = [str(a) for a in argv]
    extra = ["--device", "cpu"] if argv[0] in ("vcf", "graph") else []
    rc = torch_cli.main(argv + extra)
    out = argv[argv.index("-o") + 1].rstrip(os.sep)
    twin = twin_of(out)
    jargv = [twin if a == out else
             twin + a[len(out):] if a.startswith(out + os.sep) else a
             for a in argv]
    assert jax_cli.main(jargv) == rc
    if os.path.exists(out) or os.path.exists(twin):
        assert_same_outputs(out, twin)
    return rc


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp("gwas")
    return make_fixture(str(tmpdir)), str(tmpdir)


def _load_matrix(paths):
    reader = VcfReader(paths["vcf"])
    chunks = list(reader.chromosome_chunks())
    assert len(chunks) == 1
    _, records = chunks[0]
    m = EdgeHaplotypeMatrix(2 * len(paths["samples"]))
    for rec in records:
        m.add_record(rec)
    return m, m.shrink()


def _read_tsv(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh
                if line.rstrip("\n")]
    return header, {r[3]: r for r in rows}  # keyed by SNARL (+GENE later)


def fmt(p):
    return "NA" if (p != p) else set_precision(float(p))


def test_binary_end_to_end(fixture):
    paths, tmpdir = fixture
    out = os.path.join(tmpdir, "out_binary")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-b", paths["binary"], "-o", out])
    assert rc == 0
    header, rows = _read_tsv(os.path.join(out, "binary_table_vcf.tsv"))
    assert header == ["#CHR", "START_POS", "END_POS", "SNARL",
                      "PATH_LENGTHS", "P_FISHER", "P_CHI2", "GROUP_PATHS",
                      "DEPTH"]

    snarls = parse_snarl_path(paths["snarl"])["ref"]
    edge_matrix, M = _load_matrix(paths)
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    pheno, _ = parse_binary_pheno(paths["binary"], list(paths["samples"]))

    n_written = 0
    for snarl in snarls:
        ref = R.binary_reference(snarl, edge_matrix, M, pheno, 3, 5, 0.05)
        if ref is None:
            assert snarl.snarl_id_str not in rows
            continue
        n_written += 1
        pf, pc, g0k, g1k = ref
        row = rows[snarl.snarl_id_str]
        # chi2 string must match exactly; fisher via float tolerance
        # (scipy's exact test vs the PLINK scan agree to ~1e-6 relative)
        assert row[6] == fmt(pc), (snarl.snarl_id_str, row)
        if np.isnan(pf):
            assert row[5] == "NA"
        else:
            got = float(row[5]) if row[5] != "NA" else np.nan
            assert got == pytest.approx(pf, rel=1e-4), snarl.snarl_id_str
        expected_groups = ",".join(
            f"{int(a)}:{int(b)}" for a, b in zip(g0k, g1k))
        assert row[7] == expected_groups
        assert row[4] == snarl.type_var_str
    assert n_written == len(rows)
    assert n_written > 0


def test_quantitative_end_to_end(fixture):
    paths, tmpdir = fixture
    out = os.path.join(tmpdir, "out_quant")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-q", paths["quantitative"], "-o", out])
    assert rc == 0
    header, rows = _read_tsv(os.path.join(out, "quantitative_table_vcf.tsv"))
    assert header[:6] == ["#CHR", "START_POS", "END_POS", "SNARL",
                          "PATH_LENGTHS", "P"]

    snarls = parse_snarl_path(paths["snarl"])["ref"]
    edge_matrix, M = _load_matrix(paths)
    from stoat_tpu_torch.io.phenotype import parse_quantitative_pheno
    pheno = parse_quantitative_pheno(paths["quantitative"],
                                     list(paths["samples"]))

    n_written = 0
    for snarl in snarls:
        ref = R.quantitative_reference(snarl, edge_matrix, M, pheno, None,
                                       3, 5, 0.05)
        if ref is None:
            assert snarl.snarl_id_str not in rows
            continue
        n_written += 1
        row = rows[snarl.snarl_id_str]
        if ref == "degenerate":
            assert row[5] == "NA"
            continue
        p, b, s, r2, allele_paths = ref
        assert row[5] == fmt(p), (snarl.snarl_id_str, row)
        assert row[6] == fmt(r2)
        assert row[7] == fmt(b)
        assert row[8] == fmt(s)
        assert row[9] == ",".join(str(int(x)) for x in allele_paths)
    assert n_written == len(rows)
    assert n_written > 0


def test_quantitative_covar_end_to_end(fixture):
    paths, tmpdir = fixture
    out = os.path.join(tmpdir, "out_quant_covar")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-q", paths["quantitative"], "-c", paths["covariate"],
                   "-C", "AGE,SEX", "-o", out])
    assert rc == 0
    _, rows = _read_tsv(os.path.join(out, "quantitative_table_vcf.tsv"))

    snarls = parse_snarl_path(paths["snarl"])["ref"]
    edge_matrix, M = _load_matrix(paths)
    from stoat_tpu_torch.io.phenotype import (parse_covariates,
                                              parse_quantitative_pheno)
    pheno = parse_quantitative_pheno(paths["quantitative"],
                                     list(paths["samples"]))
    covar = parse_covariates(paths["covariate"], ["AGE", "SEX"],
                             list(paths["samples"]))

    checked = 0
    for snarl in snarls:
        ref = R.quantitative_reference(snarl, edge_matrix, M, pheno, covar,
                                       3, 5, 0.05)
        if ref is None or ref == "degenerate":
            continue
        p, b, s, r2, _ = ref
        row = rows[snarl.snarl_id_str]
        assert row[5] == fmt(p), (snarl.snarl_id_str, row)
        assert row[7] == fmt(b)
        checked += 1
    assert checked > 0


def test_binary_covar_end_to_end(fixture):
    paths, tmpdir = fixture
    out = os.path.join(tmpdir, "out_binary_covar")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-b", paths["binary"], "-c", paths["covariate"],
                   "-C", "AGE,SEX", "-o", out])
    assert rc == 0
    header, rows = _read_tsv(os.path.join(out, "binary_table_vcf.tsv"))
    assert header == ["#CHR", "START_POS", "END_POS", "SNARL",
                      "PATH_LENGTHS", "P", "BETA", "SE", "ALLELE_PATHS",
                      "DEPTH"]

    snarls = parse_snarl_path(paths["snarl"])["ref"]
    edge_matrix, M = _load_matrix(paths)
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    pheno, _ = parse_binary_pheno(paths["binary"], list(paths["samples"]))

    checked = 0
    for snarl in snarls:
        ref = R.binary_covar_reference(snarl, edge_matrix, M, pheno,
                                       3, 5, 0.05)
        if ref is None:
            assert snarl.snarl_id_str not in rows
            continue
        row = rows[snarl.snarl_id_str]
        if ref == "degenerate" or ref[0] == "NA":
            assert row[5] == "NA"
            continue
        p, b, s, allele_paths = ref
        assert row[5] == fmt(p), (snarl.snarl_id_str, row)
        assert row[6] == fmt(b)
        assert row[7] == fmt(s)
        assert row[8] == ",".join(str(int(x)) for x in allele_paths)
        checked += 1
    assert checked > 0


def test_eqtl_end_to_end(fixture):
    paths, tmpdir = fixture
    out = os.path.join(tmpdir, "out_eqtl")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-e", paths["qtl"], "-G", paths["gene_position"],
                   "-o", out])
    assert rc == 0
    with open(os.path.join(out, "eqtl_table_vcf.tsv")) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = {}
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            rows[(cols[3], cols[5])] = cols  # (SNARL, GENE)
    assert header[5] == "GENE"

    snarls = parse_snarl_path(paths["snarl"])["ref"]
    edge_matrix, M = _load_matrix(paths)
    from stoat_tpu_torch.io.phenotype import parse_qtl_gene_file
    eqtl_map = parse_qtl_gene_file(paths["qtl"], paths["gene_position"],
                                   list(paths["samples"]))
    gene_list = eqtl_map["ref"]

    checked = 0
    for snarl in snarls:
        n_samples = len(paths["samples"])
        df, used_idx, allele_paths = R.quantitative_table(
            snarl, edge_matrix, M, n_samples)
        if R.filtration_quantitative(df, 3, 5, 0.05):
            continue
        df2 = R.combine_identical_columns(df)[:, :-1]
        if df2.shape[1] == 0:
            continue
        lo = snarl.start_pos - 1000000 if snarl.start_pos > 1000000 else 0
        hi = snarl.end_pos + 1000000
        for g in gene_list:
            if g.end_pos < lo or g.start_pos > hi:
                continue
            y = g.sample_expression[used_idx]
            p, b, s, r2 = R.ols_reference(df2, y, None)
            row = rows[(snarl.snarl_id_str, g.gene_name)]
            assert row[6] == fmt(p), (snarl.snarl_id_str, g.gene_name)
            assert row[8] == fmt(b)
            checked += 1
    assert checked > 0


def test_dual_phenotype_api_contract(tmp_path, monkeypatch):
    """run_vcf_analysis called per its OWN documented contract: the
    secondary phenotype lives in the ``secondary`` dict, and the primary
    phenotype is the binary one.  The fused chunk call
    (``dual_analyze_chromosome``) runs, and the tables are those of two
    separate CLI runs and of stoat_tpu's library call."""
    import stoat_tpu_torch.pipeline.runner as runner_mod
    from stoat_tpu.pipeline.runner import run_vcf_analysis as jax_run
    from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                              parse_quantitative_pheno)

    paths = make_fixture(str(tmp_path), n_samples=30, n_snarls=40, seed=11)
    reader = VcfReader(paths["vcf"])
    samples = list(reader.samples)
    reader.close()
    binary_phenotype, _ = parse_binary_pheno(paths["binary"], samples)
    quantitative_phenotype = parse_quantitative_pheno(
        paths["quantitative"], samples)
    snarls_chr = parse_snarl_path(paths["snarl"])

    fused_calls = []
    real_fused = runner_mod.dual_analyze_chromosome

    def spy(*args, **kwargs):
        fused_calls.append(1)
        return real_fused(*args, **kwargs)

    monkeypatch.setattr(runner_mod, "dual_analyze_chromosome", spy)

    out = tmp_path / "out_api"
    out.mkdir()
    bin_tsv = out / "binary_table_vcf.tsv"
    quant_tsv = out / "quantitative_table_vcf.tsv"
    runner_mod.run_vcf_analysis(
        paths["vcf"], snarls_chr, str(bin_tsv), binary_phenotype, CPU,
        mode="binary",
        secondary={
            "mode": "quantitative",
            "output_tsv": str(quant_tsv),
            "quantitative_phenotype": quantitative_phenotype,
        },
        sample_names=samples)
    assert fused_calls, "the fused dual chunk call did not run"

    twin = tmp_path / "out_api_jax"
    twin.mkdir()
    jax_run(paths["vcf"], snarls_chr, str(twin / bin_tsv.name), "binary",
            binary_phenotype=binary_phenotype,
            secondary={"mode": "quantitative",
                       "output_tsv": str(twin / quant_tsv.name),
                       "quantitative_phenotype": quantitative_phenotype},
            use_mesh=False, sample_names=samples)
    # Same outputs as two independent CLI runs.
    for name, args_extra in (("bin", ["-b", paths["binary"]]),
                             ("quant", ["-q", paths["quantitative"]])):
        o = tmp_path / f"out_{name}"
        rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                       *args_extra, "-o", str(o)])
        assert rc == 0
    for tsv, solo in ((bin_tsv, "out_bin"), (quant_tsv, "out_quant")):
        assert filecmp.cmp(tsv, tmp_path / solo / tsv.name, shallow=False)
        assert filecmp.cmp(tsv, twin / tsv.name, shallow=False)
