"""CLI extras: multi-chromosome runs, -T significant tables,
chunked-vs-unchunked parity.

The JAX suite's tests (tests/test_cli_extras.py) on the port: its CLI on
the CPU, with ``stoat_tpu``'s writing the same files
(``test_torch_end_to_end.cli_main``).  BHcorrect and the mode's adjusted
column are tests/test_torch_bhcorrect.py's, ``plot`` tests/test_torch_
plots.py's, and ``-g`` from a GBZ tests/test_torch_gaf.py's.
"""

import filecmp
import os

import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from test_torch_end_to_end import CPU, cli_main


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp("extras")
    return make_fixture(str(tmpdir), n_samples=40, n_snarls=14, seed=17), \
        str(tmpdir)


def test_multi_chromosome(tmp_path):
    """Two chromosomes in one snarl file + VCF; both analyzed."""
    d1 = make_fixture(str(tmp_path / "c1"), n_samples=20, n_snarls=5,
                      seed=1, chrom="chr1")
    d2 = make_fixture(str(tmp_path / "c2"), n_samples=20, n_snarls=5,
                      seed=2, chrom="chr2")

    # merge snarl files
    snarl = tmp_path / "snarls.tsv"
    with open(snarl, "w") as out:
        with open(d1["snarl"]) as fh:
            out.write(fh.read())
        with open(d2["snarl"]) as fh:
            fh.readline()
            out.write(fh.read())

    # merge VCFs (samples identical by construction)
    vcf = tmp_path / "merged.vcf"
    with open(vcf, "w") as out:
        with open(d1["vcf"]) as fh:
            out.write(fh.read())
        with open(d2["vcf"]) as fh:
            for line in fh:
                if not line.startswith("#"):
                    out.write(line)

    out_dir = str(tmp_path / "out")
    rc = cli_main(["vcf", "-s", str(snarl), "-v", str(vcf),
                   "-b", d1["binary"], "-o", out_dir])
    assert rc == 0
    with open(os.path.join(out_dir, "binary_table_vcf.tsv")) as fh:
        fh.readline()
        chroms = {line.split("\t")[0] for line in fh if line.strip()}
    assert chroms == {"chr1", "chr2"}


def test_table_threshold_writes_regression_tables(fixture, tmp_path):
    paths, _ = fixture
    out = str(tmp_path / "tt")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-q", paths["quantitative"], "-o", out,
                   "-T", "1.0"])  # threshold 1.0: everything significant
    assert rc == 0
    reg_dir = os.path.join(out, "regression")
    assert os.path.isdir(reg_dir)
    tables = os.listdir(reg_dir)
    assert tables, "expected per-snarl regression tables"
    sample_table = os.path.join(reg_dir, tables[0])
    with open(sample_table) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh
                if line.strip()]
    assert header[0] == "sample_name"
    assert rows and all(len(r) == len(header) for r in rows)


def test_chunked_matches_unchunked(fixture, tmp_path):
    paths, _ = fixture
    from stoat_tpu.pipeline.runner import run_vcf_analysis as jax_run
    from stoat_tpu_torch.io import parse_binary_pheno, parse_snarl_path
    from stoat_tpu_torch.pipeline.runner import run_vcf_analysis

    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))

    out1 = str(tmp_path / "whole.tsv")
    out2 = str(tmp_path / "chunked.tsv")
    for out, chunk in ((out1, 8192), (out2, 3)):
        run_vcf_analysis(paths["vcf"], snarls_chr, out, pheno, CPU,
                         sample_names=samples, snarl_chunk_size=chunk)
    assert filecmp.cmp(out1, out2, shallow=False)
    twin = str(tmp_path / "jax.tsv")
    jax_run(paths["vcf"], snarls_chr, twin, "binary",
            binary_phenotype=pheno, sample_names=samples,
            snarl_chunk_size=3, use_mesh=False)
    assert filecmp.cmp(out2, twin, shallow=False)
