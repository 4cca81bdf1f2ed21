"""The generator's files, read by the port's own readers, have
tests/fixtures.py make_fixture's formats and shapes."""

import os

import numpy as np
import pytest

from gwasbench.inputs import vcf_cohort

from gwasbench.tests.gwasbench_tiny import CELLS, TINY, tiny_cell


def tiny_config(**more):
    return dict(tiny_cell(CELLS[0]).config, **more)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    out = tmp_path_factory.mktemp("cohort")
    return vcf_cohort.make(tiny_config(), 12345, str(out))


def test_snarl_file_as_the_port_reads_it(cohort):
    from stoat_tpu_torch.io import parse_snarl_path
    snarls = parse_snarl_path(cohort.paths["snarl"])
    assert list(snarls) == ["ref0", "ref1"]
    flat = snarls["ref0"] + snarls["ref1"]
    assert len(flat) == cohort.n_snarls
    for s, sn in enumerate(flat):
        assert sn.path_strings == cohort.path_strings[s]
        assert sn.type_var_str == cohort.types[s]
        assert sn.start_pos == cohort.pos[s]
        assert sn.snarl_id_str == cohort.snarl_id(s)
        assert 2 <= len(sn.path_strings) <= 4
    nested = [s for s in range(cohort.n_snarls) if s % 5 == 3]
    assert all(cohort.path_strings[s][0].count(">") == 2 for s in nested)
    assert all(">0>" in cohort.path_strings[s][1] for s in nested)


def test_vcf_as_the_port_reads_it(cohort):
    from stoat_tpu_torch.io.vcf import VcfReader
    reader = VcfReader(cohort.paths["vcf"])
    assert reader.samples == cohort.samples
    n = 0
    for chrom, records in reader.chromosome_chunks():
        for rec in records:
            assert chrom == cohort.chroms[cohort.chrom_of[n]]
            assert rec.at_paths == cohort.path_strings[n]
            n += 1
    reader.close()
    assert n == cohort.n_snarls


def test_vcf_text_matches_the_fixture_layout(cohort, tmp_path):
    """Header lines and columns as make_fixture writes them; genotypes
    "a/b" or "./.", allele a below the snarl's path count."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from tests.fixtures import make_fixture
    ref = make_fixture(str(tmp_path), n_samples=TINY["n_samples"],
                       n_snarls=10, n_chroms=2)
    with open(ref["vcf"]) as fh:
        ref_head = [line for line in fh if line.startswith("#")]
    with open(cohort.paths["vcf"]) as fh:
        lines = fh.read().splitlines()
    head = [line + "\n" for line in lines if line.startswith("#")]
    assert head == ref_head
    body = [line.split("\t") for line in lines if not line.startswith("#")]
    for s, cols in enumerate(body):
        assert cols[2] == cohort.snarl_id(s)
        assert cols[7] == f"AT={','.join(cohort.path_strings[s])};LV=0"
        gts = cols[9:]
        assert len(gts) == cohort.n_samples
        for i, gt in enumerate(gts):
            a, b = cohort.alleles[s, 2 * i:2 * i + 2]
            assert gt == ("./." if a < 0 else f"{a}/{b}")
            assert (a < 0) == (b < 0) and a < cohort.n_alleles[s]
    for name in ("binary", "quantitative", "covariate"):
        with open(ref[name]) as fh, open(cohort.paths[name]) as gh:
            assert fh.readline() == gh.readline()


def test_traits_as_the_port_parses_them(cohort):
    from stoat_tpu_torch.io import (parse_binary_pheno, parse_covariates,
                                    parse_quantitative_pheno)
    case, samples = parse_binary_pheno(cohort.paths["binary"],
                                       list(cohort.samples))
    assert samples == cohort.samples
    assert np.array_equal(np.asarray(case, bool), cohort.case)
    q = parse_quantitative_pheno(cohort.paths["quantitative"],
                                 cohort.samples)
    assert np.array_equal(np.asarray(q, np.float64), cohort.quantitative)
    c = parse_covariates(cohort.paths["covariate"], ["AGE", "SEX"],
                         cohort.samples)
    assert np.array_equal(np.asarray(c, np.float64), cohort.covariates)


def test_same_seed_same_files_and_sizes_for_every_seed(tmp_path):
    a = vcf_cohort.make(tiny_config(), 9, str(tmp_path / "a"))
    b = vcf_cohort.make(tiny_config(), 9, str(tmp_path / "b"))
    c = vcf_cohort.make(tiny_config(), 10, str(tmp_path / "c"))
    for name in a.paths:
        with open(a.paths[name], "rb") as fh, open(b.paths[name], "rb") as gh:
            assert fh.read() == gh.read()
    assert np.array_equal(np.bincount(a.n_alleles), np.bincount(c.n_alleles))
    assert not np.array_equal(a.alleles, c.alleles)


@pytest.mark.parametrize("name", CELLS)
def test_frequencies_follow_the_configured_spectrum(name):
    """Each bin holds its share of the non-reference paths, whatever the
    seed; each frequency lies inside its bin and the reference path takes
    the rest."""
    config = tiny_cell(name).config
    bins = config["allele_frequency_bins"]
    n_alleles = np.resize(np.arange(2, vcf_cohort.MAX_ALLELES + 1), 3000)
    share = np.asarray([b[2] for b in bins], np.float64)
    counts = []
    for seed in (1, 2**31 + 5):
        rng = np.random.default_rng(seed)
        bin_of = vcf_cohort.alt_bins(bins, n_alleles, rng)
        counts.append(np.bincount(bin_of[bin_of >= 0], minlength=len(bins)))
        f = vcf_cohort.frequencies(bins, bin_of, rng)
        assert np.allclose(f.sum(axis=1), 1.0)
        alt = bin_of >= 0
        lo = np.asarray([b[0] for b in bins])[bin_of[alt]]
        hi = np.asarray([b[1] for b in bins])[bin_of[alt]]
        fa = f[alt]
        inside = (fa >= lo) & (fa <= hi)
        assert inside.mean() > 0.99          # only a scaled-down sum leaves
        assert (fa > 0).all() and (f[:, 0] >= 1 - vcf_cohort.MAX_ALT_SUM
                                   - 1e-12).all()
    assert np.array_equal(counts[0], counts[1])
    assert np.allclose(counts[0] / counts[0].sum(), share / share.sum(),
                       atol=1e-3)


def test_sex_is_zero_or_one(cohort):
    assert set(np.unique(cohort.covariates[:, 1])) <= {0.0, 1.0}
    with open(cohort.paths["covariate"]) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    assert {r[3] for r in rows} <= {"0", "1"}
