"""Statistical calibration of the main pipeline on null data.

String parity against the reference (test_golden_replay,
test_stats_oracle) pins the NUMERICS; this file pins the STATISTICS:
on a cohort with no genotype-phenotype association, the asymptotic
p-values coming out of the full runner must be roughly uniform — no
inflation (false positives at scale) and no gross deflation beyond the
conservatism inherent to discrete 2×2 tables.

Deterministic seeds; bounds are loose enough to be stable (400 snarls)
but tight enough to catch a broken statistic (e.g. a df bug doubles
the <0.05 mass; a filtration bug empties the table).

The JAX suite's test (tests/test_null_calibration.py) on the port's runner
on the CPU, with its bounds; both tables are also byte for byte
``stoat_tpu``'s.
"""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture

from stoat_tpu.pipeline.runner import run_vcf_analysis as jax_run
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.pipeline.runner import run_vcf_analysis


def _pvals(path, col):
    out = []
    with open(path) as fh:
        fh.readline()
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if cols[col] != "NA":
                out.append(float(cols[col]))
    return np.array(out)


def test_null_binary_and_quant_pvalues_are_calibrated(tmp_path):
    paths = make_fixture(str(tmp_path), n_samples=120, n_snarls=400,
                         seed=31, n_chroms=1)
    snarls_chr = parse_snarl_path(paths["snarl"])
    # phenotypes DECOUPLED from the genotypes: fresh rng, not the
    # fixture's association machinery
    rng = np.random.default_rng(99)
    samples = list(paths["samples"])
    pheno_bin = rng.random(len(samples)) < 0.5
    pheno_q = rng.standard_normal(len(samples))
    out_b = str(tmp_path / "b.tsv")
    out_q = str(tmp_path / "q.tsv")
    cpu = torch.device("cpu")
    run_vcf_analysis(paths["vcf"], snarls_chr, out_b, pheno_bin, cpu,
                     sample_names=samples)
    run_vcf_analysis(paths["vcf"], snarls_chr, out_q, pheno_q, cpu,
                     mode="quantitative", sample_names=samples)
    jax_b = str(tmp_path / "jax_b.tsv")
    jax_q = str(tmp_path / "jax_q.tsv")
    jax_run(paths["vcf"], snarls_chr, jax_b, "binary",
            binary_phenotype=pheno_bin, sample_names=samples, use_mesh=False)
    jax_run(paths["vcf"], snarls_chr, jax_q, "quantitative",
            quantitative_phenotype=pheno_q, sample_names=samples,
            use_mesh=False)
    assert filecmp.cmp(out_b, jax_b, shallow=False)
    assert filecmp.cmp(out_q, jax_q, shallow=False)

    p_chi2 = _pvals(out_b, 6)
    p_q = _pvals(out_q, 5)
    assert len(p_chi2) >= 300 and len(p_q) >= 300

    # chi² on discrete tables is conservative (mean drifts above 0.5);
    # the OLS t on a continuous phenotype should be closer to uniform
    assert 0.40 <= float(np.mean(p_chi2)) <= 0.72, np.mean(p_chi2)
    assert 0.40 <= float(np.mean(p_q)) <= 0.60, np.mean(p_q)
    # tail mass: no inflation (α=0.05 mass must not double), and the
    # test is not degenerate (some small p-values exist across 400
    # independent nulls)
    assert float(np.mean(p_chi2 < 0.05)) <= 0.10
    assert float(np.mean(p_q < 0.05)) <= 0.10
    assert float(np.mean(p_q < 0.25)) >= 0.10
    # quartile coverage for the continuous statistic (coarse KS)
    for lo, hi in ((0.0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.01)):
        frac = float(np.mean((p_q >= lo) & (p_q < hi)))
        assert 0.10 <= frac <= 0.45, (lo, hi, frac)
