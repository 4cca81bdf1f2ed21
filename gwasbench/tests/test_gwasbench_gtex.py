"""The ``gtex_eqtl`` cell on the CPU at a tiny size: its input maker does
the same work for every seed, its reference agrees with the port, the
float32 control and faults planted in the timed path read ``correct``
false, and the eqtl_ols roofline counts a call's work as its kernel's
header does."""

import importlib
import shutil
import tempfile

import numpy as np
import pytest

from gwasbench import calibrate, harness
from gwasbench.inputs import gtex_cohort
from gwasbench.roofline import bound_seconds, eqtl_ols
from gwasbench.tracing import Context
from stoat_tpu_torch.trace import Record

from gwasbench.tests.gwasbench_tiny import SEED

# 100 samples, 256 snarls on 2 chromosomes, a TSS every 2,500 bp: 6 genes
# a chromosome, all within the default 1 Mb of every snarl
TINY = {"n_samples": 100, "n_snarls": 256, "tss_spacing": 2500}


def _cell():
    return harness.load_cell("gtex_eqtl", overrides=TINY)


def _run():
    return harness.run_cell(_cell(), SEED, 0.2, False, device_name="cpu",
                            log=lambda line: None)


# ------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    config = _cell().config
    return {seed: gtex_cohort.make(config, seed,
                                   str(tmp_path_factory.mktemp(str(seed))))
            for seed in (1, 2**31 + 3, 987654321)}


def test_every_seed_has_the_same_work(cohorts):
    first = next(iter(cohorts.values()))
    for c in cohorts.values():
        assert c.n_snarls == first.n_snarls
        assert np.array_equal(np.sort(c.n_alleles), np.sort(first.n_alleles))
        assert c.gene_names == first.gene_names
        assert np.array_equal(c.gene_chrom, first.gene_chrom)
        for k in range(len(c.chroms)):
            tss = c.tss[c.gene_chrom == k]
            assert tss.size == gtex_cohort.gene_count(_cell().config) == 6
            assert np.all(np.diff(tss) == 2500) and 0 <= tss[0] < 2500
        assert c.expression.shape == (len(c.gene_names), c.n_samples)
        assert c.covariates.shape == (c.n_samples, 68)


def test_files_read_back_as_the_arrays(cohorts):
    from stoat_tpu_torch.io.phenotype import (parse_covariates,
                                              parse_qtl_gene_file)
    c = next(iter(cohorts.values()))
    names = _cell().config["covariate_names"]
    cov = parse_covariates(c.paths["covariate"], names, c.samples)
    assert np.array_equal(cov, c.covariates)
    assert set(np.unique(cov[:, -3:])) <= {0.0, 1.0}
    genes = parse_qtl_gene_file(c.paths["expression"], c.paths["genes"],
                                c.samples)
    flat = [g for chrom in c.chroms for g in genes[chrom]]
    assert [g.gene_name for g in flat] == c.gene_names
    assert [g.start_pos for g in flat] == c.tss.tolist()
    assert [g.end_pos for g in flat] == c.tss.tolist()
    assert np.array_equal(np.stack([g.sample_expression for g in flat]),
                          c.expression)
    assert sorted(c.paths) == ["covariate", "expression", "genes", "snarl",
                               "vcf"]


# ------------------------------------------------------------ correct

def test_reference_agrees_with_the_port_on_the_cpu():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("seed", [2**31 + 41, 17])
def test_float32_control_is_not_correct(seed):
    cell = _cell()
    workdir = tempfile.mkdtemp()
    try:
        got, ctrl = calibrate.program_reading(cell, seed, "cpu", workdir,
                                              control=True)
    finally:
        shutil.rmtree(workdir)
    assert all(got[k] <= v for k, v in cell.limits.items()), got
    assert any(ctrl[k] > v for k, v in cell.limits.items()), ctrl


def _answer_scaled(mp):
    """Every pair's t statistic scaled by 1.001 where K13 produces it."""
    from stoat_tpu_torch.pipeline import quantitative
    real = quantitative.eqtl_ols_stats

    def fault(*args):
        t1, *rest = real(*args)
        return (t1 * 1.001, *rest)
    mp.setattr(quantitative, "eqtl_ols_stats", fault)


def _beta_altered(mp):
    """The pairs' beta altered after the tail."""
    from stoat_tpu_torch.pipeline import quantitative
    real = quantitative.student_t_pvalues

    def fault(*args, **kwargs):
        out = real(*args, **kwargs)
        out["beta"] = out["beta"] * 1.001
        return out
    mp.setattr(quantitative, "student_t_pvalues", fault)


def _row_dropped(mp):
    """The last pair of every chunk left unwritten."""
    from stoat_tpu_torch import writer
    real = writer.write_eqtl_rows_batch

    def fault(fh, chrom, snarls, names, ps, pg, stats, allele):
        return real(fh, chrom, snarls, names, ps[:-1], pg[:-1],
                    {k: v[:-1] for k, v in stats.items()}, allele)
    mp.setattr(writer, "write_eqtl_rows_batch", fault)


@pytest.mark.parametrize("fault", [_answer_scaled, _beta_altered,
                                   _row_dropped],
                         ids=["answer_scaled", "beta_altered", "row_dropped"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


# ------------------------------------------------------------ roofline

def test_eqtl_ols_work_is_the_headers_count():
    call = {"S": 2, "N": 3, "PT": 4, "B": 5, "G": 2}
    nbytes, flops = eqtl_ols.work(call)
    # X 2 x 3 x 4 doubles, the expression 2 x 3 doubles, 40 B a pair
    assert nbytes == 2 * 3 * 4 * 8 + 2 * 3 * 8 + 40 * 5
    # X^T X once a snarl, 3 * 4 * 5 each; a pair (4 * 4 + 4) * 3
    assert flops == 2 * 60 + 5 * 60


def _ctx(counters, device_ops):
    recs = [Record("job", 1, 0, 1000_000, 1, None, 1)]
    ctx = Context(jobs=1, peak_bytes=1, card="test card", spans={},
                  calls={}, device_ops=device_ops,
                  annotations=[("job", 0.0, 1000.0)],
                  trace_window=(0.0, 1000.0), on_card=True)
    ctx.program_store = (recs, {1: counters})
    return ctx


def test_eqtl_ols_roofline_reads_the_counters():
    counters = {"eqtl.calls": 2, "eqtl.snarls": 4000, "eqtl.pairs": 50000,
                "eqtl.genes": 52, "eqtl.samples": 1340,
                "eqtl.columns": 146}
    ops = [("void eqtl_ols_kernel<true>(double const*)", 0.0, 30000.0),
           ("void eqtl_ols_kernel<true>(double const*)", 40000.0, 70000.0),
           ("void quant_design_kernel<false>(int)", 0.0, 10.0)]
    ctx = _ctx(counters, ops)
    call = eqtl_ols.calls(ctx)
    assert call == {"S": 2000, "B": 25000, "G": 26, "N": 670, "PT": 73,
                    "n": 2}
    read = importlib.import_module("gwasbench.metrics.eqtl_ols_roofline")
    want = 100.0 * bound_seconds(*eqtl_ols.work(call)) / 0.03
    assert read.read(ctx) == pytest.approx(want)
    assert 0.0 < want < 100.0


@pytest.mark.parametrize("name", ["eqtl_ols_roofline", "eqtl_pairs_s_per_job",
                                  "eqtl_card_wait_s_per_job",
                                  "eqtl_write_s_per_job"])
def test_a_program_without_the_eqtl_records_reads_none(name):
    ctx = _ctx({}, [("void eqtl_ols_kernel<true>()", 0.0, 10.0)])
    read = importlib.import_module(f"gwasbench.metrics.{name}")
    assert read.read(ctx) is None
