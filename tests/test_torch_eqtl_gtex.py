"""The port's cis-eQTL mode in GTEx v8's shapes against a plain reference
(tests/plain_eqtl_reference.py): ``cli.main(["vcf", "-e", ...])`` on the
CPU on seeded cohorts of gwasbench/inputs/gtex_cohort.py, a small one
with 4 covariates, one at the published 68 and one whose design is rank
deficient (a covariate column twice), which takes the pseudo-inverse.
Also: the gene window by bisection against the linear scan, the batch
row writer against the per-row one, and the eQTL spans and counters,
recorded under a profiler and absent without one."""

import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

import plain_eqtl_reference as ref
from gwasbench.inputs import gtex_cohort
from stoat_tpu_torch import cli, native, trace
from stoat_tpu_torch import writer as W
from stoat_tpu_torch.io.phenotype import QtlData
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.pipeline.runner import GeneWindows

GTEX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gwasbench", "configs", "gtex_v8_whole_blood.json")

# (config overrides, -w): 6 genes a chromosome in both
SMALL = ({"n_samples": 96, "n_snarls": 512, "tss_spacing": 5000,
          "window": 12000,
          "covariate_names": ["PC1", "PC2", "PEER1", "SEX"]}, 12000)
PUBLISHED = ({"n_samples": 120, "n_snarls": 192, "tss_spacing": 1250,
              "window": 3000}, 3000)
# The program (LDL^T or the Jacobi pseudo-inverse, its own sums) and the
# reference (Cholesky or eigh, normal-equation rss) both compute in
# float64; a printed value may sit at a rounding edge of its string, where
# the two differ by a few units of the last place of the double.  Every
# case below reads 0; 1e-9 of the value's scale leaves 1e4 times a double's
# rounding and lies 1e5 times below the float32 reference's least gap on
# these cohorts (1.2e-4).
FULL_RANK_GAP = 1e-9
# A duplicated covariate leaves a null direction whose eigenvalue is a
# rounding residue; both sides drop it (tolerance 1e-6) and the variant
# column's beta, se and rss do not depend on it, so the same limit holds.
PINV_GAP = FULL_RANK_GAP


def _config(overrides):
    import json
    with open(GTEX) as fh:
        conf = json.load(fh)
    conf.update(overrides)
    return conf


def _run(tmp_path, overrides, window, seed, extra_covar=False):
    conf = _config(overrides)
    cohort = gtex_cohort.make(conf, seed, str(tmp_path / "in"))
    names = list(conf["covariate_names"])
    if extra_covar:
        # a covariate column twice: X^T X is singular for every snarl
        with open(cohort.paths["covariate"]) as fh:
            lines = fh.read().splitlines()
        j = lines[0].split("\t").index(names[0])
        with open(cohort.paths["covariate"], "w") as fh:
            for i, line in enumerate(lines):
                cols = line.split("\t")
                fh.write(line + "\t" + ("COPY" if i == 0 else cols[j])
                         + "\n")
        names.append("COPY")
        cohort.covariates = np.concatenate(
            [cohort.covariates, cohort.covariates[:, :1]], axis=1)
    out = str(tmp_path / "out")
    argv = ["vcf", "-v", cohort.paths["vcf"], "-s", cohort.paths["snarl"],
            "-e", cohort.paths["expression"], "-G", cohort.paths["genes"],
            "-c", cohort.paths["covariate"], "-C", ",".join(names),
            "--maf", str(conf["maf"]), "-w", str(window), "-o", out,
            "-V", "0", "--device", "cpu"]
    assert cli.main(argv) == 0
    with open(os.path.join(out, ref.TABLE), "rb") as fh:
        tables = {ref.TABLE: fh.read()}
    exp = ref.expected(cohort, conf, torch.device("cpu"))
    return cohort, conf, exp, tables


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The job at the published 68 covariates, and its reference."""
    return _run(tmp_path_factory.mktemp("published"), *PUBLISHED,
                2**31 + 9)


def _agrees(cohort, exp, tables):
    assert exp.snarl.size > 0
    got = ref.compare(exp, tables, cohort)
    assert got["rows_off"] == 0, got
    assert got["main_gap"] <= FULL_RANK_GAP, got


@pytest.mark.parametrize("seed", [2**31 + 5, 11])
def test_eqtl_table_matches_the_plain_reference(tmp_path, seed):
    cohort, _conf, exp, tables = _run(tmp_path, *SMALL, seed)
    _agrees(cohort, exp, tables)


def test_eqtl_table_at_68_covariates_matches_the_plain_reference(published):
    cohort, _conf, exp, tables = published
    _agrees(cohort, exp, tables)


def test_rank_deficient_design_takes_the_pseudo_inverse(tmp_path):
    cohort, conf, exp, tables = _run(tmp_path, *SMALL, 2**31 + 13,
                                     extra_covar=True)
    # every design is singular: the reference's Cholesky pivot of the
    # copied column falls below 1e-10
    d = ref.design(torch.from_numpy(cohort.alleles[:64]),
                   torch.from_numpy(ref.inclusion(cohort.path_strings[:64])),
                   torch.from_numpy(cohort.n_alleles[:64]),
                   torch.from_numpy(cohort.covariates), (3, 5, conf["maf"]),
                   torch.float64)
    X = d["X"][~d["filtered"]]
    A = torch.einsum("snp,snq->spq", X, X)
    rank = torch.linalg.matrix_rank(A, hermitian=True)
    assert (rank < d["ncols"][~d["filtered"]]).all()
    got = ref.compare(exp, tables, cohort)
    assert got["rows_off"] == 0, got
    assert got["main_gap"] <= PINV_GAP, got


def test_float32_reference_is_far_from_the_program(published):
    """The comparison sees a precision below the configuration's."""
    cohort, conf, exp, _tables = published
    low = ref.expected(cohort, conf, torch.device("cpu"), torch.float32)
    assert ref.compare(exp, ref.render(low, cohort), cohort)["main_gap"] \
        > 1e3 * FULL_RANK_GAP


# ------------------------------------------------------------ gene window

def _linear(genes, start, end, window):
    lo = start - window if start > window else 0
    hi = end + window
    return [i for i, g in enumerate(genes)
            if not (g.end_pos < lo or g.start_pos > hi)]


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_gene_window_bisection_matches_the_linear_scan(seed, shuffled):
    rng = np.random.default_rng(seed)
    G = int(rng.integers(0, 60))
    start = np.sort(rng.integers(0, 200_000, G))
    length = rng.integers(0, 30_000, G) * (rng.random(G) < 0.7)
    genes = [QtlData(f"g{i}", np.zeros(1), int(s), int(s + n))
             for i, (s, n) in enumerate(zip(start, length))]
    if shuffled:
        genes = [genes[i] for i in rng.permutation(G)]
    windows = GeneWindows(genes)
    snarl_start = rng.integers(0, 220_000, 300)
    snarl_end = snarl_start + rng.integers(0, 50, 300)
    window = int(rng.choice([0, 1, 5_000, 40_000]))
    for s, e in zip(snarl_start[:60], snarl_end):
        want = _linear(genes, int(s), int(e), window)
        one = windows.pairs(np.zeros(1, np.int64), [s], [e], window)[1]
        assert one.tolist() == want
    idx = np.arange(0, 600, 2)
    ps, pg = windows.pairs(idx, snarl_start, snarl_end, window)
    want = [(i, g) for i, s, e in zip(idx, snarl_start, snarl_end)
            for g in _linear(genes, int(s), int(e), window)]
    assert list(zip(ps.tolist(), pg.tolist())) == want


# ------------------------------------------------------------ the writer

def test_batch_eqtl_rows_equal_the_per_row_writer(tmp_path, monkeypatch):
    conf = _config(SMALL[0])
    cohort = gtex_cohort.make(conf, 7, str(tmp_path / "in"))
    snarls = next(iter(parse_snarl_path(cohort.paths["snarl"]).values()))
    S, G, B = len(snarls), 5, 400
    rng = np.random.default_rng(1)
    ps = np.sort(rng.integers(0, S, B))
    pg = rng.integers(0, G, B)
    vals = rng.standard_normal((4, B)) * 10.0 ** rng.integers(-9, 3, (4, B))
    vals[:, :7] = [np.nan, 0.0, np.inf, -np.inf, 1e-300, 0.1, -0.1]
    res = dict(zip(("p", "r2", "beta", "se"), vals))
    allele = rng.integers(0, 99999, (S, 4)).astype(np.int32)
    names = [f"GENE{i}" for i in range(G)]

    def write(path):
        with open(path, "w", newline="") as fh:
            W.write_eqtl_rows_batch(fh, "ref0", snarls, names, ps, pg, res,
                                    allele)
        with open(path, "rb") as fh:
            return fh.read()
    assert native.get_lib() is not None
    batch = write(tmp_path / "batch.tsv")
    monkeypatch.setattr(native, "format_eqtl_rows", lambda *a: None)
    rows = write(tmp_path / "rows.tsv")
    assert batch == rows and batch.count(b"\n") == B


# ------------------------------------------------------------ spans

EQTL_SPANS = {"runner.eqtl_pairs", "runner.eqtl_wait_card",
              "runner.eqtl_write", "runner.dispatch"}
EQTL_COUNTERS = ("eqtl.calls", "eqtl.snarls", "eqtl.pairs", "eqtl.genes",
                 "eqtl.samples", "eqtl.columns")


def test_eqtl_spans_and_counters_only_under_a_profiler(tmp_path):
    conf = _config(dict(SMALL[0], n_snarls=256))
    cohort = gtex_cohort.make(conf, 3, str(tmp_path / "in"))
    argv = ["vcf", "-v", cohort.paths["vcf"], "-s", cohort.paths["snarl"],
            "-e", cohort.paths["expression"], "-G", cohort.paths["genes"],
            "-c", cohort.paths["covariate"], "-C",
            ",".join(conf["covariate_names"]), "--maf", "0.01", "-w",
            str(SMALL[1]), "-V", "0", "--device", "cpu", "-o"]
    trace.clear()
    assert cli.main(argv + [str(tmp_path / "off")]) == 0
    assert trace.records() == [] and trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(argv + [str(tmp_path / "on")]) == 0
    records, counters = trace.records(), trace.counters()
    trace.clear()
    names = {r.name for r in records}
    assert EQTL_SPANS <= names
    (job, c), = counters.items()
    runner = [r for r in records if r.name == "runner"]
    assert len(runner) == 1
    for r in records:
        if r.name in EQTL_SPANS:
            assert runner[0].start_ns <= r.start_ns <= r.end_ns \
                <= runner[0].end_ns and r.job == job
    with open(tmp_path / "on" / ref.TABLE) as fh:
        rows = fh.read().splitlines()[1:]
    with open(tmp_path / "off" / ref.TABLE) as fh:
        assert fh.read().splitlines()[1:] == rows
    assert c["eqtl.pairs"] == len(rows) > 0
    assert c["eqtl.snarls"] == len({tuple(r.split("\t")[:4]) for r in rows})
    calls = c["eqtl.calls"]
    assert calls == 2                        # one chunk a chromosome
    assert c["eqtl.samples"] == calls * conf["n_samples"]
    assert c["eqtl.columns"] == calls * (1 + 4 + 4)
    assert c["eqtl.genes"] == len(cohort.gene_names)
