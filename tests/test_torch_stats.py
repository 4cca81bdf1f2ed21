"""Parity of the port's statistics with the JAX package (float64, CPU).

Fisher (K4) and the chi-squared statistics and tail (K3's arithmetic, K5)
take the same numpy inputs in both packages.  Tolerances: identical
``format_p`` strings everywhere, and a relative 1e-12 on the values (the
two packages take sums and special functions from different libraries).
The plain PyTorch versions tested here are what the CUDA kernels are held
to, bit for bit, on the card (chip_smoke.py).
"""

import os

import mpmath
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu.stats import chi2_2x2 as jchi2_2x2
from stoat_tpu.stats import chi2_2xn as jchi2_2xn
from stoat_tpu.stats import fisher_exact_2x2 as jfisher
from stoat_tpu.stats.special import chi2_sf as jchi2_sf
from stoat_tpu.writer import format_p
from stoat_tpu_torch.stats.chi2 import (chi2_2x2_stat, chi2_2xn_stat,
                                        finish_chi2_pvalues)
from stoat_tpu_torch.stats.fisher import fisher_exact_2x2
from stoat_tpu_torch.stats.special import chi2_sf

# tests/test_stats_oracle.py:105 (the reference's pinned strings)
FISHER_CASES = [
    ((10, 20, 20, 10), "1.9383e-02"),
    ((30, 5, 2, 25), "3.5379e-10"),
    ((0, 0, 0, 0), "NA"),
    ((0, 0, 0, 1), "NA"),
    ((1, 0, 0, 1), "1"),
    ((79, 18, 96, 23), "1"),
    ((122, 78, 27, 173), "1.4799e-23"),
]
# tests/test_extreme_tails.py:65: the scan overflows, the answer is "0"
OVERFLOW_TABLES = [(1000, 2, 3, 1500), (2000, 1, 1, 3000),
                   (5000, 10, 4, 8000)]
# tests/test_extreme_tails.py:23-26
TAIL_STATS = [60.0, 80.0, 84.9, 85.0001, 86.0, 100.0, 200.0, 500.0,
              1000.0, 1400.0]
TAIL_DFS = [1, 2, 3, 7]


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _assert_close(got, want, rel=1e-12):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rel, atol=0)


def _assert_same_strings(got, want):
    assert [format_p(v) for v in np.asarray(got)] == \
        [format_p(v) for v in np.asarray(want)]


def _fisher_both(tables):
    tables = np.asarray(tables, np.float64).reshape(-1, 4)
    cols = [tables[:, i] for i in range(4)]
    got = fisher_exact_2x2(*map(_t, cols)).numpy()
    want = np.asarray(jfisher(*cols))
    return got, want


@pytest.mark.parametrize("table,expected", FISHER_CASES)
def test_fisher_pinned(table, expected):
    got, want = _fisher_both([table])
    assert format_p(got[0]) == expected
    _assert_same_strings(got, want)
    _assert_close(got, want)


@pytest.mark.parametrize("table", OVERFLOW_TABLES)
def test_fisher_overflow_tables(table):
    got, want = _fisher_both([table])
    assert got[0] == 0.0 and format_p(got[0]) == "0"
    _assert_close(got, want)


@pytest.mark.parametrize("seed,hi", [(1, 60), (2, 400), (3, 5000)])
def test_fisher_random_batch(seed, hi):
    """Random tables, zero margins included; the batched loop keeps each
    lane on its own path through the three phases."""
    rng = np.random.default_rng(seed)
    tables = rng.integers(0, hi, size=(300, 4)).astype(float)
    tables[:10, 0] = 0
    tables[10:15, :2] = 0
    got, want = _fisher_both(tables)
    _assert_same_strings(got, want)
    _assert_close(got, want)


@pytest.mark.parametrize("stat", TAIL_STATS)
@pytest.mark.parametrize("df", TAIL_DFS)
def test_chi2_sf_matches_jax(stat, df):
    got = float(chi2_sf(_t([stat]), _t([df]))[0])
    want = float(np.asarray(jchi2_sf(np.float64(stat), np.float64(df))))
    assert format_p(got) == format_p(want)
    exact = float(mpmath.gammainc(mpmath.mpf(df) / 2,
                                  a=mpmath.mpf(stat) / 2, regularized=True))
    if stat <= 85.0:
        # the reference's double branch: 1 - fl(1 - q)
        assert got == pytest.approx(want, rel=1e-12, abs=1.2e-16)
        assert got == pytest.approx(exact, rel=1e-6, abs=1.2e-16)
    else:
        assert got == pytest.approx(want, rel=1e-12)
        assert got == pytest.approx(exact, rel=1e-10)


def test_chi2_sf_branch_boundary():
    """tests/test_extreme_tails.py:41: just below 85 the double branch
    rounds to exactly 0; just above, the full tail."""
    below = float(chi2_sf(_t([84.999999]), _t([1.0]))[0])
    above = float(chi2_sf(_t([85.000001]), _t([1.0]))[0])
    assert below == 0.0
    assert format_p(above) == "2.9836e-20"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chi2_2x2_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tables = rng.integers(0, 200, size=(200, 4)).astype(float)
    tables[:8, 0:2] = 0           # zero row margin
    tables[8:12, ::2] = 0         # zero column margin
    cols = [tables[:, i] for i in range(4)]
    stat, inv, zexp = chi2_2x2_stat(*map(_t, cols))
    got = finish_chi2_pvalues(stat, torch.ones_like(stat), inv, zexp)
    want = np.asarray(jchi2_2x2(*cols))
    _assert_same_strings(got.numpy(), want)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_chi2_2xn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, pad = 120, 8
    g0 = rng.integers(0, 80, (B, pad)).astype(float)
    g1 = rng.integers(0, 80, (B, pad)).astype(float)
    mask = rng.random((B, pad)) < 0.7
    g1[:5] = 0                     # zero row
    stat, df, inv = chi2_2xn_stat(_t(g0), _t(g1), torch.from_numpy(mask))
    got = finish_chi2_pvalues(stat, df, inv, torch.zeros_like(inv))
    want = np.asarray(jchi2_2xn(g0, g1, mask))
    _assert_same_strings(got.numpy(), want)
    _assert_close(got.numpy(), want)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden_sysdir", "binary",
                      "binary_table_vcf.tsv")


def test_golden_binary_rows_replay():
    """Every row of the committed golden binary table carries its kept
    columns in GROUP_PATHS: the port's statistics must reprint its
    P_FISHER and P_CHI2 strings."""
    from stoat_tpu_torch.pipeline.binary import binary_from_path_counts

    rows = []
    with open(GOLDEN) as fh:
        fh.readline()
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            pairs = [tuple(map(float, t.split(":")))
                     for t in cols[7].split(",")]
            rows.append((cols[5], cols[6], pairs))
    assert len(rows) > 100
    pmax = max(len(p) for _, _, p in rows)
    S = len(rows)
    flat0, flat1 = [], []
    sidx = np.full((S, pmax), -1, np.int32)
    for s, (_, _, pairs) in enumerate(rows):
        for j, (a, b) in enumerate(pairs):
            sidx[s, j] = len(flat0)
            flat0.append(a)
            flat1.append(b)
    res = binary_from_path_counts(_t(flat0), _t(flat1),
                                  torch.from_numpy(sidx), 0, 0, 0.0)
    pf = res["p_fisher"].numpy()
    pc = res["p_chi2"].numpy()
    mism = [(i, want_f, format_p(pf[i]), want_c, format_p(pc[i]))
            for i, (want_f, want_c, _) in enumerate(rows)
            if (format_p(pf[i]), format_p(pc[i])) != (want_f, want_c)]
    assert not mism, mism[:10]
