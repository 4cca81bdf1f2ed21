"""Numerics-oracle tests for the batched statistics kernels.

The pinned p-value *strings* come from the reference's unit tests
(tests/unittest/binary_test_unit.cpp) — they are the bit-for-float parity
contract with the C++/Boost implementation.  Cross-validation against
scipy/statsmodels-style references covers the regression kernels
(mirroring the reference's tests/regression/).

The JAX suite's tests (tests/test_stats_oracle.py) on the port's
statistics, run on CPU tensors through the plain versions that the CUDA
kernels are held to: each keeps its oracle and tolerance, and the port's
values are also held to ``stoat_tpu``'s on the same inputs (equal
strings; 1e-12 relative, as tests/test_torch_stats.py, since the two
packages sum and take special functions from different libraries).  The
reference's pinned Fisher strings are tests/test_torch_stats.py::
test_fisher_pinned.
"""

import numpy as np
import pytest
import scipy.stats

torch = pytest.importorskip("torch")

from stoat_tpu import stats as jax_stats
from stoat_tpu.stats.linreg import \
    linear_regression_batch as jax_linear_regression_batch
from stoat_tpu.stats.logreg import \
    logistic_regression_batch as jax_logistic_regression_batch
from stoat_tpu_torch.formatting import set_precision
from stoat_tpu_torch.stats.chi2 import (chi2_2x2_stat, chi2_2xn_stat,
                                        finish_chi2_pvalues)
from stoat_tpu_torch.stats.fisher import fisher_exact_2x2 as _fisher
from stoat_tpu_torch.stats.linreg import (finish_linear_pvalues,
                                          linear_regression_stats)
from stoat_tpu_torch.stats.logreg import logistic_regression_plain


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _same(got, want, rel=1e-12):
    """The port's values against stoat_tpu's: NaN in the same places,
    equal strings, within ``rel``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert [fmt(v) for v in got.ravel()] == [fmt(v) for v in want.ravel()]
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rel, atol=0)


def chi2_2x2(a, b, c, d):
    """The port's chi² p of 2x2 tables (stoat_tpu's chi2_2x2) on CPU
    tensors, held to stoat_tpu's."""
    stat, invalid, zero_expected = chi2_2x2_stat(*map(_t, (a, b, c, d)))
    p = finish_chi2_pvalues(stat, torch.ones_like(stat), invalid,
                            zero_expected).numpy()
    _same(p, jax_stats.chi2_2x2(a, b, c, d))
    return p


def chi2_2xn(g0, g1, mask):
    """The port's chi² p of 2xN tables (stoat_tpu's chi2_2xn), held to
    stoat_tpu's."""
    stat, df, invalid = chi2_2xn_stat(_t(g0), _t(g1), torch.as_tensor(mask))
    p = finish_chi2_pvalues(stat, df, invalid,
                            torch.zeros_like(invalid)).numpy()
    _same(p, jax_stats.chi2_2xn(g0, g1, mask))
    return p


def fisher_exact_2x2(a, b, c, d):
    """The port's Fisher p, held to stoat_tpu's."""
    p = _fisher(*map(_t, (a, b, c, d))).numpy()
    _same(p, jax_stats.fisher_exact_2x2(a, b, c, d))
    return p


def linear_regression_batch(X, y, mask, ncols):
    """(p, beta1, se1, r2) of the port's OLS (stoat_tpu's
    linear_regression_batch), each held to stoat_tpu's within 1e-9
    (sums in another order, ROADMAP §3)."""
    t1, df, b1, s1, r2 = linear_regression_stats(
        _t(X), _t(y), torch.as_tensor(mask), torch.as_tensor(ncols))
    got = [v.numpy() for v in (finish_linear_pvalues(t1, df), b1, s1, r2)]
    for g, w in zip(got, jax_linear_regression_batch(X, y, mask, ncols)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=0)
    return got


def logistic_regression_batch(X, y, mask, ncols):
    """(p, beta, se) of the port's IRLS (stoat_tpu's
    logistic_regression_batch), held to stoat_tpu's within 1e-9
    (tests/test_torch_logreg.py)."""
    out = logistic_regression_plain(_t(X), _t(y), torch.as_tensor(mask),
                                    torch.as_tensor(ncols))
    got = [out[k].numpy() for k in ("p", "beta", "se")]
    for g, w in zip(got, jax_logistic_regression_batch(X, y, mask, ncols)):
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)],
                                   rtol=1e-9, atol=1e-300)
    return got


def fmt(p):
    p = np.asarray(p)
    return "NA" if np.isnan(p) else set_precision(float(p))


# ---------------------------------------------------------------------------
# chi2 2x2 — binary_test_unit.cpp:10-115
# ---------------------------------------------------------------------------

CHI2_2X2_CASES = [
    ((10, 20, 20, 10), "9.8233e-03"),
    ((30, 5, 2, 25), "9.5037e-10"),
    ((0, 0, 0, 0), "NA"),
    ((0, 0, 0, 1), "NA"),
    ((1, 0, 0, 1), "0.1573"),
    ((79, 18, 96, 23), "0.8857"),
    ((122, 78, 27, 173), "8.8051e-23"),
]


@pytest.mark.parametrize("table,expected", CHI2_2X2_CASES)
def test_chi2_2x2_pinned(table, expected):
    a, b, c, d = table
    p = chi2_2x2(np.array([a]), np.array([b]), np.array([c]), np.array([d]))
    assert fmt(p[0]) == expected


def test_chi2_2x2_batch():
    tables = np.array([t for t, _ in CHI2_2X2_CASES], dtype=np.float64)
    p = chi2_2x2(tables[:, 0], tables[:, 1], tables[:, 2], tables[:, 3])
    got = [fmt(x) for x in np.asarray(p)]
    assert got == [e for _, e in CHI2_2X2_CASES]


# ---------------------------------------------------------------------------
# chi2 2xN — binary_test_unit.cpp:32-71
# ---------------------------------------------------------------------------

CHI2_2XN_CASES = [
    (([10, 15, 5], [20, 10, 10]), "9.6972e-02"),
    (([5, 10, 15, 20], [20, 15, 10, 5]), "1.6974e-04"),
    (([10, 10, 10, 10, 10], [10, 10, 10, 10, 10]), "1"),
    (([0, 0, 0], [10, 20, 30]), "NA"),
    (([0, 10, 5], [0, 20, 15]), "NA"),
]


@pytest.mark.parametrize("groups,expected", CHI2_2XN_CASES)
def test_chi2_2xn_pinned(groups, expected):
    g0, g1 = groups
    n = len(g0)
    pad = 8
    g0a = np.zeros((1, pad))
    g1a = np.zeros((1, pad))
    mask = np.zeros((1, pad), bool)
    g0a[0, :n] = g0
    g1a[0, :n] = g1
    mask[0, :n] = True
    p = chi2_2xn(g0a, g1a, mask)
    assert fmt(p[0]) == expected


def test_chi2_2xn_matches_scipy():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = rng.integers(2, 7)
        g0 = rng.integers(1, 80, n).astype(float)
        g1 = rng.integers(1, 80, n).astype(float)
        pad = 8
        g0a = np.zeros((1, pad))
        g1a = np.zeros((1, pad))
        mask = np.zeros((1, pad), bool)
        g0a[0, :n] = g0
        g1a[0, :n] = g1
        mask[0, :n] = True
        p = float(np.asarray(chi2_2xn(g0a, g1a, mask))[0])
        stat, p_ref, _, _ = scipy.stats.chi2_contingency(
            np.stack([g0, g1]), correction=False)
        assert p == pytest.approx(p_ref, rel=1e-8)


# ---------------------------------------------------------------------------
# Fisher exact — binary_test_unit.cpp pinned strings
# ---------------------------------------------------------------------------

def test_fisher_batch_matches_scipy():
    rng = np.random.default_rng(1)
    tables = rng.integers(0, 60, size=(100, 4)).astype(float)
    p = np.asarray(fisher_exact_2x2(tables[:, 0], tables[:, 1],
                                    tables[:, 2], tables[:, 3]))
    for i, (a, b, c, d) in enumerate(tables):
        if (a + b == 0) or (c + d == 0) or (a + c == 0) or (b + d == 0):
            assert np.isnan(p[i])
            continue
        _, p_ref = scipy.stats.fisher_exact([[a, b], [c, d]])
        # PLINK's relative-probability scan matches the exact two-sided
        # p-value to its documented epsilon
        assert p[i] == pytest.approx(p_ref, rel=1e-6), (i, (a, b, c, d))


# ---------------------------------------------------------------------------
# Linear regression — cross-validated vs closed-form numpy OLS
# (mirrors tests/regression/linear_regression_arg.py)
# ---------------------------------------------------------------------------

def numpy_ols_reference(X, y):
    """Scalar reference replicating stats_test.cpp:423-506."""
    XtX = X.T @ X
    XtXinv = np.linalg.inv(XtX)
    beta = XtXinv @ (X.T @ y)
    resid = y - X @ beta
    rss = float(resid @ resid)
    tss = float(((y - y.mean()) ** 2).sum())
    r2 = 1 - rss / tss
    n, pdim = X.shape
    df_res = max(n - pdim + 1, 1)
    mse = rss / df_res
    se = np.sqrt(np.diag(XtXinv) * mse)
    t = beta / se
    if not np.isfinite(t[1]):
        p = 1.0
    else:
        p = 2 * scipy.stats.t.sf(abs(t[1]), df_res)
    return p, beta[1], se[1], r2


def _pack_regression(Xs, ys, P, N):
    B = len(Xs)
    X = np.zeros((B, N, P))
    y = np.zeros((B, N))
    mask = np.zeros((B, N), bool)
    ncols = np.zeros(B, np.int32)
    for b, (Xb, yb) in enumerate(zip(Xs, ys)):
        n, p = Xb.shape
        X[b, :n, :p] = Xb
        y[b, :n] = yb
        mask[b, :n] = True
        ncols[b] = p
    return X, y, mask, ncols


def test_linreg_batch_matches_reference():
    rng = np.random.default_rng(2)
    Xs, ys, refs = [], [], []
    for _ in range(20):
        n = int(rng.integers(10, 60))
        k = int(rng.integers(1, 4))       # variant columns
        c = int(rng.integers(0, 3))       # covariates
        dos = rng.random((n, k))
        cov = rng.standard_normal((n, c))
        Xb = np.column_stack([np.ones(n), dos, cov])
        yb = rng.standard_normal(n) * 2 + dos[:, 0]
        Xs.append(Xb)
        ys.append(yb)
        refs.append(numpy_ols_reference(Xb, yb))
    X, y, mask, ncols = _pack_regression(Xs, ys, P=8, N=64)
    p, b1, s1, r2 = (np.asarray(v) for v in
                     linear_regression_batch(X, y, mask, ncols))
    for i, (pr, br, sr, rr) in enumerate(refs):
        assert p[i] == pytest.approx(pr, rel=1e-9)
        assert b1[i] == pytest.approx(br, rel=1e-9)
        assert s1[i] == pytest.approx(sr, rel=1e-9)
        assert r2[i] == pytest.approx(rr, rel=1e-9)


def test_linreg_rank_deficient_falls_back_to_pinv():
    # Duplicate dosage columns -> singular XtX -> SVD pseudo-inverse branch
    rng = np.random.default_rng(3)
    n = 30
    d = rng.random(n)
    Xb = np.column_stack([np.ones(n), d, d])
    yb = rng.standard_normal(n)
    X, y, mask, ncols = _pack_regression([Xb], [yb], P=4, N=32)
    p, b1, s1, r2 = (np.asarray(v) for v in
                     linear_regression_batch(X, y, mask, ncols))
    # Reference result via explicit pinv with tol semantics
    XtX = Xb.T @ Xb
    U, s, Vt = np.linalg.svd(XtX)
    sinv = np.where(s > 1e-6, 1 / s, 0.0)
    XtXinv = Vt.T @ np.diag(sinv) @ U.T
    beta = XtXinv @ (Xb.T @ yb)
    assert np.isfinite(p[0])
    assert b1[0] == pytest.approx(beta[1], rel=1e-6)


# ---------------------------------------------------------------------------
# Logistic regression — cross-validated vs a scalar IRLS replica
# ---------------------------------------------------------------------------

def scalar_irls_reference(X, y):
    """Replicates stats_test.cpp:49-176 (no covariates, L2=1e-4)."""
    n, pdim = X.shape
    beta = np.zeros(pdim)
    beta_old = beta.copy()
    converged = False
    for _ in range(100):
        z = X @ beta
        prob = 1 / (1 + np.exp(-z))
        w = np.clip(prob * (1 - prob), 1e-8, 1.0)
        H = (X * w[:, None]).T @ X + 1e-4 * np.eye(pdim)
        g = X.T @ (y - prob) - 1e-4 * beta
        beta = beta + np.linalg.solve(H, g)
        if np.linalg.norm(beta - beta_old) < 1e-6:
            converged = True
            break
        beta_old = beta.copy()
    if not converged:
        return None
    z = X @ beta
    prob = 1 / (1 + np.exp(-z))
    w = np.clip(prob * (1 - prob), 1e-8, 1.0)
    H = (X * w[:, None]).T @ X + 1e-4 * np.eye(pdim)
    cov = np.linalg.inv(H)
    se = np.sqrt(np.diag(cov))
    pvals = [2 * (1 - scipy.stats.norm.cdf(abs(beta[i] / se[i])))
             for i in range(1, pdim)]
    if len(pvals) > 1:
        from stoat_tpu_torch.corrections import adjusted_holm
        adj = adjusted_holm(np.array(pvals))
        k = int(np.argmin(adj))
        return adj[k], beta[k + 1], se[k + 1]
    return pvals[0], beta[1], se[1]


def test_logreg_batch_matches_reference():
    rng = np.random.default_rng(4)
    cases = []
    for _ in range(12):
        n = int(rng.integers(30, 80))
        k = int(rng.integers(1, 4))
        dos = rng.random((n, k))
        logits = -0.3 + 1.5 * dos[:, 0]
        yb = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(float)
        Xb = np.column_stack([np.ones(n), dos])
        cases.append((Xb, yb))
    X, y, mask, ncols = _pack_regression(
        [c[0] for c in cases], [c[1] for c in cases], P=6, N=96)
    p, b, s = (np.asarray(v) for v in
               logistic_regression_batch(X, y, mask, ncols))
    for i, (Xb, yb) in enumerate(cases):
        ref = scalar_irls_reference(Xb, yb)
        if ref is None:
            assert np.isnan(p[i])
            continue
        pr, br, sr = ref
        assert p[i] == pytest.approx(pr, rel=1e-6, abs=1e-12), i
        assert b[i] == pytest.approx(br, rel=1e-6), i
        assert s[i] == pytest.approx(sr, rel=1e-6), i


def test_logreg_separable_returns_na_or_value_consistently():
    # Perfect separation: IRLS may diverge; reference returns NA if it
    # fails to converge in 100 iterations.  We only require agreement with
    # the scalar replica.
    n = 40
    d = np.concatenate([np.zeros(n // 2), np.ones(n // 2)])
    yb = d.copy()
    Xb = np.column_stack([np.ones(n), d])
    X, y, mask, ncols = _pack_regression([Xb], [yb], P=4, N=48)
    p, b, s = (np.asarray(v) for v in
               logistic_regression_batch(X, y, mask, ncols))
    ref = scalar_irls_reference(Xb, yb)
    if ref is None:
        assert np.isnan(p[0])
    else:
        assert p[0] == pytest.approx(ref[0], rel=1e-5, abs=1e-12)
