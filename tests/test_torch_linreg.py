"""Parity of the port's OLS (K9) and Student-t tail (K10) with the JAX
package, float64 on the CPU.

The same numpy designs, made from a seed, go through stoat_tpu's
``linear_regression_stats_batch`` (the unrolled body for P <= 8, the
matrix branch above) and the port's ``linear_regression_stats_plain``.
Tolerances: a relative 1e-9 on the statistics (sums over the rows run in
another order, and a design with condition number c amplifies that by up
to c); a relative 1e-12 on the t tail over the grid the kernel is checked
on, against ``jax.scipy.special.betainc`` (the two take lgamma, log and
exp from different libraries; at df = 2,500 lgamma(1250) ~ 7.6e3 carries
about 1e-12 of relative error into the prefactor).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.special
torch = pytest.importorskip("torch")

from stoat_tpu.stats.linalg import sym_pinv as j_sym_pinv
from stoat_tpu.stats.linreg import finish_linear_pvalues as j_finish
from stoat_tpu.stats.linreg import linear_regression_stats_batch as j_ols
from stoat_tpu.stats.special import student_t_sf2 as j_sf2
from stoat_tpu_torch.stats.linalg import sym_pinv
from stoat_tpu_torch.stats.linreg import (finish_linear_pvalues,
                                          linear_regression_stats,
                                          student_t_pvalues)
from stoat_tpu_torch.stats.special import betainc_plain, student_t_sf2_plain

# the grid chip_smoke.py holds the kernel to
T_DFS = [1.0, 2.0, 5.0, 30.0, 1000.0, 2500.0]
T_ABS = [0.0, 1e-8, 0.5, 2.0, 10.0, 40.0, 1e3]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rel, atol=0)
    np.testing.assert_array_equal(got[~ok & ~np.isnan(want)],
                                  want[~ok & ~np.isnan(want)])


def _designs(seed, B, N, P, C=1):
    """B designs [1 | dosage fractions | covariates] with C covariates,
    each with its own used rows and width, padded to [B, N, P]; snarl 0
    has duplicate dosage columns (the pseudo-inverse branch), snarl 1 a
    covariate collinear with a dosage, snarl 2 a constant phenotype."""
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N, P))
    y = np.zeros((B, N))
    mask = rng.random((B, N)) < 0.8
    ncols = np.zeros(B, np.int32)
    pheno = rng.standard_normal(N) * 2.0 + 5.0
    covar = rng.standard_normal((N, C))
    for b in range(B):
        k = int(rng.integers(1, P - C))          # variant columns
        counts = rng.integers(0, 3, (N, k + 1)).astype(float)
        counts[counts.sum(1) == 0, 0] = 1.0
        frac = counts / counts.sum(1, keepdims=True)
        cols = [np.ones(N), *frac[:, :k].T, *covar.T]
        if b == 0 and k >= 2:
            cols[2] = cols[1].copy()
        if b == 1:
            cols[-1] = 2.0 * cols[1] - 0.5
        Xb = np.stack(cols, axis=1)
        ncols[b] = Xb.shape[1]
        X[b, :, :ncols[b]] = Xb
        y[b] = 3.0 if b == 2 else pheno
    X[~mask] = 0.0
    y[~mask] = 0.0
    return X, y, mask, ncols


@pytest.mark.parametrize("seed,P", [(0, 4), (1, 6), (2, 8), (3, 12),
                                    (4, 12)])
def test_ols_matches_jax(seed, P):
    """Both sides of the JAX package's _UNROLL_P_MAX = 8."""
    X, y, mask, ncols = _designs(seed, B=48, N=90, P=P)
    want = [np.asarray(w) for w in j_ols(X, y, mask, ncols)]
    got = [g.numpy() for g in linear_regression_stats(
        _t(X), _t(y), _t(mask), _t(ncols))]
    rest = np.arange(48) != 2
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        _assert_close(g[rest], w[rest], rel=1e-9)
    assert np.isfinite(got[0][3:]).all()
    # snarl 2, a constant phenotype: tss = 0, so r2 is not finite, and
    # beta1 and se1 are rounding noise whose ratio t1 no order of
    # summation reproduces
    for stats in (got, want):
        t1, df_res, beta1, se1, r2 = (v[2] for v in stats)
        assert not np.isfinite(r2)
        assert abs(beta1) < 1e-9 and se1 < 1e-9
    assert got[1][2] == want[1][2]


def test_ols_rank_deficient_takes_the_pseudo_inverse():
    """tests/test_stats_oracle.py:203: duplicate dosage columns make X^T X
    singular; beta1 follows the 1e-6-tolerance pseudo-inverse."""
    rng = np.random.default_rng(3)
    n = 30
    d = rng.random(n)
    Xb = np.column_stack([np.ones(n), d, d])
    yb = rng.standard_normal(n)
    X = np.zeros((1, 32, 4))
    X[0, :n, :3] = Xb
    y = np.zeros((1, 32))
    y[0, :n] = yb
    mask = np.zeros((1, 32), bool)
    mask[0, :n] = True
    ncols = np.array([3], np.int32)
    want = j_ols(X, y, mask, ncols)
    got = linear_regression_stats(_t(X), _t(y), _t(mask), _t(ncols))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, rel=1e-9)
    XtX = Xb.T @ Xb
    U, s, Vt = np.linalg.svd(XtX)
    beta = Vt.T @ np.diag(np.where(s > 1e-6, 1 / s, 0.0)) @ U.T @ (Xb.T @ yb)
    assert float(got[2][0]) == pytest.approx(beta[1], rel=1e-6)


@pytest.mark.parametrize("seed,P", [(0, 3), (1, 7), (2, 12)])
def test_sym_pinv_matches_jax(seed, P):
    rng = np.random.default_rng(seed)
    B = 16
    Z = rng.standard_normal((B, 40, P))
    Z[:, :, -1] = Z[:, :, 0]                      # rank P - 1
    A = np.einsum("bnp,bnq->bpq", Z, Z)
    want = np.asarray(j_sym_pinv(jnp.asarray(A), tol=1e-6))
    got = sym_pinv(_t(A), tol=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_student_t_grid_matches_jax_and_scipy():
    grid = np.array([(df, t) for df in T_DFS for t in T_ABS])
    df, t = grid[:, 0], grid[:, 1]
    want = np.asarray(j_sf2(t, df))
    got = student_t_sf2_plain(_t(t), _t(df)).numpy()
    _assert_close(got, want, rel=1e-12)
    # against the exact tail, away from |t| = 1e-8, where x = df / (df +
    # t^2) rounds to 1 and both packages give p = 1 (exact 1 - 1e-8 c)
    exact = 2.0 * scipy.special.stdtr(df, -t)
    big = (exact > 1e-300) & (t != 1e-8)
    np.testing.assert_allclose(got[big], exact[big], rtol=1e-10)
    assert (got[t == 1e-8] == 1.0).all()
    # betainc itself, at the same points
    x = df / (df + t * t)
    np.testing.assert_array_equal(
        betainc_plain(_t(df / 2), _t(np.full_like(df, 0.5)), _t(x)).numpy(),
        student_t_sf2_plain(_t(t), _t(df)).numpy())


def test_betainc_edges_match_jax():
    """The selects for exact 0, 1 and NaN, and the mirrored branch."""
    from jax.scipy.special import betainc
    a = np.array([0.0, 0.5, 2.0, 3.0, np.inf, -1.0, np.nan, 2.0, 7.5, 0.5])
    b = np.array([1.0, 0.0, 0.5, 4.0, 1.0, 1.0, 1.0, 0.5, 0.5, 1250.0])
    x = np.array([0.3, 0.3, 0.0, 1.0, 0.5, 0.5, 0.5, 0.999, 0.2, 1e-3])
    want = np.asarray(betainc(a, b, x))
    got = betainc_plain(_t(a), _t(b), _t(x)).numpy()
    _assert_close(got, want, rel=1e-12)


@pytest.mark.parametrize("df,t_abs", [(2500.0, 43.5), (2500.0, 44.0),
                                      (1.0, 1e154), (5.0, 1e60)])
def test_subnormal_flush_matches_jax(df, t_abs):
    """XLA flushes subnormal float64 values to 0 under the JAX package,
    intermediates included: at df 2,500 and |t| 43.5 the prefactor falls
    below DBL_MIN, so the p-value is 0 there although the exact tail,
    2.8e-308, is not; at |t| 1e154 x = df / (df + t^2) is subnormal."""
    want = float(np.asarray(j_sf2(np.float64(t_abs), np.float64(df))))
    got = float(student_t_sf2_plain(_t(np.array([t_abs])),
                                    _t(np.array([df])))[0])
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    if t_abs < 1e60:
        assert got == 0.0


def test_p_rule_and_degenerate_masking():
    """NaN or infinite t gives p = 1.0; degenerate snarls are NaN in every
    statistic (stoat_tpu/pipeline/quantitative.py:339-347)."""
    t1 = np.array([2.5, np.nan, np.inf, -np.inf, -3.0, 0.0])
    df = np.array([10.0, 5.0, 5.0, 5.0, 1000.0, 3.0])
    deg = np.array([False, False, False, False, True, False])
    stats = [np.arange(6, dtype=float) + k for k in range(3)]
    _assert_close(finish_linear_pvalues(_t(t1), _t(df)).numpy(),
                  np.asarray(j_finish(t1, df)), rel=1e-12)
    out = student_t_pvalues(_t(t1), _t(df), _t(deg), *map(_t, stats))
    assert sorted(out) == ["beta", "p", "r2", "se"]
    assert out["p"].tolist()[1:4] == [1.0, 1.0, 1.0]
    for key, v in zip(("beta", "se", "r2"), stats):
        got = out[key].numpy()
        assert np.isnan(got[4]) and np.array_equal(got[~deg], v[~deg])
    assert np.isnan(out["p"].numpy()[4])
