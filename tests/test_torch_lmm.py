"""LMM (kinship mixed model) on the port: numerics validation.

The reference declares-but-never-implements its LMM (stats_test.hpp:
115-125), so there is no oracle to pin against; validation is therefore
against independent dense linear algebra.  The JAX suite's tests
(tests/test_lmm.py) on the port's ``stats/lmm.py`` and CLI, each also held
to ``stoat_tpu``'s result on the same inputs:

  1. the rotated REML log-likelihood == an unrotated evaluation using
     full Sigma = K + delta*I solves,
  2. REML recovers the simulated variance ratio,
  3. with K = I the LMM collapses to plain OLS (identical t statistics),
  4. on a structured phenotype it deflates what OLS inflates,
  5. ``vcf -q -k --lmm`` end to end, and ``-k`` without ``--lmm`` is OLS.

The batched GLS against dense solves, the identity kinship on the
pipeline's fully covered snarls and the null fit with collinear
covariates are tests/test_torch_vcf_modes.py's.
"""

import os

import numpy as np
import pytest
import scipy.stats

torch = pytest.importorskip("torch")

from stoat_tpu.stats import lmm as jax_lmm
from stoat_tpu.stats.linreg import \
    linear_regression_batch as jax_linear_regression_batch
from stoat_tpu_torch.convert import to_lmm_inputs
from stoat_tpu_torch.stats.linreg import (finish_linear_pvalues,
                                          linear_regression_stats)
from stoat_tpu_torch.stats.lmm import (fit_null_reml, lmm_regression_batch,
                                       reml_loglik)

from test_lmm import dense_reml, random_kinship
from test_torch_end_to_end import cli_main

CPU = torch.device("cpu")


def _same_fit(ctx, y, K, covar=None):
    """The port's null fit is stoat_tpu's (both numpy, the same code)."""
    want = jax_lmm.fit_null_reml(y, K, covar)
    assert (ctx.delta, ctx.loglik, ctx.sigma_g2) == (
        want.delta, want.loglik, want.sigma_g2)
    np.testing.assert_array_equal(ctx.rot, want.rot)


def _lmm_p(X, ctx, ncols):
    """(p, beta1, se1) of the port's rotated OLS on CPU tensors, each held
    to stoat_tpu's lmm_regression_batch within 1e-9 (the rotation is one
    GEMM in the port, an einsum in stoat_tpu: ROADMAP §3)."""
    n = X.shape[1]
    rot, y_rot, _c = to_lmm_inputs(ctx, None, n, CPU)
    t1, df, b1, se1, _r2 = lmm_regression_batch(
        torch.from_numpy(X), rot, y_rot, torch.from_numpy(ncols))
    got = [finish_linear_pvalues(t1, df).numpy(), b1.numpy(), se1.numpy()]
    want = jax_lmm.lmm_regression_batch(X, ctx, ncols)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=0)
    return got


def _ols_p(X, y, ncols):
    """p and beta1 of the port's OLS with every row used, held to
    stoat_tpu's within 1e-9."""
    S, n, _ = X.shape
    y = np.broadcast_to(y, (S, n)).copy()
    mask = np.ones((S, n), bool)
    t1, df, b1, _se, _r2 = linear_regression_stats(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(mask),
        torch.from_numpy(ncols))
    got = [finish_linear_pvalues(t1, df).numpy(), b1.numpy()]
    want = jax_linear_regression_batch(X, y, mask, ncols)
    for g, w in zip(got, want[:2]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=0)
    return got


def test_reml_loglik_matches_dense():
    rng = np.random.default_rng(0)
    n = 60
    K = random_kinship(n, rng)
    y = rng.normal(size=n)
    X0 = np.column_stack([np.ones(n), rng.normal(size=n)])
    S, U = np.linalg.eigh(K)
    S = np.clip(S, 0, None)
    yt, X0t = U.T @ y, U.T @ X0
    _s, ld = np.linalg.slogdet(X0.T @ X0)
    for delta in (0.01, 0.3, 1.0, 7.5, 100.0):
        a = reml_loglik(delta, S, yt, X0t, ld)
        b = dense_reml(delta, K, y, X0)
        assert a == pytest.approx(b, rel=1e-9), delta
        assert a == jax_lmm.reml_loglik(delta, S, yt, X0t, ld)


def test_reml_recovers_variance_ratio():
    rng = np.random.default_rng(1)
    n = 500
    K = random_kinship(n, rng, rank=100)
    L = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    sg, se = 2.0, 1.0   # true delta = 0.5
    y = 3.0 + np.sqrt(sg) * (L @ rng.normal(size=n)) \
        + np.sqrt(se) * rng.normal(size=n)
    ctx = fit_null_reml(y, K)
    _same_fit(ctx, y, K)
    assert ctx.delta == pytest.approx(se / sg, rel=0.5)
    assert 0.4 < ctx.heritability < 0.85
    # optimum really is a maximum on the grid neighbourhood
    S, U = np.linalg.eigh(K)
    S = np.clip(S, 0, None)
    yt, X0t = U.T @ y, (U.T @ np.ones((n, 1)))
    _s, ld = np.linalg.slogdet(np.ones((1, 1)) * n)
    for mul in (0.5, 2.0):
        assert reml_loglik(ctx.delta * mul, S, yt, X0t, ld) <= \
            ctx.loglik + 1e-9


def test_identity_kinship_reduces_to_ols():
    rng = np.random.default_rng(3)
    n, p = 50, 3
    y = rng.normal(size=n)
    X = np.zeros((1, n, p + 1))
    X[0, :, 0] = 1.0
    X[0, :, 1:p] = rng.integers(0, 3, size=(n, p - 1))
    ctx = fit_null_reml(y, np.eye(n))
    _same_fit(ctx, y, np.eye(n))
    ncols = np.array([p], np.int32)
    p_lmm, b_lmm, _se = _lmm_p(X, ctx, ncols)
    p_ols, b_ols = _ols_p(X, y, ncols)
    # rotation by an orthogonal matrix times a scalar leaves t unchanged
    assert float(b_lmm[0]) == pytest.approx(float(b_ols[0]), rel=1e-8)
    assert float(p_lmm[0]) == pytest.approx(float(p_ols[0]), rel=1e-6)


def test_lmm_controls_structure_inflation():
    """Structured phenotype: LMM p-values are less inflated than OLS on
    null (non-causal) variants correlated with the structure."""
    rng = np.random.default_rng(4)
    n = 200
    group = np.repeat([0, 1], n // 2)
    K = 0.9 * (group[:, None] == group[None, :]).astype(float) \
        + 0.1 * np.eye(n)
    L = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    y = 2.0 * (L @ rng.normal(size=n)) + 0.5 * rng.normal(size=n)

    n_var = 60
    X = np.zeros((n_var, n, 3))
    X[:, :, 0] = 1.0
    for v in range(n_var):
        # allele frequency differs by group (confounded, non-causal)
        freq = np.where(group == 0, 0.2, 0.8)
        X[v, :, 1] = rng.binomial(2, freq)
    ncols = np.full(n_var, 2, np.int32)

    ctx = fit_null_reml(y, K)
    _same_fit(ctx, y, K)
    p_lmm, *_ = _lmm_p(X, ctx, ncols)
    p_ols, _b = _ols_p(X, y, ncols)

    def lambda_gc(p):
        chi = scipy.stats.chi2.isf(np.asarray(p), 1)
        return np.median(chi) / scipy.stats.chi2.ppf(0.5, 1)

    assert lambda_gc(p_lmm) < lambda_gc(p_ols)
    assert lambda_gc(p_lmm) < 3.0   # near 1 in expectation; generous bound


def test_cli_lmm_end_to_end(tmp_path):
    from fixtures import make_fixture
    paths = make_fixture(str(tmp_path), n_samples=40, n_snarls=30, seed=11)
    samples = list(paths["samples"])
    n = len(samples)
    rng = np.random.default_rng(5)
    K = random_kinship(n, rng, rank=10)
    kin_path = tmp_path / "kinship.tsv"
    with open(kin_path, "w") as f:
        f.write("id\t" + "\t".join(samples) + "\n")
        for i, s in enumerate(samples):
            f.write(s + "\t" + "\t".join(f"{v:.8f}" for v in K[i]) + "\n")
    out = str(tmp_path / "out_lmm")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-q", paths["quantitative"], "-k", str(kin_path),
                   "--lmm", "-o", out])
    assert not rc
    rows = open(os.path.join(out, "lmm_table_vcf.tsv")).read().splitlines()
    assert rows[0].startswith("#CHR")
    assert len(rows) > 5
    # every P parses as float or NA
    for r in rows[1:]:
        p = r.split("\t")[5]
        assert p == "NA" or 0.0 <= float(p) <= 1.0

    # default behavior unchanged: -k without --lmm runs plain OLS
    out2 = str(tmp_path / "out_ols")
    rc = cli_main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                   "-q", paths["quantitative"], "-k", str(kin_path),
                   "-o", out2])
    assert not rc
    assert os.path.exists(os.path.join(out2, "quantitative_table_vcf.tsv"))
