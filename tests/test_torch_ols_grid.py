"""Parity of the port's OLS (K9) and eQTL pair OLS (K13) with the JAX
package on the edge grid that chip_smoke.py holds the card's kernels to,
float64 on the CPU.

The numpy designs of ``chip_smoke.ols_grid_designs`` and
``eqtl_grid_designs`` go through stoat_tpu's
``linear_regression_stats_batch`` (on y = row * mask; per pair on the
gathered X and expression row) and ``eqtl_regress_pairs``, and through the
port's ``linear_regression_row_stats`` and ``eqtl_ols_stats`` (their plain
versions here).  Tolerance: a relative 1e-9 on the statistics, as
``tests/test_torch_linreg.py`` states it (1e-8 on the rows that take the
pseudo-inverse, as chip_smoke.py holds them: at P = 90 the two packages'
Jacobi sweeps end 2.5e-9 apart), r2 held as 1 - r2 (the scale
chip_smoke.stat_err holds it in: a rank-deficient design's r2 of 0 is
-2.2e-16 in one package); df_res exactly.  Rows of a
constant y (tss = 0) are noise in both: r2 not finite, |beta1| and se1
below 1e-9.  The phenotype row through ``linear_regression_row_stats``
gives bit for bit the statistics of y = row * mask through
``linear_regression_stats``, with every row used where the mask is None.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import quantitative as jq
from stoat_tpu.stats.linreg import linear_regression_stats_batch as j_ols
from stoat_tpu_torch.convert import to_eqtl_pairs
from stoat_tpu_torch.pipeline import quantitative as tq
from stoat_tpu_torch.stats.linreg import (linear_regression_row_stats,
                                          linear_regression_stats)
from test_torch_cli import _chip_smoke

REL = 1e-9
PINV_REL = 1e-8
CPU = torch.device("cpu")
SMOKE = _chip_smoke()
OLS_CASES = {c[0]: c[1:] for c in SMOKE.ols_grid_designs()}
EQTL_CASES = {c[0]: c[1:] for c in SMOKE.eqtl_grid_designs()}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _full(X, row, mask):
    """(y = row * mask [S, N], mask [S, N]) as the JAX package takes them;
    mask None uses every row."""
    if mask is None:
        mask = np.ones(X.shape[:2], bool)
    return row[None, :] * mask, mask


def _pinv(X, ncols):
    """bool [S]: the designs that take the pseudo-inverse."""
    rows, _ = SMOKE.pinv_rows(_t(X), _t(ncols))
    out = np.zeros(X.shape[0], bool)
    out[rows] = True
    return out


def _hold(got, want, pinv, noise=()):
    """(t1, df_res, beta1, se1, r2) of the port against the JAX package's;
    ``pinv`` marks the rows held to PINV_REL."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    rest = np.ones(got[0].shape, bool)
    rest[list(noise)] = False
    np.testing.assert_array_equal(got[1], want[1])
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 4:
            g, w = 1.0 - g, 1.0 - w
        for rows, rel in ((rest & ~pinv, REL), (rest & pinv, PINV_REL)):
            a, b = g[rows], w[rows]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            ok = np.isfinite(b)
            np.testing.assert_allclose(a[ok], b[ok], rtol=rel, atol=0)
    for stats in (got, want):
        _t1, _df, beta1, se1, r2 = (v[list(noise)] for v in stats)
        assert not np.isfinite(r2).any()
        assert (np.abs(beta1) < 1e-9).all() and (se1 < 1e-9).all()


@pytest.mark.parametrize("name", sorted(OLS_CASES))
def test_ols_grid_matches_jax(name):
    """The port's OLS entry point of the pipelines on the grid, against
    stoat_tpu's linear_regression_stats_batch on y = row * mask, and bit
    for bit the port's linear_regression_stats on that y (but on the wide
    designs, whose Jacobi sweeps take half a minute on the CPU and run the
    same code)."""
    X, row, mask, ncols, noise = OLS_CASES[name]
    yf, mf = _full(X, row, mask)
    want = j_ols(X, yf, mf, ncols)
    got = linear_regression_row_stats(
        _t(X), _t(row), None if mask is None else _t(mask), _t(ncols))
    _hold(got, want, _pinv(X, ncols), noise)
    if X.shape[2] > 12:
        return
    full = linear_regression_stats(_t(X), _t(yf), _t(mf), _t(ncols))
    for a, b in zip(got, full):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("name", sorted(EQTL_CASES))
def test_eqtl_grid_matches_jax(name):
    """eqtl_ols_stats on the grid's CSR pairs against stoat_tpu's
    linear_regression_stats_batch on X[pair_snarl] and expr[gene] * used,
    and eqtl_regress_pairs' p, beta, se and r2 against stoat_tpu's."""
    X, mask, ncols, pair_snarl, pair_gene, expr, noise_genes = \
        EQTL_CASES[name]
    counts = np.bincount(pair_snarl, minlength=X.shape[0])
    assert {0, 1, 8, 9, 33} <= set(counts.tolist())
    ps = np.asarray(pair_snarl)
    pg = np.asarray(pair_gene)
    noise = np.flatnonzero(np.isin(pg, noise_genes)).tolist()
    assert noise
    want = j_ols(X[ps], expr[pg] * mask[ps], mask[ps], ncols[ps])
    pairs = to_eqtl_pairs(pair_snarl, pair_gene, X.shape[0], CPU)
    got = tq.eqtl_ols_stats(_t(X), _t(mask), _t(ncols), *pairs, _t(expr))
    pinv = _pinv(X, ncols)[ps]
    _hold(got, want, pinv, noise)

    deg = np.zeros(X.shape[0], bool)
    jdesign = {"X": jnp.asarray(X), "used": jnp.asarray(mask),
               "ncols": jnp.asarray(ncols), "degenerate": jnp.asarray(deg)}
    jout = jq.eqtl_regress_pairs(jdesign, ps, expr[pg])
    tdesign = {"X": _t(X), "used": _t(mask), "ncols": _t(ncols),
               "degenerate": _t(deg)}
    tout = tq.eqtl_regress_pairs(tdesign, *pairs, _t(expr))
    rest = ~np.isin(pg, noise_genes)
    for key in ("p", "beta", "se", "r2"):
        g, w = np.asarray(tout[key]), np.asarray(jout[key])
        if key == "r2":
            g, w = 1.0 - g, 1.0 - w
        for rows, rel in ((rest & ~pinv, REL), (rest & pinv, PINV_REL)):
            a, b = g[rows], w[rows]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            ok = np.isfinite(b)
            np.testing.assert_allclose(a[ok], b[ok], rtol=rel, atol=0)
