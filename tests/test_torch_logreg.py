"""Parity of the port's logistic regression (K11) and its normal tail with
the JAX package, float64 on the CPU.

The same numpy designs, made from a seed, go through stoat_tpu's
``logistic_regression_batch`` and the port's ``logistic_regression_plain``.
Tolerance: a relative 1e-9 on p, beta and se with identical NA sets (and
identical infinities).  The Newton iterations sum over the rows in
another order (torch.bmm against XLA's dot), and the sigmoid's exp comes
from another library: the differences are ~1e-14 on well-conditioned
designs.  ``normal_sf2_plain`` against JAX's ``normal_sf2``: an absolute
4.5e-16 (two ulps of ndtr's argument y in [1, 2]): XLA's erf and erfc and
glibc's differ in the last bit for |z| < 3.43, and ``1 - cdf`` keeps that
absolute step, which is the reference's own quantisation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from jax.scipy.special import ndtr as j_ndtr
from stoat_tpu.stats.logreg import logistic_regression_batch as j_logreg
from stoat_tpu.stats.special import normal_sf2 as j_normal_sf2
from stoat_tpu_torch.stats.logreg import (MAX_ITER, logistic_regression,
                                          logistic_regression_plain)
from stoat_tpu_torch.stats.special import ndtr_plain, normal_sf2_plain
from test_torch_cli import _chip_smoke

REL = 1e-9


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# chip_smoke.py holds the edge designs that the card's kernel is checked on
SMOKE = _chip_smoke()
_pack = SMOKE.pack_designs


def _oracle_designs(seed, count, max_k):
    """tests/test_stats_oracle.py:262: [1 | uniform dosages], y drawn from
    a logistic model of the first dosage."""
    rng = np.random.default_rng(seed)
    designs, ys = [], []
    for _ in range(count):
        n = int(rng.integers(30, 80))
        k = int(rng.integers(1, max_k + 1))
        dos = rng.random((n, k))
        logits = -0.3 + 1.5 * dos[:, 0]
        ys.append((rng.random(n) < 1 / (1 + np.exp(-logits))).astype(float))
        designs.append(np.column_stack([np.ones(n), dos]))
    return designs, ys


def _check(X, y, mask, ncols):
    want = [np.asarray(w) for w in j_logreg(X, y, mask, ncols)]
    got = logistic_regression_plain(_t(X), _t(y), _t(mask), _t(ncols))
    for key, w in zip(("p", "beta", "se"), want):
        g = got[key].numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=REL, atol=0)
    return got


@pytest.mark.parametrize("seed,max_k,P,N", [(4, 3, 6, 96), (8, 3, 6, 96),
                                            (9, 2, 4, 80)])
def test_logreg_oracle_designs_match_jax(seed, max_k, P, N):
    got = _check(*_pack(*_oracle_designs(seed, 24, max_k), P=P, N=N))
    assert np.isfinite(got["p"].numpy()).all()
    assert (got["iters"].numpy() < 20).all()


def test_logreg_edge_designs_match_jax():
    """chip_smoke.py's edge designs (separated, oscillating, failing,
    singular, all-NaN-p, Holm with m = 3) in one batch: each snarl's result
    depends on its own design alone."""
    cases = SMOKE.logreg_edge_designs()
    assert [c[0] for c in cases] == ["separated", "oscillating", "failing",
                                     "singular", "all_nan_p", "holm_m3"]
    got = _check(*_pack([c[1] for c in cases], [c[2] for c in cases], P=5,
                        N=200))
    p = got["p"].numpy()
    iters = got["iters"].numpy().tolist()
    assert np.isfinite(p[0]) and iters[0] == 13
    assert np.isnan(p[1]) and iters[1] == MAX_ITER
    assert np.isnan(p[2]) and iters[2] == 1
    assert np.isfinite(p[3]) and np.isfinite(p[5])
    assert p[4] == np.inf and got["beta"].numpy()[4] == 0.0
    assert np.isfinite(got["se"].numpy()[4])


def test_logreg_pt12_matches_jax():
    """PT = 12: eleven variant columns wide, padded and not."""
    designs, ys = SMOKE.logreg_pt12_designs()
    _check(*_pack(designs, ys, P=12, N=300))


@pytest.mark.parametrize("case", ["stream_p5", "p7", "p8", "p60", "p118"])
def test_logreg_grid_matches_jax(case):
    """chip_smoke.py's grid at the edges of the kernel's design: rows past
    the ones a block holds, P + 1 = 8 and 9 (one and three output tiles),
    the algebra beside few rows (P = 60) and in the scratch (P = 118)."""
    designs = dict(SMOKE.logreg_grid_designs())
    assert sorted(designs) == sorted(["stream_p5", "p7", "p8", "p60",
                                      "p118"])
    got = _check(*designs[case])
    assert np.isfinite(got["p"].numpy()).all()
    assert (got["iters"].numpy() < 20).all()


def test_logreg_wrapper_masks_degenerate_and_counts_steps():
    X, y, mask, ncols = _pack(*_oracle_designs(4, 6, 2), P=4, N=80)
    deg = np.array([False, True, False, False, True, False])
    out = logistic_regression(_t(X), _t(y), _t(mask), _t(ncols), _t(deg))
    plain = logistic_regression_plain(_t(X), _t(y), _t(mask), _t(ncols))
    assert sorted(out) == ["beta", "iters", "p", "se"]
    for key in ("p", "beta", "se"):
        o, p = out[key].numpy(), plain[key].numpy()
        assert np.isnan(o[deg]).all()
        np.testing.assert_array_equal(o[~deg], p[~deg])
    assert out["iters"].dtype == torch.int32
    assert (out["iters"].numpy() == plain["iters"].numpy()).all()


def test_normal_sf2_matches_jax():
    z = np.concatenate([np.linspace(0.0, 40.0, 200001),
                        [8.2, 8.3, 8.5, 37.5, np.inf, np.nan]])
    want = np.asarray(j_normal_sf2(jnp.asarray(z)))
    got = normal_sf2_plain(_t(z)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.max(np.abs(got[ok] - want[ok])) <= 4.5e-16
    # the reference's 1 - cdf: exactly 0 from |z| ~ 8.3 on, as in JAX
    assert (got[(z > 8.3) & ~np.isnan(z)] == 0.0).all()
    assert (want[(z > 8.3) & ~np.isnan(z)] == 0.0).all()
    assert got[0] == 1.0
    x = np.linspace(-12.0, 12.0, 4801)
    assert np.max(np.abs(ndtr_plain(_t(x)).numpy()
                         - np.asarray(j_ndtr(jnp.asarray(x))))) <= 2.3e-16
