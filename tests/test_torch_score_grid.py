"""Parity of the port's score-test precompute (K16b) with the JAX package
on the edge grid that chip_smoke.py holds the card's kernel to, float64
on the CPU.

csrc/score_test.cu's score_precompute takes a snarl a warp, 8 a block,
streams the rows in tiles of a multiple of 8 and sums the Gram of [D | Z]
in 8 x 8 tiles; ``chip_smoke.score_grid_cases`` sits on those edges: PT +
C1 = 8 (one tile), 10 and 17 (two and three tile columns) and 3, N not a
multiple of 4, S not a multiple of 8, a snarl with no used row, one with
ncols = 1, one flagged bad, and a singular Z^T W Z.  Its numpy inputs go
through stoat_tpu's _score_precompute_jit and the port's
score_precompute (its plain version here), then both packages' score
p-values.  Tolerances: D, df and allbad exact; V^-1 within 1e-9 of each
snarl's largest entry on the snarls not flagged (an ill-conditioned V
inverts to finite garbage that no statistic reads); the p-values' +inf
sets equal and the rest within 1e-9 relative (sums over the rows in
another order), as tests/test_torch_permutation.py states them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import permutation as jperm
from stoat_tpu_torch.pipeline import permutation as tperm
from test_torch_cli import _chip_smoke

SMOKE = _chip_smoke()
REL = 1e-9
CASES = {c[0]: c[1:] for c in SMOKE.score_grid_cases()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(name):
    """(JAX's (D, Vinv, df, allbad), the port's) on case ``name``."""
    X, used, ncols, bad, Z, w, _e = CASES[name]
    want = tuple(np.asarray(a) for a in jperm._score_precompute_jit(
        *(jnp.asarray(a) for a in (X, used, ncols, bad, Z, w))))
    got = tuple(a.numpy() for a in tperm.score_precompute(
        *(_t(a) for a in (X, used, ncols, bad, Z, w))))
    return want, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_score_grid_precompute_matches_jax(name):
    """D, df and allbad exact, V^-1 within REL on the snarls not flagged;
    the degenerate snarls (no used row, ncols = 1, bad) flagged, and all
    of them under a singular Z^T W Z."""
    (jD, jV, jdf, jbad), (D, V, df, allbad) = _both(name)
    np.testing.assert_array_equal(D, jD)
    np.testing.assert_array_equal(df, jdf)
    np.testing.assert_array_equal(allbad, jbad)
    assert allbad[:3].all()
    assert allbad.all() == (name == "singular_g")
    good = ~allbad
    scale = np.abs(jV[good]).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(V[good] - jV[good]) <= REL * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_score_grid_pvalues_match_jax(name):
    """The score test's [3, S] p-values on those pieces (the port's
    score_perm_stats and chi-squared tail against _perm_score_pvalues):
    the same +inf set, the rest within REL."""
    X, used, ncols, bad, Z, w, e = CASES[name]
    (jD, jV, jdf, jbad), _ = _both(name)
    want = np.asarray(jperm._perm_score_pvalues(
        *(jnp.asarray(a) for a in (jD, used, jV, jdf, jbad, e))))
    D, V, df, allbad = tperm.score_precompute(
        *(_t(a) for a in (X, used, ncols, bad, Z, w)))
    T = tperm.score_perm_stats(D, _t(used), V, _t(e))
    got = tperm.score_perm_pvalues(T, df, allbad).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert ok.any() == (name != "singular_g")
    np.testing.assert_allclose(got[ok], want[ok], rtol=REL, atol=0)
