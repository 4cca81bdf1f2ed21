"""The permutation kernels' tile edges, on the CPU: the port's perm_ols_stats
and score_perm_stats (their plain versions here) against the JAX package's
_perm_quant_pvalues, _score_precompute_jit and _perm_score_pvalues.

csrc/perm_gemm_device.cuh tiles the product over groups of G snarls (8 at
P <= 8, 4 at P <= 16), 64 permutation rows and steps of 32 samples, with
m8 blocks of design columns; these shapes sit on its edges: S = 17 (not a
multiple of G), N = 33 and 37 (a ragged sample step, N P odd), K = 1 and
65 (a ragged row tile), P = 2, 5, 9 and 12 (one and two m8 blocks).  The
inputs are chip_smoke.py's tile_case, whose grid runs on the card kernel
against plain.  Every case holds a rank-deficient snarl (the
pseudo-inverse; for the score test an ill-conditioned V) and, with K > 1,
a NaN in one phenotype or residual row at a sample that no snarl uses: 0 x
NaN makes that row NaN on every snarl, in both packages.  Tolerances as tests/test_torch_permutation.py: the
p-values within 1e-9 relative (rows summed in another order), the NaN and
+inf sets equal; D and the flags exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import permutation as jperm
from stoat_tpu_torch.pipeline import permutation as tperm
from test_torch_cli import _chip_smoke

SMOKE = _chip_smoke()
S = SMOKE.TILE_S
REL = 1e-9
# (N, K, P): every N, K and P of chip_smoke.py's grid, N P odd and even
SHAPES = [(33, 1, 2), (37, 65, 2), (33, 65, 5), (37, 1, 5), (33, 1, 9),
          (37, 65, 9), (33, 65, 12), (37, 1, 12)]


def _case(N, K, P):
    """chip_smoke.tile_case at (N, K, P), snarl S - 1 filtered:
    (X, used, ncols, bad, phenos, Z, w, e)."""
    X, used, ncols, phenos, e, Z, w = SMOKE.tile_case(
        1000 * N + 10 * K + P, S, N, K, P)
    bad = np.zeros(S, bool)
    bad[-1] = True
    return X, used, ncols, bad, phenos, Z, w, e


def _same_nan_inf_and_close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=REL, atol=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("N,K,P", SHAPES)
def test_perm_ols_tile_edges_match_jax(N, K, P):
    """K16a: the [K, S] OLS-t p-values against _perm_quant_pvalues, the
    filtered snarl +inf; the NaN row's t1 NaN on every snarl and nowhere
    else."""
    X, used, ncols, bad, phenos, _Z, _w, _e = _case(N, K, P)
    want = np.asarray(jperm._perm_quant_pvalues(
        jnp.asarray(X), jnp.asarray(used), jnp.asarray(ncols),
        jnp.asarray(bad), jnp.asarray(phenos)))
    t1, df = tperm.perm_ols_stats(_t(X), _t(used), _t(ncols), _t(phenos))
    assert t1.shape == df.shape == (K, S)
    got = tperm.quant_perm_pvalues(t1, df, _t(bad)).numpy()
    _same_nan_inf_and_close(got, want)
    assert np.isinf(want[:, -1]).all()
    nan_rows = np.isnan(t1.numpy()).all(axis=1)
    assert nan_rows.tolist() == [K > 1 and k == K // 2 for k in range(K)]
    assert not np.isnan(t1.numpy()[~nan_rows]).any()


@pytest.mark.parametrize("N,K,P", SHAPES)
def test_score_perm_tile_edges_match_jax(N, K, P):
    """K16b/c: D, df and allbad exact and the [K, S] score p-values within
    1e-9 of _score_precompute_jit and _perm_score_pvalues; the NaN row's T
    NaN on every snarl, its p +inf."""
    X, used, ncols, bad, _ph, Z, w, e = _case(N, K, P)
    jD, jV, jdf, jbad = (np.asarray(a) for a in jperm._score_precompute_jit(
        jnp.asarray(X), jnp.asarray(used), jnp.asarray(ncols),
        jnp.asarray(bad), jnp.asarray(Z), jnp.asarray(w)))
    D, V, df, allbad = tperm.score_precompute(
        _t(X), _t(used), _t(ncols), _t(bad), _t(Z), _t(w))
    np.testing.assert_array_equal(D.numpy(), jD)
    np.testing.assert_array_equal(df.numpy(), jdf)
    np.testing.assert_array_equal(allbad.numpy(), jbad)
    assert allbad[0] and allbad[-1] and not allbad.all()
    want = np.asarray(jperm._perm_score_pvalues(
        jnp.asarray(jD), jnp.asarray(used), jnp.asarray(jV),
        jnp.asarray(jdf), jnp.asarray(jbad), jnp.asarray(e)))
    T = tperm.score_perm_stats(D, _t(used), V, _t(e))
    assert T.shape == (K, S)
    got = tperm.score_perm_pvalues(T, df, allbad).numpy()
    _same_nan_inf_and_close(got, want)
    if K > 1:
        assert np.isnan(T[K // 2].numpy()).all()
        assert np.isinf(got[K // 2]).all()
