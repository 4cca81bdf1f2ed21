"""Parity of the port's binary permutation statistic (K15) with the JAX
package on the edge grid that chip_smoke.py holds the card's kernel to,
on the CPU.

csrc/perm_binary.cu takes row tiles of floor(64 / Pmax) whole snarls
(rounded up to 64 rows, one snarl over several 32-row units above Pmax =
64) and tiles of 128 masks (32 or 8 for very wide snarls), the words in
stages of 32; ``chip_smoke.perm_binary_grid_cases`` sits on those edges:
Pmax = 1, 3, 4, 65, 400 and 1,966, K = 1, 33 and 129, W = 1 and ragged
last words, a snarl of -1 columns only, invalid paths, an all-zero and an
all-ones mask.  Its numpy inputs go through stoat_tpu's
_perm_binary_pvalues and through the port's perm_membership and
perm_binary_stats (their plain versions here), then the port's chi-squared
tail.  Tolerances: every row's statistic, df and flags bitwise equal to
K3's plain version on that mask's counts (K15's own contract); the +inf
sets of the p-values equal, and the p-values within 1e-12 relative where
df <= 40, the bound tests/test_torch_stats.py holds the port's
chi-squared tail to against JAX's, and within 5e-12 at the wide snarls'
df > 40, the bound tests/test_torch_chi2_tail.py holds it to over df
1-400 (both packages run JAX's igammac; they differ in their logarithms,
exponentials and lgamma's divisions, 8.5e-15 apart at df ~ 400 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import permutation as jperm
from stoat_tpu_torch.pipeline import permutation as tperm
from stoat_tpu_torch.pipeline.binary import binary_tables_plain
from test_torch_cli import _chip_smoke

SMOKE = _chip_smoke()
TH = SMOKE.THRESHOLDS
REL = 1e-12
LARGE_DF_REL = 5e-12
CASES = {c[0]: c[1:] for c in SMOKE.perm_binary_grid_cases()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(name):
    """The port's (mem, g_all) and its K15 outputs on case ``name``."""
    words, valid, tail, masks, sidx = CASES[name]
    idx = np.arange(words.shape[0], dtype=np.int32)[:, None]
    mem, g_all = tperm.perm_membership(_t(words.view(np.int32)), _t(idx),
                                       _t(valid), _t(tail.view(np.int32)))
    stats = tperm.perm_binary_stats(mem, g_all, _t(masks.view(np.int32)),
                                    _t(sidx), *TH)
    return mem, g_all, stats


@pytest.mark.parametrize("name", sorted(CASES))
def test_perm_binary_grid_matches_jax(name):
    """The [K, S] p-values against _perm_binary_pvalues: the same +inf set
    (the all -1 snarl among it), the rest within REL."""
    words, valid, tail, masks, sidx = CASES[name]
    want = np.asarray(jperm._perm_binary_pvalues(
        jnp.asarray(words), jnp.asarray(valid), jnp.asarray(tail),
        jnp.asarray(masks), jnp.asarray(sidx), *map(jnp.float64, TH)))
    _mem, _g, (stat, df, bad) = _port(name)
    got = tperm.binary_perm_pvalues(stat, df, bad).numpy()
    assert got.shape == want.shape == (masks.shape[0], sidx.shape[0])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(want[:, 1]).all()
    ok = np.isfinite(want)
    assert ok.any() == (sidx.shape[1] > 1)
    small = ok & (df.numpy() <= 40)
    np.testing.assert_allclose(got[small], want[small], rtol=REL, atol=0)
    np.testing.assert_allclose(got[ok & ~small], want[ok & ~small],
                               rtol=LARGE_DF_REL, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_perm_binary_grid_rows_are_k3s_bits(name):
    """Every mask's statistic and df bitwise equal to K3's plain version
    on that mask's counts (numpy popcounts of the tail-masked words); the
    membership words tail-masked and zero on invalid paths."""
    words, valid, tail, masks, sidx = CASES[name]
    mem, g_all, (stat, df, bad) = _port(name)
    want_mem = np.where(valid[:, None], words & tail, 0)
    np.testing.assert_array_equal(mem.numpy().view(np.uint32), want_mem)
    bits = np.unpackbits(want_mem.view(np.uint8), axis=1)
    np.testing.assert_array_equal(g_all.numpy(), bits.sum(axis=1))
    for k in range(masks.shape[0]):
        case = np.unpackbits((want_mem & masks[k]).view(np.uint8), axis=1)
        g1 = case.sum(axis=1).astype(np.float64)
        t = binary_tables_plain(_t(bits.sum(axis=1) - g1), _t(g1),
                                _t(sidx), *TH)
        np.testing.assert_array_equal(stat[k].numpy(),
                                      t["chi2_stat"].numpy())
        np.testing.assert_array_equal(df[k].numpy(), t["chi2_df"].numpy())
        np.testing.assert_array_equal(
            bad[k].numpy(), (t["filtered"] | t["chi2_invalid"]
                             | t["chi2_zexp"]).numpy())
