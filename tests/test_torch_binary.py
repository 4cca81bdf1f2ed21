"""Parity of the port's binary pipeline (K3, and K1-K5 together) with the
JAX package, on the CPU, plus the host-copy contract of pipeline/fetch.py.

Tolerances: flags, keep masks and counts exact; the chi-squared statistic
to a relative 1e-12 (the JAX sum over columns may run in another order);
p-values to identical ``format_p`` strings and a relative 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from stoat_tpu.pipeline import packed as jpk
from stoat_tpu.pipeline.binary import (_binary_from_path_counts,
                                       binary_tables_device_packed)
from stoat_tpu.writer import format_p
from stoat_tpu_torch.convert import DeviceChunk
from stoat_tpu_torch.pipeline import fetch
from stoat_tpu_torch.pipeline.binary import (binary_tables,
                                             binary_tables_packed)


def _random_counts(seed, S=64, Pmax=8, P=200, hi=60):
    rng = np.random.default_rng(seed)
    g0 = rng.integers(0, hi, P).astype(np.float64)
    g1 = rng.integers(0, hi, P).astype(np.float64)
    zero = rng.random(P) < 0.2           # columns with no carriers
    g0[zero] = 0
    g1[zero] = 0
    g1[rng.random(P) < 0.1] = 0          # zero case margins
    sidx = rng.integers(0, P, (S, Pmax)).astype(np.int32)
    n_real = rng.integers(1, Pmax + 1, S)
    sidx[np.arange(Pmax)[None, :] >= n_real[:, None]] = -1
    sidx[-1] = -1                        # a padded snarl slot
    return g0, g1, sidx


def _compare(got, want, key):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, key
    if key in ("chi2_stat", "p_fisher", "p_chi2"):
        assert [format_p(v) for v in got] == [format_p(v) for v in want], key
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("seed,min_ind,min_hap,maf", [
    (0, 3, 5, 0.05), (1, 3, 5, 0.05), (2, 10, 30, 0.2), (3, 2, 2, 0.0),
    (4, 40, 5, 0.45)])
def test_binary_tables_match_jax(seed, min_ind, min_hap, maf):
    """K3 against ``_binary_from_path_counts(tails=False)``."""
    g0, g1, sidx = _random_counts(seed)
    want = _binary_from_path_counts(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(sidx),
        jnp.float64(min_ind), jnp.float64(min_hap), jnp.float64(maf),
        tails=False)
    got = binary_tables(torch.from_numpy(g0), torch.from_numpy(g1),
                        torch.from_numpy(sidx), min_ind, min_hap, maf)
    for key in ("filtered", "keep", "g0", "g1", "chi2_df", "chi2_invalid",
                "chi2_zexp", "chi2_stat"):
        _compare(got[key].numpy(), want[key], key)
    k = got["k"].numpy()
    np.testing.assert_array_equal(k, np.asarray(want["keep"]).sum(-1))


def test_binary_tables_first_two_kept_columns():
    """a, b / c, d are the first two kept columns in column order."""
    g0 = np.array([0, 5, 0, 7, 9], np.float64)
    g1 = np.array([0, 1, 0, 2, 3], np.float64)
    sidx = np.array([[0, 1, 2, 3], [4, -1, -1, -1], [2, 0, -1, -1]],
                    np.int32)
    got = binary_tables(torch.from_numpy(g0), torch.from_numpy(g1),
                        torch.from_numpy(sidx), 3, 5, 0.05)
    assert got["k"].tolist() == [2, 1, 0]
    assert got["a"].tolist() == [5, 9, 0] and got["b"].tolist() == [7, 0, 0]
    assert got["c"].tolist() == [1, 3, 0] and got["d"].tolist() == [2, 0, 0]
    assert got["chi2_df"].tolist() == [1.0, 1.0, 1.0]


def _random_chunk(seed, E=60, H=150, S=16, Pmax=4):
    rng = np.random.default_rng(seed)
    matrix = rng.random((E, H)) < 0.7
    n_paths = rng.integers(2, Pmax + 1, S)
    P = int(n_paths.sum()) + 3            # trailing invalid padding slots
    sidx = np.full((S, Pmax), -1, np.int32)
    start = 0
    for s, n in enumerate(n_paths):
        sidx[s, :n] = np.arange(start, start + n)
        start += n
    valid = np.ones(P, bool)
    valid[-3:] = False
    valid[rng.integers(0, P - 3, 2)] = False
    coo_path, coo_row = [], []
    for p in range(P):
        for _ in range(rng.integers(0, 4)):
            coo_path.append(p)
            coo_row.append(rng.integers(0, E))
    coo_path = np.array(coo_path, np.int32)
    coo_row = np.array(coo_row, np.int32)
    words = jpk.pack_matrix_words(matrix)
    idx = jpk.pack_path_edge_idx(coo_path, coo_row, valid, E)
    pheno = rng.random(H // 2) < 0.5
    return words, idx, valid, sidx, pheno, H


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_pipeline_matches_jax(seed):
    """K1+K2 -> K3 -> K4 -> K5 against binary_tables_device_packed."""
    words, idx, valid, sidx, pheno, H = _random_chunk(seed)
    W = words.shape[1]
    g1w, tail = jpk.upload_pheno_mask_words(pheno, H, W)
    want = binary_tables_device_packed(
        jnp.asarray(words), jnp.asarray(idx), jnp.asarray(valid), tail,
        g1w, jnp.asarray(sidx), jnp.float64(3), jnp.float64(5),
        jnp.float64(0.05))
    chunk = DeviceChunk(
        words=torch.from_numpy(words.view(np.int32).copy()),
        path_idx=torch.from_numpy(idx),
        path_valid=torch.from_numpy(valid),
        snarl_path_idx=torch.from_numpy(sidx),
        tail=torch.from_numpy(np.asarray(tail).view(np.int32).copy()),
        g1_words=torch.from_numpy(np.asarray(g1w).view(np.int32).copy()))
    got = binary_tables_packed(chunk, 3, 5, 0.05)
    assert sorted(got) == sorted(want)
    for key in want:
        _compare(got[key].numpy(), want[key], key)


class _FakeEvent:
    """Stands in for a torch.cuda.Event whose copies land only when it is
    synchronized, as a non-blocking device-to-host copy does."""

    def __init__(self, pending):
        self.pending = pending
        self.synced = 0

    def synchronize(self):
        for dst, src in self.pending:
            dst.copy_(src)
        self.synced += 1


def test_host_result_waits_for_its_event():
    """A HostResult never hands out a buffer before its event completes:
    reading a non-blocking copy early returns stale memory, silently."""
    src = {"p": torch.arange(5, dtype=torch.float64),
           "f": torch.tensor([True, False])}
    host = {k: torch.full_like(v, 7) if v.dtype != torch.bool
            else torch.zeros_like(v) for k, v in src.items()}
    event = _FakeEvent([(host[k], src[k]) for k in src])
    res = fetch.HostResult(host, event)
    assert event.synced == 0
    np.testing.assert_array_equal(res["p"], np.arange(5.0))
    assert res["f"].tolist() == [True, False]
    assert event.synced == 1           # one wait serves every key
    assert sorted(res) == ["f", "p"] and len(res) == 2


def test_fetch_async_cpu_hands_over_arrays():
    out = {"a": torch.ones(3, dtype=torch.float64),
           "b": torch.zeros(2, 2, dtype=torch.bool)}
    res = fetch.fetch_async(out)
    np.testing.assert_array_equal(res["a"], np.ones(3))
    assert res["b"].shape == (2, 2)
    with pytest.raises(ValueError):
        fetch.fetch_async({"a": torch.ones(1),
                           "b": torch.ones(1, device="meta")})
