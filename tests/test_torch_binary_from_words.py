"""The main path's count, table and Fisher call (``binary_stats_from_words``,
csrc/binary_stats.cu's binary_from_words), on the CPU.

Its plain version is ``membership_counts_plain`` followed by
``binary_stats_plain``, bit for bit: the wrapper's result on CPU tensors is
held to that chain on chunks of tests/fixtures.make_fixture (two seeds,
2-4 allele paths a snarl), on the same chunks with invalid paths and paths
of no edge, on words with the sign bit set, and on the dual's rows (its
membership words as word rows, one row a path: K = 1).  Against stoat_tpu's
``binary_tables_device_packed`` on the same numpy inputs: counts, flags
and keep masks exact; Fisher's p the same strings within a relative 1e-12
(XLA's CPU build differs in the last bit of some values, as
tests/test_torch_fisher_scan.py holds it); the chi-squared p the same
strings within a relative 1e-12 (tests/test_torch_binary.py's bound for
the tail).  On CPU tensors the wrapper launches nothing; its one output
allocation is checked by a stand-in launch that writes the plain
version's outputs through the pointers it is given.  No kernel is built
here: chip_smoke.py holds the kernel to the plain version on the card.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import chip_smoke
from fixtures import make_fixture
from stoat_tpu.pipeline.binary import binary_tables_device_packed
from stoat_tpu.writer import format_p
from stoat_tpu_torch import kernels
from stoat_tpu_torch.pipeline import binary
from stoat_tpu_torch.pipeline.binary import (binary_stats_from_words,
                                             binary_stats_from_words_plain,
                                             binary_stats_plain,
                                             binary_tables_packed,
                                             with_chi2_tail)
from stoat_tpu_torch.pipeline.packed import membership_counts_plain
from stoat_tpu_torch.pipeline.permutation import perm_membership_plain

CPU = torch.device("cpu")
THRESHOLDS = (3, 5, 0.05)
CASES = ("fixture", "invalid and zero-edge paths", "sign-bit words",
         "dual rows")


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """The first chunk of make_fixture's cohort at seeds 0 and 1 (120
    samples, 300 snarls of 2-4 allele paths on two chromosomes), as the
    main path builds it (chip_smoke.main_path_chunks), on the CPU."""
    out = {}
    for seed in (0, 1):
        tmp = tmp_path_factory.mktemp(f"from_words_{seed}")
        paths = make_fixture(str(tmp), n_samples=120, n_snarls=300,
                             seed=seed, n_chroms=2)
        out[seed] = chip_smoke.main_path_chunks(paths, CPU)[0]
    return out


def _case(chunk, case, seed):
    """(words, path_idx, path_valid, tail, g1_words, snarl_path_idx) of
    ``case`` on a fixture chunk."""
    words, idx, valid = chunk.words, chunk.path_idx, chunk.path_valid
    tail, g1w, sidx = chunk.tail, chunk.g1_words, chunk.snarl_path_idx
    rng = np.random.default_rng(10 + seed)
    P = idx.shape[0]
    if case == "invalid and zero-edge paths":
        valid = valid.clone()
        valid[torch.from_numpy(rng.choice(P, P // 8, replace=False))] = False
        # a valid path of no edge: every row the identity (the last row)
        assert (words[-1] == -1).all()
        idx = idx.clone()
        zero = torch.from_numpy(rng.choice(P, P // 8, replace=False))
        idx[zero] = words.shape[0] - 1
        valid[zero] = True
    elif case == "sign-bit words":
        raw = rng.integers(0, 2 ** 32, tuple(words.shape), dtype=np.uint64)
        raw[-1] = 2 ** 32 - 1                   # the identity row
        raw[:, :2] |= 2 ** 31
        words = torch.from_numpy(raw.astype(np.uint32).view(np.int32))
        g1w = g1w | torch.tensor(-2 ** 31, dtype=torch.int32)
    elif case == "dual rows":
        words, _ = perm_membership_plain(words, idx, valid, tail)
        idx = torch.arange(P, dtype=torch.int32)[:, None]
    return words, idx, valid, tail, g1w, sidx


def _same(got, want):
    got, want = got.numpy(), want.numpy()
    if got.dtype == np.float64:
        return chip_smoke.same_bits(got, want)
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_is_the_counts_then_the_stats(chunks, seed, case):
    """The wrapper on CPU tensors is membership_counts_plain, then
    binary_stats_plain, bit for bit in every output."""
    args = _case(chunks[seed], case, seed)
    got = binary_stats_from_words(*args, *THRESHOLDS)
    g0p, g1p = membership_counts_plain(*args[:5])
    want = binary_stats_plain(g0p, g1p, args[5], *THRESHOLDS)
    assert set(got) == set(want) == set(binary.STATS_F64 + binary.STATS_U8)
    for key in want:
        assert _same(got[key], want[key]), key
    if case == "invalid and zero-edge paths":
        # an invalid path counts 0 and stays a real column
        valid = args[2].numpy()
        sidx = args[5].numpy()
        dead = (sidx >= 0) & ~valid[np.maximum(sidx, 0)]
        assert dead.any()
        assert (got["g0"].numpy()[dead] == 0).all()
        assert (got["g1"].numpy()[dead] == 0).all()


def _compare(got, want, key):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if key in ("p_fisher", "p_chi2"):
        assert [format_p(v) for v in got] == [format_p(v) for v in want], key
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_against_jax(chunks, seed, case):
    """With its tail, against stoat_tpu's binary_tables_device_packed on
    the same numpy inputs."""
    args = _case(chunks[seed], case, seed)
    words, idx, valid, tail, g1w, sidx = (a.numpy() for a in args)
    want = binary_tables_device_packed(
        jnp.asarray(words.view(np.uint32)), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(tail.view(np.uint32)),
        jnp.asarray(g1w.view(np.uint32)), jnp.asarray(sidx),
        jnp.float64(THRESHOLDS[0]), jnp.float64(THRESHOLDS[1]),
        jnp.float64(THRESHOLDS[2]))
    got = with_chi2_tail(binary_stats_from_words(*args, *THRESHOLDS))
    assert sorted(got) == sorted(want)
    for key in want:
        _compare(got[key].numpy(), want[key], key)
    assert np.asarray(want["keep"]).any(axis=1).any()


GRID = chip_smoke.from_words_grid_cases()


@pytest.mark.parametrize("name", [name for name, _ in GRID])
def test_grid_against_jax(name):
    """chip_smoke.py's grid for the kernel (phase 3 holds the card's
    kernel to the plain version on it): H = 7 to 9,000 (W = 1, a
    part-filled last word, two batches of a lane's words), K = 128 rows a
    path, Pmax = 700, a path in two snarls, a snarl slot of padding only;
    the plain version against the counts-then-stats chain and against
    stoat_tpu."""
    words, idx, valid, tail, g1w, sidx = dict(GRID)[name]
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                             if a.dtype == np.uint32 else a.copy())
            for a in (words, idx, valid, tail, g1w, sidx)]
    got = binary_stats_from_words(*args, *THRESHOLDS)
    g0p, g1p = membership_counts_plain(*args[:5])
    for key, want in binary_stats_plain(g0p, g1p, args[5],
                                        *THRESHOLDS).items():
        assert _same(got[key], want), key
    want = binary_tables_device_packed(
        jnp.asarray(words), jnp.asarray(idx), jnp.asarray(valid),
        jnp.asarray(tail), jnp.asarray(g1w), jnp.asarray(sidx),
        *(jnp.float64(t) for t in THRESHOLDS))
    got = with_chi2_tail(got)
    for key in want:
        _compare(got[key].numpy(), want[key], key)


def test_cpu_tensors_launch_nothing(chunks, monkeypatch):
    """A CPU tensor never reaches the launcher, on the wrapper and on the
    main path's chunk call (binary_tables_packed)."""
    def no_launch(*a, **k):
        raise AssertionError("launch on CPU tensors")
    monkeypatch.setattr(binary, "launch", no_launch)
    kernels.reset_launch_counts()
    chunk = chunks[0]
    got = binary_tables_packed(chunk, *THRESHOLDS)
    want = with_chi2_tail(binary_stats_from_words_plain(
        *_case(chunk, "fixture", 0), *THRESHOLDS))
    for key in want:
        assert _same(got[key], want[key]), key
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_outputs_share_one_allocation(chunks, monkeypatch):
    """The wrapper's one allocation and launch: each output a contiguous
    view of its dtype and shape, disjoint from the others, where the
    launch writes it (a stand-in launch copies the plain version's
    outputs through the pointers, in the launch's order), and the
    launch's shapes (S, Pmax, K, W) and thresholds."""
    args = _case(chunks[1], "invalid and zero-edge paths", 1)
    want = binary_stats_from_words_plain(*args, *THRESHOLDS)
    keys = binary.STATS_F64 + binary.STATS_U8
    seen = {}

    def fake_launch(name, argtypes, values, device, source=None):
        assert (name, source) == ("binary_from_words", "binary_stats")
        assert len(values) == len(argtypes) and device == CPU
        assert values[:6] == [a.data_ptr() for a in args]
        S, Pmax = args[5].shape
        assert values[6:13] == [S, Pmax, args[1].shape[1],
                                args[0].shape[1], *map(float, THRESHOLDS)]
        for key, ptr in zip(keys, values[13:]):
            src = want[key].contiguous()
            ctypes.memmove(ptr, src.data_ptr(),
                           src.numel() * src.element_size())
        seen["n"] = len(values) - 13
    monkeypatch.setattr(binary, "launch", fake_launch)
    got = binary._binary_stats_from_words_cuda(*args, *THRESHOLDS)
    assert seen["n"] == len(keys) == len(got)
    spans = []
    for key in keys:
        t = got[key]
        assert t.is_contiguous() and t.dtype == want[key].dtype, key
        assert t.shape == want[key].shape, key
        assert _same(t, want[key]), key
        spans.append((t.data_ptr(), t.data_ptr()
                      + t.numel() * t.element_size()))
    assert len({t.untyped_storage().data_ptr() for t in got.values()}) == 1
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_wrapper_rejects_what_the_kernel_cannot_take(chunks):
    """The launch's checks: the words' and rows' dtypes and the masks'
    width are checked before anything is allocated or launched."""
    words, idx, valid, tail, g1w, sidx = _case(chunks[0], "fixture", 0)
    with pytest.raises(ValueError, match="dtype"):
        binary._binary_stats_from_words_cuda(
            words.long(), idx, valid, tail, g1w, sidx, *THRESHOLDS)
    with pytest.raises(ValueError, match="shape"):
        binary._binary_stats_from_words_cuda(
            words, idx, valid, tail[:-1], g1w, sidx, *THRESHOLDS)
