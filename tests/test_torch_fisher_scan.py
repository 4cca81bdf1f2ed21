"""K4's redesigned scan and the fused K3 + K4 call (binary_stats), on the
CPU.

csrc/fisher_device.cuh's ``fisher_scan`` divides each block of ratios
ahead of the walk's chain of multiplies and adds; the card runs it one
thread a table (csrc/fisher.cu, csrc/binary_stats.cu).  Here the same
header is compiled with g++ (-ffp-contract=off, as nvcc's -fmad=false),
at the kernels' block of kFisherBlock steps and at blocks of 1 and 3
(a step that leaves its walk falls in every position of a block), beside
the parent's ``fisher_single``, and held bit for bit to the plain version
(stats/fisher.py fisher_exact_2x2_plain) on chip_smoke.py's K4 grids: the
reference's pinned strings, the overflow tables, random tables at hi 60,
400 and 5,000 with zero margins, and tables drawn like a 2,504-sample
cohort's (5,008 haplotypes, carrier frequency 0.01-0.5, seeds 0 and 1),
where the scans run ~300 steps and the ratios run furthest ahead.  Against
``stoat_tpu.stats.fisher_exact_2x2`` the scan gives the same strings
within a relative 1e-12: XLA's CPU build of the JAX scan differs from the
plain version's operations in the last bit of some values, which is why
tests/test_torch_stats.py holds the plain version to it at 1e-12 too.

The fused wrapper takes its plain version on CPU tensors and launches
nothing; its one output allocation is checked here by a stand-in launch
that writes the plain version's outputs through the pointers it is given.
No kernel is built here.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import chip_smoke
from stoat_tpu.pipeline.binary import _binary_from_path_counts
from stoat_tpu.stats import fisher_exact_2x2 as j_fisher
from stoat_tpu_torch import kernels
from stoat_tpu_torch.kernels import build
from stoat_tpu_torch.pipeline import binary
from stoat_tpu_torch.pipeline.binary import (binary_from_path_counts,
                                             binary_stats, binary_stats_plain,
                                             binary_tables_plain)
from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
from stoat_tpu_torch.stats.fisher import fisher_exact_2x2_plain
from stoat_tpu_torch.writer import format_p

HOST_SHIM = r"""
#include <cstdint>
#include "fisher_device.cuh"

// which: 0 fisher_single (the parent's scan), 1 fisher_scan at the
// kernels' block of steps, 2 a block of 1, 3 a block of 3
extern "C" void fisher_host(const double* a, const double* b,
                            const double* c, const double* d, double* p,
                            int64_t n, int which) {
  constexpr int kBlock = stoat::kFisherBlock;
  for (int64_t i = 0; i < n; ++i) {
    switch (which) {
      case 0: p[i] = stoat::fisher_single(a[i], b[i], c[i], d[i]); break;
      case 1: p[i] = stoat::fisher_scan<kBlock>(a[i], b[i], c[i], d[i]);
              break;
      case 2: p[i] = stoat::fisher_scan<1>(a[i], b[i], c[i], d[i]); break;
      default: p[i] = stoat::fisher_scan<3>(a[i], b[i], c[i], d[i]);
    }
  }
}
"""
HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
SCANS = {"fisher_single": 0, "fisher_scan kernel block": 1,
         "fisher_scan block 1": 2, "fisher_scan block 3": 3}
GRIDS = {name: (tables, expected) for name, tables, expected in
         chip_smoke.fisher_grid_cases(np.random.default_rng(1))}


@pytest.fixture(scope="module")
def host_fisher():
    """fisher_device.cuh built for the host: the library's name carries a
    key of the shim, the header and the flags, and concurrent first uses
    build once, under a file lock (as tests/test_torch_chi2_tail.py)."""
    header = (build.CSRC_DIR / "fisher_device.cuh").read_bytes()
    key = hashlib.sha256(HOST_SHIM.encode() + header
                         + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "host"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libfisher_host-{key}.so"
    with open(f"{lib}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            src = out_dir / f"fisher_host-{key}.cpp"
            src.write_text(HOST_SHIM)
            tmp = f"{lib}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *HOST_FLAGS, "-I",
                                  str(build.CSRC_DIR), str(src), "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr
            os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).fisher_host
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int]
    fn.restype = None

    def call(tables, which):
        cols = [np.ascontiguousarray(tables[:, i], np.float64)
                for i in range(4)]
        p = np.empty(len(tables))
        fn(*(c.ctypes.data for c in cols), p.ctypes.data, len(tables), which)
        return p
    return call


def _plain(tables):
    return fisher_exact_2x2_plain(*(torch.from_numpy(
        np.ascontiguousarray(tables[:, i], np.float64))
        for i in range(4))).numpy()


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_host_scan_is_the_plain_version(host_fisher, grid, scan):
    """The header's scans give the plain version's bits on every table."""
    tables, expected = GRIDS[grid]
    got = host_fisher(tables, SCANS[scan])
    want = _plain(tables)
    assert chip_smoke.same_bits(got, want)
    if expected is not None:
        assert [format_p(v) for v in got] == expected


@pytest.mark.parametrize("grid", list(GRIDS))
def test_host_scan_against_jax(host_fisher, grid):
    """The kernels' scan against stoat_tpu's Fisher: the same NaNs and
    strings, values within a relative 1e-12."""
    tables, _ = GRIDS[grid]
    got = host_fisher(tables, SCANS["fisher_scan kernel block"])
    want = np.asarray(j_fisher(*(tables[:, i] for i in range(4))))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert [format_p(v) for v in got] == [format_p(v) for v in want]
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)


def test_host_scan_non_integer_counts(host_fisher):
    """Counters stepped by +-1.0 in sequence, never from the step index:
    non-integer counts keep the plain version's bits too."""
    rng = np.random.default_rng(7)
    tables = rng.uniform(0.0, 60.0, (4096, 4))
    tables[:32, 1] = 0.25
    want = _plain(tables)
    for which in SCANS.values():
        assert chip_smoke.same_bits(host_fisher(tables, which), want)


def test_cohort_scans_run_long():
    """The cohort draws are where the ratios run furthest ahead: scans of
    hundreds of steps (chip_smoke.fisher_steps), many blocks of ratios."""
    steps = chip_smoke.fisher_steps(*GRIDS["cohort seed 0"][0].T)
    assert steps.max() > 250 and steps.min() > 0
    assert steps.mean() > 100


def _random_counts(seed, S=96, Pmax=6, P=300, hi=400):
    rng = np.random.default_rng(seed)
    g0 = rng.integers(0, hi, P).astype(np.float64)
    g1 = rng.integers(0, hi, P).astype(np.float64)
    zero = rng.random(P) < 0.2
    g0[zero] = 0
    g1[zero] = 0
    g1[rng.random(P) < 0.1] = 0
    sidx = rng.integers(0, P, (S, Pmax)).astype(np.int32)
    n_real = rng.integers(1, Pmax + 1, S)
    sidx[np.arange(Pmax)[None, :] >= n_real[:, None]] = -1
    sidx[:40, 2:] = -1                    # 2x2 tables
    return [torch.from_numpy(v) for v in (g0, g1, sidx)]


def _same(got, want):
    got, want = got.numpy(), want.numpy()
    if got.dtype == np.float64:
        return chip_smoke.same_bits(got, want)
    return got.dtype == want.dtype and np.array_equal(got, want)


def test_fused_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the launcher: binary_stats is
    binary_stats_plain, and no kernel is counted."""
    def no_launch(*a, **k):
        raise AssertionError("launch on CPU tensors")
    monkeypatch.setattr(binary, "launch", no_launch)
    kernels.reset_launch_counts()
    args = _random_counts(0)
    got = binary_stats(*args, 3, 5, 0.05)
    want = binary_stats_plain(*args, 3, 5, 0.05)
    assert set(got) == set(binary.STATS_F64 + binary.STATS_U8)
    for key in want:
        assert _same(got[key], want[key]), key
    binary_from_path_counts(*args, 3, 5, 0.05)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_fused_outputs_share_one_allocation(monkeypatch):
    """The wrapper's views of its one allocation: each output contiguous,
    of its dtype and shape, disjoint from the others, and where the launch
    writes it (a stand-in launch copies the plain version's outputs
    through the pointers, in the launch's order)."""
    args = _random_counts(1)
    thr = (3, 5, 0.05)
    want = binary_stats_plain(*args, *thr)
    keys = binary.STATS_F64 + binary.STATS_U8
    seen = {}

    def fake_launch(name, argtypes, values, device):
        assert name == "binary_stats" and len(values) == len(argtypes)
        assert values[3:8] == [*args[2].shape, *map(float, thr)]
        for key, ptr in zip(keys, values[8:]):
            src = want[key].contiguous()
            ctypes.memmove(ptr, src.data_ptr(),
                           src.numel() * src.element_size())
        seen["n"] = len(values) - 8
    monkeypatch.setattr(binary, "launch", fake_launch)
    got = binary._binary_stats_cuda(*args, *thr)
    assert seen["n"] == len(keys) == len(got)
    spans = []
    for key in keys:
        t = got[key]
        assert t.is_contiguous() and t.dtype == want[key].dtype, key
        assert t.shape == want[key].shape, key
        assert _same(t, want[key]), key
        spans.append((t.data_ptr(), t.data_ptr()
                      + t.numel() * t.element_size()))
    base = {t.untyped_storage().data_ptr() for t in got.values()}
    assert len(base) == 1
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("seed,thr", [(0, (3, 5, 0.05)), (2, (2, 2, 0.0)),
                                      (3, (40, 5, 0.45))])
def test_fused_plain_is_the_two_kernels_plain(seed, thr):
    """binary_stats_plain is K3's plain version, then Fisher of every
    (a, b, c, d) masked to NaN where k != 2: what the main path ran as
    two launches and a torch.where, bit for bit."""
    args = _random_counts(seed)
    got = binary_stats_plain(*args, *thr)
    t = binary_tables_plain(*args, *thr)
    p = fisher_exact_2x2_plain(t["a"], t["b"], t["c"], t["d"])
    assert _same(got["p_fisher"], torch.where(t["k"] == 2, p, float("nan")))
    for key in set(got) - {"p_fisher"}:
        assert _same(got[key], t[key]), key


@pytest.mark.parametrize("grid", ["hi 400", "cohort seed 1"])
def test_fused_against_jax(grid):
    """binary_from_path_counts (the fused call, then K5) against
    stoat_tpu's _binary_from_path_counts on K4's tables as two-path
    snarls: flags, masks and counts equal, p-values the same strings
    within a relative 1e-12."""
    tables, _ = GRIDS[grid]
    g0, g1, sidx = chip_smoke.tables_as_snarls(tables, torch.device("cpu"))
    got = binary_from_path_counts(g0, g1, sidx, *chip_smoke.THRESHOLDS)
    want = _binary_from_path_counts(
        jnp.asarray(g0.numpy()), jnp.asarray(g1.numpy()),
        jnp.asarray(sidx.numpy()), *map(jnp.float64, chip_smoke.THRESHOLDS))
    for key in ("filtered", "keep", "g0", "g1"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("p_fisher", "p_chi2"):
        a, b = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert [format_p(v) for v in a] == [format_p(v) for v in b], key
        ok = ~np.isnan(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-12, atol=0,
                                   err_msg=key)
    stats = binary_stats_plain(g0, g1, sidx, *chip_smoke.THRESHOLDS)
    p_chi2 = finish_chi2_pvalues(stats["chi2_stat"], stats["chi2_df"],
                                 stats["chi2_invalid"], stats["chi2_zexp"])
    assert _same(got["p_chi2"], p_chi2)
