"""K5, the chi-squared tail: the plain version and csrc/chi2_tail_device.cuh
against the JAX package and against each other, on the CPU.

The plain version (stats/special.py chi2_sf_plain) is JAX's igammac,
transcribed; it is held to ``stoat_tpu.stats.special.chi2_sf`` within 5e-12
relative, with the same printed strings, on draws of (stat, df) at df 1-400
(the fault the port had while its tail was torch's, whose uniform
asymptotic expansion for a > 20 moved p by up to 1.9e-9 there).  The
card's kernel (csrc/chi2_tail.cu) evaluates ``chi2_tail::chi2_sf`` of that
header.  Here the same header is compiled with g++ (-ffp-contract=off, as
nvcc's -fmad=false) into a small host library under build/, and held to
the plain version over the grids chip_smoke.py uses on the card: relative
1e-13 where p > 1e-300, the same zeros, NaNs and printed strings (both
call the C library's logarithms and exponentials); and to JAX's on the
draws.  That catches an error in the transcription without nvcc.  The
wrapper's device rule and the masks of ``finish_chi2_pvalues`` are checked
on the CPU too.  No kernel is built here.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.stats.chi2 import finish_chi2_pvalues as j_finish
from stoat_tpu.stats.special import chi2_sf as j_chi2_sf
from stoat_tpu_torch import kernels
from stoat_tpu_torch.kernels import build
from stoat_tpu_torch.stats import special
from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
from stoat_tpu_torch.stats.special import chi2_sf, chi2_sf_plain
from stoat_tpu_torch.writer import format_p

REL = 1e-13
# the port against the JAX package: the two take their logarithms,
# exponentials and lgamma's divisions from other libraries
JAX_REL = 5e-12
DBL_MAX = np.finfo(np.float64).max
# tests/test_extreme_tails.py:23-26 and chip_smoke.py's TAIL_STATS x TAIL_DFS
TAIL_STATS = [60.0, 80.0, 84.9, 85.0001, 86.0, 100.0, 200.0, 500.0, 1000.0,
              1400.0]
TAIL_DFS = [1, 2, 3, 7]

HOST_SHIM = r"""
#include <cstdint>
#include "chi2_tail_device.cuh"

extern "C" void chi2_sf_host(const double* stat, const double* df,
                             double* p, int64_t n) {
  for (int64_t i = 0; i < n; ++i) p[i] = chi2_tail::chi2_sf(stat[i], df[i]);
}
"""
HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


@pytest.fixture(scope="module")
def host_chi2_sf():
    """chi2_tail_device.cuh's chi2_sf built for the host: the library's
    name carries a key of the shim, the header and the flags, and
    concurrent first uses build once, under a file lock (the port's
    native-build pattern, stoat_tpu_torch/native)."""
    header = (build.CSRC_DIR / "chi2_tail_device.cuh").read_bytes()
    key = hashlib.sha256(HOST_SHIM.encode() + header
                         + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "host"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libchi2_tail_host-{key}.so"
    with open(f"{lib}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            src = out_dir / f"chi2_tail_host-{key}.cpp"
            src.write_text(HOST_SHIM)
            tmp = f"{lib}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *HOST_FLAGS, "-I",
                                  str(build.CSRC_DIR), str(src), "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr
            os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).chi2_sf_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    fn.restype = None

    def call(stat, df):
        stat = np.ascontiguousarray(stat, np.float64)
        df = np.ascontiguousarray(df, np.float64)
        p = np.empty_like(stat)
        fn(stat.ctypes.data, df.ctypes.data, p.ctypes.data, stat.size)
        return p
    return call


def _plain(stat, df):
    return chi2_sf_plain(torch.from_numpy(np.asarray(stat, np.float64)),
                         torch.from_numpy(np.asarray(df, np.float64))).numpy()


def _hold(got, want):
    """The header's p against the plain version's: NaN, zeros and DBL_MAX
    in the same places, relative REL where p > 1e-300, the same strings.
    Returns the largest relative error."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(got == DBL_MAX, want == DBL_MAX)
    big = want > 1e-300
    rel = np.abs(got[big] - want[big]) / want[big]
    worst = float(rel.max()) if rel.size else 0.0
    assert worst <= REL, worst
    assert [format_p(v) for v in got] == [format_p(v) for v in want]
    return worst


def _branches(stat, df):
    """Which loop of JAX's igammac each (a, x) = (df/2, stat/2) runs: none
    (x = 0, NaN or inf, an underflowing prefactor), the power series (x <
    1 or x < a) or the continued fraction."""
    a, x = np.asarray(df) / 2, np.asarray(stat) / 2
    with np.errstate(all="ignore"):
        from scipy.special import gammaln
        live = ~((a * np.log(x) - x - gammaln(a) < -np.log(DBL_MAX))
                 | np.isnan(x) | np.isinf(x))
        series = (x < 1) | (x < a)
    return {"no loop": ~live, "power series": live & series,
            "continued fraction": live & ~series}


def _draw(seed, n=200_000):
    """The fault's draw: df uniform on 1-400, stat = |df + 4 z sqrt(2 df)|."""
    rng = np.random.default_rng(seed)
    df = rng.integers(1, 401, n).astype(np.float64)
    stat = np.abs(df + 4.0 * rng.standard_normal(n) * np.sqrt(2.0 * df))
    return stat, df


def _hold_jax(got, want):
    """p against JAX's: NaNs and zeros in the same places, relative JAX_REL
    where p > 1e-300, no differing string.  Returns the bitwise share."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    big = want > 1e-300
    rel = np.abs(got[big] - want[big]) / want[big]
    assert float(rel.max()) <= JAX_REL, float(rel.max())
    differ = np.nonzero(got != want)[0]
    assert [i for i in differ if format_p(got[i]) != format_p(want[i])] == []
    return 1.0 - differ.size / got.size


def test_host_build_matches_plain_on_the_tail_grid(host_chi2_sf):
    """stoat_tpu's pinned tail grid (test_extreme_tails.py), both sides of
    the 85 switch."""
    stat = np.repeat(TAIL_STATS, len(TAIL_DFS))
    df = np.tile(np.asarray(TAIL_DFS, np.float64), len(TAIL_STATS))
    _hold(host_chi2_sf(stat, df), _plain(stat, df))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_build_matches_plain_on_a_random_grid(host_chi2_sf, seed):
    """10^6 statistics in [0, 1500] on df 1-8 (the binary tables' and the
    graph's dfs), with zeros, NaNs and 85 +- 1e-9."""
    rng = np.random.default_rng(seed)
    n = 1_000_000
    stat = rng.uniform(0.0, 1500.0, n)
    df = rng.integers(1, 9, n).astype(np.float64)
    stat[:1000] = 0.0
    stat[1000:1100] = np.nan
    stat[1100:1600] = 85.0 + 1e-9
    stat[1600:2100] = 85.0 - 1e-9
    got, want = host_chi2_sf(stat, df), _plain(stat, df)
    _hold(got, want)
    for name, mask in _branches(stat, df).items():
        assert mask.sum() > 100, name


def test_host_build_matches_plain_for_large_df(host_chi2_sf):
    """df up to 2,000 with statistics near df, where both loops run long
    and lgamma's argument is large; plus infinities and a zero df."""
    rng = np.random.default_rng(7)
    df = rng.integers(1, 2001, 200_000).astype(np.float64)
    stat = df * rng.uniform(0.3, 1.7, df.size)
    stat[:1000] = rng.uniform(0.0, 5000.0, 1000)
    stat = np.concatenate([stat, [np.inf, np.inf, 0.0, 3.0, 1e-300]])
    df = np.concatenate([df, [1.0, 0.0, 0.0, 0.0, 4.0]])
    got, want = host_chi2_sf(stat, df), _plain(stat, df)
    _hold(got, want)
    branches = _branches(stat, df)
    large = df > 40
    for name in ("power series", "continued fraction"):
        assert (branches[name] & large).sum() > 10_000, name


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_and_host_build_match_jax_at_df_1_to_400(host_chi2_sf, seed):
    """Fault 3.2: the plain version and the host build against stoat_tpu's
    chi2_sf on the fault's draw, df 1-400 (2e5 pairs): within JAX_REL, no
    differing string, at df <= 40 and above."""
    stat, df = _draw(seed)
    want = np.asarray(j_chi2_sf(stat, df))
    for got in (_plain(stat, df), host_chi2_sf(stat, df)):
        for part in (df <= 40, df > 40):
            _hold_jax(got[part], want[part])


def test_first_differing_string_of_the_fault():
    """stat = 313.7369477976512 on df = 272 prints 4.1496e-02 in both
    packages (torch's algorithm printed 4.1497e-02)."""
    stat, df = np.array([313.7369477976512]), np.array([272.0])
    want = float(np.asarray(j_chi2_sf(stat, df))[0])
    got = float(_plain(stat, df)[0])
    assert format_p(want) == format_p(got) == "4.1496e-02"
    assert abs(got - want) <= JAX_REL * want


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the kernel launcher: chi2_sf is
    chi2_sf_plain, broadcasting included, and no launch is counted."""
    def no_launch(*a, **k):
        raise AssertionError("launch on CPU tensors")
    monkeypatch.setattr(special, "launch", no_launch)
    kernels.reset_launch_counts()
    stat = torch.tensor([[0.0, 3.84, 85.0, 90.0, float("nan")]] * 2,
                        dtype=torch.float64)
    df = torch.tensor([[1.0], [3.0]], dtype=torch.float64)
    got = chi2_sf(stat, df)
    want = chi2_sf_plain(stat, df)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert kernels.LAUNCHES["chi2_tail"] == 0


def test_finish_masks(monkeypatch):
    """finish_chi2_pvalues: DBL_MAX where an expected count is zero, NaN
    where the table is invalid (invalid wins), the tail elsewhere; the
    plain path on the CPU, as stoat_tpu's on the same statistics."""
    monkeypatch.setattr(special, "launch", None)
    rng = np.random.default_rng(3)
    n = 4096
    stat = rng.uniform(0.0, 120.0, n)
    df = rng.integers(1, 5, n).astype(np.float64)
    invalid = rng.random(n) < 0.1
    zexp = rng.random(n) < 0.1
    t = [torch.from_numpy(v) for v in (stat, df, invalid, zexp)]
    got = finish_chi2_pvalues(*t).numpy()
    np.testing.assert_array_equal(np.isnan(got), invalid)
    np.testing.assert_array_equal(got == DBL_MAX, zexp & ~invalid)
    rest = ~invalid & ~zexp
    np.testing.assert_array_equal(got[rest], _plain(stat, df)[rest])
    want = np.asarray(j_finish(stat, df, invalid, zexp))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)
