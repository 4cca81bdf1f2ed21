"""Distribution tails, float64 (stoat_tpu/stats/special.py).

K5, the chi-squared tail (:30-50): ``chi2_sf_plain`` takes the upper
incomplete gamma function from ``torch.special.gammaincc``, as the JAX
package takes it from ``jax.scipy.special.gammaincc``; CUDA tensors run the
hand-written kernel csrc/chi2_tail.cu, a transcription of the algorithm
behind torch's CPU op (csrc/chi2_tail_device.cuh).  At or below a
statistic of 85 the reference computes ``1 - cdf`` in double precision;
``1 - (1 - q)`` reproduces that rounding from the accurate upper tail.
Above 85 it evaluates the tail in 50-digit arithmetic, which the direct
upper tail matches in float64.

K10, the two-sided Student-t tail (:53-61), needs the regularized
incomplete beta function, which torch does not have.  ``betainc_plain``
transcribes JAX's ``regularized_incomplete_beta_impl``
(jax/_src/lax/special.py, itself XLA's math.cc); csrc/student_t.cu runs the
same continued fraction on the card (stats/linreg.py student_t_pvalues).

The two-sided normal tail of the Wald test (:64-72) is ``2 * (1 - ndtr)``
taken literally, as the reference does: ``ndtr_plain`` transcribes JAX's
``_ndtr`` (jax/_src/scipy/special.py), and csrc/logreg.cu repeats it with
CUDA's erf and erfc (stats/logreg.py).
"""

from __future__ import annotations

import math

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, check_tensor, launch

__all__ = ["CHI2_HIGH_PRECISION_THRESHOLD", "chi2_sf", "chi2_sf_plain",
           "chi2_tail_cuda", "betainc_plain", "student_t_sf2_plain",
           "ndtr_plain", "normal_sf2_plain"]

CHI2_HIGH_PRECISION_THRESHOLD = 85.0
_DBL_MIN = 2.2250738585072014e-308
# float64 eps / 2: both the Lentz floor ("small") and the convergence
# threshold of the continued fraction; 600 iterations, as JAX for float64
_HALF_EPS = torch.finfo(torch.float64).eps / 2
_CF_ITERATIONS = 600
_TWO_TINY = torch.finfo(torch.float64).tiny * 2


def chi2_sf_plain(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`chi2_sf`."""
    stat = stat.to(torch.float64)
    df = df.to(torch.float64)
    q = torch.special.gammaincc(df * 0.5, stat * 0.5)
    # XLA, under the JAX package, flushes subnormal results to zero: a
    # tail below DBL_MIN prints as "0" there, and here
    q = torch.where(q < _DBL_MIN, 0.0, q)
    low = 1.0 - (1.0 - q)
    return torch.where(stat > CHI2_HIGH_PRECISION_THRESHOLD, q, low)


def chi2_tail_cuda(stat: torch.Tensor, df: torch.Tensor, invalid=None,
                   zero_expected=None) -> torch.Tensor:
    """csrc/chi2_tail.cu on CUDA tensors: :func:`chi2_sf` of the
    broadcast ``stat`` and ``df``, one thread per element; given the bool
    masks too, ``finish_chi2_pvalues``'s DBL_MAX where ``zero_expected``
    and NaN where ``invalid`` (stats/chi2.py)."""
    stat, df = torch.broadcast_tensors(stat.to(torch.float64),
                                       df.to(torch.float64))
    stat, df = stat.contiguous(), df.contiguous()
    device, shape = stat.device, tuple(stat.shape)
    check_tensor(stat, "stat", torch.float64, shape, device)
    check_tensor(df, "df", torch.float64, shape, device)
    masks = [None, None]
    if invalid is not None:
        masks = [m.expand(shape).contiguous()
                 for m in (invalid, zero_expected)]
        for name, m in zip(("invalid", "zero_expected"), masks):
            check_tensor(m, name, torch.bool, shape, device)
    p = torch.empty(shape, dtype=torch.float64, device=device)
    launch("chi2_tail", [VOIDP] * 5 + [I64],
           [stat.data_ptr(), df.data_ptr(),
            *(None if m is None else m.data_ptr() for m in masks),
            p.data_ptr(), p.numel()], device)
    return p


def chi2_sf(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Survival function of the chi-squared distribution (float64), of
    ``stat`` and ``df`` broadcast together; subnormal p flushed to 0.

    CUDA tensors run csrc/chi2_tail.cu, one thread per element, which is
    bound by launch latency and the series' iterations, not by bytes; CPU
    tensors run the plain version."""
    if kernels_enabled(stat.device):
        return chi2_tail_cuda(stat, df)
    return chi2_sf_plain(stat, df)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormal -> 0.  XLA runs the JAX package's float64 programs with
    subnormals flushed, intermediates included: a prefactor that falls
    below DBL_MIN zeroes the p-value there even when cf * prefactor would
    not have."""
    return torch.where(v.abs() < _DBL_MIN, 0.0, v)


def _cf_numerator(n: int, a, b, x):
    """Partial numerator n >= 1 of the incomplete beta continued fraction
    (DLMF 8.17.22), in JAX's operation order."""
    if n == 1:
        return torch.ones_like(x)
    m = float((n - 1) // 2)
    if n % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / ((a + 2.0 * m)
                                             * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _betainc_continued_fraction(a, b, x):
    """Lentz-Thompson-Barnett evaluation, partial denominators 0, 1, 1, ...

    JAX iterates until every element of the batch has converged; here
    each element stops at its own convergence (|delta - 1| < eps/2), as
    csrc/student_t.cu does, which moves a converged element's result by
    a few ulps at most."""
    h = torch.full_like(x, _HALF_EPS)
    c = h.clone()
    d = torch.zeros_like(x)
    active = torch.ones_like(x, dtype=torch.bool)
    for n in range(1, _CF_ITERATIONS):
        num = _cf_numerator(n, a, b, x)
        c_new = 1.0 + num / c
        c_new = torch.where(c_new.abs() < _HALF_EPS, _HALF_EPS, c_new)
        d_new = 1.0 + num * d
        d_new = torch.where(d_new.abs() < _HALF_EPS, _HALF_EPS, d_new)
        d_new = 1.0 / d_new
        delta = c_new * d_new
        c = torch.where(active, c_new, c)
        d = torch.where(active, d_new, d)
        h = torch.where(active, h * delta, h)
        active = active & ((delta - 1.0).abs() >= _HALF_EPS)
        if not bool(active.any()):
            break
    return h


def betainc_plain(a: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b), float64, elementwise.

    JAX 0.9's regularized_incomplete_beta_impl: the continued fraction on
    x < (a+1)/(a+b+2), else on the mirrored (b, a, 1-x) with 1 - result;
    the lgamma prefactor with its a < 2*tiny branch; then the selects for
    results that are exactly 0, 1 or NaN."""
    a, b, x = torch.broadcast_tensors(a.to(torch.float64),
                                      b.to(torch.float64),
                                      x.to(torch.float64))
    inf = float("inf")
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero)
                     | a.isnan() | b.isnan() | x.isnan())

    rapid = x < (a + 1.0) / (a + b + 2.0)
    a, b, x = (torch.where(rapid, a, b), torch.where(rapid, b, a),
               torch.where(rapid, x, 1.0 - x))
    cf = _betainc_continued_fraction(a, b, x)
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < _TWO_TINY,
        _flush(torch.exp(torch.log1p(-x) * b - lbeta_small_a)),
        _flush(_flush(torch.exp(torch.log(x) * a + torch.log1p(-x) * b
                                - lbeta)) / a))
    result = _flush(cf * factor)
    result = torch.where(rapid, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float("nan"), result)


def student_t_sf2_plain(t_abs: torch.Tensor, df: torch.Tensor
                        ) -> torch.Tensor:
    """Two-sided Student-t p-value 2 P(T > |t|) = I_{df/(df+t^2)}(df/2,
    1/2) (stats_test.cpp:484), float64.  Subnormal values are flushed to
    0 (x, the prefactor and p), as XLA flushes them under the JAX
    package."""
    t_abs = t_abs.to(torch.float64)
    df = df.to(torch.float64)
    x = _flush(df / (df + t_abs * t_abs))
    return _flush(betainc_plain(df * 0.5, torch.full_like(df, 0.5), x))


_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def ndtr_plain(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, float64: JAX 0.9's ``_ndtr``.  With w = x *
    sqrt(2)/2: 1 + erf(w) where |w| < sqrt(2)/2, else 2 - erfc(|w|) for
    w > 0 and erfc(|w|) below; times 0.5.  (``torch.special.ndtr`` takes
    another branch rule and differs in the last bit.)"""
    w = x.to(torch.float64) * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def normal_sf2_plain(z_abs: torch.Tensor) -> torch.Tensor:
    """Two-sided normal p-value 2 * (1 - ndtr(|z|)) (stats_test.cpp:143),
    computed literally: p moves in steps of 2^-52 near 0 and is exactly 0
    for |z| above about 8.3, as in the reference."""
    return 2.0 * (1.0 - ndtr_plain(z_abs))
