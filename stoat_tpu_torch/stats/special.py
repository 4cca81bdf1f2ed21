"""Distribution tails, float64 (stoat_tpu/stats/special.py).

K5, the chi-squared tail (:30-50): ``chi2_sf_plain`` takes the upper
incomplete gamma function from JAX's igammac, as the JAX package takes it
from ``jax.scipy.special.gammaincc``: ``igammac_plain`` transcribes JAX
0.9's igammac_impl operation for operation (its power series, its
continued fraction, their masks and stopping rules), with XLA's lgamma
(``lgamma_plain``); CUDA tensors run the hand-written kernel
csrc/chi2_tail.cu on the same algorithm (csrc/chi2_tail_device.cuh).  On
the CPU the logarithms, exponentials and sines are the C library's, as the
header's host build takes them.  At or below a statistic of 85 the
reference computes ``1 - cdf`` in double precision; ``1 - (1 - q)``
reproduces that rounding from the accurate upper tail.  Above 85 it
evaluates the tail in 50-digit arithmetic, which the direct upper tail
matches in float64.

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
           "chi2_tail_cuda", "igammac_plain", "lgamma_plain",
           "betainc_plain", "student_t_sf2_plain", "ndtr_plain",
           "normal_sf2_plain"]

CHI2_HIGH_PRECISION_THRESHOLD = 85.0
_DBL_MIN = 2.2250738585072014e-308
# float64 eps / 2: both the Lentz floor ("small") and the convergence
# threshold of the continued fraction; 600 iterations, as JAX for float64
_HALF_EPS = torch.finfo(torch.float64).eps / 2
_CF_ITERATIONS = 600
_TWO_TINY = torch.finfo(torch.float64).tiny * 2


# XLA's lgamma, the Lanczos approximation (g = 7, 9 terms) that
# jax.lax.lgamma lowers to: log(Gamma(z + 1)) = log(sqrt(2 pi)) + (z + 1/2 -
# t / log t) log t + log A(z), t = z + 7.5, log t = log(7.5) + log1p(z /
# 7.5), A(z) = base + sum_k c_k / (z + k); Euler's reflection below 1/2
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS_COEFFS = (676.520368121885098567009190444019,
                   -1259.13921672240287047156078755283,
                   771.3234287776530788486528258894,
                   -176.61502916214059906584551354,
                   12.507343278686904814458936853,
                   -0.13857109526572011689554707,
                   9.984369578019570859563e-6,
                   1.50563273514931155834e-7)
_LANCZOS_T = 7.5
_LOG_LANCZOS_T = math.log(_LANCZOS_T)
_LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))
_LOG_PI = math.log(math.pi)
# JAX's igammac: its convergence threshold (float64 eps), the bound of
# its underflow test, its rescale threshold (1 / eps) and the cap of its
# continued fraction
_EPS = torch.finfo(torch.float64).eps
_LOG_DBL_MAX = math.log(torch.finfo(torch.float64).max)
_RESCALE = 1.0 / _EPS
_IGAMMAC_CF_ITERATIONS = 2000


def _c_log(v: float) -> float:
    try:
        return math.log(v)
    except ValueError:          # 0 and below
        return -math.inf if v == 0 else math.nan


def _c_log1p(v: float) -> float:
    try:
        return math.log1p(v)
    except ValueError:          # -1 and below
        return -math.inf if v == -1 else math.nan


def _c_exp(v: float) -> float:
    try:
        return math.exp(v)
    except OverflowError:
        return math.inf


def _c_sin(v: float) -> float:
    try:
        return math.sin(v)
    except ValueError:          # infinities
        return math.nan


_C_FUNCTIONS = {"log": _c_log, "log1p": _c_log1p, "exp": _c_exp,
                "sin": _c_sin}


def _elementary(name: str, t: torch.Tensor) -> torch.Tensor:
    """log, log1p, exp or sin of a float64 tensor, as the math library of
    its device computes it: on the CPU the C library's, element by element
    (torch's vectorized CPU versions differ from it in the last bit, and
    between runs with the data's alignment), which the host build of
    csrc/chi2_tail_device.cuh calls too; on the card torch's op, which
    calls CUDA's, as the kernel does.  The chi-squared tail's 85 switch,
    1 - (1 - q), turns one ulp of q into up to 1.1e-16 / p of p."""
    if t.device.type == "cpu":
        return t.to(torch.float64).clone().apply_(_C_FUNCTIONS[name])
    return getattr(torch, name)(t)


_SPLIT = 134217729.0   # 2^27 + 1, Veltkamp's splitter for float64


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c rounded once, as XLA's contracted multiply-adds and the
    kernel's fma() round it, from float64 operations: the product's
    rounding error by Dekker's product (Veltkamp's split), the sum's by
    Knuth's two-sum, then their sum added last (exact but where that last
    addition lands on a rounding boundary).  A product that is not finite
    is added as it is."""
    p = a * b
    ca = _SPLIT * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = _SPLIT * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return torch.where(torch.isfinite(p), s + (t + err), s)


def lgamma_plain(x: torch.Tensor) -> torch.Tensor:
    """log |Gamma(x)|, float64: XLA's lgamma operation for operation, its
    one contracted multiply-add included (the chi-squared tail's
    prefactor, as jax.lax.lgamma computes it in the JAX package;
    csrc/chi2_tail_device.cuh repeats it)."""
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    a = torch.full_like(z, _LANCZOS_BASE)
    for k, c in enumerate(_LANCZOS_COEFFS, 1):
        # tensors on both sides of every division: torch takes ``float /
        # tensor`` as a reciprocal times the float, and on the card
        # ``tensor / float`` as a product by the float's reciprocal, two
        # roundings each
        a = a + torch.full_like(z, c) / (z + float(k))
    t = _LANCZOS_T + z
    log_t = _LOG_LANCZOS_T + _elementary(
        "log1p", z / torch.full_like(z, _LANCZOS_T))
    # XLA contracts log(sqrt(2 pi)) + (z + 1/2 - t / log t) log t into one
    # multiply-add
    value = _fma(z + 0.5 - t / log_t, log_t, _LOG_SQRT_2PI) \
        + _elementary("log", a)
    # lgamma(x) = log(pi) - lgamma(1 - x) - log|sin(pi x)|, with the sine
    # of |x|'s fraction mirrored about 1/2
    frac = x.abs() - torch.floor(x.abs())
    frac = torch.where(0.5 < frac, 1.0 - frac, frac)
    denom = _elementary("log", _elementary("sin", math.pi * frac))
    reflected = torch.where(torch.isfinite(denom), _LOG_PI - denom - value,
                            -denom)
    value = torch.where(reflect, reflected, value)
    return torch.where(x.isinf(), math.inf, value)


def _igamma_series(ax, x, a, enabled):
    """JAX's _igamma_series (VALUE mode): P(a, x) = ax / a * sum of c_n,
    c_n = c_{n-1} * (x / (a + n)), each element until c / ans <= eps.
    Only the elements still running are iterated: the set shrinks as they
    converge, so the cost follows the slowest element."""
    ans = torch.ones_like(x)
    idx = enabled.nonzero().squeeze(1)
    r, c, s = a[idx], torch.ones_like(a[idx]), ans[idx]
    xs = x[idx]
    while idx.numel():
        r = r + 1.0
        c = c * (xs / r)
        s = s + c
        go = c / s > _EPS
        if not bool(go.all()):
            ans[idx[~go]] = s[~go]
            idx, r, c, s, xs = idx[go], r[go], c[go], s[go], xs[go]
    return (ans * ax) / a


def _igammac_continued_fraction(ax, x, a, enabled):
    """JAX's _igammac_continued_fraction (VALUE mode): the Cephes
    continued fraction of Q(a, x) / ax, the convergents p_k / q_k (each a
    multiply-add that XLA contracts) rescaled by eps when |p_k| > 1 / eps,
    each element until |(ans - r) / r| <= eps (where q_k != 0), at most
    2,000 iterations.  Only the elements still running are iterated."""
    y = 1.0 - a
    z = x + y + 1.0
    pkm2 = torch.ones_like(x)
    qkm2 = x
    pkm1 = x + 1.0
    qkm1 = z * x
    ans = pkm1 / qkm1
    idx = enabled.nonzero().squeeze(1)
    st = [v[idx] for v in (y, z, pkm1, qkm1, pkm2, qkm2, ans)]
    for c in range(1, _IGAMMAC_CF_ITERATIONS + 1):
        if not idx.numel():
            break
        y, z, pkm1, qkm1, pkm2, qkm2, s = st
        y = y + 1.0
        z = z + 2.0
        yc = y * float(c)
        pk = _fma(pkm1, z, -(pkm2 * yc))
        qk = _fma(qkm1, z, -(qkm2 * yc))
        nonzero = qk != 0
        r = pk / qk
        t = torch.where(nonzero, ((s - r) / r).abs(), 1.0)
        s = torch.where(nonzero, r, s)
        pkm2, pkm1, qkm2, qkm1 = pkm1, pk, qkm1, qk
        rescale = pk.abs() > _RESCALE
        pkm2, pkm1, qkm2, qkm1 = (torch.where(rescale, v * _EPS, v)
                                  for v in (pkm2, pkm1, qkm2, qkm1))
        st = [y, z, pkm1, qkm1, pkm2, qkm2, s]
        go = t > _EPS
        if not bool(go.all()):
            ans[idx[~go]] = s[~go]
            idx = idx[go]
            st = [v[go] for v in st]
    # the elements still running at the cap keep their last convergent
    ans[idx] = st[-1]
    return ans * ax


def igammac_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Q(a, x), the regularized upper incomplete gamma function, float64:
    JAX 0.9's igammac_impl (jax/_src/lax/special.py), which
    jax.scipy.special.gammaincc runs.  1 - the power series where x < 1
    or x < a, else the continued fraction; 0 at x = inf or a = 0, NaN
    outside the domain.  The prefactor ax = exp(a log x - x - lgamma(a)),
    a log x - x one multiply-add as XLA contracts it, is flushed to 0
    below DBL_MIN, as XLA flushes it."""
    a, x = torch.broadcast_tensors(a.to(torch.float64), x.to(torch.float64))
    shape = a.shape
    a, x = a.reshape(-1), x.reshape(-1)
    a_is_zero = a == 0
    x_is_inf = x == math.inf
    domain_error = ((x < 0) | (a < 0) | (a_is_zero & (x == 0)) | a.isnan()
                    | x.isnan())
    use_igamma = (x < 1) | (x < a)
    ax = _fma(a, _elementary("log", x), -x) - lgamma_plain(a)
    underflow = ax < -_LOG_DBL_MAX
    enabled = ~(domain_error | underflow | x_is_inf | a_is_zero)
    ax = _flush(_elementary("exp", ax))
    series = _igamma_series(ax, x, a, enabled & use_igamma)
    cf = _igammac_continued_fraction(ax, x, a, enabled & ~use_igamma)
    out = torch.where(use_igamma, 1.0 - series, cf)
    out = torch.where(x_is_inf | a_is_zero, 0.0, out)
    return torch.where(domain_error, math.nan, out).reshape(shape)


def chi2_sf_plain(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`chi2_sf`."""
    stat = stat.to(torch.float64)
    df = df.to(torch.float64)
    q = igammac_plain(df * 0.5, stat * 0.5)
    # XLA, under the JAX package, flushes subnormal results to zero: a
    # tail below DBL_MIN prints as "0" there, and here
    q = torch.where(q < _DBL_MIN, 0.0, q)
    low = 1.0 - (1.0 - q)
    return torch.where(stat > CHI2_HIGH_PRECISION_THRESHOLD, q, low)


def chi2_tail_cuda(stat: torch.Tensor, df: torch.Tensor, invalid=None,
                   zero_expected=None) -> torch.Tensor:
    """csrc/chi2_tail.cu on CUDA tensors: :func:`chi2_sf` of the
    broadcast ``stat`` and ``df``; given the bool masks too,
    ``finish_chi2_pvalues``'s DBL_MAX where ``zero_expected`` and NaN where
    ``invalid`` (stats/chi2.py).  A df that broadcasts along the leading
    dimensions only (the score test's [1, S] against [K, S] statistics)
    is read with its period, never made [K, S]."""
    shape = tuple(torch.broadcast_shapes(stat.shape, df.shape))
    stat = stat.to(torch.float64).expand(shape).contiguous()
    df = df.to(torch.float64)
    rows = 0
    while rows < df.dim() and df.shape[rows] == 1:
        rows += 1
    df = df.reshape(df.shape[rows:])
    if shape[len(shape) - df.dim():] != tuple(df.shape):
        df = df.expand(shape)
    df = df.contiguous()
    device, n = stat.device, stat.numel()
    check_tensor(stat, "stat", torch.float64, shape, device)
    check_tensor(df, "df", torch.float64, tuple(df.shape), device)
    masks = [None, None]
    if invalid is not None:
        masks = [m.expand(shape).contiguous()
                 for m in (invalid, zero_expected)]
        for name, m in zip(("invalid", "zero_expected"), masks):
            check_tensor(m, name, torch.bool, shape, device)
    p = torch.empty(shape, dtype=torch.float64, device=device)
    launch("chi2_tail", [VOIDP] * 5 + [I64] * 2,
           [stat.data_ptr(), df.data_ptr(),
            *(None if m is None else m.data_ptr() for m in masks),
            p.data_ptr(), n, max(df.numel(), 1)], device)
    return p


def chi2_sf(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Survival function of the chi-squared distribution (float64), of
    ``stat`` and ``df`` broadcast together; subnormal p flushed to 0.

    CUDA tensors run csrc/chi2_tail.cu, whose blocks sort their elements
    by the loop they run; it is bound by the loops' iterations, not by
    bytes.  CPU tensors run the plain version."""
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
