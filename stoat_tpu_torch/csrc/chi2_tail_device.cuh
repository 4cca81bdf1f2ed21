// K5: the chi-squared upper tail, for the card (csrc/chi2_tail.cu) and for
// a host build (tests/test_torch_chi2_tail.py compiles this header with g++
// and -ffp-contract=off, so that a transcription error shows without nvcc).
//
// chi2_sf(stat, df) computes what stats/special.py chi2_sf_plain computes
// (stoat_tpu/stats/special.py chi2_sf, :30-50):
//
//   q = igammac(df / 2, stat / 2)
//   q < DBL_MIN -> 0        (XLA flushes subnormal results under the JAX
//                            package, and so does the plain version)
//   p = stat > 85 ? q : 1 - (1 - q)
//
// igammac is JAX's igammac: JAX 0.9's igammac_impl (jax/_src/lax/special.py),
// which jax.scipy.special.gammaincc runs, transcribed operation for
// operation with its masks, thresholds and iteration cap.  With the
// prefactor ax = exp(a log x - x - lgamma(a)):
//
//   x < 1 or x < a:  1 - ax / a * (power series), each term c_n =
//                    c_{n-1} * (x / (a + n)) until c / ans <= eps;
//   otherwise:       ax * (Cephes' continued fraction), the convergents
//                    p_k / q_k rescaled by eps above 1 / eps, until
//                    |(ans - r) / r| <= eps, at most 2,000 iterations;
//
// an element whose a log x - x - lgamma(a) falls below -log(DBL_MAX), or
// with x = inf, a = 0 or outside the domain, runs no loop (JAX's
// ``enabled``), and the selects give 0 at x = inf or a = 0, NaN outside
// the domain.  A subnormal ax is flushed to 0, as XLA flushes it.
// lgamma is XLA's (the Lanczos approximation that jax.lax.lgamma lowers to,
// lgamma_xla below), as stats/special.py lgamma_plain repeats it.
//
// Every operation is separately rounded (nvcc -fmad=false, g++
// -ffp-contract=off), as the plain version's torch operations are, but
// the multiply-adds that XLA contracts on the CPU: lgamma's
// log(sqrt(2 pi)) + (z + 1/2 - t / log t) log t, the prefactor's a log x -
// x and the fraction's p_k and q_k are fma() here, rounded once, and the
// plain version rounds them once too (stats/special.py _fma).  With them
// the plain version equals stoat_tpu's tail bit for bit in nine cases of
// ten on the CPU.  The card's log, log1p, exp and sin are CUDA's, the
// host build's glibc's: the card's kernel is held to the plain version
// run on the card's tensors (chip_smoke.py phase 3), the host build to
// the plain version on the CPU (tests/test_torch_chi2_tail.py).
//
// The pieces are exposed for the kernel, which sorts elements by branch
// before it runs a loop: start() classifies an element and finishes the
// ones that run no loop; the loops run whole (series(), fraction()) or
// one iteration at a time (*_begin, *_step, *_end).

#pragma once

#include <float.h>
#include <math.h>

#ifdef __CUDACC__
#define CHI2_TAIL_HD __host__ __device__
#else
#define CHI2_TAIL_HD
#endif

namespace chi2_tail {

constexpr double kEps = 2.220446049250313e-16;     // float64 eps
constexpr double kDblMin = 2.2250738585072014e-308;
constexpr double kLogDblMax = 709.782712893384;    // log(DBL_MAX)
constexpr double kRescale = 4503599627370496.0;    // 1 / eps
constexpr int kFractionIterations = 2000;
constexpr double kHighPrecisionThreshold = 85.0;

// XLA's lgamma: Lanczos, g = 7, 9 terms; t = z + 7.5
constexpr double kLanczosBase = 0.99999999999980993227684700473478;
constexpr double kLanczosT = 7.5;
constexpr double kLogLanczosT = 2.0149030205422647;    // log(7.5)
constexpr double kLogSqrt2Pi = 0.9189385332046727;     // log(sqrt(2 pi))
constexpr double kLogPi = 1.1447298858494002;
constexpr double kPi = 3.141592653589793;

CHI2_TAIL_HD inline double lanczos_coeff(int k) {
  switch (k) {
    case 0: return 676.520368121885098567009190444019;
    case 1: return -1259.13921672240287047156078755283;
    case 2: return 771.3234287776530788486528258894;
    case 3: return -176.61502916214059906584551354;
    case 4: return 12.507343278686904814458936853;
    case 5: return -0.13857109526572011689554707;
    case 6: return 9.984369578019570859563e-6;
    default: return 1.50563273514931155834e-7;
  }
}

// log |Gamma(x)|: log(sqrt(2 pi)) + (z + 1/2 - t / log t) log t + log A(z)
// with z = x - 1, t = z + 7.5, log t = log(7.5) + log1p(z / 7.5); below 1/2
// Euler's reflection, the sine's argument |x|'s fraction mirrored about 1/2
CHI2_TAIL_HD inline double lgamma_xla(double x) {
  const bool reflect = x < 0.5;
  const double z = reflect ? -x : x - 1.0;
  double a = kLanczosBase;
#pragma unroll
  for (int k = 0; k < 8; ++k) a = a + lanczos_coeff(k) / (z + double(k + 1));
  const double t = kLanczosT + z;
  const double log_t = kLogLanczosT + log1p(z / kLanczosT);
  double value = fma(z + 0.5 - t / log_t, log_t, kLogSqrt2Pi) + log(a);
  if (reflect) {
    double frac = fabs(x) - floor(fabs(x));
    if (0.5 < frac) frac = 1.0 - frac;
    const double denom = log(sin(kPi * frac));
    value = isfinite(denom) ? kLogPi - denom - value : -denom;
  }
  return isinf(x) ? INFINITY : value;
}

CHI2_TAIL_HD inline double flush(double v) {
  return fabs(v) < kDblMin ? 0.0 : v;
}

// what an element runs: no loop (its q is known), the series, the fraction
enum Branch { kDone = 0, kSeries = 1, kFraction = 2 };

struct Element {
  double a, x, ax;
};

// The two loops, one iteration at a time, so that a kernel can run many
// elements' loops side by side and give a lane a new element when its own
// has converged: begin() sets the starting values, step() runs one
// iteration and says whether the element has stopped, end() gives q.

// 1 - P(a, x) by the power series (_igamma_series)
struct Series {
  double r, c, ans;
};

CHI2_TAIL_HD inline void series_begin(const Element& e, Series* s) {
  s->r = e.a;
  s->c = 1.0;
  s->ans = 1.0;
}

CHI2_TAIL_HD inline bool series_step(const Element& e, Series* s) {
  s->r = s->r + 1.0;
  s->c = s->c * (e.x / s->r);
  s->ans = s->ans + s->c;
  return !(s->c / s->ans > kEps);  // NaN stops too
}

CHI2_TAIL_HD inline double series_end(const Element& e, const Series& s) {
  return 1.0 - (s.ans * e.ax) / e.a;
}

// Q(a, x) by the continued fraction (_igammac_continued_fraction)
struct Fraction {
  double y, z, pkm1, qkm1, pkm2, qkm2, ans;
  int c;
};

CHI2_TAIL_HD inline void fraction_begin(const Element& e, Fraction* f) {
  f->y = 1.0 - e.a;
  f->z = e.x + f->y + 1.0;
  f->pkm2 = 1.0;
  f->qkm2 = e.x;
  f->pkm1 = e.x + 1.0;
  f->qkm1 = f->z * e.x;
  f->ans = f->pkm1 / f->qkm1;
  f->c = 0;
}

CHI2_TAIL_HD inline bool fraction_step(Fraction* f) {
  f->c += 1;
  f->y = f->y + 1.0;
  f->z = f->z + 2.0;
  const double yc = f->y * double(f->c);
  const double pk = fma(f->pkm1, f->z, -(f->pkm2 * yc));
  const double qk = fma(f->qkm1, f->z, -(f->qkm2 * yc));
  double t = 1.0;
  if (qk != 0.0) {
    const double r = pk / qk;
    t = fabs((f->ans - r) / r);
    f->ans = r;
  }
  f->pkm2 = f->pkm1;
  f->pkm1 = pk;
  f->qkm2 = f->qkm1;
  f->qkm1 = qk;
  if (fabs(pk) > kRescale) {
    f->pkm2 = f->pkm2 * kEps;
    f->pkm1 = f->pkm1 * kEps;
    f->qkm2 = f->qkm2 * kEps;
    f->qkm1 = f->qkm1 * kEps;
  }
  return !(t > kEps) || f->c == kFractionIterations;  // NaN stops too
}

CHI2_TAIL_HD inline double fraction_end(const Element& e, const Fraction& f) {
  return f.ans * e.ax;
}

// igammac's masks and prefactor for a = df / 2, x = stat / 2; for kDone,
// *q is igammac's value (the loops' starting values times ax)
CHI2_TAIL_HD inline int start(double stat, double df, Element* e, double* q) {
  const double a = df * 0.5;
  const double x = stat * 0.5;
  const bool a_is_zero = a == 0.0;
  const bool x_is_inf = x == INFINITY;
  const bool domain_error = x < 0.0 || a < 0.0 || (a_is_zero && x == 0.0) ||
                            isnan(a) || isnan(x);
  const bool use_igamma = x < 1.0 || x < a;
  double ax = fma(a, log(x), -x) - lgamma_xla(a);
  const bool underflow = ax < -kLogDblMax;
  ax = flush(exp(ax));
  e->a = a;
  e->x = x;
  e->ax = ax;
  if (domain_error) {
    *q = NAN;
  } else if (x_is_inf || a_is_zero) {
    *q = 0.0;
  } else if (!underflow) {
    return use_igamma ? kSeries : kFraction;
  } else if (use_igamma) {  // no iteration: the loops' starting values
    Series s;
    series_begin(*e, &s);
    *q = series_end(*e, s);
  } else {
    Fraction f;
    fraction_begin(*e, &f);
    *q = fraction_end(*e, f);
  }
  return kDone;
}

CHI2_TAIL_HD inline double series(const Element& e) {
  Series s;
  series_begin(e, &s);
  while (!series_step(e, &s)) {
  }
  return series_end(e, s);
}

CHI2_TAIL_HD inline double fraction(const Element& e) {
  Fraction f;
  fraction_begin(e, &f);
  while (!fraction_step(&f)) {
  }
  return fraction_end(e, f);
}

// chi2_sf from igammac's q: the flush and the 85 switch
CHI2_TAIL_HD inline double finish(double q, double stat) {
  if (q < kDblMin) q = 0.0;
  return stat > kHighPrecisionThreshold ? q : 1.0 - (1.0 - q);
}

CHI2_TAIL_HD inline double chi2_sf(double stat, double df) {
  Element e;
  double q;
  const int branch = start(stat, df, &e, &q);
  if (branch == kSeries) q = series(e);
  if (branch == kFraction) q = fraction(e);
  return finish(q, stat);
}

}  // namespace chi2_tail
