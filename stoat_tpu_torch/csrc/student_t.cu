// K10: two-tailed Student-t p-values of the per-snarl OLS statistics, and
// the NA masking of degenerate snarls.
//
// Replaces stoat_tpu/stats/linreg.py finish_linear_pvalues (:206) ->
// stoat_tpu/stats/special.py student_t_sf2 (:53) -> jax.scipy.special
// .betainc (JAX 0.9 regularized_incomplete_beta_impl, from XLA's math.cc),
// followed by the jnp.where(degenerate, nan, .) of stoat_tpu/pipeline/
// quantitative.py:339-347.  For every snarl i:
//
//   p        = t1 finite ? I_x(df/2, 1/2) with x = df / (df + t1^2) : 1.0
//   outputs  = degenerate ? NaN : (p, beta1, se1, r2)
//
// I_x(a, b) is the Lentz-Thompson-Barnett continued fraction (DLMF
// 8.17.22), at most 599 iterations, on (a, b, x) when x < (a+1)/(a+b+2)
// and on (b, a, 1-x) with 1 - result otherwise, times the prefactor
// x^a (1-x)^b / (a B(a, b)) from lgamma.  It is the plain version's
// (stats/special.py betainc_plain) arithmetic, operation for operation;
// -fmad=false keeps every multiply and add separately rounded.  Two
// behaviours are kept on purpose: subnormal x, prefactor and p are
// flushed to 0 (XLA flushes them under the JAX package), and each element
// stops iterating at its own convergence, where JAX stops only when the
// whole batch has converged (a few ulps of difference).
//
// What bounds it on the card: the continued fraction's dependent chain of
// float64 divisions (up to 599 iterations for large df near the branch
// point), not bytes: it reads 6 and writes 4 doubles per snarl.  Design:
// one thread per snarl; a warp runs as long as its slowest lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIterations = 600;
constexpr double kHalfEps = 1.1102230246251565e-16;  // float64 eps / 2
constexpr double kDblMin = 2.2250738585072014e-308;
constexpr double kTwoTiny = 2.0 * kDblMin;

__device__ __forceinline__ double flush(double v) {
  return fabs(v) < kDblMin ? 0.0 : v;
}

// partial numerator n >= 1 of the continued fraction, in JAX's order
__device__ double cf_numerator(int n, double a, double b, double x) {
  if (n == 1) return 1.0;
  const double m = double((n - 1) / 2);
  if (n % 2 == 0) {
    if (m == 0.0) return -(a + b) * x / (a + 1.0);
    return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0));
  }
  return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m));
}

__device__ double betainc_cf(double a, double b, double x) {
  double h = kHalfEps;
  double c = kHalfEps;
  double d = 0.0;
  for (int n = 1; n < kIterations; ++n) {
    const double num = cf_numerator(n, a, b, x);
    double cn = 1.0 + num / c;
    if (fabs(cn) < kHalfEps) cn = kHalfEps;
    double dn = 1.0 + num * d;
    if (fabs(dn) < kHalfEps) dn = kHalfEps;
    dn = 1.0 / dn;
    const double delta = cn * dn;
    c = cn;
    d = dn;
    h = h * delta;
    if (!(fabs(delta - 1.0) >= kHalfEps)) break;  // NaN stops too
  }
  return h;
}

__device__ double betainc(double a, double b, double x) {
  const double inf = INFINITY;
  const bool a_is_zero = a == 0.0 || b == inf;
  const bool b_is_zero = b == 0.0 || a == inf;
  const bool x_is_zero = x == 0.0;
  const bool x_is_one = x == 1.0;
  const bool result_is_zero =
      (b_is_zero && !x_is_one) || (a_is_zero && x_is_zero);
  const bool result_is_one =
      (a_is_zero && !x_is_zero) || (b_is_zero && x_is_one);
  const bool result_is_nan = a < 0.0 || b < 0.0 || x < 0.0 || x > 1.0 ||
                             (a_is_zero && b_is_zero) || isnan(a) ||
                             isnan(b) || isnan(x);
  const bool rapid = x < (a + 1.0) / (a + b + 2.0);
  if (!rapid) {
    const double a_orig = a;
    a = b;
    b = a_orig;
    x = 1.0 - x;
  }
  const double cf = betainc_cf(a, b, x);
  const double lbeta_small_a = lgamma(b) - lgamma(a + b);
  double factor;
  if (a < kTwoTiny) {
    factor = flush(exp(log1p(-x) * b - lbeta_small_a));
  } else {
    const double lbeta = lgamma(a) + lbeta_small_a;
    factor = flush(flush(exp(log(x) * a + log1p(-x) * b - lbeta)) / a);
  }
  double result = flush(cf * factor);
  if (!rapid) result = 1.0 - result;
  if (result_is_zero) result = 0.0;
  if (result_is_one) result = 1.0;
  if (result_is_nan) result = NAN;
  return result;
}

__global__ void student_t_kernel(
    const double* __restrict__ t1, const double* __restrict__ df,
    const uint8_t* __restrict__ degenerate, const double* __restrict__ beta,
    const double* __restrict__ se, const double* __restrict__ r2,
    double* __restrict__ p_out, double* __restrict__ beta_out,
    double* __restrict__ se_out, double* __restrict__ r2_out, int64_t S) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= S) return;
  const double t = t1[i];
  double p = 1.0;
  if (isfinite(t)) {
    const double nu = df[i];
    const double ta = fabs(t);
    const double x = flush(nu / (nu + ta * ta));
    p = flush(betainc(nu * 0.5, 0.5, x));
  }
  const bool deg = degenerate[i] != 0;
  p_out[i] = deg ? NAN : p;
  beta_out[i] = deg ? NAN : beta[i];
  se_out[i] = deg ? NAN : se[i];
  r2_out[i] = deg ? NAN : r2[i];
}

}  // namespace

extern "C" int student_t_launch(const void* t1, const void* df,
                                const void* degenerate, const void* beta,
                                const void* se, const void* r2, void* p_out,
                                void* beta_out, void* se_out, void* r2_out,
                                int64_t S, void* stream) {
  if (S > 0) {
    const int64_t blocks = (S + kThreads - 1) / kThreads;
    student_t_kernel<<<unsigned(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(t1), static_cast<const double*>(df),
        static_cast<const uint8_t*>(degenerate),
        static_cast<const double*>(beta), static_cast<const double*>(se),
        static_cast<const double*>(r2), static_cast<double*>(p_out),
        static_cast<double*>(beta_out), static_cast<double*>(se_out),
        static_cast<double*>(r2_out), S);
  }
  return int(cudaGetLastError());
}

extern "C" const char* student_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
