// K4: two-sided Fisher exact test for 2x2 tables, one thread per table.
//
// Replaces stoat_tpu/stats/fisher.py fisher_exact_2x2 (:165) and its
// per-table body _fisher_single (:39-161): PLINK's relative-probability
// scan (the reference's FisherKhi2::fastFishersExactTest).  The three
// phases are transcribed statement for statement on float64:
//
//   1. walk the right tail from the observed table while the relative
//      probability stays at or above the bias, summing into cprob; stop on
//      the first table below it (added to tprob) or on overflow ("0");
//   2. keep walking the right tail into tprob until an addition no longer
//      changes it;
//   3. walk the left tail from the observed table into tprob (a do-while)
//      until an addition no longer changes it.
//
//   p = tprob / (cprob + tprob), with the sentinels NaN (a zero margin),
//   0 (overflow) and 1 (cprob == 0); a subnormal p becomes 0, as the JAX
//   package's XLA backends flush it.
//
// The ratio is formed first and then multiplied (fisher.py:73), overflow is
// "!isfinite || > DBL_MAX" (:83), and the stall exits compare the new sum
// with the old one, all as in the JAX function.  nvcc must run with
// -fmad=false: otherwise it contracts cprob + prob * ratio into a fused
// multiply-add, whose single rounding differs from the plain version's two
// in the last bit.  With it the kernel is bitwise equal to the plain
// PyTorch version (stats/fisher.py).
//
// What bounds it on the card: double-precision latency and divergence.  A
// table reads and writes 40 bytes, but its loops run a data-dependent
// number of steps that grows with the table's counts, each a dependent
// chain of double multiplies, one double divide and adds.
// Threads of one warp run as long as the slowest of them.  This PR accepts
// that divergence; sorting tables by expected loop length is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr double kEps2 = 9.094947017729282e-13;
constexpr double kBias = 1.0339757656912846e-25;
constexpr double kDblMax = 1.7976931348623157e308;
constexpr double kDblMin = 2.2250738585072014e-308;

__device__ double fisher_single(double m11, double m12, double m21,
                                double m22) {
  if ((m11 + m12) == 0.0 || (m21 + m22) == 0.0 || (m11 + m21) == 0.0 ||
      (m12 + m22) == 0.0) {
    return nan("");
  }
  // canonical order: m12 <= m21, m11 <= m22, left of centre
  {
    const double lo = m12 < m21 ? m12 : m21;
    const double hi = m12 < m21 ? m21 : m12;
    m12 = lo;
    m21 = hi;
  }
  {
    const double lo = m11 < m22 ? m11 : m22;
    const double hi = m11 < m22 ? m22 : m11;
    m11 = lo;
    m22 = hi;
  }
  if ((m11 * m22) > (m12 * m21)) {
    double t = m11;
    m11 = m12;
    m12 = t;
    t = m21;
    m21 = m22;
    m22 = t;
  }
  const double tprob0 = (1.0 - kEps2) * kBias;

  // phase 1
  double c11 = m11, c12 = m12, c21 = m21, c22 = m22;
  double prob = tprob0;
  double cprob = 0.0;
  double tprob = tprob0;
  int status = 0;  // 0 scanning, 1 fell below the bias, 2 overflow
  while (status == 0 && c12 > 0.5) {
    c11 = c11 + 1.0;
    c22 = c22 + 1.0;
    prob = prob * ((c12 * c21) / (c11 * c22));
    c12 = c12 - 1.0;
    c21 = c21 - 1.0;
    const bool overflow = !isfinite(prob) || prob > kDblMax;
    const bool under = prob < kBias;
    if (under) tprob = tprob + prob;
    if (!(under || overflow)) cprob = cprob + prob;
    status = overflow ? 2 : (under ? 1 : 0);
  }
  if (status == 2) return 0.0;
  if (cprob == 0.0) return 1.0;

  // phase 2: only after the phase-1 break below the bias
  if (status == 1) {
    while (c12 > 0.5) {
      c11 = c11 + 1.0;
      c22 = c22 + 1.0;
      prob = prob * ((c12 * c21) / (c11 * c22));
      c12 = c12 - 1.0;
      c21 = c21 - 1.0;
      const double next = tprob + prob;
      const bool stalled = next <= tprob;
      tprob = next;
      if (stalled) break;
    }
  }

  // phase 3: left tail from the canonical table, do-while
  double num = tprob;
  if (m11 > 0.0) {
    c11 = m11;
    c12 = m12;
    c21 = m21;
    c22 = m22;
    prob = tprob0;
    bool first = true;
    while (first || c11 > 0.5) {
      first = false;
      c12 = c12 + 1.0;
      c21 = c21 + 1.0;
      prob = prob * ((c11 * c22) / (c12 * c21));
      c11 = c11 - 1.0;
      c22 = c22 - 1.0;
      const double pre = tprob;
      tprob = tprob + prob;
      if (tprob <= pre) {
        num = pre;
        break;
      }
      num = tprob;
    }
  }
  const double p = num / (cprob + num);
  // stoat_tpu's XLA backends flush subnormal results to zero, so a p-value
  // below DBL_MIN prints as "0" there; keep that output
  return p < kDblMin ? 0.0 : p;
}

__global__ void fisher_kernel(const double* __restrict__ m11,
                              const double* __restrict__ m12,
                              const double* __restrict__ m21,
                              const double* __restrict__ m22,
                              double* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = fisher_single(m11[i], m12[i], m21[i], m22[i]);
}

}  // namespace

extern "C" int fisher_launch(const void* m11, const void* m12,
                             const void* m21, const void* m22, void* out,
                             int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    fisher_kernel<<<unsigned(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(m11), static_cast<const double*>(m12),
        static_cast<const double*>(m21), static_cast<const double*>(m22),
        static_cast<double*>(out), n);
  }
  return int(cudaGetLastError());
}

extern "C" const char* fisher_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
