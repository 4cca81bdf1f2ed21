// K5: chi-squared upper-tail p-values, and the NA masking of the binary
// tables.
//
// Replaces stoat_tpu/stats/special.py chi2_sf (:30-50) ->
// jax.scipy.special.gammaincc, behind stoat_tpu/stats/chi2.py
// finish_chi2_pvalues (:137-146).  For every element i of a flat [n]:
//
//   p = chi2_sf(stat[i], df[i])          (chi2_tail_device.cuh)
//   with the masks: zexp[i] ? DBL_MAX : p, then invalid[i] ? NaN : p
//
// Given no masks (null pointers) it writes p alone: the permutation test's
// [K, S] tails (pipeline/permutation.py binary_perm_pvalues and
// score_perm_pvalues through stats/special.py chi2_sf), as student_t.cu
// does for linear_pvalues.
//
// What bounds it on the card: neither bytes (26 per element) nor flops at
// the main path's sizes, but launch latency and the longest lane of each
// warp: the series and the continued fraction of igammac run to
// convergence, one element per thread, up to 2,000 iterations (a NaN
// statistic runs them all).  Design: one thread per element, the
// coefficient tables in __constant__ memory; no shared memory, no atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "chi2_tail_device.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void chi2_tail_kernel(const double* __restrict__ stat,
                                 const double* __restrict__ df,
                                 const uint8_t* __restrict__ invalid,
                                 const uint8_t* __restrict__ zexp,
                                 double* __restrict__ p, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  double v = chi2_tail::chi2_sf(stat[i], df[i]);
  // finish_chi2_pvalues's masks, in its order
  if (invalid != nullptr) {
    if (zexp[i]) v = DBL_MAX;
    if (invalid[i]) v = NAN;
  }
  p[i] = v;
}

}  // namespace

extern "C" int chi2_tail_launch(const void* stat, const void* df,
                                const void* invalid, const void* zexp,
                                void* p, int64_t n, void* stream) {
  if ((invalid == nullptr) != (zexp == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    chi2_tail_kernel<<<unsigned(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(stat), static_cast<const double*>(df),
        static_cast<const uint8_t*>(invalid),
        static_cast<const uint8_t*>(zexp), static_cast<double*>(p), n);
  }
  return int(cudaGetLastError());
}

extern "C" const char* chi2_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
