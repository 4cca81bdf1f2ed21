// K4: two-sided Fisher exact test for 2x2 tables, one thread per table.
//
// Replaces stoat_tpu/stats/fisher.py fisher_exact_2x2 (:165) and its
// per-table body _fisher_single (:39-161).  The scan is fisher_device.cuh's
// fisher_scan, which binary_stats.cu (the main path's K3 + K4) runs too;
// with -fmad=false the kernel is bitwise equal to the plain PyTorch version
// (stats/fisher.py).
//
// What bounds it on the card: the latency of the scan's dependent steps.
// A table reads and writes 40 bytes, but its walks run a data-dependent
// number of steps (about 230-320 at carrier frequencies 0.2-0.5 in a
// cohort of 5,008 haplotypes), and a warp runs as long as its slowest
// table.  fisher_scan divides each block of ratios ahead of the chain of
// multiplies and adds, the divisions of a block in flight together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "fisher_device.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void fisher_kernel(const double* __restrict__ m11,
                              const double* __restrict__ m12,
                              const double* __restrict__ m21,
                              const double* __restrict__ m22,
                              double* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = stoat::fisher_scan<stoat::kFisherBlock>(m11[i], m12[i], m21[i],
                                                   m22[i]);
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
