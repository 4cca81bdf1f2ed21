// K3 + K4 in one launch: per snarl the binary table, its filter and
// chi-squared statistic, and the Fisher p of the 2x2 tables, masked.
//
// Replaces stoat_tpu/pipeline/binary.py _binary_from_path_counts (:98-153)
// up to the chi-squared tail, which csrc/chi2_tail.cu (K5) takes next:
//
//   g0, g1, keep        [S, Pmax]  the gathered path counts and kept columns
//   filtered            [S]        the snarl filter
//   chi2_stat, chi2_df, chi2_invalid, chi2_zexp
//                       [S]        the 2x2 (k == 2) or 2xN statistic
//   p_fisher            [S]        Fisher's p of (a, b, c, d) when k == 2,
//                                  else NaN (binary.py:146)
//
// The table is binary_tables_device.cuh's binary_table (perm_binary.cu
// runs it too) and the scan fisher_device.cuh's fisher_scan (fisher.cu
// runs it too), so each output has the bits of the plain version
// (pipeline/binary.py binary_stats_plain) when built with -fmad=false.
//
// What bounds it on the card: the scan's dependent steps, as in fisher.cu;
// the table is a few dozen float64 operations and 17 Pmax + 43 bytes a
// snarl.  Before this kernel the main path launched binary_tables.cu and
// fisher.cu and masked Fisher with a torch.where, 13 output allocations
// besides; the wrapper now makes one allocation and this one launch.
//
// Design: one thread per snarl, as in binary_tables.cu: the table in
// registers, then the scan on the 2x2 tables only, each output written
// once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "binary_tables_device.cuh"
#include "fisher_device.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void binary_stats_kernel(
    const double* __restrict__ g0_path,      // [P]
    const double* __restrict__ g1_path,      // [P]
    const int32_t* __restrict__ sidx,        // [S, Pmax]
    int64_t S, int64_t Pmax, double min_individuals, double min_haplotypes,
    double maf_threshold,
    double* __restrict__ p_fisher,           // [S]
    double* __restrict__ stat_out,           // [S]
    double* __restrict__ df_out,             // [S]
    double* __restrict__ g0_out,             // [S, Pmax]
    double* __restrict__ g1_out,             // [S, Pmax]
    uint8_t* __restrict__ filtered,          // [S]
    uint8_t* __restrict__ invalid_out,       // [S]
    uint8_t* __restrict__ zexp_out,          // [S]
    uint8_t* __restrict__ keep) {            // [S, Pmax]
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int32_t* row = sidx + s * Pmax;
  auto column = [&](int64_t j, double& x0, double& x1) {
    const int32_t pi = row[j];
    x0 = pi >= 0 ? g0_path[pi] : 0.0;
    x1 = pi >= 0 ? g1_path[pi] : 0.0;
    return pi >= 0;
  };
  for (int64_t j = 0; j < Pmax; ++j) {
    double x0, x1;
    const bool real = column(j, x0, x1);
    g0_out[s * Pmax + j] = x0;
    g1_out[s * Pmax + j] = x1;
    keep[s * Pmax + j] = real && x0 + x1 != 0.0 ? 1 : 0;
  }
  const stoat::BinaryTable t = stoat::binary_table(
      column, Pmax, min_individuals, min_haplotypes, maf_threshold);
  p_fisher[s] = t.k == 2
                    ? stoat::fisher_scan<stoat::kFisherBlock>(t.a, t.b, t.c,
                                                              t.d)
                    : nan("");
  stat_out[s] = t.stat;
  df_out[s] = t.df;
  filtered[s] = t.filtered ? 1 : 0;
  invalid_out[s] = t.invalid ? 1 : 0;
  zexp_out[s] = t.zexp ? 1 : 0;
}

}  // namespace

extern "C" int binary_stats_launch(
    const void* g0_path, const void* g1_path, const void* sidx, int64_t S,
    int64_t Pmax, double min_individuals, double min_haplotypes,
    double maf_threshold, void* p_fisher, void* stat_out, void* df_out,
    void* g0_out, void* g1_out, void* filtered, void* invalid_out,
    void* zexp_out, void* keep, void* stream) {
  if (S > 0) {
    const int64_t blocks = (S + kThreads - 1) / kThreads;
    binary_stats_kernel<<<unsigned(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(g0_path),
        static_cast<const double*>(g1_path),
        static_cast<const int32_t*>(sidx), S, Pmax, min_individuals,
        min_haplotypes, maf_threshold, static_cast<double*>(p_fisher),
        static_cast<double*>(stat_out), static_cast<double*>(df_out),
        static_cast<double*>(g0_out), static_cast<double*>(g1_out),
        static_cast<uint8_t*>(filtered), static_cast<uint8_t*>(invalid_out),
        static_cast<uint8_t*>(zexp_out), static_cast<uint8_t*>(keep));
  }
  return int(cudaGetLastError());
}

extern "C" const char* binary_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
