// K3: per-snarl binary table, filter and chi-squared statistic.
//
// Replaces the per-snarl part of stoat_tpu/pipeline/binary.py
// _binary_from_path_counts (:98-146) together with stoat_tpu/stats/chi2.py
// chi2_2x2_stat (:32) and chi2_2xn_stat (:89).  For snarl s, over its
// Pmax padded path columns j (snarl_path_idx[s, j] = -1 is padding):
//
//   g0[s,j], g1[s,j]  gathered path counts (0 on padding)
//   total_sum         sum of g0 + g1 over all columns
//   keep[s,j]         real column with g0 + g1 != 0;  k = kept columns
//   maf_count         kept columns with min(f, 1 - f) > maf, f = g1/(g0+g1)
//   filtered          floor(total_sum/2) < min_individuals
//                     | total_sum < min_haplotypes | k < 2 | maf_count < 2
//   a, b / c, d       g0 / g1 of the first two kept columns in column order
//                     (the stable argsort at binary.py:131), 0 if missing
//   chi2              k == 2: the 2x2 statistic of (a, b, c, d), df 1;
//                     else the 2xN statistic over the kept columns, summed
//                     in column order, df max(k - 1, 1)
//
// The operations are those of the JAX functions, in the same order, on
// float64; nvcc is run with -fmad=false so that no multiply-add is fused
// and the plain PyTorch version (pipeline/binary.py) gives the same bits.
//
// What bounds it on the card: memory and latency.  Per snarl it reads Pmax
// int32 indices, gathers 2*Pmax doubles from the [P] path counts (which
// stay in L2), and writes 17*Pmax + 55 bytes; the arithmetic is a few
// dozen double operations.  At S = 8192 snarls and Pmax = 4 that is about
// 1.7 MB per chunk, so a launch costs a few microseconds of latency.
//
// Design: one thread per snarl, looping over Pmax, so that the argsort and
// the row reductions of the JAX version become running sums in registers
// and nothing but the outputs touches device memory.  The table code is
// binary_tables_device.cuh, which perm_binary.cu (K15) runs too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "binary_tables_device.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void binary_tables_kernel(
    const double* __restrict__ g0_path,      // [P]
    const double* __restrict__ g1_path,      // [P]
    const int32_t* __restrict__ sidx,        // [S, Pmax]
    int64_t S, int64_t Pmax, double min_individuals, double min_haplotypes,
    double maf_threshold,
    uint8_t* __restrict__ filtered,          // [S]
    uint8_t* __restrict__ keep,              // [S, Pmax]
    double* __restrict__ g0_out,             // [S, Pmax]
    double* __restrict__ g1_out,             // [S, Pmax]
    int32_t* __restrict__ k_out,             // [S]
    double* __restrict__ a_out, double* __restrict__ b_out,
    double* __restrict__ c_out, double* __restrict__ d_out,  // [S] each
    double* __restrict__ stat_out,           // [S]
    double* __restrict__ df_out,             // [S]
    uint8_t* __restrict__ invalid_out,       // [S]
    uint8_t* __restrict__ zexp_out) {        // [S]
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int32_t* row = sidx + s * Pmax;
  double* g0_row = g0_out + s * Pmax;
  double* g1_row = g1_out + s * Pmax;
  uint8_t* keep_row = keep + s * Pmax;
  auto column = [&](int64_t j, double& x0, double& x1) {
    const int32_t pi = row[j];
    x0 = pi >= 0 ? g0_path[pi] : 0.0;
    x1 = pi >= 0 ? g1_path[pi] : 0.0;
    return pi >= 0;
  };
  for (int64_t j = 0; j < Pmax; ++j) {
    double x0, x1;
    const bool real = column(j, x0, x1);
    g0_row[j] = x0;
    g1_row[j] = x1;
    keep_row[j] = real && x0 + x1 != 0.0 ? 1 : 0;
  }
  const stoat::BinaryTable t = stoat::binary_table(
      column, Pmax, min_individuals, min_haplotypes, maf_threshold);
  filtered[s] = t.filtered ? 1 : 0;
  k_out[s] = t.k;
  a_out[s] = t.a;
  b_out[s] = t.b;
  c_out[s] = t.c;
  d_out[s] = t.d;
  stat_out[s] = t.stat;
  df_out[s] = t.df;
  invalid_out[s] = t.invalid ? 1 : 0;
  zexp_out[s] = t.zexp ? 1 : 0;
}

}  // namespace

extern "C" int binary_tables_launch(
    const void* g0_path, const void* g1_path, const void* sidx, int64_t S,
    int64_t Pmax, double min_individuals, double min_haplotypes,
    double maf_threshold, void* filtered, void* keep, void* g0_out,
    void* g1_out, void* k_out, void* a_out, void* b_out, void* c_out,
    void* d_out, void* stat_out, void* df_out, void* invalid_out,
    void* zexp_out, void* stream) {
  if (S > 0) {
    const int64_t blocks = (S + kThreads - 1) / kThreads;
    binary_tables_kernel<<<unsigned(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(g0_path),
        static_cast<const double*>(g1_path),
        static_cast<const int32_t*>(sidx), S, Pmax, min_individuals,
        min_haplotypes, maf_threshold, static_cast<uint8_t*>(filtered),
        static_cast<uint8_t*>(keep), static_cast<double*>(g0_out),
        static_cast<double*>(g1_out), static_cast<int32_t*>(k_out),
        static_cast<double*>(a_out), static_cast<double*>(b_out),
        static_cast<double*>(c_out), static_cast<double*>(d_out),
        static_cast<double*>(stat_out), static_cast<double*>(df_out),
        static_cast<uint8_t*>(invalid_out), static_cast<uint8_t*>(zexp_out));
  }
  return int(cudaGetLastError());
}

extern "C" const char* binary_tables_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
