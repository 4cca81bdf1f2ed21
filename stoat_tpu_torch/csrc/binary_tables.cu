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
// and nothing but the outputs touches device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

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

  double total_sum = 0.0;
  double row0 = 0.0;  // 2xN row sums over kept columns
  double row1 = 0.0;
  double total_kept = 0.0;
  int k = 0;
  int maf_count = 0;
  double a = 0.0, b = 0.0, c = 0.0, d = 0.0;
  for (int64_t j = 0; j < Pmax; ++j) {
    const int32_t pi = row[j];
    const double x0 = pi >= 0 ? g0_path[pi] : 0.0;
    const double x1 = pi >= 0 ? g1_path[pi] : 0.0;
    g0_row[j] = x0;
    g1_row[j] = x1;
    const double col = x0 + x1;
    total_sum += col;
    const bool kept = pi >= 0 && col != 0.0;
    keep_row[j] = kept ? 1 : 0;
    if (!kept) continue;
    const double freq1 = x1 / col;
    const double other = 1.0 - freq1;
    const double maf = freq1 < other ? freq1 : other;
    if (maf > maf_threshold) ++maf_count;
    if (k == 0) {
      a = x0;
      c = x1;
    } else if (k == 1) {
      b = x0;
      d = x1;
    }
    ++k;
    row0 += x0;
    row1 += x1;
    total_kept += col;
  }
  filtered[s] = (floor(total_sum / 2.0) < min_individuals ||
                 total_sum < min_haplotypes || k < 2 || maf_count < 2)
                    ? 1 : 0;
  k_out[s] = k;
  a_out[s] = a;
  b_out[s] = b;
  c_out[s] = c;
  d_out[s] = d;

  if (k == 2) {
    // chi2.py:46-72
    const double r1 = a + b;
    const double r2 = c + d;
    const double c1 = a + c;
    const double c2 = b + d;
    const double total = r1 + r2;
    const bool invalid = r1 == 0.0 || r2 == 0.0 || c1 == 0.0 || c2 == 0.0;
    const double safe_total = invalid ? 1.0 : total;
    double ea = r1 * c1 / safe_total;
    double eb = r1 * c2 / safe_total;
    double ec = c1 * r2 / safe_total;
    double ed = c2 * r2 / safe_total;
    const bool zexp = ea == 0.0 || eb == 0.0 || ec == 0.0 || ed == 0.0;
    if (zexp) {
      ea = 1.0;
      eb = 1.0;
      ec = 1.0;
      ed = 1.0;
    }
    const double da = a - ea;
    const double db = b - eb;
    const double dc = c - ec;
    const double dd = d - ed;
    stat_out[s] = da * da / ea + db * db / eb + dc * dc / ec + dd * dd / ed;
    df_out[s] = 1.0;
    invalid_out[s] = invalid ? 1 : 0;
    zexp_out[s] = zexp ? 1 : 0;
    return;
  }

  // chi2.py:95-118 over the kept columns; a column that is not kept adds
  // 0.0 + 0.0 in the JAX sum, which leaves every partial sum unchanged.
  const bool invalid = total_kept == 0.0 || row0 == 0.0 || row1 == 0.0;
  const double safe_total = total_kept == 0.0 ? 1.0 : total_kept;
  double stat = 0.0;
  for (int64_t j = 0; j < Pmax; ++j) {
    if (!keep_row[j]) continue;
    const double x0 = g0_row[j];
    const double x1 = g1_row[j];
    const double col = x0 + x1;
    double e0 = row0 * col / safe_total;
    double e1 = row1 * col / safe_total;
    if (!(e0 > 0.0)) e0 = 1.0;
    if (!(e1 > 0.0)) e1 = 1.0;
    const double d0 = x0 - e0;
    const double d1 = x1 - e1;
    stat += d0 * d0 / e0 + d1 * d1 / e1;
  }
  stat_out[s] = stat;
  df_out[s] = double(k - 1 > 1 ? k - 1 : 1);
  invalid_out[s] = invalid ? 1 : 0;
  zexp_out[s] = 0;
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
