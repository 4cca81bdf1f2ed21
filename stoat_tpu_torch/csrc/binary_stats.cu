// K3 + K4 in one launch: per snarl the binary table, its filter and
// chi-squared statistic, and the Fisher p of the 2x2 tables, masked; and
// K1+K2 + K3 + K4 in one launch (binary_from_words, the main path's), the
// path counts counted from the packed words inside the same block.
//
// Replaces stoat_tpu/pipeline/binary.py _binary_from_path_counts (:98-153)
// up to the chi-squared tail, which csrc/chi2_tail.cu (K5) takes next, and
// with binary_from_words binary_tables_device_packed (:77-96) up to that
// tail, which is the JAX package's own program boundary:
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
// snarl; with binary_from_words the gathered words besides (valid paths x
// K x W x 4 bytes: 30.9 MB at the first vcf -b chunk, 24,609 valid paths
// of 32,768, K = 2, W = 157; 29.2 MB of distinct rows).  Before
// binary_stats the main path launched binary_tables.cu and fisher.cu and
// masked Fisher with a torch.where, 13 output allocations besides; before
// binary_from_words it launched membership_counts.cu ahead of
// binary_stats, two wrappers and two allocations.  The wrapper now makes
// one allocation and one launch.
//
// Design of binary_stats (counts given): one thread per snarl, as in
// binary_tables.cu: the table in registers, then the scan on the 2x2
// tables only, each output written once.
//
// binary_from_words: the K1+K2 count (membership_counts_device.cuh) is
// bound by its gathered words, which the standalone kernel wrote as [P]
// float64 counts for this kernel to gather back, two launches and two
// allocations a chunk.  Here a block owns a tile of kTile snarls and runs
// kWarps warps:
//   1. every thread stages the tile's snarl_path_idx rows (each entry
//      >= 0 read as a path index, never assumed contiguous), the paths'
//      valid flags folded in, the paths' K row indices and tail and
//      g1_words in shared memory, with coalesced loads, so that a path's
//      gathered words are its only dependent loads;
//   2. the warps count the tile's paths, kPaths at once a warp, into
//      shared memory as integers;
//   3. every thread writes the tile's g0, g1 and keep rows, coalesced;
//   4. threads t < kTile build snarl t's table from the shared counts and
//      run the scan, exactly as binary_stats does (one device function).
// A snarl_path_idx too wide for kTile snarls' rows in shared memory gets
// fewer snarls a block; row indices that do not fit in kRowsBudget bytes
// are read from global memory.  The layout (32 snarls, 8 warps, 2 paths a
// warp at once: 256 blocks at the chunk, two an SM, one wave) won an A/B
// on the card against 4 and 16 warps, 64 and 128 snarls, 1 path a warp,
// and a pipelined block whose counting warps hand each part of the tile
// to its own scanning warp by named barriers (PERF.md section 6): the
// count and the scan do not overlap, every block counting and then
// scanning at once, and the count runs at about half its gathered
// words' rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "binary_tables_device.cuh"
#include "fisher_device.cuh"
#include "membership_counts_device.cuh"

namespace {

constexpr int kThreads = 64;  // binary_stats: snarls (threads) a block

// binary_from_words' block: kTile snarls, kWarps warps, kPaths paths a
// warp at once; row indices staged up to kRowsBudget bytes
constexpr int kTile = 32;
constexpr int kWarps = 8;
constexpr int kPaths = 2;
constexpr size_t kRowsBudget = 32 * 1024;
constexpr size_t kMaxShared = 200 * 1024;
static_assert(kTile <= kWarps * 32, "a thread a snarl of the tile");

// The per-snarl half both kernels share: snarl s's table from column(j,
// x0, x1) (binary_tables_device.cuh), the scan on a 2x2 table, and the
// [S] outputs.
template <typename Column>
__device__ inline void table_and_scan(
    int64_t s, Column column, int64_t Pmax, double min_individuals,
    double min_haplotypes, double maf_threshold, double* __restrict__ p_fisher,
    double* __restrict__ stat_out, double* __restrict__ df_out,
    uint8_t* __restrict__ filtered, uint8_t* __restrict__ invalid_out,
    uint8_t* __restrict__ zexp_out) {
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
  table_and_scan(s, column, Pmax, min_individuals, min_haplotypes,
                 maf_threshold, p_fisher, stat_out, df_out, filtered,
                 invalid_out, zexp_out);
}

// a tile entry in shared memory: the path index, kPadding for a padding
// entry, kInvalid for a path whose valid flag is 0 (a real column that
// counts 0)
constexpr int32_t kPadding = -1;
constexpr int32_t kInvalid = -2;

__global__ void __launch_bounds__(kWarps * 32) binary_from_words_kernel(
    const uint32_t* __restrict__ words,      // [E+1, W]
    const int32_t* __restrict__ path_idx,    // [P, K]
    const uint8_t* __restrict__ valid,       // [P]
    const uint32_t* __restrict__ tail,       // [W]
    const uint32_t* __restrict__ g1_words,   // [W]
    const int32_t* __restrict__ sidx,        // [S, Pmax]
    int64_t S, int64_t Pmax, int64_t K, int64_t W, int64_t tile,
    bool rows_staged, double min_individuals, double min_haplotypes,
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
  // shared memory: the tile's entries, their two counts, tail and
  // g1_words, and (rows_staged) the entries' K row indices
  extern __shared__ uint32_t smem[];
  const int64_t slots = tile * Pmax;
  int32_t* entry = reinterpret_cast<int32_t*>(smem);
  uint32_t* count0 = smem + slots;         // controls (n_all - n_case)
  uint32_t* count1 = count0 + slots;       // cases
  uint32_t* masks = count1 + slots;        // tail, then g1_words
  int32_t* rows_s = reinterpret_cast<int32_t*>(masks + 2 * W);

  const int64_t s0 = int64_t(blockIdx.x) * tile;
  const int64_t n_snarls = S - s0 < tile ? S - s0 : tile;
  const int64_t n = n_snarls * Pmax;
  const int32_t* tile_idx = sidx + s0 * Pmax;
  const int nthreads = kWarps * 32;

  // 1. stage, every load independent of the others but for the path's
  // valid flag and rows, which wait for its index only
  for (int64_t i = threadIdx.x; i < n; i += nthreads) {
    const int32_t pi = tile_idx[i];
    entry[i] = pi < 0 ? kPadding : (valid[pi] ? pi : kInvalid);
  }
  for (int64_t w = threadIdx.x; w < W; w += nthreads) {
    masks[w] = tail[w];
    masks[W + w] = g1_words[w];
  }
  if (rows_staged) {
    for (int64_t i = threadIdx.x; i < n * K; i += nthreads) {
      const int64_t e = i / K;
      const int32_t pi = tile_idx[e];
      rows_s[i] = pi >= 0 ? path_idx[int64_t(pi) * K + (i - e * K)] : 0;
    }
  }
  __syncthreads();

  // 2. count, kPaths entries a warp at once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t e0 = int64_t(warp) * kPaths; e0 < n;
       e0 += int64_t(kWarps) * kPaths) {
    const int32_t* rows[kPaths];
#pragma unroll
    for (int g = 0; g < kPaths; ++g) {
      const int64_t e = e0 + g;
      const int32_t pi = e < n ? entry[e] : kPadding;
      rows[g] = pi < 0 ? nullptr
                       : (rows_staged ? rows_s + e * K
                                      : path_idx + int64_t(pi) * K);
    }
    unsigned n_all[kPaths], n_case[kPaths];
    stoat::count_paths<kPaths>(words, rows, K, W, masks, masks + W, lane,
                               n_all, n_case);
#pragma unroll
    for (int g = 0; g < kPaths; ++g) {
      if (lane == g && e0 + g < n) {
        count0[e0 + g] = n_all[g] - n_case[g];
        count1[e0 + g] = n_case[g];
      }
    }
  }
  __syncthreads();

  // 3. the tile's [S, Pmax] rows, coalesced
  for (int64_t i = threadIdx.x; i < n; i += nthreads) {
    const bool real = entry[i] != kPadding;
    const double x0 = real ? double(count0[i]) : 0.0;
    const double x1 = real ? double(count1[i]) : 0.0;
    g0_out[s0 * Pmax + i] = x0;
    g1_out[s0 * Pmax + i] = x1;
    keep[s0 * Pmax + i] = real && x0 + x1 != 0.0 ? 1 : 0;
  }

  // 4. a thread a snarl: its table and scan
  if (threadIdx.x >= n_snarls) return;
  const int64_t base = int64_t(threadIdx.x) * Pmax;
  auto column = [&](int64_t j, double& x0, double& x1) {
    const bool real = entry[base + j] != kPadding;
    x0 = real ? double(count0[base + j]) : 0.0;
    x1 = real ? double(count1[base + j]) : 0.0;
    return real;
  };
  table_and_scan(s0 + threadIdx.x, column, Pmax, min_individuals,
                 min_haplotypes, maf_threshold, p_fisher, stat_out, df_out,
                 filtered, invalid_out, zexp_out);
}

// binary_from_words' shared memory for a tile of ``tile`` snarls
size_t from_words_shared(int64_t tile, int64_t Pmax, int64_t K, int64_t W,
                         bool rows_staged) {
  return sizeof(uint32_t) *
         size_t(3 * tile * Pmax + 2 * W + (rows_staged ? tile * Pmax * K : 0));
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

extern "C" int binary_from_words_launch(
    const void* words, const void* path_idx, const void* valid,
    const void* tail, const void* g1_words, const void* sidx, int64_t S,
    int64_t Pmax, int64_t K, int64_t W, double min_individuals,
    double min_haplotypes, double maf_threshold, void* p_fisher,
    void* stat_out, void* df_out, void* g0_out, void* g1_out,
    void* filtered, void* invalid_out, void* zexp_out, void* keep,
    void* stream) {
  // the tile: kTile snarls, fewer where their rows would not fit
  int64_t tile = kTile;
  while (tile > 1 && from_words_shared(tile, Pmax, K, W, false) > kMaxShared)
    tile /= 2;
  if (from_words_shared(tile, Pmax, K, W, false) > kMaxShared)
    return int(cudaErrorInvalidValue);
  const bool rows_staged =
      from_words_shared(tile, Pmax, K, W, true) <= kRowsBudget;
  const size_t smem = from_words_shared(tile, Pmax, K, W, rows_staged);
  // set at every launch: the runtime keeps a function's attributes for
  // each device apart, and a launch may go to any card
  const cudaError_t allowed = cudaFuncSetAttribute(
      binary_from_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kMaxShared));
  if (allowed != cudaSuccess) return int(allowed);
  if (S > 0) {
    const int64_t blocks = (S + tile - 1) / tile;
    binary_from_words_kernel<<<unsigned(blocks), kWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(path_idx),
        static_cast<const uint8_t*>(valid),
        static_cast<const uint32_t*>(tail),
        static_cast<const uint32_t*>(g1_words),
        static_cast<const int32_t*>(sidx), S, Pmax, K, W, tile, rows_staged,
        min_individuals, min_haplotypes, maf_threshold,
        static_cast<double*>(p_fisher), static_cast<double*>(stat_out),
        static_cast<double*>(df_out), static_cast<double*>(g0_out),
        static_cast<double*>(g1_out), static_cast<uint8_t*>(filtered),
        static_cast<uint8_t*>(invalid_out), static_cast<uint8_t*>(zexp_out),
        static_cast<uint8_t*>(keep));
  }
  return int(cudaGetLastError());
}

extern "C" const char* binary_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
