// K15: the binary permutation test's counts, tables and chi-squared
// statistics for K packed phenotype masks against one chunk's membership.
//
// Replaces stoat_tpu/pipeline/permutation.py _perm_binary_pvalues (:79-100)
// up to its chi-squared tail, and the membership it is given
// (_ChunkDevice, :245-261: membership_words, stoat_tpu/pipeline/packed.py
// :294).  Two entry points:
//
//   perm_membership  mem[p, w] = tail[w] & AND_k words[idx[p, k], w], 0 on
//                    an invalid path, and g_all[p] = its popcount: once per
//                    chunk, whatever the number of permutations
//   perm_binary      for permutation k and snarl s, over the snarl's path
//                    columns j (p = sidx[s, j], -1 padding):
//                      g1 = popcount(mem[p] & mask[k]),  g0 = g_all[p] - g1
//                    then the table, filter and statistic of
//                    binary_tables_device.cuh (K3's own code, so the
//                    statistic has K3's bits for the same counts):
//                      stat[k, s], df[k, s],
//                      bad[k, s] = filtered | invalid | zero expected
//
// The chi-squared tail and the +inf of bad tables follow as torch ops
// (pipeline/permutation.py).
//
// What bounds it on the card: the population counts.  perm_binary does
// K * S * Pmax * W AND + popcount pairs, 5.2e9 per chunk at K = 1,001,
// S = 8,192, Pmax = 4 and W = 157 words (2,504 samples); its bytes are the
// [P, W] membership, read from L2 once per block of 32 permutations, the
// K x W masks and the 17 bytes of output per (k, s).
// Design: a block takes 32 permutations (the lanes) and up to 8 snarls
// (the warps).  A warp's lanes read the same membership word, a broadcast,
// and each its own mask word from shared memory, where the block's mask
// rows sit in tiles of 128 words with a row stride of 129 words, so the
// 32 lanes hit 32 banks.  Each thread keeps its columns' case counts in
// shared memory across the tiles, then runs the table code.
// perm_membership is membership_counts.cu writing the words: one warp per
// path, lanes over W.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "binary_tables_device.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLanes = 32;          // permutations per block
constexpr int kTileWords = 128;     // mask words per tile
constexpr int kTileStride = kTileWords + 1;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void perm_membership_kernel(
    const uint32_t* __restrict__ words,   // [E+1, W]
    const int32_t* __restrict__ idx,      // [P, K]
    const uint8_t* __restrict__ valid,    // [P]
    const uint32_t* __restrict__ tail,    // [W]
    uint32_t* __restrict__ mem,           // [P, W]
    int32_t* __restrict__ g_all,          // [P]
    int64_t P, int64_t K, int64_t W) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // uniform across the warp
  const bool ok = valid[p] != 0;
  const int32_t* rows = idx + p * K;
  unsigned int n = 0;
  for (int64_t w = lane; w < W; w += 32) {
    uint32_t m = 0;
    if (ok) {
      m = tail[w];
      for (int64_t k = 0; k < K; ++k) m &= words[int64_t(rows[k]) * W + w];
    }
    mem[p * W + w] = m;
    n += __popc(m);
  }
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_down_sync(0xffffffffu, n, off);
  }
  if (lane == 0) g_all[p] = int32_t(n);
}

__global__ void perm_binary_kernel(
    const uint32_t* __restrict__ mem,     // [P, W]
    const int32_t* __restrict__ g_all,    // [P]
    const uint32_t* __restrict__ masks,   // [K, W]
    const int32_t* __restrict__ sidx,     // [S, Pmax]
    int64_t K, int64_t S, int64_t Pmax, int64_t W, double min_individuals,
    double min_haplotypes, double maf_threshold,
    double* __restrict__ stat_out,        // [K, S]
    double* __restrict__ df_out,          // [K, S]
    uint8_t* __restrict__ bad_out) {      // [K, S]
  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;                                  // [32][129]
  int32_t* counts = reinterpret_cast<int32_t*>(tile + kLanes * kTileStride);
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = warp * kLanes + lane;
  const int64_t k = int64_t(blockIdx.y) * kLanes + lane;
  const int64_t s = int64_t(blockIdx.x) * blockDim.y + warp;
  const bool active = k < K && s < S;
  const int32_t* row = sidx + (active ? s : 0) * Pmax;
  int32_t* my_counts = counts + int64_t(tid) * Pmax;
  for (int64_t j = 0; j < Pmax; ++j) my_counts[j] = 0;

  for (int64_t w0 = 0; w0 < W; w0 += kTileWords) {
    const int width = int(W - w0 < kTileWords ? W - w0 : kTileWords);
    for (int e = tid; e < kLanes * kTileWords; e += nthreads) {
      const int r = e / kTileWords;
      const int c = e % kTileWords;
      const int64_t kr = int64_t(blockIdx.y) * kLanes + r;
      tile[r * kTileStride + c] =
          kr < K && c < width ? masks[kr * W + w0 + c] : 0u;
    }
    __syncthreads();
    if (active) {
      const uint32_t* mine = tile + lane * kTileStride;
      for (int64_t j = 0; j < Pmax; ++j) {
        const int32_t p = row[j];
        if (p < 0) continue;
        const uint32_t* m = mem + int64_t(p) * W + w0;
        int n = 0;
        for (int c = 0; c < width; ++c) n += __popc(m[c] & mine[c]);
        my_counts[j] += n;
      }
    }
    __syncthreads();
  }
  if (!active) return;

  auto column = [&](int64_t j, double& x0, double& x1) {
    const int32_t p = row[j];
    if (p < 0) {
      x0 = 0.0;
      x1 = 0.0;
      return false;
    }
    const int32_t g1 = my_counts[j];
    x0 = double(g_all[p] - g1);
    x1 = double(g1);
    return true;
  };
  const stoat::BinaryTable t = stoat::binary_table(
      column, Pmax, min_individuals, min_haplotypes, maf_threshold);
  const int64_t o = k * S + s;
  stat_out[o] = t.stat;
  df_out[o] = t.df;
  bad_out[o] = t.filtered || t.invalid || t.zexp ? 1 : 0;
}

}  // namespace

extern "C" int perm_membership_launch(const void* words, const void* idx,
                                      const void* valid, const void* tail,
                                      void* mem, void* g_all, int64_t P,
                                      int64_t K, int64_t W, void* stream) {
  if (P > 0) {
    const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
    perm_membership_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(tail),
        static_cast<uint32_t*>(mem), static_cast<int32_t*>(g_all), P, K, W);
  }
  return int(cudaGetLastError());
}

extern "C" int perm_binary_launch(const void* mem, const void* g_all,
                                  const void* masks, const void* sidx,
                                  int64_t K, int64_t S, int64_t Pmax,
                                  int64_t W, double min_individuals,
                                  double min_haplotypes, double maf_threshold,
                                  void* stat_out, void* df_out, void* bad_out,
                                  void* stream) {
  if (K <= 0 || S <= 0) return int(cudaGetLastError());
  // as many snarls per block as 24 KB of case counts allow, at least one
  const size_t per_warp = size_t(kLanes) * size_t(Pmax) * 4;
  int warps = int(24 * 1024 / (per_warp > 0 ? per_warp : 1));
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  if (warps < 1) warps = 1;
  const size_t smem = size_t(kLanes) * kTileStride * 4 + warps * per_warp;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        perm_binary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t k_blocks = (K + kLanes - 1) / kLanes;
  if (k_blocks > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((S + warps - 1) / warps), unsigned(k_blocks));
  perm_binary_kernel<<<grid, dim3(kLanes, warps), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mem), static_cast<const int32_t*>(g_all),
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(sidx),
      K, S, Pmax, W, min_individuals, min_haplotypes, maf_threshold,
      static_cast<double*>(stat_out), static_cast<double*>(df_out),
      static_cast<uint8_t*>(bad_out));
  return int(cudaGetLastError());
}

extern "C" const char* perm_binary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
