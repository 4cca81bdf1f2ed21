// K1+K2: fused per-path gather-AND membership and popcount carrier counts.
//
// Replaces stoat_tpu/pipeline/packed.py membership_words (:294, body :281)
// followed by packed_binary_counts (:310).  For every flat path p:
//
//   mem[w]  = tail[w] & AND_k words[idx[p, k], w]      (w < W)
//   g_all   = sum_w popcount(mem[w])         (0 when path_valid[p] is 0)
//   g1      = sum_w popcount(mem[w] & g1_words[w])
//   g0_out  = double(g_all - g1),  g1_out = double(g1)
//
// Padding entries of idx point at row E, the all-ones AND identity, so a
// valid path with no edges matches every haplotype (vacuous AND).
//
// What bounds it on the card: memory.  It gathers P*K*W*4 bytes of word
// rows (plus P*K*4 bytes of indices) and does one AND and two popcounts
// per gathered word.  At the main path's chunk shape (P = 32768 paths,
// K = 2, W = 157 words for 2,504 samples) that is about 41 MB per chunk,
// 12 us at the H100's 3.35 TB/s.
// The JAX program materialises the [P, W] membership in device memory and
// reads it back for the counts; this kernel keeps it in registers, so the
// only bytes written are the 16 bytes of counts per path.
//
// Design: one warp per path, kWarpsPerBlock paths per block, on
// membership_counts_device.cuh's count_paths (binary_stats.cu's
// binary_from_words runs the same function inside the table launch, which
// is the main path's since it came; this launch is kept to time and check
// the count alone).  The lanes stride over W, so the 32 lanes of a warp
// read 128 contiguous bytes of each gathered row; each lane issues its
// words of two rows before the first AND.  Invalid paths gather nothing.
// (Staging tail and g1_words in shared memory a block, as the fused
// kernel does, made this kernel no faster on the card: PERF.md section 6.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "membership_counts_device.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void membership_counts_kernel(
    const uint32_t* __restrict__ words,   // [E+1, W]
    const int32_t* __restrict__ idx,      // [P, K]
    const uint8_t* __restrict__ valid,    // [P]
    const uint32_t* __restrict__ tail,    // [W]
    const uint32_t* __restrict__ g1_words,  // [W]
    double* __restrict__ g0_out,          // [P]
    double* __restrict__ g1_out,          // [P]
    int64_t P, int64_t K, int64_t W) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // uniform across the warp: p depends on the warp only
  const int32_t* rows[1] = {valid[p] ? idx + p * K : nullptr};
  unsigned n_all[1], n_case[1];
  stoat::count_paths<1>(words, rows, K, W, tail, g1_words, lane, n_all,
                        n_case);
  if (lane == 0) {
    g0_out[p] = double(n_all[0] - n_case[0]);
    g1_out[p] = double(n_case[0]);
  }
}

}  // namespace

extern "C" int membership_counts_launch(
    const void* words, const void* idx, const void* valid, const void* tail,
    const void* g1_words, void* g0_out, void* g1_out, int64_t P, int64_t K,
    int64_t W, void* stream) {
  if (P > 0) {
    const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
    membership_counts_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(tail),
        static_cast<const uint32_t*>(g1_words), static_cast<double*>(g0_out),
        static_cast<double*>(g1_out), P, K, W);
  }
  return int(cudaGetLastError());
}

extern "C" const char* membership_counts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
