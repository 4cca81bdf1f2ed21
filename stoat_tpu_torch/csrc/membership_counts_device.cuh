// K1+K2's count of one path, or of a few paths at once, on one warp:
// the device function that membership_counts.cu (the standalone count)
// and binary_stats.cu's binary_from_words (the count inside the table
// launch, the main path's) run.
//
// For a path whose rows (its K edge-row indices) are rows[0..K):
//
//   mem[w]  = tail[w] & AND_k words[rows[k], w]      (w < W)
//   n_all   = sum_w popcount(mem[w])
//   n_case  = sum_w popcount(mem[w] & g1_words[w])
//
// which is stoat_tpu/pipeline/packed.py membership_words (:294) followed
// by packed_binary_counts (:310) for that path.  A path given no rows
// (nullptr: an invalid path, or a padding slot) counts 0 and gathers
// nothing.
//
// What bounds it on the card: the gathered words (K x W x 4 bytes a path,
// 1,256 at the first vcf -b chunk's K = 2, W = 157) are the only bytes
// that matter, and a word is a dependent load: its address needs the row
// index.  The parent kernel loaded row index, word, AND and popcount one
// word after another, so a lane held at most K loads in flight.  Here a
// lane loads its words of kCountRows rows of kPaths paths at once (lanes
// over W, kCountWords words a lane a batch: one batch up to W = 256, the
// first chunk's 157 in 5), and only then ANDs them: up to kPaths x
// kCountRows x kCountWords loads in flight a lane.  On the card that alone
// moved the standalone count by 1-17% (PERF.md section 6): at 64 warps an
// SM the parent already had most of the bytes in flight that the memory
// needs; the count runs at about half its gathered words' rate.  The
// row indices come
// from wherever the caller keeps them, and so do tail and g1_words
// (binary_from_words stages all three in shared memory with its tile's
// entries; the standalone kernel reads them from global memory).  The
// popcounts finish with one butterfly of shuffles, so every lane holds the
// path's totals.

#pragma once

#include <cstdint>

namespace stoat {

constexpr int kCountWords = 8;  // words a lane a batch: W <= 256 in one
constexpr int kCountRows = 2;   // rows a batch (the main path's K = 2)

// On one warp, every lane calling: the counts of kPaths paths, rows[g]
// the K row indices of path g or nullptr for a path that counts 0.
// ``words`` is [rows, W]; ``tail`` and ``g1_words`` [W].
template <int kPaths>
__device__ inline void count_paths(const uint32_t* __restrict__ words,
                                   const int32_t* const (&rows)[kPaths],
                                   int64_t K, int64_t W,
                                   const uint32_t* tail,
                                   const uint32_t* g1_words, int lane,
                                   unsigned (&n_all)[kPaths],
                                   unsigned (&n_case)[kPaths]) {
#pragma unroll
  for (int g = 0; g < kPaths; ++g) {
    n_all[g] = 0;
    n_case[g] = 0;
  }
  for (int64_t w0 = 0; w0 < W; w0 += 32 * kCountWords) {
    uint32_t m[kPaths][kCountWords];
#pragma unroll
    for (int g = 0; g < kPaths; ++g) {
#pragma unroll
      for (int u = 0; u < kCountWords; ++u) {
        const int64_t w = w0 + lane + 32 * u;
        m[g][u] = rows[g] != nullptr && w < W ? tail[w] : 0u;
      }
    }
    for (int64_t k0 = 0; k0 < K; k0 += kCountRows) {
      // every load of the batch first, then the ANDs
      uint32_t v[kPaths][kCountRows][kCountWords];
#pragma unroll
      for (int g = 0; g < kPaths; ++g) {
#pragma unroll
        for (int j = 0; j < kCountRows; ++j) {
          const bool row_on = rows[g] != nullptr && k0 + j < K;
          const uint32_t* row =
              words + (row_on ? int64_t(rows[g][k0 + j]) * W : 0);
#pragma unroll
          for (int u = 0; u < kCountWords; ++u) {
            const int64_t w = w0 + lane + 32 * u;
            v[g][j][u] = row_on && w < W ? row[w] : ~0u;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kPaths; ++g) {
#pragma unroll
        for (int j = 0; j < kCountRows; ++j) {
#pragma unroll
          for (int u = 0; u < kCountWords; ++u) m[g][u] &= v[g][j][u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCountWords; ++u) {
      const int64_t w = w0 + lane + 32 * u;
      const uint32_t case_mask = w < W ? g1_words[w] : 0u;
#pragma unroll
      for (int g = 0; g < kPaths; ++g) {
        n_all[g] += __popc(m[g][u]);
        n_case[g] += __popc(m[g][u] & case_mask);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < kPaths; ++g) {
      n_all[g] += __shfl_xor_sync(0xffffffffu, n_all[g], off);
      n_case[g] += __shfl_xor_sync(0xffffffffu, n_case[g], off);
    }
  }
}

}  // namespace stoat
