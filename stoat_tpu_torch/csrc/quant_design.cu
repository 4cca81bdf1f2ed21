// K1 + K7 + K8 fused: per-snarl OLS designs straight from the packed words.
//
// Replaces stoat_tpu/pipeline/packed.py membership_words (:281-306) and
// unpack_membership (:325-342), then stoat_tpu/pipeline/quantitative.py
// _design_from_membership (:122-259), as _design_packed_body (:81) chains
// them.  For snarl s, column j (path sidx[s, j], -1 padding), sample n:
//
//   mem_j[w]     = AND_k words[idx[p_j, k], w], bits past H cleared, 0 for
//                  an invalid path
//   count_j(n)   = bits 2n and 2n+1 of mem_j (the sample's dosage, 0-2)
//   allele_j     = popcount of mem_j; kept_j = allele_j > 0
//   row_sum(n)   = sum of count_j(n) over kept j; used(n) = row_sum > 0
//   recip(n)     = 1.0 / row_sum(n) (0 for unused rows)
//   colsum_j     = sum_n count_j(n) * recip(n); maf_j = min(f, 1 - f) with
//                  f = colsum_j / n_used
//   filtered     = kept < 2 | n_used < min_individuals
//                  | n_used < min_haplotypes | #(kept, maf > thr) < 2
//   merge        (kept >= 3) a kept column joins the first kept column
//                  with the same dosages in every sample
//   variant cols the merge representatives but the last, in column order
//   X[s, n, :]   = used(n) ? [1, m_j * count_j(n) * recip(n) for each
//                  variant j (m_j columns merged into it), covariates,
//                  0...] : 0, width PT = 1 + Pmax + C
//   all_rows     (the EMMAX designs of the mixed model, stoat_tpu's
//                  all_rows=True, quantitative.py:238-242) an unused row
//                  keeps its intercept and covariates: [1, 0..., covariates,
//                  0...]; used, ncols, the flags and the counts are as above
//   tables       (the -T table view, quantitative.py:245-258) also
//                  norm[s, n, j] = kept_j ? count_j(n) * recip(n) : 0, over
//                  the unmerged columns, float64 [S, N, Pmax], and kept
//                  [S, Pmax]
//
// Counts, row sums, allele counts and the merge test are exact integer
// work.  ||d_i - d_j||^2 == 0 on the Gram matrix, stoat_tpu's test, holds
// exactly when the 2-bit dosage fields of the two columns agree in every
// word, which is what the kernel compares.  Each X and norm entry is one
// float64 multiply of an integer by the one reciprocal of its row, so both
// equal the plain version (pipeline/quantitative.py) bit for bit.  colsum
// is a float64 sum in a fixed order: the samples in tiles of kRows, in
// order; within a tile, lane l of the column's warp adds the samples l,
// l + 32, ... in order, then a butterfly of shuffles (xor 16, 8, 4, 2, 1)
// sums the 32 lanes, and the tile's sum is added to the column's running
// total.  It feeds only the maf > threshold test.  No atomics.
//
// What bounds it on the card: writing X, S * N * PT * 8 bytes (1.15 GB
// per chunk at S = 8192, N = 2,504, PT = 7; 0.34 ms at 3.35 TB/s), and with
// the table view norm too (S * N * Pmax * 8 bytes, 0.66 GB at Pmax = 4).
// The word gathers are P * K * W * 4 bytes per pass (41 MB at that shape).
//
// Design: one block per snarl.  Each column's membership words, the K-way
// AND of its edge rows, are computed once per (column, word) into a stage
// in shared memory of Pmax x TW words; TW is sized from Pmax (stage_words),
// so that the whole of W fits at the main paths' shapes (Pmax = 4, W = 157)
// and every Pmax the kernel takes fits with TW = 8.  Every later use reads
// that stage: the carrier counts (a warp per column, __reduce_add_sync),
// the merge test (a warp per column, __any_sync), the row sums, the
// dosages of X and norm and the column masses.  When W needs more than one
// word tile, each of the three passes (counts, merges, samples) re-stages
// the tiles in order; the merge test then refines, tile by tile, the
// partition of the kept columns into classes of equal columns, each class
// named by its first member, which ends as the first kept column with the
// same dosages everywhere.  One pass over the samples, in tiles of kRows:
// each thread takes a row (row sum, used, reciprocal into shared memory),
// then each warp sums its columns' masses over the tile, and the block
// writes the tile's rows of X, which form one contiguous block of rows x
// PT doubles, in storage order: each thread computes the two entries of a
// 16-byte pair and stores them with one st.global.v2.f64, so a warp's
// store covers 512 contiguous bytes, whole sectors (a pair cut by the
// block's ends is stored as single doubles).  norm is written the same
// way.  About 2 barriers per sample tile and 7 per snarl besides.  (A
// bulk copy of the tile's rows, built in shared memory, out with one
// cp.async.bulk, took 0.760 ms against these stores' 0.743 at 256
// threads, tools/kernel_ab.py.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 128 threads: 0.693 ms per first `-q -c` chunk on an H100, against 0.743
// at 256 and 0.858 at 512 (tools/kernel_ab.py)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads;         // samples per sample tile
constexpr int kTileWords = kRows / 16;  // a word tile is a whole number of
                                        // sample tiles
constexpr int64_t kStageBytes = 32 * 1024;  // the stage's target size
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t tail_mask(int64_t w, int64_t H) {
  const int64_t lo = w * 32;
  if (lo + 32 <= H) return 0xffffffffu;
  if (lo >= H) return 0u;
  return (1u << unsigned(H - lo)) - 1u;
}

// per 2-bit field: the number of its set bits (a sample's dosage)
__device__ __forceinline__ uint32_t pair_counts(uint32_t m) {
  return (m & 0x55555555u) + ((m >> 1) & 0x55555555u);
}

// the dosage of sample n in its membership word m: bits 2n and 2n+1
__device__ __forceinline__ int dosage_of(uint32_t m, int64_t n) {
  return __popc((m >> (unsigned(n & 15) * 2u)) & 3u);
}

// Words of the stage per column: the target size over Pmax, a whole number
// of sample tiles, at least one and no more than W needs.
__host__ int64_t stage_words(int64_t Pmax, int64_t W) {
  int64_t tw = kStageBytes / (4 * Pmax);
  tw -= tw % kTileWords;
  const int64_t all = (W + kTileWords - 1) / kTileWords * kTileWords;
  if (tw > all) tw = all;
  return tw < kTileWords ? kTileWords : tw;
}

__host__ size_t smem_bytes(int64_t Pmax, int64_t TW) {
  return size_t(Pmax + kRows) * 8 + size_t(Pmax) * TW * 4 +
         size_t(6 * Pmax + 1) * 4 + size_t(Pmax);
}

// out[base + e] = value(e / width, e % width) for 0 <= e < count, by the
// block, in the 16-byte pairs of out (out is 16-byte aligned): each thread
// stores whole pairs with one vector store, the pairs cut by the ends as
// single doubles.  (r, c) follow e without a division per entry.
template <typename Value>
__device__ __forceinline__ void store_block(double* __restrict__ out,
                                            int64_t base, int count,
                                            int width, Value value) {
  const int odd = int(base & 1);
  const int step = 2 * kThreads;
  const int dr = step / width, dc = step % width;
  int e = 2 * int(threadIdx.x) - odd;
  int r, c;
  if (e < 0) {
    r = -1;
    c = width - 1;
  } else {
    r = e / width;
    c = e - r * width;
  }
  for (; e < count; e += step) {
    const int r1 = c + 1 == width ? r + 1 : r;
    const int c1 = c + 1 == width ? 0 : c + 1;
    double* dst = out + base + e;
    if (e >= 0 && e + 1 < count) {
      const double v0 = value(r, c);
      const double v1 = value(r1, c1);
      *reinterpret_cast<double2*>(dst) = make_double2(v0, v1);
    } else if (e >= 0) {
      dst[0] = value(r, c);
    } else {
      dst[1] = value(r1, c1);
    }
    c += dc;
    r += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// kAllRows and kTables: template arguments, so that the OLS designs'
// instantiation is the code without them (an int argument tested per row
// took the parent design from 64 to 56 registers and 2.5% more time on an
// H100, tools/kernel_ab.py)
template <bool kAllRows, bool kTables>
__global__ void __launch_bounds__(kThreads) quant_design_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ path_idx,
    const uint8_t* __restrict__ path_valid, const int32_t* __restrict__ sidx,
    const double* __restrict__ covar, double* __restrict__ X,
    uint8_t* __restrict__ used_out, int32_t* __restrict__ ncols_out,
    uint8_t* __restrict__ filtered_out, uint8_t* __restrict__ degenerate_out,
    int32_t* __restrict__ allele_out, double* __restrict__ norm_out,
    uint8_t* __restrict__ kept_out, int Pmax, int K, int64_t W, int64_t N,
    int C, int TW, double min_individuals, double min_haplotypes,
    double maf_threshold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* colsum = reinterpret_cast<double*>(smem_raw);  // [Pmax]
  double* recip_s = colsum + Pmax;            // [kRows] the tile's 1 / row_sum
  uint32_t* stage = reinterpret_cast<uint32_t*>(recip_s + kRows);  // [Pmax, TW]
  int32_t* col_path = reinterpret_cast<int32_t*>(stage + int64_t(Pmax) * TW);
  int32_t* count = col_path + Pmax;    // carrier haplotypes
  int32_t* cls = count + Pmax;         // merge class (its first member)
  int32_t* ncls = cls + Pmax;          // the class refined by a word tile
  int32_t* col_mult = ncls + Pmax;     // columns merged into a variant one
  int32_t* slot_col = col_mult + Pmax; // [Pmax + 1] X slot -> column
  uint8_t* kept = reinterpret_cast<uint8_t*>(slot_col + Pmax + 1);
  __shared__ int red[kWarps];
  __shared__ int sh_k3, sh_kept_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t s = blockIdx.x;
  const int64_t H = 2 * N;
  const int n_tiles = int((W + TW - 1) / TW);
  for (int j = tid; j < Pmax; j += kThreads) {
    const int32_t p = sidx[s * Pmax + j];
    col_path[j] = (p >= 0 && path_valid[p]) ? p : -1;
    count[j] = 0;
    colsum[j] = 0.0;
  }
  __syncthreads();

  // words of word tile t
  auto tile_words = [&](int t) {
    const int64_t left = W - int64_t(t) * TW;
    return int(left < TW ? left : TW);
  };
  // stage word tile t: stage[j, w] = mem_j[t TW + w]
  auto stage_tile = [&](int t) {
    const int64_t w0 = int64_t(t) * TW;
    const int tw = tile_words(t);
    for (int i = tid; i < Pmax * tw; i += kThreads) {
      const int j = i / tw;
      const int w = i - j * tw;
      const int32_t p = col_path[j];
      uint32_t m = 0u;
      if (p >= 0) {
        const int32_t* rows = path_idx + int64_t(p) * K;
        m = tail_mask(w0 + w, H);
        for (int k = 0; k < K; ++k) {
          m &= __ldg(words + int64_t(__ldg(rows + k)) * W + w0 + w);
        }
      }
      stage[int64_t(j) * TW + w] = m;
    }
  };

  // carrier haplotypes of each column (K1 + K7's popcount)
  for (int t = 0; t < n_tiles; ++t) {
    stage_tile(t);
    __syncthreads();
    const int tw = tile_words(t);
    for (int j = warp; j < Pmax; j += kWarps) {
      int c = 0;
      for (int w = lane; w < tw; w += 32) c += __popc(stage[int64_t(j) * TW + w]);
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) count[j] += c;
    }
    __syncthreads();
  }
  for (int j = tid; j < Pmax; j += kThreads) {
    kept[j] = count[j] > 0;
    allele_out[s * Pmax + j] = count[j];
    if (kTables) kept_out[s * Pmax + j] = count[j] > 0;
    cls[j] = j;
  }
  __syncthreads();
  if (tid == 0) {
    int kc = 0, first = -1;
    for (int j = 0; j < Pmax; ++j) {
      if (!kept[j]) continue;
      ++kc;
      if (first < 0) first = j;
    }
    // with three or more kept columns, they start as one class
    if (kc >= 3) {
      for (int j = 0; j < Pmax; ++j) {
        if (kept[j]) cls[j] = first;
      }
    }
    sh_kept_count = kc;
  }
  __syncthreads();
  const int kept_count = sh_kept_count;

  // identical-column merge: each word tile splits the classes by the
  // tile's dosages; a column's new class is its class's first member with
  // the same dosages in the tile (the column itself at the latest)
  if (kept_count >= 3) {
    for (int t = 0; t < n_tiles; ++t) {
      if (n_tiles > 1) {
        stage_tile(t);
        __syncthreads();
      }
      const int tw = tile_words(t);
      for (int j = warp; j < Pmax; j += kWarps) {
        int rep = cls[j];
        if (kept[j]) {
          rep = j;
          const uint32_t* sj = stage + int64_t(j) * TW;
          for (int i = cls[j]; i < j; ++i) {
            if (!kept[i] || cls[i] != cls[j]) continue;
            const uint32_t* si = stage + int64_t(i) * TW;
            bool differs = false;
            for (int w = lane; w < tw && !differs; w += 32) {
              differs = pair_counts(si[w]) != pair_counts(sj[w]);
            }
            if (!__any_sync(kFull, differs)) {
              rep = i;
              break;
            }
          }
        }
        if (lane == 0) ncls[j] = rep;
      }
      __syncthreads();
      for (int j = tid; j < Pmax; j += kThreads) cls[j] = ncls[j];
      __syncthreads();
    }
  }

  // drop the last representative; the others are the variant columns
  if (tid == 0) {
    int last_rep = -1;
    for (int j = 0; j < Pmax; ++j) col_mult[j] = 0;
    for (int j = 0; j < Pmax; ++j) {
      if (!kept[j]) continue;
      ++col_mult[cls[j]];
      if (cls[j] == j) last_rep = j;
    }
    int k3 = 0;
    for (int j = 0; j < Pmax; ++j) {
      if (kept[j] && cls[j] == j && j != last_rep) slot_col[++k3] = j;
    }
    sh_k3 = k3;
    degenerate_out[s] = last_rep >= 0 && k3 == 0;
    ncols_out[s] = 1 + k3 + C;
  }
  __syncthreads();

  // one pass over the samples: used, the column masses, X (and norm)
  const int k3 = sh_k3;
  const int PT = 1 + Pmax + C;
  int n_used = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (n_tiles > 1) {
      stage_tile(t);
      __syncthreads();
    }
    const int64_t w0 = int64_t(t) * TW;
    const int64_t n_end_t = (w0 + tile_words(t)) * 16;
    const int64_t n_hi = n_end_t < N ? n_end_t : N;
    for (int64_t n0 = w0 * 16; n0 < n_hi; n0 += kRows) {
      const int rows = int(n_hi - n0 < kRows ? n_hi - n0 : kRows);
      // the word of sample n0 + r for column j
      auto word = [&](int j, int r) {
        return stage[int64_t(j) * TW + ((n0 + r) >> 4) - w0];
      };
      if (tid < rows) {
        const int64_t n = n0 + tid;
        int rs = 0;
        for (int j = 0; j < Pmax; ++j) {
          if (kept[j]) rs += dosage_of(word(j, tid), n);
        }
        recip_s[tid] = rs == 0 ? 0.0 : 1.0 / double(rs);
        used_out[s * N + n] = rs > 0;
        n_used += rs > 0;
      }
      __syncthreads();
      for (int j = warp; j < Pmax; j += kWarps) {
        if (!kept[j]) continue;
        double v = 0.0;
        for (int r = lane; r < rows; r += 32) {
          v = v + double(dosage_of(word(j, r), n0 + r)) * recip_s[r];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v = v + __shfl_xor_sync(kFull, v, off);
        }
        if (lane == 0) colsum[j] = colsum[j] + v;
      }
      store_block(X, (s * N + n0) * PT, rows * PT, PT, [&](int r, int c) {
        const double rc = recip_s[r];
        const bool keep = kAllRows || rc != 0.0;
        if (c == 0) return keep ? 1.0 : 0.0;
        if (c <= k3) {
          const int j = slot_col[c];
          return double(col_mult[j] * dosage_of(word(j, r), n0 + r)) * rc;
        }
        if (c <= k3 + C) {
          return keep ? covar[(n0 + r) * C + (c - 1 - k3)] : 0.0;
        }
        return 0.0;
      });
      if (kTables) {
        store_block(norm_out, (s * N + n0) * Pmax, rows * Pmax, Pmax,
                    [&](int r, int j) {
                      return kept[j] ? double(dosage_of(word(j, r), n0 + r)) *
                                           recip_s[r]
                                     : 0.0;
                    });
      }
      __syncthreads();
    }
  }
  n_used = __reduce_add_sync(kFull, n_used);
  if (lane == 0) red[warp] = n_used;
  __syncthreads();

  if (tid == 0) {
    int total_i = 0;
    for (int w = 0; w < kWarps; ++w) total_i += red[w];
    const double total = double(total_i);
    const double safe_total = total == 0.0 ? 1.0 : total;
    int maf_count = 0;
    for (int j = 0; j < Pmax; ++j) {
      if (!kept[j]) continue;
      const double freq = colsum[j] / safe_total;
      const double other = 1.0 - freq;
      maf_count += (freq < other ? freq : other) > maf_threshold;
    }
    filtered_out[s] = kept_count < 2 || total < min_individuals ||
                      total < min_haplotypes || maf_count < 2;
  }
}

template <bool kAllRows, bool kTables>
cudaError_t launch_design(size_t smem, unsigned blocks, cudaStream_t stream,
                          const void* words, const void* path_idx,
                          const void* path_valid, const void* sidx,
                          const void* covar, void* X, void* used, void* ncols,
                          void* filtered, void* degenerate, void* allele_paths,
                          void* norm, void* kept, int Pmax, int K, int64_t W,
                          int64_t N, int C, int TW, double min_individuals,
                          double min_haplotypes, double maf_threshold) {
  auto kernel = quant_design_kernel<kAllRows, kTables>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(path_idx),
      static_cast<const uint8_t*>(path_valid),
      static_cast<const int32_t*>(sidx), static_cast<const double*>(covar),
      static_cast<double*>(X), static_cast<uint8_t*>(used),
      static_cast<int32_t*>(ncols), static_cast<uint8_t*>(filtered),
      static_cast<uint8_t*>(degenerate), static_cast<int32_t*>(allele_paths),
      static_cast<double*>(norm), static_cast<uint8_t*>(kept), Pmax, K, W, N,
      C, TW, min_individuals, min_haplotypes, maf_threshold);
  return cudaGetLastError();
}

}  // namespace

extern "C" int quant_design_launch(
    const void* words, const void* path_idx, const void* path_valid,
    const void* sidx, const void* covar, void* X, void* used, void* ncols,
    void* filtered, void* degenerate, void* allele_paths, void* norm,
    void* kept, int64_t S, int64_t Pmax, int64_t K, int64_t W, int64_t N,
    int64_t C, int64_t H, int64_t all_rows, double min_individuals,
    double min_haplotypes, double maf_threshold, void* stream) {
  if (Pmax < 1 || K < 1 || H != 2 * N ||
      (norm == nullptr) != (kept == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t TW = stage_words(Pmax, W);
  const size_t smem = smem_bytes(Pmax, TW);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (S == 0) return int(cudaGetLastError());
  // the table view when given its outputs
  auto launch = norm != nullptr
                    ? (all_rows ? launch_design<true, true>
                                : launch_design<false, true>)
                    : (all_rows ? launch_design<true, false>
                                : launch_design<false, false>);
  return int(launch(smem, unsigned(S), static_cast<cudaStream_t>(stream),
                    words, path_idx, path_valid, sidx, covar, X, used, ncols,
                    filtered, degenerate, allele_paths, norm, kept, int(Pmax),
                    int(K), W, N, int(C), int(TW), min_individuals,
                    min_haplotypes, maf_threshold));
}

extern "C" const char* quant_design_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
