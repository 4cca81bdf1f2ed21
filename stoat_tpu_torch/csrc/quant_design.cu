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
// equal the plain version (pipeline/quantitative.py) bit for bit.  colsum is a
// float64 sum in a fixed order (each thread's samples in order, then a
// fixed tree); it feeds only the maf > threshold test.  No atomics.
//
// What bounds it on the card: writing X, S * N * PT * 8 bytes (1.15 GB
// per chunk at S = 8192, N = 2,504, PT = 7; 0.34 ms at 3.35 TB/s), and with
// the table view norm too (S * N * Pmax * 8 bytes, 0.66 GB at Pmax = 4).  The
// word gathers are P * K * W * 4 bytes per pass (41 MB at that shape) and
// stay in L1/L2: the kernel re-derives a column's membership words from
// the edge rows whenever it needs them instead of writing the [P, W] or
// [P, H] membership, which the JAX program materialises.  Design: one
// block per snarl; threads stride over words for the per-column counts
// and merge tests (block reductions), and over samples for the column
// masses and the rows of X, which each thread writes whole.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColGroup = 8;  // column masses accumulated per sample pass

__device__ __forceinline__ uint32_t tail_mask(int64_t w, int64_t H) {
  const int64_t lo = w * 32;
  if (lo + 32 <= H) return 0xffffffffu;
  if (lo >= H) return 0u;
  return (1u << unsigned(H - lo)) - 1u;
}

struct Words {
  const uint32_t* words;  // [E+1, W]
  const int32_t* idx;     // [P, K]
  int64_t K, W, H;

  // membership word w of path p (valid), bits past H cleared
  __device__ __forceinline__ uint32_t mem(int32_t p, int64_t w) const {
    const int32_t* rows = idx + int64_t(p) * K;
    uint32_t m = tail_mask(w, H);
    for (int64_t k = 0; k < K; ++k) {
      m &= __ldg(words + int64_t(rows[k]) * W + w);
    }
    return m;
  }

  // dosage of sample n on path p: bits 2n and 2n+1
  __device__ __forceinline__ int dosage(int32_t p, int64_t n) const {
    const uint32_t m = mem(p, n >> 4);
    const unsigned b = unsigned(n & 15) * 2u;
    return int((m >> b) & 1u) + int((m >> (b + 1u)) & 1u);
  }
};

// per 2-bit field: the number of its set bits (a sample's dosage)
__device__ __forceinline__ uint32_t pair_counts(uint32_t m) {
  return (m & 0x55555555u) + ((m >> 1) & 0x55555555u);
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const T total = red[0];
  __syncthreads();
  return total;
}

// kAllRows and kTables: template arguments, so that the OLS designs'
// instantiation is the code without them (an int argument tested per row
// took the kernel from 64 to 56 registers and 2.5% more time on an H100,
// tools/kernel_ab.py)
template <bool kAllRows, bool kTables>
__global__ void quant_design_kernel(
    Words wd, const uint8_t* __restrict__ path_valid,
    const int32_t* __restrict__ sidx, const double* __restrict__ covar,
    double* __restrict__ X, uint8_t* __restrict__ used_out,
    int32_t* __restrict__ ncols_out, uint8_t* __restrict__ filtered_out,
    uint8_t* __restrict__ degenerate_out, int32_t* __restrict__ allele_out,
    double* __restrict__ norm_out, uint8_t* __restrict__ kept_out,
    int Pmax, int64_t N, int C, double min_individuals,
    double min_haplotypes, double maf_threshold) {
  extern __shared__ double dyn[];
  double* colsum = dyn;                                      // [Pmax]
  int32_t* col_path = reinterpret_cast<int32_t*>(colsum + Pmax);
  int32_t* col_rep = col_path + Pmax;   // merge representative, or Pmax+1
  int32_t* col_slot = col_rep + Pmax;   // X slot of a variant column, or 0
  int32_t* col_mult = col_slot + Pmax;  // columns merged into a variant one
  uint8_t* kept = reinterpret_cast<uint8_t*>(col_mult + Pmax);
  __shared__ double red_f[kThreads];
  __shared__ long long red_i[kThreads];
  __shared__ int sh_k3;

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const int64_t W = wd.W;
  const int32_t* srow = sidx + s * Pmax;
  for (int j = tid; j < Pmax; j += kThreads) {
    const int32_t p = srow[j];
    col_path[j] = (p >= 0 && path_valid[p]) ? p : -1;
  }
  __syncthreads();

  // carrier haplotypes of each column (K1 + K7's popcount)
  for (int j = 0; j < Pmax; ++j) {
    const int32_t p = col_path[j];
    long long cnt = 0;
    if (p >= 0) {
      for (int64_t w = tid; w < W; w += kThreads) cnt += __popc(wd.mem(p, w));
    }
    cnt = block_sum(cnt, red_i);
    if (tid == 0) {
      allele_out[s * Pmax + j] = int32_t(cnt);
      kept[j] = cnt > 0;
      if (kTables) kept_out[s * Pmax + j] = cnt > 0;
    }
  }
  __syncthreads();
  int kept_count = 0;
  for (int j = 0; j < Pmax; ++j) kept_count += kept[j];

  // identical-column merge, only with three or more kept columns
  const int big = Pmax + 1;
  for (int j = 0; j < Pmax; ++j) {
    int rep = kept[j] ? j : big;
    if (kept[j] && kept_count >= 3) {
      for (int i = 0; i < j; ++i) {
        if (!kept[i]) continue;
        bool differs = false;
        for (int64_t w = tid; w < W && !differs; w += kThreads) {
          differs = pair_counts(wd.mem(col_path[i], w)) !=
                    pair_counts(wd.mem(col_path[j], w));
        }
        if (!__syncthreads_or(differs)) {
          rep = i;
          break;
        }
      }
    }
    if (tid == 0) col_rep[j] = rep;
  }
  __syncthreads();

  // drop the last representative; the others are the variant columns
  if (tid == 0) {
    int last_rep = -1;
    for (int j = 0; j < Pmax; ++j) {
      if (kept[j] && col_rep[j] == j) last_rep = j;
    }
    int k3 = 0;
    for (int j = 0; j < Pmax; ++j) {
      const bool var = kept[j] && col_rep[j] == j && j != last_rep;
      col_slot[j] = var ? ++k3 : 0;
      int mult = 0;
      for (int i = 0; var && i < Pmax; ++i) mult += col_rep[i] == j;
      col_mult[j] = mult;
    }
    sh_k3 = k3;
    degenerate_out[s] = last_rep >= 0 && k3 == 0;
    ncols_out[s] = 1 + k3 + C;
  }
  __syncthreads();

  // column masses sum_n count_j(n) / row_sum(n), kColGroup columns a pass
  for (int j0 = 0; j0 < Pmax; j0 += kColGroup) {
    double acc[kColGroup];
#pragma unroll
    for (int g = 0; g < kColGroup; ++g) acc[g] = 0.0;
    for (int64_t n = tid; n < N; n += kThreads) {
      int rs = 0;
      for (int j = 0; j < Pmax; ++j) {
        if (kept[j]) rs += wd.dosage(col_path[j], n);
      }
      const double recip = rs == 0 ? 0.0 : 1.0 / double(rs);
#pragma unroll
      for (int g = 0; g < kColGroup; ++g) {
        const int j = j0 + g;
        if (j < Pmax && kept[j]) {
          acc[g] = acc[g] + double(wd.dosage(col_path[j], n)) * recip;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kColGroup; ++g) {
      const double total = block_sum(acc[g], red_f);
      if (tid == 0 && j0 + g < Pmax) colsum[j0 + g] = total;
    }
  }

  // the rows of X, and the used-row mask
  const int k3 = sh_k3;
  const int64_t PT = 1 + Pmax + C;
  long long n_used_part = 0;
  for (int64_t n = tid; n < N; n += kThreads) {
    int rs = 0;
    for (int j = 0; j < Pmax; ++j) {
      if (kept[j]) rs += wd.dosage(col_path[j], n);
    }
    const bool used = rs > 0;
    const double recip = rs == 0 ? 0.0 : 1.0 / double(rs);
    used_out[s * N + n] = used;
    n_used_part += used;
    const bool keep = kAllRows || used;
    double* row = X + (s * N + n) * PT;
    row[0] = keep ? 1.0 : 0.0;
    for (int j = 0; j < Pmax; ++j) {
      const int slot = col_slot[j];
      if (slot) {
        const int merged = col_mult[j] * wd.dosage(col_path[j], n);
        row[slot] = used ? double(merged) * recip : 0.0;
      }
    }
    for (int c = 0; c < C; ++c) {
      row[1 + k3 + c] = keep ? covar[n * C + c] : 0.0;
    }
    for (int64_t t = 1 + k3 + C; t < PT; ++t) row[t] = 0.0;
    if (kTables) {
      double* nrow = norm_out + (s * N + n) * Pmax;
      for (int j = 0; j < Pmax; ++j) {
        nrow[j] = kept[j] ? double(wd.dosage(col_path[j], n)) * recip : 0.0;
      }
    }
  }
  const long long n_used = block_sum(n_used_part, red_i);

  if (tid == 0) {
    const double total = double(n_used);
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

}  // namespace

extern "C" int quant_design_launch(
    const void* words, const void* path_idx, const void* path_valid,
    const void* sidx, const void* covar, void* X, void* used, void* ncols,
    void* filtered, void* degenerate, void* allele_paths, void* norm,
    void* kept, int64_t S, int64_t Pmax, int64_t K, int64_t W, int64_t N,
    int64_t C, int64_t H, int64_t all_rows, double min_individuals,
    double min_haplotypes, double maf_threshold, void* stream) {
  const size_t smem = size_t(Pmax) * (sizeof(double) + 4 * sizeof(int32_t) +
                                      sizeof(uint8_t));
  if (Pmax < 1 || K < 1 || smem > 48 * 1024 || H != 2 * N ||
      (norm == nullptr) != (kept == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (S > 0) {
    const Words wd{static_cast<const uint32_t*>(words),
                   static_cast<const int32_t*>(path_idx), K, W, H};
    // the table view when given its outputs
    auto kernel = norm != nullptr
                      ? (all_rows ? quant_design_kernel<true, true>
                                  : quant_design_kernel<false, true>)
                      : (all_rows ? quant_design_kernel<true, false>
                                  : quant_design_kernel<false, false>);
    kernel<<<unsigned(S), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wd, static_cast<const uint8_t*>(path_valid),
        static_cast<const int32_t*>(sidx), static_cast<const double*>(covar),
        static_cast<double*>(X), static_cast<uint8_t*>(used),
        static_cast<int32_t*>(ncols), static_cast<uint8_t*>(filtered),
        static_cast<uint8_t*>(degenerate),
        static_cast<int32_t*>(allele_paths), static_cast<double*>(norm),
        static_cast<uint8_t*>(kept), int(Pmax), N, int(C),
        min_individuals, min_haplotypes, maf_threshold);
  }
  return int(cudaGetLastError());
}

extern "C" const char* quant_design_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
