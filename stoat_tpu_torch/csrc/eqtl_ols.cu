// K13: masked OLS of (snarl, gene) pairs for the eQTL mode, one block per
// snarl.
//
// Replaces stoat_tpu/pipeline/quantitative.py eqtl_regress_pairs (:599-623)
// up to its Student-t tail.  The JAX program gathers X[pair_snarl] into
// [B, N, PT] and runs stoat_tpu/stats/linreg.py linear_regression_batch
// (:212; linear_regression_stats_batch :141, _ols_unrolled_body :47) on
// y = expr[gene] * used, so every pair rebuilds its snarl's X^T X.  A
// snarl's X and its inverse do not depend on the gene: here the pairs come
// as CSR by snarl (pair_off [S + 1], pair_gene [B], in the (snarl, gene)
// order of the host's loop) and, per snarl s with pairs b in
// pair_off[s] .. pair_off[s + 1]:
//
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   inv    = A^-1 by LDL^T, or the Jacobi pseudo-inverse when a real pivot
//            is below 1e-10 or not finite (ols_device.cuh, as ols.cu and
//            perm_ols.cu): once per snarl
//   for each pair b, gene g = pair_gene[b], y = expr[g] * used:
//            beta = inv X^T y;  mean = (sum of y over the used rows) / n_used
//            rss, tss = sums over the used rows of (y - X beta)^2 and
//            (y - mean)^2;  df_res = max(n_used - ncols + 1, 1)
//            out[b] = (beta_1 / se_1, df_res, beta_1,
//                      se_1 = sqrt(inv_11 rss / df_res), 1 - rss / tss)
//
// The Student-t tail and the NA of degenerate snarls follow in
// student_t.cu over [B] (pipeline/quantitative.py eqtl_regress_pairs).
// Every sum has a fixed order and no atomics; sums over the rows run in
// another order than the plain version's, which the comparison on the card
// bounds by a relative tolerance.
//
// What bounds it on the card: memory.  Each input read once and each output
// written once is X (S * N * PT * 8 bytes, 1.15 GB per chunk at S = 8,192,
// N = 2,504, PT = 7), the [G, N] expression rows and 40 bytes per pair:
// 0.35 ms at 3.35 TB/s; its float64 work, about (4 PT + 4) N per pair
// (7.2e9 at 90,000 pairs), is 0.1 ms at 67 TFLOP/s.  As written it streams
// a snarl's X 1 + 2 ceil(g_s / 32) times for its g_s genes (3.5 GB per chunk
// at about 11 genes per snarl; the repeats mostly from L2) and each pair's
// expression row twice from L2 (the [G, N] rows of a chromosome are small).
// Design: pass 1 streams X through shared memory in tiles of rows and sums
// X^T X as perm_ols.cu does; thread 0 factors and inverts.  Then the block
// takes its genes 32 at a time: pass A streams X and the 32 y rows for
// X^T y and the masked sum of y (each thread owns (gene, column) entries
// and adds each tile's rows in order), beta and the mean follow, and pass B
// streams them again for rss and tss (thread (gene, g) takes every 4th row
// from g; the four partial sums are added in g order).  A block whose
// snarl has no pair (filtered snarls, padding) leaves at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "ols_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGenes = 32;                    // genes per pass over X
constexpr int kGroups = kThreads / kGenes;    // row groups of pass B
constexpr int kMaxTileRows = 128;
constexpr size_t kBudget = 44 * 1024;         // shared memory aimed at
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void eqtl_ols_kernel(const double* __restrict__ X,
                                const uint8_t* __restrict__ mask,
                                const int32_t* __restrict__ ncols,
                                const int32_t* __restrict__ pair_off,
                                const int32_t* __restrict__ pair_gene,
                                const double* __restrict__ expr,
                                double* __restrict__ work,
                                double* __restrict__ t1_out,
                                double* __restrict__ df_out,
                                double* __restrict__ beta1_out,
                                double* __restrict__ se1_out,
                                double* __restrict__ r2_out, int64_t N,
                                int P, int TR) {
  const int64_t s = blockIdx.x;
  const int64_t first = pair_off[s];
  const int64_t n_pairs = pair_off[s + 1] - first;
  if (n_pairs <= 0) return;

  extern __shared__ double smem[];
  double* xs = smem;                          // [TR * P]
  double* ys = xs + TR * P;                   // [kGenes * TR]
  double* xty = ys + kGenes * TR;             // [kGenes * (P + 1)]: X^T y, sum y
  double* beta = xty + kGenes * (P + 1);      // [kGenes * P]
  double* mean = beta + kGenes * P;           // [kGenes]
  double* red = mean + kGenes;                // [2 * kThreads]
  int32_t* genes = reinterpret_cast<int32_t*>(red + 2 * kThreads);  // [kGenes]
  uint8_t* ms = reinterpret_cast<uint8_t*>(genes + kGenes);        // [TR]

  const int tid = threadIdx.x;
  const double* Xs = X + s * N * P;
  const uint8_t* msrc = mask + s * N;
  double* A = work + s * (4 * P * P + 2 * P + 1);
  double* L = A + P * P;
  double* inv = L + P * P;
  double* V = inv + P * P;
  double* D = V + P * P;
  double* col = D + P;
  double* n_used_g = col + P;

  auto load_tile = [&](int64_t n0, int rows, int nk) {
    for (int e = tid; e < rows * P; e += kThreads) xs[e] = Xs[n0 * P + e];
    for (int r = tid; r < rows; r += kThreads) ms[r] = msrc[n0 + r];
    for (int e = tid; e < nk * rows; e += kThreads) {
      const int kk = e / rows;
      const int r = e % rows;
      ys[kk * TR + r] = expr[int64_t(genes[kk]) * N + n0 + r] *
                        (msrc[n0 + r] ? 1.0 : 0.0);
    }
  };

  // pass 1: the upper triangle of X^T X and the number of used rows
  const int npairs = P * (P + 1) / 2;
  for (int q = tid; q <= npairs; q += kThreads) {
    if (q < npairs) {
      int i = 0, r = q;
      while (r >= P - i) {
        r -= P - i;
        ++i;
      }
      A[i * P + i + r] = 0.0;
    } else {
      n_used_g[0] = 0.0;
    }
  }
  __syncthreads();
  for (int64_t n0 = 0; n0 < N; n0 += TR) {
    const int rows = int(N - n0 < TR ? N - n0 : TR);
    load_tile(n0, rows, 0);
    __syncthreads();
    for (int q = tid; q <= npairs; q += kThreads) {
      double acc = 0.0;
      if (q < npairs) {
        int i = 0, j = q;
        while (j >= P - i) {
          j -= P - i;
          ++i;
        }
        j += i;
        for (int r = 0; r < rows; ++r) {
          acc = acc + xs[r * P + i] * xs[r * P + j];
        }
        A[i * P + j] += acc;
      } else {
        for (int r = 0; r < rows; ++r) acc = acc + (ms[r] ? 1.0 : 0.0);
        n_used_g[0] += acc;
      }
    }
    __syncthreads();
  }
  const int nc = ncols[s];
  if (tid == 0) {
    for (int i = 0; i < P; ++i) {
      A[i * P + i] = A[i * P + i] + (i < nc ? 0.0 : 1.0);
      for (int j = i + 1; j < P; ++j) A[j * P + i] = A[i * P + j];
    }
    stoat::normal_inverse(A, L, inv, V, D, col, P, nc);
  }
  __syncthreads();
  const double n_used = n_used_g[0];
  const double n_safe = n_used == 0.0 ? 1.0 : n_used;
  const double df = (n_used - double(nc)) + 1.0;
  const double df_res = df > 1.0 ? df : 1.0;
  const int width = P + 1;

  for (int64_t k0 = 0; k0 < n_pairs; k0 += kGenes) {
    const int nk = int(n_pairs - k0 < kGenes ? n_pairs - k0 : kGenes);
    for (int q = tid; q < nk * width; q += kThreads) xty[q] = 0.0;
    if (tid < nk) genes[tid] = pair_gene[first + k0 + tid];
    __syncthreads();
    // pass A: X^T y and the masked sum of y per gene
    for (int64_t n0 = 0; n0 < N; n0 += TR) {
      const int rows = int(N - n0 < TR ? N - n0 : TR);
      load_tile(n0, rows, nk);
      __syncthreads();
      for (int q = tid; q < nk * width; q += kThreads) {
        const double* yk = ys + (q / width) * TR;
        const int j = q % width;
        double acc = 0.0;
        if (j < P) {
          for (int r = 0; r < rows; ++r) acc = acc + xs[r * P + j] * yk[r];
        } else {
          for (int r = 0; r < rows; ++r) acc = acc + (ms[r] ? yk[r] : 0.0);
        }
        xty[q] += acc;
      }
      __syncthreads();
    }
    for (int q = tid; q < nk; q += kThreads) {
      stoat::apply_inverse(inv, xty + q * width, beta + q * P, P);
      mean[q] = xty[q * width + P] / n_safe;
    }
    __syncthreads();

    // pass B: the residual and total sums of squares over the used rows
    const int kk = tid % kGenes;
    const int g = tid / kGenes;
    const double* bk = beta + kk * P;
    double rss = 0.0, tss = 0.0;
    for (int64_t n0 = 0; n0 < N; n0 += TR) {
      const int rows = int(N - n0 < TR ? N - n0 : TR);
      load_tile(n0, rows, nk);
      __syncthreads();
      if (kk < nk) {
        const double* yk = ys + kk * TR;
        const double mk = mean[kk];
        for (int r = g; r < rows; r += kGroups) {
          double pred = xs[r * P] * bk[0];
          for (int t = 1; t < P; ++t) pred = pred + xs[r * P + t] * bk[t];
          const double resid = ms[r] ? yk[r] - pred : 0.0;
          rss = rss + resid * resid;
          const double dev = yk[r] - mk;
          tss = tss + (ms[r] ? dev * dev : 0.0);
        }
      }
      __syncthreads();
    }
    red[tid] = rss;
    red[kThreads + tid] = tss;
    __syncthreads();
    if (tid < nk) {
      double r_sum = 0.0, t_sum = 0.0;
      for (int gg = 0; gg < kGroups; ++gg) {
        r_sum += red[gg * kGenes + tid];
        t_sum += red[kThreads + gg * kGenes + tid];
      }
      const double mse = r_sum / df_res;
      const double beta1 = beta[tid * P + 1];
      const double se1 = sqrt(inv[1 * P + 1] * mse);
      const int64_t b = first + k0 + tid;
      t1_out[b] = beta1 / se1;
      df_out[b] = df_res;
      beta1_out[b] = beta1;
      se1_out[b] = se1;
      r2_out[b] = 1.0 - r_sum / t_sum;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int eqtl_ols_launch(const void* X, const void* mask,
                               const void* ncols, const void* pair_off,
                               const void* pair_gene, const void* expr,
                               void* work, void* t1_out, void* df_out,
                               void* beta1_out, void* se1_out, void* r2_out,
                               int64_t S, int64_t N, int64_t P,
                               void* stream) {
  if (P < 2) return int(cudaErrorInvalidValue);  // beta1 needs a column 1
  if (S <= 0) return int(cudaGetLastError());
  const size_t fixed = (kGenes * size_t(2 * P + 2) + 2 * kThreads) * 8 +
                       kGenes * sizeof(int32_t);
  const size_t per_row = (size_t(P) + kGenes) * 8 + 1;
  int TR = kMaxTileRows;
  if (fixed + TR * per_row > kBudget) {
    TR = fixed < kBudget ? int((kBudget - fixed) / per_row) : 0;
    if (TR < 16) TR = 16;
  }
  const size_t smem = fixed + size_t(TR) * per_row;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eqtl_ols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  eqtl_ols_kernel<<<unsigned(S), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols),
      static_cast<const int32_t*>(pair_off),
      static_cast<const int32_t*>(pair_gene),
      static_cast<const double*>(expr), static_cast<double*>(work),
      static_cast<double*>(t1_out), static_cast<double*>(df_out),
      static_cast<double*>(beta1_out), static_cast<double*>(se1_out),
      static_cast<double*>(r2_out), N, int(P), TR);
  return int(cudaGetLastError());
}

extern "C" const char* eqtl_ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
