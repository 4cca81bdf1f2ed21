// K16a: masked OLS t statistics of K phenotypes against each snarl's one
// design, for the quantitative permutation test.
//
// Replaces stoat_tpu/pipeline/permutation.py _perm_quant_pvalues (:103-118)
// up to its Student-t tail: for each phenotype row k, y = phenos[k] * used
// and the statistics of stoat_tpu/stats/linreg.py
// linear_regression_stats_batch (:47-137, :141-202).  X does not depend on
// the phenotype, so per snarl s:
//
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   inv    = A^-1 by LDL^T, or the Jacobi pseudo-inverse when a real pivot
//            is below 1e-10 or not finite (ols_device.cuh, as ols.cu):
//            once per snarl
//   for each k:  beta = inv X^T y;  rss over the used rows;
//            df_res = max(n_used - ncols + 1, 1);
//            t1[k, s] = beta_1 / sqrt(inv_11 rss / df_res),  df[k, s] = df_res
//
// The Student-t tail (student_t.cu) and the +inf of filtered and
// degenerate snarls follow (pipeline/permutation.py).
//
// What bounds it on the card: float64 operations.  Per (k, s) it reads
// each used row's P values twice (X^T y, then the residual), about 4 N P
// flops: 5.7e11 per chunk at K = 1,001, S = 8,192, N = 2,504, P = 7, 8.5 ms
// at the card's 67 TFLOP/s float64 (tensor-core) peak, 17 ms at its
// 34 TFLOP/s vector float64 rate, which is what this kernel's scalar code
// can reach.  Its bytes are X once (1.15 GB, 0.34 ms at 3.35 TB/s), the
// K x N phenotypes and 16 bytes per (k, s).
// Design: one block per snarl.  Pass 1 streams X through shared memory in
// tiles of rows and sums X^T X as ols.cu does; thread 0 factors and
// inverts.  Then the block takes the phenotypes 32 at a time: pass A
// streams X and the 32 y rows once for X^T y (each thread owns (k, j)
// entries and adds each tile's rows in order), beta follows, and pass B
// streams them again for rss (thread (k, g) takes every 4th row from g;
// the four partial sums are added in g order); r2, and so tss, is not
// needed here.  A snarl's X (140 KB at N = 2,504, P = 7) is streamed
// 1 + 2 ceil(K / 32) times, the repeats from L2 where it stays there.  No
// atomics: every sum has a fixed order.
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
constexpr int kPerms = 32;                    // phenotypes per pass over X
constexpr int kGroups = kThreads / kPerms;    // row groups of pass B
constexpr int kMaxTileRows = 128;
constexpr size_t kBudget = 44 * 1024;         // shared memory aimed at
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void perm_ols_kernel(const double* __restrict__ X,
                                const uint8_t* __restrict__ mask,
                                const int32_t* __restrict__ ncols,
                                const double* __restrict__ phenos,
                                double* __restrict__ work,
                                double* __restrict__ t1_out,
                                double* __restrict__ df_out, int64_t N,
                                int P, int64_t K, int64_t S, int TR) {
  extern __shared__ double smem[];
  double* xs = smem;                          // [TR * P]
  double* ys = xs + TR * P;                   // [kPerms * TR]
  double* xty = ys + kPerms * TR;             // [kPerms * P]
  double* beta = xty + kPerms * P;            // [kPerms * P]
  double* red = beta + kPerms * P;            // [kThreads]
  uint8_t* ms = reinterpret_cast<uint8_t*>(red + kThreads);  // [TR]

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const double* Xs = X + s * N * P;
  const uint8_t* msrc = mask + s * N;
  double* A = work + s * (4 * P * P + 2 * P + 1);
  double* L = A + P * P;
  double* inv = L + P * P;
  double* V = inv + P * P;
  double* D = V + P * P;
  double* col = D + P;
  double* n_used_g = col + P;

  auto load_tile = [&](int64_t n0, int rows, int64_t k0, int nk) {
    for (int e = tid; e < rows * P; e += kThreads) xs[e] = Xs[n0 * P + e];
    for (int r = tid; r < rows; r += kThreads) ms[r] = msrc[n0 + r];
    for (int e = tid; e < nk * rows; e += kThreads) {
      const int kk = e / rows;
      const int r = e % rows;
      ys[kk * TR + r] =
          phenos[(k0 + kk) * N + n0 + r] * (msrc[n0 + r] ? 1.0 : 0.0);
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
    load_tile(n0, rows, 0, 0);
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
  const double df = (n_used - double(nc)) + 1.0;
  const double df_res = df > 1.0 ? df : 1.0;

  for (int64_t k0 = 0; k0 < K; k0 += kPerms) {
    const int nk = int(K - k0 < kPerms ? K - k0 : kPerms);
    for (int q = tid; q < nk * P; q += kThreads) xty[q] = 0.0;
    __syncthreads();
    // pass A: X^T y per phenotype
    for (int64_t n0 = 0; n0 < N; n0 += TR) {
      const int rows = int(N - n0 < TR ? N - n0 : TR);
      load_tile(n0, rows, k0, nk);
      __syncthreads();
      for (int q = tid; q < nk * P; q += kThreads) {
        const double* yk = ys + (q / P) * TR;
        const int j = q % P;
        double acc = 0.0;
        for (int r = 0; r < rows; ++r) acc = acc + xs[r * P + j] * yk[r];
        xty[q] += acc;
      }
      __syncthreads();
    }
    for (int q = tid; q < nk; q += kThreads) {
      stoat::apply_inverse(inv, xty + q * P, beta + q * P, P);
    }
    __syncthreads();

    // pass B: the residual sum of squares over the used rows
    const int kk = tid % kPerms;
    const int g = tid / kPerms;
    const double* bk = beta + kk * P;
    double rss = 0.0;
    for (int64_t n0 = 0; n0 < N; n0 += TR) {
      const int rows = int(N - n0 < TR ? N - n0 : TR);
      load_tile(n0, rows, k0, nk);
      __syncthreads();
      if (kk < nk) {
        const double* yk = ys + kk * TR;
        for (int r = g; r < rows; r += kGroups) {
          double pred = xs[r * P] * bk[0];
          for (int t = 1; t < P; ++t) pred = pred + xs[r * P + t] * bk[t];
          const double resid = ms[r] ? yk[r] - pred : 0.0;
          rss = rss + resid * resid;
        }
      }
      __syncthreads();
    }
    red[tid] = rss;
    __syncthreads();
    if (tid < nk) {
      double r_sum = 0.0;
      for (int gg = 0; gg < kGroups; ++gg) r_sum += red[gg * kPerms + tid];
      const double mse = r_sum / df_res;
      const double beta1 = beta[tid * P + 1];
      const double se1 = sqrt(inv[1 * P + 1] * mse);
      t1_out[(k0 + tid) * S + s] = beta1 / se1;
      df_out[(k0 + tid) * S + s] = df_res;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int perm_ols_launch(const void* X, const void* mask,
                               const void* ncols, const void* phenos,
                               void* work, void* t1_out, void* df_out,
                               int64_t S, int64_t N, int64_t P, int64_t K,
                               void* stream) {
  if (P < 2) return int(cudaErrorInvalidValue);  // beta1 needs a column 1
  if (S <= 0 || K <= 0) return int(cudaGetLastError());
  const size_t fixed = (2 * kPerms * size_t(P) + kThreads) * 8;
  const size_t per_row = (size_t(P) + kPerms) * 8 + 1;
  int TR = kMaxTileRows;
  if (fixed + TR * per_row > kBudget) {
    TR = fixed < kBudget ? int((kBudget - fixed) / per_row) : 0;
    if (TR < 16) TR = 16;
  }
  const size_t smem = fixed + size_t(TR) * per_row;
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        perm_ols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  perm_ols_kernel<<<unsigned(S), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), static_cast<const double*>(phenos),
      static_cast<double*>(work), static_cast<double*>(t1_out),
      static_cast<double*>(df_out), N, int(P), K, S, TR);
  return int(cudaGetLastError());
}

extern "C" const char* perm_ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
