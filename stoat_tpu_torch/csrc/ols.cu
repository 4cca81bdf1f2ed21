// K9: batched masked OLS, one regression per snarl.
//
// Replaces stoat_tpu/stats/linreg.py linear_regression_stats_batch (:141;
// _ols_unrolled_body :47 for P <= 8, the matrix branch :150-202 above)
// with stoat_tpu/stats/linalg.py ldlt_factor (:33), ldlt_solve (:90),
// jacobi_eigh (:113) and sym_pinv (:170).  For snarl s with design
// X [N, P] (rows of unused samples zero), y [N], used-row mask and ncols:
//
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   L, D   = unpivoted LDL^T of A; bad = some real |D_j| < 1e-10 or not
//            finite
//   inv    = A^-1 by solves against the identity, or, when bad, the
//            Jacobi pseudo-inverse (12 cyclic sweeps, eigenvalues with
//            |w| <= 1e-6 dropped)
//   beta   = inv X^T y; rss, tss over used rows; r2 = 1 - rss / tss
//   df_res = max(n_used - ncols + 1, 1); se1 = sqrt(inv_11 rss / df_res)
//   out    = (beta1 / se1, df_res, beta1, se1, r2)
//
// The algebra repeats the plain version (stats/linreg.py, stats/linalg.py)
// operation for operation: the LDL^T of ldlt_device.cuh (shared with
// logreg.cu), the Jacobi rotation formulas, sums over p in order;
// -fmad=false keeps each multiply and add separately rounded.  The
// sums over the N rows run in another order than the plain version's
// (each entry sequentially over the rows here), which the comparison on
// the card bounds by a relative tolerance.  No atomics: every sum has a
// fixed order, so results repeat from run to run.
//
// What bounds it on the card: memory.  It reads X twice, once for the
// normal equations and once for the residuals: 2 * S * N * P * 8 bytes,
// 2.3 GB per chunk at S = 8192, N = 2,504, P = 7 (0.7 ms at 3.35 TB/s).
// Design: one block per snarl.  Rows stream through shared memory in tiles
// loaded with coalesced reads (a tile is TR contiguous rows of X); in pass
// 1 each thread owns entries of X^T X, X^T y and the masked sums and adds
// the tile's rows to them in row order; in pass 2 each thread takes rows
// and a fixed tree reduces rss and tss.  The P x P algebra runs on thread
// 0 of the block, in a per-snarl float64 scratch of the wrapper's
// (4 P^2 + 4 P + 4 doubles), so any P works; the Jacobi sweeps run only
// on rank-deficient snarls.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "ldlt_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTileRows = 128;
constexpr int kTileBytes = 32768;   // X rows per tile: 32 KB at most
constexpr double kLdltTol = 1e-10;  // stats_test.cpp:401
constexpr double kPinvTol = 1e-6;   // stats_test.cpp:386
constexpr int kSweeps = 12;

__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

// one Jacobi rotation of rows/columns p, q of A (P x P), accumulated in V
__device__ void jacobi_rotate(double* A, double* V, int P, int p, int q) {
  const double app = A[p * P + p];
  const double aqq = A[q * P + q];
  const double apq = A[p * P + q];
  const bool small = fabs(apq) < 1e-300;
  const double apq_safe = small ? 1.0 : apq;
  const double tau = (aqq - app) / (2.0 * apq_safe);
  // jnp.sign: NaN stays NaN
  const double sg = tau > 0.0 ? 1.0 : (tau < 0.0 ? -1.0 : tau);
  double t = sg / (fabs(tau) + sqrt(1.0 + tau * tau));
  if (tau == 0.0) t = 1.0;
  double c = 1.0 / sqrt(1.0 + t * t);
  double s = t * c;
  if (small) {
    c = 1.0;
    s = 0.0;
  }
  for (int k = 0; k < P; ++k) {
    const double rp = A[p * P + k];
    const double rq = A[q * P + k];
    A[p * P + k] = c * rp - s * rq;
    A[q * P + k] = s * rp + c * rq;
  }
  for (int k = 0; k < P; ++k) {
    const double cp = A[k * P + p];
    const double cq = A[k * P + q];
    A[k * P + p] = c * cp - s * cq;
    A[k * P + q] = s * cp + c * cq;
  }
  for (int k = 0; k < P; ++k) {
    const double vp = V[k * P + p];
    const double vq = V[k * P + q];
    V[k * P + p] = c * vp - s * vq;
    V[k * P + q] = s * vp + c * vq;
  }
}

// Thread 0's part: from A = X^T X (padded diagonal set) and X^T y, the
// inverse (or pseudo-inverse) in inv and beta.
__device__ void solve_normal_equations(double* A, double* L, double* inv,
                                       double* V, double* D, double* xty,
                                       double* beta, double* col, int P,
                                       int nc) {
  stoat::ldlt_factor(A, L, D, P);
  bool bad = false;
  for (int j = 0; j < nc && j < P; ++j) {
    bad = bad || fabs(D[j]) < kLdltTol || !isfinite(D[j]);
  }
  // the inverse, one identity column at a time (ldlt_solve)
  for (int m = 0; m < P; ++m) {
    for (int i = 0; i < P; ++i) col[i] = i == m ? 1.0 : 0.0;
    stoat::ldlt_solve(L, D, col, P);
    for (int i = 0; i < P; ++i) inv[i * P + m] = col[i];
  }
  if (bad) {
    // Jacobi pseudo-inverse (sym_pinv): L becomes the working copy of A
    for (int e = 0; e < P * P; ++e) {
      L[e] = A[e];
      V[e] = (e / P == e % P) ? 1.0 : 0.0;
    }
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
      for (int p = 0; p < P - 1; ++p) {
        for (int q = p + 1; q < P; ++q) jacobi_rotate(L, V, P, p, q);
      }
    }
    for (int p = 0; p < P; ++p) {
      const double w = L[p * P + p];
      col[p] = fabs(w) > kPinvTol ? 1.0 / (w == 0.0 ? 1.0 : w) : 0.0;
    }
    for (int i = 0; i < P; ++i) {
      for (int j = 0; j < P; ++j) {
        double acc = 0.0;
        for (int p = 0; p < P; ++p) {
          acc = acc + V[i * P + p] * col[p] * V[j * P + p];
        }
        inv[i * P + j] = acc;
      }
    }
  }
  for (int i = 0; i < P; ++i) {
    double acc = 0.0;
    for (int m = 0; m < P; ++m) acc = acc + inv[i * P + m] * xty[m];
    beta[i] = acc;
  }
}

__global__ void ols_kernel(const double* __restrict__ X,
                           const double* __restrict__ y,
                           const uint8_t* __restrict__ mask,
                           const int32_t* __restrict__ ncols,
                           double* __restrict__ work,
                           double* __restrict__ t1_out,
                           double* __restrict__ df_out,
                           double* __restrict__ beta1_out,
                           double* __restrict__ se1_out,
                           double* __restrict__ r2_out, int64_t N, int P,
                           int TR) {
  extern __shared__ double smem[];
  double* xs = smem;                 // [TR * P] a tile of X rows
  double* ys = xs + TR * P;          // [TR]
  double* beta_s = ys + TR;          // [P]
  uint8_t* ms = reinterpret_cast<uint8_t*>(beta_s + P);  // [TR]
  __shared__ double red[kThreads];
  __shared__ double mean_s;

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const double* Xs = X + s * N * P;
  const double* ysrc = y + s * N;
  const uint8_t* msrc = mask + s * N;
  double* A = work + s * (4 * P * P + 4 * P + 4);
  double* L = A + P * P;
  double* inv = L + P * P;
  double* V = inv + P * P;
  double* D = V + P * P;
  double* xty = D + P;
  double* beta = xty + P;
  double* col = beta + P;
  double* sums = col + P;            // [0] masked sum of y, [1] used rows

  // pass 1: entries of X^T X (upper triangle), X^T y, sum y, used rows
  const int npairs = P * (P + 1) / 2;
  const int n_entries = npairs + P + 2;
  for (int q = tid; q < n_entries; q += kThreads) {
    if (q < npairs) {
      int i = 0, r = q;
      while (r >= P - i) {
        r -= P - i;
        ++i;
      }
      A[i * P + i + r] = 0.0;
    } else if (q < npairs + P) {
      xty[q - npairs] = 0.0;
    } else {
      sums[q - npairs - P] = 0.0;
    }
  }
  __syncthreads();
  for (int64_t n0 = 0; n0 < N; n0 += TR) {
    const int rows = int(N - n0 < TR ? N - n0 : TR);
    for (int e = tid; e < rows * P; e += kThreads) xs[e] = Xs[n0 * P + e];
    for (int r = tid; r < rows; r += kThreads) {
      ys[r] = ysrc[n0 + r];
      ms[r] = msrc[n0 + r];
    }
    __syncthreads();
    for (int q = tid; q < n_entries; q += kThreads) {
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
      } else if (q < npairs + P) {
        const int j = q - npairs;
        for (int r = 0; r < rows; ++r) acc = acc + xs[r * P + j] * ys[r];
        xty[j] += acc;
      } else if (q == npairs + P) {
        for (int r = 0; r < rows; ++r) acc = acc + (ms[r] ? ys[r] : 0.0);
        sums[0] += acc;
      } else {
        for (int r = 0; r < rows; ++r) acc = acc + (ms[r] ? 1.0 : 0.0);
        sums[1] += acc;
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
    solve_normal_equations(A, L, inv, V, D, xty, beta, col, P, nc);
    for (int i = 0; i < P; ++i) beta_s[i] = beta[i];
    const double n_used = sums[1];
    mean_s = sums[0] / (n_used == 0.0 ? 1.0 : n_used);
  }
  __syncthreads();

  // pass 2: residual and total sums of squares over the used rows
  const double mean = mean_s;
  double rss = 0.0, tss = 0.0;
  for (int64_t n0 = 0; n0 < N; n0 += TR) {
    const int rows = int(N - n0 < TR ? N - n0 : TR);
    for (int e = tid; e < rows * P; e += kThreads) xs[e] = Xs[n0 * P + e];
    for (int r = tid; r < rows; r += kThreads) {
      ys[r] = ysrc[n0 + r];
      ms[r] = msrc[n0 + r];
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      double pred = xs[r * P] * beta_s[0];
      for (int t = 1; t < P; ++t) pred = pred + xs[r * P + t] * beta_s[t];
      const double resid = ms[r] ? ys[r] - pred : 0.0;
      rss = rss + resid * resid;
      const double dev = ys[r] - mean;
      tss = tss + (ms[r] ? dev * dev : 0.0);
    }
    __syncthreads();
  }
  rss = block_sum(rss, red);
  tss = block_sum(tss, red);

  if (tid == 0) {
    const double n_used = sums[1];
    const double df = (n_used - double(nc)) + 1.0;
    const double df_res = df > 1.0 ? df : 1.0;
    const double mse = rss / df_res;
    const double beta1 = beta[1];
    const double se1 = sqrt(inv[1 * P + 1] * mse);
    t1_out[s] = beta1 / se1;
    df_out[s] = df_res;
    beta1_out[s] = beta1;
    se1_out[s] = se1;
    r2_out[s] = 1.0 - rss / tss;
  }
}

}  // namespace

extern "C" int ols_launch(const void* X, const void* y, const void* mask,
                          const void* ncols, void* work, void* t1_out,
                          void* df_out, void* beta1_out, void* se1_out,
                          void* r2_out, int64_t S, int64_t N, int64_t P,
                          void* stream) {
  if (P < 2) return int(cudaErrorInvalidValue);  // beta1 needs a column 1
  int TR = int(kTileBytes / ((P + 1) * 8));
  if (TR > kMaxTileRows) TR = kMaxTileRows;
  if (TR < 1) TR = 1;
  const size_t smem = size_t(TR) * (P + 1) * 8 + size_t(P) * 8 + TR;
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  if (S > 0) {
    ols_kernel<<<unsigned(S), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(X), static_cast<const double*>(y),
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(ncols),
        static_cast<double*>(work), static_cast<double*>(t1_out),
        static_cast<double*>(df_out), static_cast<double*>(beta1_out),
        static_cast<double*>(se1_out), static_cast<double*>(r2_out), N,
        int(P), TR);
  }
  return int(cudaGetLastError());
}

extern "C" const char* ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
