// K11: batched penalised IRLS logistic regression with the Wald test and
// Holm selection, one block per snarl.
//
// Replaces stoat_tpu/stats/logreg.py logistic_regression_batch (:44-135)
// with stoat_tpu/stats/linalg.py ldlt_solve (:90) and ldlt_inverse (:105)
// and stoat_tpu/stats/special.py normal_sf2 (:64), as ``vcf -b -c`` runs it
// (stoat_tpu/pipeline/quantitative.py _fused_packed_analysis, kind
// "logistic", :305-350).  For snarl s with design X [N, P] = [intercept |
// variant dosages | zero padding] (rows of unused samples zero), y [N],
// the used-row mask, ncols and the degenerate flag:
//
//   each Newton step, at most 100:
//     z = X beta, prob = 1 / (1 + exp(-z)), w = clamp(prob (1 - prob),
//     1e-8, 1) on used rows (0 elsewhere); H = X^T W X + 1e-4 I over all P
//     columns; g = X^T (y - prob) on used rows - 1e-4 beta; the step from
//     an unpivoted LDL^T solve (D == 0 divides by 1); a step that is not
//     finite fails the snarl; it converges when ||beta_new - beta_old|| <
//     1e-6 (beta_old follows beta while the snarl is active)
//   then, at the final beta: H again, se = sqrt(diag H^-1) by LDL^T solves
//   against the identity, z = beta / se, p = 2 (1 - ndtr(|z|)) with JAX's
//   _ndtr branch rule on CUDA's erf and erfc;
//   Holm over the variant columns 1 <= j < ncols (m counts them): the
//   finite p in a stable ascending order, min((m - i) p, 1), a running
//   maximum, +inf for the others; the first column with the smallest
//   adjusted p, or column 0 (the intercept, p = +inf) when none is finite;
//   NaN in p, beta and se where the snarl failed, never converged, or is
//   degenerate.
//
// The algebra repeats the plain version's (stats/logreg.py,
// stats/linalg.py) operation for operation, with -fmad=false; the LDL^T is
// ldlt_device.cuh's, shared with ols.cu.  The sums over the N rows run in
// another order than torch.bmm's, so the two agree to a relative ~1e-12 on
// well-conditioned snarls, not bitwise; the comparison on the card bounds
// it, and records any snarl whose convergence test lands on the other side
// of 1e-6.  No atomics: every sum has a fixed order, so results repeat
// from run to run.
//
// What bounds it on the card: memory.  Each pass reads the snarl's X once
// (N * P * 8 bytes), plus y and the mask, and a snarl takes one pass per
// Newton step and one at the end: 0.82 GB per pass over a chunk at S =
// 8192, N = 2,504, P = 5.  A block ends when its own snarl does.
// Design: rows stream through shared-memory tiles, loaded with coalesced
// reads.  Per tile, one thread per row computes z, the weight and the
// residual; then the block's threads split the upper triangle of X^T W X
// and X^T (y - prob) into (entry, row group) pairs, so that a narrow P
// still keeps most threads busy, and each pair adds its rows in order into
// a per-snarl float64 scratch; thread 0 sums the row groups in order,
// solves, updates beta in shared memory and decides.  The P x P algebra
// runs in the scratch too, so any P works.
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
constexpr int kTileBytes = 32768;  // X rows per tile: 32 KB at most
constexpr int kMaxIter = 100;      // stats_test.hpp:109
constexpr double kTol = 1e-6;      // stats_test.hpp:110
constexpr double kL2 = 1e-4;       // stats_test.hpp:111
constexpr double kEps = 1e-8;      // stats_test.hpp:112
constexpr double kHalfSqrt2 = 0.7071067811865476;  // 0.5 * sqrt(2)

__host__ __device__ int64_t n_entries(int64_t P) {
  return P * (P + 1) / 2 + P;
}

// row groups per entry: enough (entry, group) pairs to fill the block
__host__ __device__ int64_t n_groups(int64_t P) {
  const int64_t g = kThreads / n_entries(P);
  return g < 1 ? 1 : g;
}

// per-snarl scratch (doubles): partial sums, then H, L, D, g, beta,
// beta_old, a solve column, se and p
__host__ __device__ int64_t work_doubles(int64_t P) {
  const int64_t parts = n_groups(P) * n_entries(P);
  return parts + 2 * P * P + 7 * P;
}

// JAX 0.9's _ndtr
__device__ double ndtr(double x) {
  const double w = x * kHalfSqrt2;
  const double z = fabs(w);
  const double y = z < kHalfSqrt2 ? 1.0 + erf(w)
                                  : (w > 0.0 ? 2.0 - erfc(z) : erfc(z));
  return 0.5 * y;
}

// the (i, j) of upper-triangle entry e, row by row
__device__ void upper_pair(int e, int P, int* i, int* j) {
  int r = 0, q = e;
  while (q >= P - r) {
    q -= P - r;
    ++r;
  }
  *i = r;
  *j = r + q;
}

__global__ void logreg_kernel(const double* __restrict__ X,
                              const double* __restrict__ y,
                              const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ ncols,
                              const uint8_t* __restrict__ degenerate,
                              double* __restrict__ work,
                              double* __restrict__ p_out,
                              double* __restrict__ beta_out,
                              double* __restrict__ se_out,
                              int32_t* __restrict__ iters_out, int64_t N,
                              int P, int TR) {
  extern __shared__ double smem[];
  double* xs = smem;                 // [TR * P] a tile of X rows
  double* ws = xs + TR * P;          // [TR] weights, 0 on unused rows
  double* rs = ws + TR;              // [TR] y - prob, 0 on unused rows
  double* beta_s = rs + TR;          // [P] the current beta
  __shared__ int active_s, failed_s, iter_s;

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const double* Xs = X + s * N * P;
  const double* ysrc = y + s * N;
  const uint8_t* msrc = mask + s * N;
  const int E = int(n_entries(P));
  const int npairs = P * (P + 1) / 2;
  const int G = int(n_groups(P));
  const int Q = G * E;
  double* part = work + s * work_doubles(P);  // [G * E], group-major
  double* H = part + Q;
  double* L = H + P * P;
  double* D = L + P * P;
  double* g = D + P;
  double* beta = g + P;
  double* beta_old = beta + P;
  double* col = beta_old + P;
  double* se = col + P;
  double* pz = se + P;

  if (tid == 0) {
    for (int j = 0; j < P; ++j) {
      beta[j] = 0.0;
      beta_old[j] = 0.0;
      beta_s[j] = 0.0;
    }
    // logreg.py:91-94: a NaN in X[s, 0, 0] starts the snarl inactive
    active_s = N > 0 ? (Xs[0] * 0.0 < 1.0) : 1;
    failed_s = 0;
    iter_s = 0;
  }

  for (;;) {
    __syncthreads();
    // uniform across the block: read after the barrier, written by thread
    // 0 only after the next one
    const bool last = !active_s || iter_s == kMaxIter;

    // one pass over the rows at beta_s: the partial sums of H and g
    for (int q = tid; q < Q; q += kThreads) part[q] = 0.0;
    for (int64_t n0 = 0; n0 < N; n0 += TR) {
      const int rows = int(N - n0 < TR ? N - n0 : TR);
      __syncthreads();
      for (int e = tid; e < rows * P; e += kThreads) xs[e] = Xs[n0 * P + e];
      __syncthreads();
      for (int r = tid; r < rows; r += kThreads) {
        double z = xs[r * P] * beta_s[0];
        for (int t = 1; t < P; ++t) z = z + xs[r * P + t] * beta_s[t];
        const double prob = 1.0 / (1.0 + exp(-z));
        double w = prob * (1.0 - prob);
        w = w < kEps ? kEps : w;   // a NaN stays NaN, as in jnp.clip
        w = w > 1.0 ? 1.0 : w;
        const bool used = msrc[n0 + r] != 0;
        ws[r] = used ? w : 0.0;
        rs[r] = used ? ysrc[n0 + r] - prob : 0.0;
      }
      __syncthreads();
      for (int q = tid; q < Q; q += kThreads) {
        const int grp = q / E;
        const int e = q - grp * E;
        double acc = 0.0;
        if (e < npairs) {
          int i, j;
          upper_pair(e, P, &i, &j);
          for (int r = grp; r < rows; r += G) {
            acc = acc + (xs[r * P + i] * ws[r]) * xs[r * P + j];
          }
        } else {
          const int j = e - npairs;
          for (int r = grp; r < rows; r += G) {
            acc = acc + xs[r * P + j] * rs[r];
          }
        }
        part[q] += acc;
      }
    }
    __syncthreads();

    if (tid == 0) {
      // the row groups in order, then the ridge
      for (int e = 0; e < E; ++e) {
        double v = part[e];
        for (int grp = 1; grp < G; ++grp) v = v + part[grp * E + e];
        if (e < npairs) {
          int i, j;
          upper_pair(e, P, &i, &j);
          H[i * P + j] = v;
          H[j * P + i] = v;
        } else {
          g[e - npairs] = v;
        }
      }
      for (int i = 0; i < P; ++i) H[i * P + i] = H[i * P + i] + kL2;
      stoat::ldlt_factor(H, L, D, P);
      if (!last) {
        // a Newton step (logreg.py:74-88)
        for (int j = 0; j < P; ++j) col[j] = g[j] - kL2 * beta[j];
        stoat::ldlt_solve(L, D, col, P);
        bool bad = false;
        for (int j = 0; j < P; ++j) bad = bad || !isfinite(col[j]);
        double diff2 = 0.0;
        for (int j = 0; j < P; ++j) {
          const double nb = beta[j] + (bad ? 0.0 : col[j]);
          const double d = nb - beta_old[j];
          diff2 = diff2 + d * d;
          col[j] = nb;
        }
        const bool still = !bad && !(sqrt(diff2) < kTol);
        for (int j = 0; j < P; ++j) {
          beta[j] = col[j];
          beta_s[j] = col[j];
          if (still) beta_old[j] = col[j];
        }
        failed_s = failed_s || bad;
        active_s = still;
        iter_s = iter_s + 1;
      } else {
        // the Wald test at the final beta (logreg.py:98-108)
        for (int m = 0; m < P; ++m) {
          for (int i = 0; i < P; ++i) col[i] = i == m ? 1.0 : 0.0;
          stoat::ldlt_solve(L, D, col, P);
          se[m] = sqrt(col[m]);
        }
        for (int j = 0; j < P; ++j) {
          pz[j] = 2.0 * (1.0 - ndtr(fabs(beta[j] / se[j])));
        }
        // Holm over the variant columns (logreg.py:110-130)
        const int hi = ncols[s] < P ? ncols[s] : P;
        const double m = double(hi - 1 > 0 ? hi - 1 : 0);
        // col[j]: the raw adjusted p of each finite variant p, at its
        // position in the stable ascending order of the finite ones
        for (int j = 1; j < hi; ++j) {
          if (!isfinite(pz[j])) continue;
          int rank = 0;
          for (int i = 1; i < hi; ++i) {
            if (isfinite(pz[i]) &&
                (pz[i] < pz[j] || (pz[i] == pz[j] && i < j))) {
              ++rank;
            }
          }
          const double raw = (m - double(rank)) * pz[j];
          col[j] = raw < 1.0 ? raw : 1.0;
          H[j] = double(rank);   // H is free once factored
        }
        // the running maximum in that order, then the first minimum
        const double inf = INFINITY;
        double best = inf;
        int sel = 0;
        for (int j = 1; j < hi; ++j) {
          if (!isfinite(pz[j])) continue;
          double adj = col[j];
          for (int i = 1; i < hi; ++i) {
            if (isfinite(pz[i]) && H[i] < H[j] && col[i] > adj) adj = col[i];
          }
          if (adj < best) {
            best = adj;
            sel = j;
          }
        }
        const bool na = active_s || failed_s || degenerate[s];
        const double nan_v = nan("");
        p_out[s] = na ? nan_v : best;
        beta_out[s] = na ? nan_v : beta[sel];
        se_out[s] = na ? nan_v : se[sel];
        iters_out[s] = iter_s;
      }
    }
    if (last) break;
  }
}

}  // namespace

extern "C" int64_t logreg_work_doubles(int64_t P) { return work_doubles(P); }

extern "C" int logreg_launch(const void* X, const void* y, const void* mask,
                             const void* ncols, const void* degenerate,
                             void* work, void* p_out, void* beta_out,
                             void* se_out, void* iters_out, int64_t S,
                             int64_t N, int64_t P, void* stream) {
  if (P < 1) return int(cudaErrorInvalidValue);
  int TR = int(kTileBytes / (P * 8));
  if (TR > kMaxTileRows) TR = kMaxTileRows;
  if (TR < 1) TR = 1;
  const size_t smem = size_t(TR) * (P + 2) * 8 + size_t(P) * 8;
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  if (S > 0) {
    logreg_kernel<<<unsigned(S), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(X), static_cast<const double*>(y),
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(ncols),
        static_cast<const uint8_t*>(degenerate), static_cast<double*>(work),
        static_cast<double*>(p_out), static_cast<double*>(beta_out),
        static_cast<double*>(se_out), static_cast<int32_t*>(iters_out), N,
        int(P), TR);
  }
  return int(cudaGetLastError());
}

extern "C" const char* logreg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
