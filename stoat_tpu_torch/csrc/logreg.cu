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
// The P x P algebra repeats the plain version's (stats/logreg.py,
// stats/linalg.py) operation for operation, with -fmad=false; the LDL^T is
// ldlt_device.cuh's, shared with ols.cu.  The sums over the N rows run on
// the float64 tensor cores, which fuse each multiply-add whatever -fmad
// says, in another order than torch.bmm's, and an entry of H is summed as
// x_i (w x_j) where the plain version takes (x_i w) x_j: the two agree to
// a relative ~1e-12 on well-conditioned snarls, not bitwise; the
// comparison on the card bounds it, and records any snarl whose
// convergence test lands on the other side of 1e-6.  No atomics: every sum
// has a fixed order, so results repeat from run to run.
//
// What bounds it on the card: memory, reading the snarl's X once (N * P * 8
// bytes), y and the mask: 0.82 GB over a chunk at S = 8192, N = 2,504,
// P = 5 (0.30 ms at 3.35 TB/s).  A snarl takes one pass over its rows per
// Newton step and one at the end (about 4 at that shape).
//
// Design: X stays on chip across the Newton steps.  The block copies the
// snarl's first R rows of X, with y and the mask, into shared memory once
// (cp.async, 16-byte copies where X is 16-byte aligned); R is a runtime
// bound that the host sizes so that three blocks share an SM (kBlockSmem;
// 1,469 of the 2,504 rows at P = 5), and the rows past R are read from
// device memory at every pass, in the same order: a group of 32 rows that
// lies wholly in the first R is read from shared memory, any other from
// device memory, through one pointer per group, so both run the same code.
// A pass computes H and g as one product over the rows, [X | 0]^T [W X |
// r] with P + 1 padded to 8: each warp takes groups of 32 rows (groups w,
// w + 8, ...), its lanes one row each for z, w and r (one exp per row)
// into the warp's slot of shared memory, then eight float64
// mma.sync.m8n8k4 of 4 rows each accumulate the warp's 8 x 8 tile in
// registers.  For P + 1 > 8 the pass loops over the 8 x 8 output tiles
// (i <= j), so any P works in one kernel.  The warps' tiles are summed in
// shared memory in warp order, two barriers per output tile.  Warp 0 then
// does the P x P algebra in shared memory (H, L, D, g, beta: 2 P^2 + 7 P
// doubles, R shrunk to make room; in a per-snarl scratch of the wrapper's
// only when P is too wide for shared memory at all): the factor and the
// Newton step on lane 0, the Wald step's P solves against the unit vectors
// one per lane, and Holm's ranks and running maxima one per lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "ldlt_device.cuh"
#include "perm_gemm_device.cuh"

namespace {

using stoat::pg::cp_async16;
using stoat::pg::cp_async8;
using stoat::pg::cp_async_commit;
using stoat::pg::cp_async_wait;
using stoat::pg::mma884;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPart = kWarps * 64;          // the warps' 8 x 8 tiles
// three blocks of 256 threads on an SM: 2.007 ms at the first `-b -c`
// chunk on an H100, against 2.386 with two (113 KB, every row but 241
// held) and 2.309 with four of 128 threads (56 KB), tools/kernel_ab.py
constexpr size_t kBlockSmem = 75 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxIter = 100;      // stats_test.hpp:109
constexpr double kTol = 1e-6;      // stats_test.hpp:110
constexpr double kL2 = 1e-4;       // stats_test.hpp:111
constexpr double kEps = 1e-8;      // stats_test.hpp:112
constexpr double kHalfSqrt2 = 0.7071067811865476;  // 0.5 * sqrt(2)

// the algebra's doubles: H, L [P, P], then D, g, beta, beta_old, a solve
// column, se and p [P] each; even, so that what follows stays 16-byte
// aligned
__host__ __device__ int64_t alg_doubles(int64_t P) {
  const int64_t n = 2 * P * P + 7 * P;
  return n + (n & 1);
}

// Shared memory of a block: the warps' tiles, the algebra when it fits
// beside them (shrinking the resident rows first), and R rows of X, y and
// the mask.
struct Plan {
  int64_t R;       // resident rows
  int alg_smem;    // the algebra in shared memory (else in the scratch)
  size_t smem;
};

__host__ Plan plan(int64_t N, int64_t P) {
  const size_t part = size_t(kPart) * 8;
  const size_t alg = size_t(alg_doubles(P)) * 8;
  const size_t per_row = size_t(P) * 8 + 8 + 1;
  Plan p{0, 1, 0};
  size_t budget = kBlockSmem;
  if (part + alg > budget) budget = part + alg;
  if (budget > kMaxSmem) {
    p.alg_smem = 0;
    budget = kBlockSmem;
  }
  const size_t fixed = part + (p.alg_smem ? alg : 0);
  int64_t R = int64_t((budget - fixed) / per_row);
  p.R = R < N ? R : N;
  p.smem = fixed + size_t(p.R) * (per_row - 1) + ((size_t(p.R) + 15) & ~15);
  return p;
}

// JAX 0.9's _ndtr
__device__ double ndtr(double x) {
  const double w = x * kHalfSqrt2;
  const double z = fabs(w);
  const double y = z < kHalfSqrt2 ? 1.0 + erf(w)
                                  : (w > 0.0 ? 2.0 - erfc(z) : erfc(z));
  return 0.5 * y;
}

// kAlgSmem: the algebra in shared memory, a template argument so that its
// loads and stores are shared-memory ones: 2.061 ms at the first `-b -c`
// chunk on an H100 against 2.234 through a pointer chosen at run time
// (tools/kernel_ab.py); the scratch instantiation runs only where the
// algebra does not fit (P >= 118)
template <bool kAlgSmem>
__global__ void __launch_bounds__(kThreads, 3) logreg_kernel(
    const double* __restrict__ X, const double* __restrict__ y,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ ncols,
    const uint8_t* __restrict__ degenerate, double* __restrict__ work,
    double* __restrict__ p_out, double* __restrict__ beta_out,
    double* __restrict__ se_out, int32_t* __restrict__ iters_out, int64_t N,
    int P, int64_t R) {
  extern __shared__ __align__(16) double smem[];
  double* part = smem;                                  // [kWarps, 8, 8]
  double* alg = kAlgSmem ? part + kPart : work + blockIdx.x * alg_doubles(P);
  double* xs = part + kPart + (kAlgSmem ? alg_doubles(P) : 0);  // [R, P]
  double* ys = xs + R * P;                                         // [R]
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + R);                // [R]
  double* H = alg;
  double* L = H + P * P;
  double* D = L + P * P;
  double* g = D + P;
  double* beta = g + P;
  double* beta_old = beta + P;
  double* col = beta_old + P;
  double* se = col + P;
  double* pz = se + P;
  __shared__ int active_s, failed_s, iter_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t s = blockIdx.x;
  const double* Xs = X + s * N * P;
  const double* ysrc = y + s * N;
  const uint8_t* msrc = mask + s * N;

  // the resident rows, once
  const int64_t nx = R * P;
  if ((reinterpret_cast<uintptr_t>(Xs) & 15) == 0) {
    for (int64_t e = 2 * tid; e < nx; e += 2 * kThreads) {
      if (e + 1 < nx) {
        cp_async16(xs + e, Xs + e, 16);
      } else {
        cp_async8(xs + e, Xs + e, 8);
      }
    }
  } else {
    for (int64_t e = tid; e < nx; e += kThreads) cp_async8(xs + e, Xs + e, 8);
  }
  for (int64_t r = tid; r < R; r += kThreads) cp_async8(ys + r, ysrc + r, 8);
  cp_async_commit();
  for (int64_t r = tid; r < R; r += kThreads) ms[r] = msrc[r];
  if (tid == 0) {
    for (int j = 0; j < P; ++j) {
      beta[j] = 0.0;
      beta_old[j] = 0.0;
    }
    // logreg.py:91-94: a NaN in X[s, 0, 0] starts the snarl inactive
    active_s = N > 0 ? (Xs[0] * 0.0 < 1.0) : 1;
    failed_s = 0;
    iter_s = 0;
  }
  cp_async_wait<0>();

  const int gq = lane >> 2;   // the fragment's row of A and column of B
  const int tq = lane & 3;    // its row of 4 (k)
  const int n_ct = (P + 1 + 7) / 8;   // 8-wide column tiles of [X | r]
  double* wr = part + warp * 64;      // the warp's w [32] and r [32]

  for (;;) {
    __syncthreads();
    // uniform across the block: read after the barrier, written by lane 0
    // of warp 0 only after the pass's barriers
    const bool last = !active_s || iter_s == kMaxIter;

    // one pass over the rows at beta: H and g, an 8 x 8 tile at a time
    for (int mt = 0; mt < n_ct; ++mt) {
      for (int nt = mt; nt < n_ct; ++nt) {
        double c[2] = {0.0, 0.0};
        const int ca = 8 * mt + gq;
        const int cb = 8 * nt + gq;
        const int ca_in = ca < P ? ca : P - 1;
        const int cb_in = cb < P ? cb : P - 1;
        for (int64_t g0 = int64_t(warp) * 32; g0 < N; g0 += kWarps * 32) {
          const int rows = N - g0 < 32 ? int(N - g0) : 32;
          // a group held in shared memory, or read whole from device memory
          const bool held = g0 + rows <= R;
          const double* xg = held ? xs + g0 * P : Xs + g0 * P;
          double w = 0.0, r = 0.0;
          if (lane < rows) {
            const double* xr = xg + lane * P;
            double z = xr[0] * beta[0];
            for (int t = 1; t < P; ++t) z = z + xr[t] * beta[t];
            const double prob = 1.0 / (1.0 + exp(-z));
            double wv = prob * (1.0 - prob);
            wv = wv < kEps ? kEps : wv;   // a NaN stays NaN, as in jnp.clip
            wv = wv > 1.0 ? 1.0 : wv;
            const int64_t n = g0 + lane;
            const bool used = (held ? ms[n] : msrc[n]) != 0;
            const double yv = held ? ys[n] : ysrc[n];
            w = used ? wv : 0.0;
            r = used ? yv - prob : 0.0;
          }
          wr[lane] = w;
          wr[32 + lane] = r;
          __syncwarp();
          // the fragments of all eight products first, by selects, not
          // branches: every lane loads from a row and column that exist
          // (clamped), and a lane outside X, the group or [W X | r] gives an
          // exact 0; then the products
          double fa[8], fb[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = 4 * i + tq;
            const bool in = k < rows;
            const double* xk = xg + (in ? k : rows - 1) * P;
            const double xa = xk[ca_in];
            const double xb = mt == nt ? xa : xk[cb_in];
            const double wk = wr[k];
            const double rk = wr[32 + k];
            fa[i] = in && ca < P ? xa : 0.0;
            fb[i] = !in ? 0.0 : cb < P ? wk * xb : cb == P ? rk : 0.0;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) mma884(c, fa[i], fb[i]);
          __syncwarp();
        }
        // the warp's tile: C[gq][2 tq + i], then the warps' sum in order
        part[warp * 64 + gq * 8 + 2 * tq] = c[0];
        part[warp * 64 + gq * 8 + 2 * tq + 1] = c[1];
        __syncthreads();
        if (warp == 0) {
          for (int e = lane; e < 64; e += 32) {
            double v = part[e];
            for (int k = 1; k < kWarps; ++k) v = v + part[k * 64 + e];
            const int i = 8 * mt + (e >> 3);
            const int j = 8 * nt + (e & 7);
            if (i < P && j < P && i <= j) {
              H[i * P + j] = v;
              H[j * P + i] = v;
            } else if (i < P && j == P) {
              g[i] = v;
            }
          }
        }
        if (mt + 1 < n_ct || nt + 1 < n_ct) __syncthreads();
      }
    }

    if (warp == 0) {
      __syncwarp();
      if (lane == 0) {
        for (int i = 0; i < P; ++i) H[i * P + i] = H[i * P + i] + kL2;
        stoat::ldlt_factor(H, L, D, P);
      }
      if (!last && lane == 0) {
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
          if (still) beta_old[j] = col[j];
        }
        failed_s = failed_s || bad;
        active_s = still;
        iter_s = iter_s + 1;
      }
      if (last) {
        // the Wald test at the final beta (logreg.py:98-108): lane m
        // solves against the unit vector m in H's rows (H is factored)
        __syncwarp();
        for (int m = lane; m < P; m += 32) {
          double* x = H + m * P;
          for (int i = 0; i < P; ++i) x[i] = i == m ? 1.0 : 0.0;
          stoat::ldlt_solve(L, D, x, P);
          se[m] = sqrt(x[m]);
          pz[m] = 2.0 * (1.0 - ndtr(fabs(beta[m] / se[m])));
        }
        __syncwarp();
        // Holm over the variant columns (logreg.py:110-130): lane j ranks
        // column j among the finite p in their stable ascending order and
        // keeps its raw adjusted p (col) and its rank (g)
        const int hi = ncols[s] < P ? ncols[s] : P;
        const double m = double(hi - 1 > 0 ? hi - 1 : 0);
        for (int j = 1 + lane; j < hi; j += 32) {
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
          g[j] = double(rank);
        }
        __syncwarp();
        // the running maximum in that order (into H's first row, free)
        for (int j = 1 + lane; j < hi; j += 32) {
          if (!isfinite(pz[j])) continue;
          double adj = col[j];
          for (int i = 1; i < hi; ++i) {
            if (isfinite(pz[i]) && g[i] < g[j] && col[i] > adj) adj = col[i];
          }
          H[j] = adj;
        }
        __syncwarp();
        if (lane == 0) {
          // the first minimum
          double best = INFINITY;
          int sel = 0;
          for (int j = 1; j < hi; ++j) {
            if (isfinite(pz[j]) && H[j] < best) {
              best = H[j];
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
    }
    if (last) break;
  }
}

}  // namespace

// scratch doubles per snarl: the algebra's, where it does not fit in
// shared memory, else none
extern "C" int64_t logreg_work_doubles(int64_t P) {
  return plan(1, P).alg_smem ? 0 : alg_doubles(P);
}

extern "C" int logreg_launch(const void* X, const void* y, const void* mask,
                             const void* ncols, const void* degenerate,
                             void* work, void* p_out, void* beta_out,
                             void* se_out, void* iters_out, int64_t S,
                             int64_t N, int64_t P, void* stream) {
  if (P < 1) return int(cudaErrorInvalidValue);
  const Plan pl = plan(N, P);
  if (pl.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (S == 0) return int(cudaGetLastError());
  auto kernel = pl.alg_smem ? logreg_kernel<true> : logreg_kernel<false>;
  if (pl.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(pl.smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    }
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<unsigned(S), kThreads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const double*>(y),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(ncols),
      static_cast<const uint8_t*>(degenerate), static_cast<double*>(work),
      static_cast<double*>(p_out), static_cast<double*>(beta_out),
      static_cast<double*>(se_out), static_cast<int32_t*>(iters_out), N,
      int(P), pl.R);
  return int(cudaGetLastError());
}

extern "C" const char* logreg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
