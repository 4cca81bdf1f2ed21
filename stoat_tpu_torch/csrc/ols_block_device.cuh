// The block program of the two masked-OLS kernels, one block per snarl:
// ols.cu (K9, one y per snarl) and eqtl_ols.cu (K13, the snarl's genes).
//
// For snarl s with design X [N, P] (rows of unused samples zero), the
// used-row mask (or every row used: a null mask), ncols and its y rows,
// each y = row[n] * (used ? 1 : 0) formed on chip (bit for bit the
// caller's pheno[None, :] * used):
//
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   inv    = A^-1 by LDL^T, or the Jacobi pseudo-inverse when a real pivot
//            is below 1e-10 or not finite (ols_device.cuh)
//   for each y: beta = inv X^T y;  mean = (sum of y over the used rows) /
//            n_used;  rss, tss = sums over the used rows of (y - X beta)^2
//            and (y - mean)^2;  df_res = max(n_used - ncols + 1, 1)
//            out = (beta_1 / se_1, df_res, beta_1,
//                   se_1 = sqrt(inv_11 rss / df_res), 1 - rss / tss)
//
// What bounds it on the card: memory, reading each snarl's X once (S N P 8
// bytes, 1.15 GB per chunk at S = 8,192, N = 2,504, P = 7: 0.34 ms at 3.35
// TB/s), the mask and the y rows.
//
// Design.
//  1. The block copies the snarl's first R rows of X, and the mask, into
//     shared memory once (cp.async, 16-byte copies where X is 16-byte
//     aligned).  The host sizes R so that three blocks share an SM
//     (kBlockSmem); every pass reads a row below R from shared memory and
//     any other from device memory, through one pointer per 32-row group,
//     so both run the same code.
//  2. One pass over the rows sums [X | m]^T [X | y_0 .. y_g-1] on the
//     float64 tensor cores (m the used-row indicator), in 8 x 8 output
//     tiles (i <= j): X^T X, X^T y and, on row P, the masked sum of each y
//     (m y).  Each warp takes 32-row groups (w, w + 8, ...), first those
//     past the held rows, read from device memory while the copies of the
//     held ones land, then the held ones: its lanes stage the group's m,
//     then mma.sync.m8n8k4 of 4 rows each accumulate the pass's one 8 x 8
//     tile in registers (several tiles a pass spilled registers and took
//     1.32x and 1.53x as long, tools/kernel_ab.py); a lane's fragment
//     comes from X, from m, or from a y row in device memory times m,
//     chosen by a pointer and a stride, with rows past the group zeroed,
//     never skipped (0 x NaN).  The warps' tiles are summed in warp order
//     in shared memory.  At P = 7 with one y, [X | y] and [X | m] are
//     exactly 8 wide: one tile.  Wider designs, and genes past the first
//     tile, loop over tiles, so any P and any number of genes work.  n_used
//     counts the mask's ballots.
//  3. Warp 0 does the algebra in shared memory: the factor of
//     ldlt_device.cuh and the rank probe on lane 0, the P solves against
//     the identity one per lane, the Jacobi pseudo-inverse (rank-deficient
//     snarls only) on lane 0; then each entry of beta on a thread of its
//     own, and the mean one gene per thread.
//     Where P is too wide for shared memory, the algebra works in the
//     wrapper's per-snarl scratch (kAlgSmem false).
//  4. The residual pass gives every thread rows (n = tid, tid + 256, ...)
//     and each of kR genes: rss and tss from the rows directly, not by the
//     Gram identity (which loses the exact tss = 0 of a constant y), each
//     reduced in a fixed tree (a shuffle butterfly, then the warps in
//     order).
//  A snarl's genes go kG at a time through steps 2-4, kR at a time through
//  step 4 (K9: kG = kR = 1), the first batch's pass also giving X^T X and
//  n_used.  Each source wraps ols_block in a __global__ kernel of its own
//  name.
//
// The P x P algebra repeats the plain version's (stats/linreg.py,
// stats/linalg.py) operation for operation with -fmad=false.  The sums
// over the rows run on the tensor cores, which fuse each multiply-add
// whatever -fmad says, in another order than the plain version's: the
// comparison on the card bounds the difference by a relative tolerance.
// No atomics: every sum has a fixed order, so results repeat from run to
// run.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "ols_device.cuh"
#include "perm_gemm_device.cuh"

namespace stoat {
namespace ob {

using pg::cp_async16;
using pg::cp_async8;
using pg::cp_async_commit;
using pg::cp_async_wait;
using pg::mma884;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// three blocks an SM: 3 (smem + 1 KB reserved + the static shared
// variables) within the SM's 228 KB
constexpr size_t kBlockSmem = 75 * 1024 - 256;
constexpr size_t kMaxSmem = 227 * 1024;

// A snarl's y rows: K9's phenotype row y, which every snarl shares; or
// K13's genes b in pair_off[s] .. pair_off[s + 1], rows y + pair_gene[b] *
// N.  Outputs go to index s (K9) or b (K13).
struct Rows {
  const double* y;
  const int32_t* pair_off;   // K13 only
  const int32_t* pair_gene;  // K13 only
};

struct Out {
  double* t1;
  double* df;
  double* beta1;
  double* se1;
  double* r2;
};

// The algebra's doubles: A, L, inv, V [P, P]; D and a column [P]; then for
// a batch of kG genes X^T y and beta [kG, P], the masked sums and the
// means [kG].  Even, so that what follows stays 16-byte aligned.
template <int kG>
__host__ __device__ int64_t alg_doubles(int64_t P) {
  const int64_t n = 4 * P * P + 2 * P + kG * (2 * P + 2);
  return n + (n & 1);
}

// Doubles of shared memory before the algebra: the warps' 8 x 8 tiles, their
// m slots [32] and the residual sums [kG, 2].
template <int kG>
__host__ __device__ constexpr int fixed_doubles() {
  return kWarps * (64 + 32 + 2 * kG);
}

// Shared memory of a block: the fixed part, the algebra when it fits
// beside it (shrinking the resident rows first), and R rows of X and the
// mask.
struct Plan {
  int64_t R;      // resident rows
  int alg_smem;   // the algebra in shared memory (else in the scratch)
  size_t smem;
};

template <int kG>
__host__ Plan plan(int64_t N, int64_t P, bool has_mask) {
  const size_t fixed0 = size_t(fixed_doubles<kG>()) * 8;
  const size_t alg = size_t(alg_doubles<kG>(P)) * 8;
  const size_t per_row = size_t(P) * 8 + (has_mask ? 1 : 0);
  Plan p{0, 1, 0};
  size_t budget = kBlockSmem;
  if (fixed0 + alg > budget) budget = fixed0 + alg;
  if (budget > kMaxSmem) {
    p.alg_smem = 0;
    budget = kBlockSmem;
  }
  const size_t fixed = fixed0 + (p.alg_smem ? alg : 0);
  const int64_t R = budget > fixed ? int64_t((budget - fixed) / per_row) : 0;
  p.R = R < N ? R : N;
  p.smem = fixed + size_t(p.R) * size_t(P) * 8 +
           (has_mask ? ((size_t(p.R) + 15) & ~size_t(15)) : 0);
  return p;
}

// The tile of a batch's pass at index idx: tiles run over the B tiles nt
// from nt_lo and, for each, the A tiles mt <= nt of [X | m] (n_at of them).
__device__ inline void tile_at(int idx, int nt_lo, int n_at, int* mt,
                               int* nt) {
  int n = nt_lo;
  for (;;) {
    const int w = (n < n_at - 1 ? n : n_at - 1) + 1;
    if (idx < w) break;
    idx -= w;
    ++n;
  }
  *mt = idx;
  *nt = n;
}

// The block program, for the __global__ kernel of each source (kG genes a
// batch, kR of them a residual pass; kCsr: K13's pairs).
template <int kG, int kR, bool kCsr, bool kAlgSmem>
__device__ __forceinline__ void ols_block(
    const double* __restrict__ X, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ ncols, Rows ys, double* __restrict__ work,
    Out out, int64_t N, int P, int64_t R) {
  const int64_t s = blockIdx.x;
  int64_t first = s, count = 1;
  if (kCsr) {
    first = ys.pair_off[s];
    count = ys.pair_off[s + 1] - first;
    if (count <= 0) return;   // a snarl with no genes
  }

  extern __shared__ __align__(16) double smem[];
  double* part = smem;                        // [kWarps, 64]
  double* m_all = part + kWarps * 64;         // [kWarps, 32]
  double* red = m_all + kWarps * 32;          // [kWarps, kG, 2]
  double* alg;
  if constexpr (kAlgSmem) {
    alg = red + kWarps * kG * 2;
  } else {
    alg = work + s * alg_doubles<kG>(P);
  }
  double* xs = red + kWarps * kG * 2 + (kAlgSmem ? alg_doubles<kG>(P) : 0);
  uint8_t* ms = reinterpret_cast<uint8_t*>(xs + R * P);   // [R]
  double* A = alg;
  double* L = A + P * P;
  double* inv = L + P * P;
  double* V = inv + P * P;
  double* D = V + P * P;
  double* col = D + P;
  double* xty = col + P;         // [kG, P]
  double* beta = xty + kG * P;   // [kG, P]
  double* sumy = beta + kG * P;  // [kG]
  double* mean = sumy + kG;      // [kG]
  __shared__ const double* rows_s[kG];
  __shared__ int nu_s[kWarps];
  __shared__ int bad_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double* Xs = X + s * N * P;
  const uint8_t* msrc = mask == nullptr ? nullptr : mask + s * N;

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
  cp_async_commit();
  if (msrc != nullptr) {
    for (int64_t r = tid; r < R; r += kThreads) ms[r] = msrc[r];
  }
  bool first_pass = true;   // the copies have not been waited for

  const int nc = ncols[s];
  const int gq = lane >> 2;   // the fragment's row of A and column of B
  const int tq = lane & 3;    // its row of 4 (k)
  const int n_at = (P + 1 + 7) / 8;   // 8-wide tiles of [X | m]
  double* mw = m_all + warp * 32;     // the warp's m [32]

  for (int64_t k0 = 0; k0 < count; k0 += kG) {
    const int gb = int(count - k0 < kG ? count - k0 : kG);
    const bool first_batch = k0 == 0;
    if (tid < gb) {
      rows_s[tid] = kCsr ? ys.y + int64_t(ys.pair_gene[first + k0 + tid]) * N
                         : ys.y;
    }
    __syncthreads();

    // step 2: the batch's tiles of [X | m]^T [X | y], one a pass over the
    // rows; a later batch skips the tiles of X^T X alone
    const int n_bt = (P + gb + 7) / 8;
    const int nt_lo = first_batch ? 0 : P / 8;
    int n_tiles = 0;
    for (int n = nt_lo; n < n_bt; ++n) {
      n_tiles += (n < n_at - 1 ? n : n_at - 1) + 1;
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      int mt, nt;
      tile_at(tile, nt_lo, n_at, &mt, &nt);
      double c[2] = {0.0, 0.0};
      int nu = 0;
      // one group of 32 rows, held in shared memory or read whole from
      // device memory
      auto group = [&](int64_t g0, bool held) {
        const int rows = N - g0 < 32 ? int(N - g0) : 32;
        const double* xg = held ? xs + g0 * P : Xs + g0 * P;
        bool used = false;
        if (lane < rows) {
          used = msrc == nullptr ||
                 (held ? ms[g0 + lane] : msrc[g0 + lane]) != 0;
        }
        mw[lane] = used ? 1.0 : 0.0;
        nu += __popc(__ballot_sync(0xffffffffu, used));
        __syncwarp();
        // the lane's column of A (X, then m) and of B (X, then y), found
        // here and not once per tile: hoisted, eqtl_ols took 1.13x as long
        // (tools/kernel_ab.py on an H100)
        const int ca = 8 * mt + gq;
        const int cb = 8 * nt + gq;
        const bool xa = ca < P;
        const bool xb = cb < P;
        const bool yb = !xb && cb - P < gb;
        const double* pa = xa ? xg + ca : mw;
        const int sa = xa ? P : 1;
        const double* pb = xb ? xg + cb : yb ? rows_s[cb - P] + g0 : mw;
        const int sb = xb ? P : 1;
        // the fragments of all eight products first, by selects: every lane
        // loads from a row that exists (clamped), and a lane outside the
        // group or the columns gives an exact 0
        double fa[8], fb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = 4 * i + tq;
          const bool in = k < rows;
          const int kk = in ? k : rows - 1;
          const double a = pa[kk * sa];
          const double b = pb[kk * sb];
          fa[i] = in && ca <= P ? a : 0.0;
          fb[i] = !in ? 0.0 : xb ? b : yb ? b * mw[kk] : 0.0;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) mma884(c, fa[i], fb[i]);
        __syncwarp();
      };
      // the groups past the held rows first (from device memory, while the
      // first pass's copies land), then the held ones: warp w takes groups
      // w, w + 8, ... of each
      for (int64_t g0 = R / 32 * 32 + 32 * warp; g0 < N; g0 += 32 * kWarps) {
        group(g0, false);
      }
      if (first_pass) {
        cp_async_wait<0>();
        __syncthreads();
        first_pass = false;
      }
      for (int64_t g0 = 32 * warp; g0 + 32 <= R; g0 += 32 * kWarps) {
        group(g0, true);
      }
      if (first_batch && tile == 0 && lane == 0) nu_s[warp] = nu;
      // the tile: C[gq][2 tq + i] of every warp, summed in warp order
      part[warp * 64 + gq * 8 + 2 * tq] = c[0];
      part[warp * 64 + gq * 8 + 2 * tq + 1] = c[1];
      __syncthreads();
      if (tid < 64) {
        double v = part[tid];
        for (int w = 1; w < kWarps; ++w) v = v + part[w * 64 + tid];
        const int i = 8 * mt + (tid >> 3);
        const int j = 8 * nt + (tid & 7);
        if (j < P) {
          if (first_batch && i <= j) {
            A[i * P + j] = v;
            A[j * P + i] = v;
          }
        } else if (j - P < gb) {
          if (i < P) {
            xty[(j - P) * P + i] = v;
          } else if (i == P) {
            sumy[j - P] = v;
          }
        }
      }
      __syncthreads();
    }

    // step 3: the inverse, once per snarl
    if (first_batch) {
      if (warp == 0) {
        if (lane == 0) {
          for (int i = 0; i < P; ++i) {
            A[i * P + i] = A[i * P + i] + (i < nc ? 0.0 : 1.0);
          }
          ldlt_factor(A, L, D, P);
          bad_s = rank_deficient(D, P, nc);
        }
        __syncwarp();
        // lane m solves against the unit vector m in V's row m
        for (int m = lane; m < P; m += 32) {
          double* x = V + m * P;
          for (int i = 0; i < P; ++i) x[i] = i == m ? 1.0 : 0.0;
          ldlt_solve(L, D, x, P);
          for (int i = 0; i < P; ++i) inv[i * P + m] = x[i];
        }
        __syncwarp();
        if (lane == 0 && bad_s) jacobi_pinv(A, L, inv, V, col, P);
      }
      __syncthreads();
    }
    int n_used_i = 0;
    for (int w = 0; w < kWarps; ++w) n_used_i += nu_s[w];
    const double n_used = double(n_used_i);
    // beta[g, i] = sum_m inv[i, m] X^T y_g[m], in m order as the plain
    // version sums it, one (gene, i) a thread
    for (int q = tid; q < gb * P; q += kThreads) {
      const int g = q / P;
      const int i = q - g * P;
      const double* xg = xty + g * P;
      double acc = 0.0;
      for (int m = 0; m < P; ++m) acc = acc + inv[i * P + m] * xg[m];
      beta[q] = acc;
    }
    if (tid < gb) mean[tid] = sumy[tid] / (n_used == 0.0 ? 1.0 : n_used);
    __syncthreads();

    // step 4: rss and tss over the rows, every thread a row at a time,
    // for kR of the batch's genes a pass
    for (int g0 = 0; g0 < gb; g0 += kR) {
      double rss[kR], tss[kR];
#pragma unroll
      for (int g = 0; g < kR; ++g) {
        rss[g] = 0.0;
        tss[g] = 0.0;
      }
      const double* bg = beta + g0 * P;
      for (int64_t n = tid; n < N; n += kThreads) {
        const bool held = n < R;
        const double* xr = held ? xs + n * P : Xs + n * P;
        const bool used = msrc == nullptr || (held ? ms[n] : msrc[n]) != 0;
        double pred[kR];
        const double x0 = xr[0];
#pragma unroll
        for (int g = 0; g < kR; ++g) pred[g] = x0 * bg[g * P];
        for (int t = 1; t < P; ++t) {
          const double xt = xr[t];
#pragma unroll
          for (int g = 0; g < kR; ++g) pred[g] = pred[g] + xt * bg[g * P + t];
        }
#pragma unroll
        for (int g = 0; g < kR; ++g) {
          if (g0 + g < gb) {
            // on a used row y = row * 1, the row's own value
            const double y = rows_s[g0 + g][n];
            const double resid = used ? y - pred[g] : 0.0;
            rss[g] = rss[g] + resid * resid;
            const double dev = y - mean[g0 + g];
            tss[g] = tss[g] + (used ? dev * dev : 0.0);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kR; ++g) {
        if (g0 + g < gb) {
          double r = rss[g], q = tss[g];
          for (int off = 16; off > 0; off >>= 1) {
            r = r + __shfl_xor_sync(0xffffffffu, r, off);
            q = q + __shfl_xor_sync(0xffffffffu, q, off);
          }
          if (lane == 0) {
            red[(warp * kG + g0 + g) * 2] = r;
            red[(warp * kG + g0 + g) * 2 + 1] = q;
          }
        }
      }
    }
    __syncthreads();
    if (tid < gb) {
      double r_sum = red[tid * 2], t_sum = red[tid * 2 + 1];
      for (int w = 1; w < kWarps; ++w) {
        r_sum = r_sum + red[(w * kG + tid) * 2];
        t_sum = t_sum + red[(w * kG + tid) * 2 + 1];
      }
      const double df = (n_used - double(nc)) + 1.0;
      const double df_res = df > 1.0 ? df : 1.0;
      const double mse = r_sum / df_res;
      const double beta1 = beta[tid * P + 1];
      const double se1 = sqrt(inv[1 * P + 1] * mse);
      const int64_t b = first + k0 + tid;
      out.t1[b] = beta1 / se1;
      out.df[b] = df_res;
      out.beta1[b] = beta1;
      out.se1[b] = se1;
      out.r2[b] = 1.0 - r_sum / t_sum;
    }
    __syncthreads();   // the batch's rows, sums and betas are done with
  }
}

// Scratch doubles per snarl: the algebra's, where it does not fit in
// shared memory, else none.
template <int kG>
__host__ int64_t work_doubles(int64_t P) {
  return plan<kG>(1, P, true).alg_smem ? 0 : alg_doubles<kG>(P);
}

// The kernel's signature: each source's __global__ kernel, instantiated for
// the algebra in shared memory (true) or in the scratch (false), runs
// ols_block with its own kG, kR and kCsr.
using Kernel = void (*)(const double*, const uint8_t*, const int32_t*, Rows,
                        double*, Out, int64_t, int, int64_t);

template <int kG>
__host__ int launch(Kernel in_smem, Kernel in_scratch, const double* X,
                    const uint8_t* mask, const int32_t* ncols, Rows ys,
                    double* work, Out out, int64_t S, int64_t N, int64_t P,
                    cudaStream_t stream) {
  if (P < 2) return int(cudaErrorInvalidValue);  // beta1 needs a column 1
  const Plan pl = plan<kG>(N, P, mask != nullptr);
  if (pl.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (S == 0) return int(cudaGetLastError());
  const Kernel kernel = pl.alg_smem ? in_smem : in_scratch;
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
  kernel<<<unsigned(S), kThreads, pl.smem, stream>>>(
      X, mask, ncols, ys, work, out, N, int(P), pl.R);
  return int(cudaGetLastError());
}

}  // namespace ob
}  // namespace stoat
