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
// What bounds it on the card: float64 operations.  Per (k, s) X^T y and
// the residual each take 2 N Pp multiply-adds: 6.6e11 padded flops per
// chunk at K = 1,001, S = 8,192, N = 2,504, P = 7 (Pp = 8), 9.8 ms at the
// card's 67 TFLOP/s float64 tensor-core peak.  Its bytes are X once (1.15
// GB, 0.34 ms at 3.35 TB/s), the K x N phenotypes and 16 bytes per (k, s).
// Design: two kernels.  perm_ols_inverse, one warp per snarl, sums X^T X
// as m8n8k4 float64 tensor-core tiles over all 32 lanes (X read once) and
// the used rows by a shuffle tree; lane 0 inverts (normal_inverse,
// unchanged) and writes inv and df_res into the scratch.  perm_ols_main,
// one block per group of G snarls x KT phenotype rows (the K tile
// fastest, perm_gemm_device.cuh): pass A is the tile product X^T Y, its
// epilogue beta = inv X^T y into shared memory; pass B sweeps the samples
// again, forms pred = X_s beta_s as mmas of depth Pp, and sums resid^2 =
// (used ? y - pred : 0)^2 in registers (the residuals themselves, never
// y^T y - beta^T X^T y, which cancels as R^2 -> 1), then a fixed shuffle
// tree.  Pass B is bound by reading y from shared memory, once per (snarl,
// sample, row): for Pp <= 32 the phenotype rows are its m16 dimension, so
// beta^T stays in registers as the A fragments and y is read in 16-byte
// pairs (pass_b_rows); wider designs read beta from shared memory
// (pass_b_generic).  The phenotype matrix is read from L2 twice per snarl
// group instead of twice per snarl.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "ols_device.cuh"
#include "perm_gemm_device.cuh"

namespace {

using stoat::pg::kThreads;
using stoat::pg::kWarps;
using stoat::pg::Stage;
using stoat::pg::Tile;

constexpr int kInvWarps = 4;

// scratch doubles per snarl: X^T X, its factor, the inverse and Jacobi's
// V (P x P each), D and a solve column (P each), df_res
__host__ __device__ inline int64_t work_stride(int64_t P) {
  return 4 * P * P + 2 * P + 1;
}

__global__ void __launch_bounds__(kInvWarps * 32)
    perm_ols_inverse_kernel(const double* __restrict__ X,
                            const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ ncols,
                            double* __restrict__ work, int64_t S, int64_t N,
                            int P) {
  const int lane = threadIdx.x % 32;
  const int64_t s = int64_t(blockIdx.x) * kInvWarps + threadIdx.x / 32;
  if (s >= S) return;
  const double* Xs = X + s * N * P;
  double* A = work + s * work_stride(P);
  double* L = A + P * P;
  double* inv = L + P * P;
  double* V = inv + P * P;
  double* D = V + P * P;
  double* col = D + P;
  double* df_out = col + P;

  // the upper 8 x 8 tiles of X^T X: lane (r, q) holds A[n][ti 8 + r] and
  // X[n][tj 8 + r] of sample n = n0 + q
  const int nb = (P + 7) / 8;
  const int r = lane / 4;
  const int q = lane % 4;
  for (int ti = 0; ti < nb; ++ti) {
    for (int tj = ti; tj < nb; ++tj) {
      const int pa = ti * 8 + r;
      const int pb = tj * 8 + r;
      double c[2] = {0.0, 0.0};
#pragma unroll 4
      for (int64_t n0 = 0; n0 < N; n0 += 4) {
        const int64_t n = n0 + q;
        const bool in = n < N;
        const double a = in && pa < P ? Xs[n * P + pa] : 0.0;
        const double b = in && pb < P ? Xs[n * P + pb] : 0.0;
        stoat::pg::mma884(c, a, b);
      }
      for (int e = 0; e < 2; ++e) {
        const int j = tj * 8 + 2 * q + e;
        if (pa < P && j < P && j >= pa) A[pa * P + j] = c[e];
      }
    }
  }
  double used = 0.0;
  for (int64_t n = lane; n < N; n += 32) {
    used = used + (mask[s * N + n] ? 1.0 : 0.0);
  }
  for (int off = 16; off > 0; off >>= 1) {
    used = used + __shfl_xor_sync(0xffffffffu, used, off);
  }
  __syncwarp();
  if (lane != 0) return;
  const int nc = ncols[s];
  for (int i = 0; i < P; ++i) {
    A[i * P + i] = A[i * P + i] + (i < nc ? 0.0 : 1.0);
    for (int j = i + 1; j < P; ++j) A[j * P + i] = A[i * P + j];
  }
  stoat::normal_inverse(A, L, inv, V, D, col, P, nc);
  const double df = (used - double(nc)) + 1.0;
  df_out[0] = df > 1.0 ? df : 1.0;
}

// shared memory of perm_ols_main after the product tile: beta [R, CS] and
// the residual sums [kWarps, KT]
size_t main_extra(const Tile& t) {
  return (size_t(t.R) * t.CS + size_t(kWarps) * t.KT) * 8;
}

// Pass B for Pp = 8 kKS <= 32 at KT = 64 (G = 8, 4, 2, 2): the rows of the
// product are the phenotypes, pred^T [k, n] = beta^T [k, p] X^T [p, n] as
// m16n8k8 mmas with beta^T as the A fragments, held in registers for the
// whole sweep.  Warp w takes snarl g = w % G and the kMPW row blocks of 16
// from (w / G) kMPW; each lane sums resid^2 of its two rows over its two
// samples of every block of 8, then over the 4 lanes of a row.  Writes
// rss[g KT + k].
template <int kKS>
__device__ __forceinline__ void pass_b_rows(const Tile& t, char* smem,
                                            const double* __restrict__ X,
                                            const uint8_t* __restrict__ mask,
                                            const double* __restrict__ phenos,
                                            int64_t s0, int64_t k0,
                                            const double* beta, double* rss) {
  constexpr int kMPW = 4 / kKS;
  const int warp = threadIdx.x / 32;
  const int gid = threadIdx.x % 32 / 4;
  const int tig = threadIdx.x % 4;
  const int g = warp % t.G;
  const int mb0 = warp / t.G * kMPW;
  const int P = t.P;
  double ba[kMPW][kKS][4];
#pragma unroll
  for (int i = 0; i < kMPW; ++i) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const double* b = beta + (g * t.Pp + ks * 8 + tig) * t.CS
                        + (mb0 + i) * 16 + gid;
      ba[i][ks][0] = b[0];
      ba[i][ks][1] = b[8];
      ba[i][ks][2] = b[4 * t.CS];
      ba[i][ks][3] = b[4 * t.CS + 8];
    }
  }
  // row k = (mb0 + i) 16 + gid + 8 h of the Y stage; its swizzle depends
  // on gid alone
  double acc_rss[kMPW][2];
  int y_row[kMPW][2];
#pragma unroll
  for (int i = 0; i < kMPW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc_rss[i][h] = 0.0;
      y_row[i][h] = ((mb0 + i) * 16 + gid + 8 * h) * t.YS;
    }
  }
  const int sw = stoat::pg::y_swz(t, gid);
  const int n_nb = t.nt / 8;
  stoat::pg::sweep(t, smem, X, mask, phenos, s0, k0, [&](const Stage& st) {
    for (int nb = 0; nb < n_nb; ++nb) {
      const int n = nb * 8 + gid;
      const double* xrow = st.xs + g * t.XS + n * P;
      double bx[kKS][2];
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int p = ks * 8 + tig;
        bx[ks][0] = p < P ? xrow[p] : 0.0;
        bx[ks][1] = p + 4 < P ? xrow[p + 4] : 0.0;
      }
      const int nc = nb * 8 + 2 * tig;
      const bool used0 = st.ms[g * t.nt + nc] != 0;
      const bool used1 = st.ms[g * t.nt + nc + 1] != 0;
      const int y_unit = ((nc >> 1) ^ sw) << 1;
#pragma unroll
      for (int i = 0; i < kMPW; ++i) {
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          stoat::pg::mma16808(acc, ba[i][ks], bx[ks]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double2 y = *reinterpret_cast<const double2*>(
              st.ys + y_row[i][h] + y_unit);
          const double r0 = used0 ? y.x - acc[2 * h] : 0.0;
          const double r1 = used1 ? y.y - acc[2 * h + 1] : 0.0;
          acc_rss[i][h] = acc_rss[i][h] + r0 * r0;
          acc_rss[i][h] = acc_rss[i][h] + r1 * r1;
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < kMPW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double v = acc_rss[i][h];
      v = v + __shfl_xor_sync(0xffffffffu, v, 1);
      v = v + __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) rss[g * t.KT + (mb0 + i) * 16 + gid + 8 * h] = v;
    }
  }
}

// Pass B for any Pp, KT and nt: pred [n, k] = X [n, p] beta [p, k] as
// m8n8k4 mmas with beta read from shared memory.  Warp w takes snarl g =
// w % G, the n-blocks of its share ns and the sample blocks mb0, mb0 +
// step, ...; each lane sums resid^2 of its two phenotypes over its rows,
// then over the 8 lanes of a column.  Writes red[w KT + k]; the warps of
// one (g, ns) are summed in warp order by the caller.
struct Split {
  int ns_count, nbc, mb_step;
};

__device__ inline Split generic_split(const Tile& t) {
  const int n_nb = t.KT / 8;
  const int n_mb = t.nt / 8;
  int ns_count = 8 / (t.G * n_mb);
  if (ns_count < 1) ns_count = 1;
  if (ns_count > n_nb) ns_count = n_nb;
  return {ns_count, n_nb / ns_count, kWarps / (t.G * ns_count)};
}

__device__ __forceinline__ void pass_b_generic(
    const Tile& t, char* smem, const double* __restrict__ X,
    const uint8_t* __restrict__ mask, const double* __restrict__ phenos,
    int64_t s0, int64_t k0, const double* beta, double* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Split sp = generic_split(t);
  const int n_mb = t.nt / 8;
  const int g = warp % t.G;
  const int ns = (warp / t.G) % sp.ns_count;
  const int mb0 = warp / (t.G * sp.ns_count);
  const int nb0 = ns * sp.nbc;
  const int ksteps = t.Pp / 4;
  const int P = t.P;
  double rss[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) rss[j][0] = rss[j][1] = 0.0;
  stoat::pg::sweep(t, smem, X, mask, phenos, s0, k0, [&](const Stage& st) {
    for (int mb = mb0; mb < n_mb; mb += sp.mb_step) {
      const int n = mb * 8 + lane / 4;
      const double* xrow = st.xs + g * t.XS + n * P;
      double acc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int p = ks * 4 + lane % 4;
        const double a = p < P ? xrow[p] : 0.0;
        const double* brow = beta + (g * t.Pp + p) * t.CS + nb0 * 8 + lane / 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < sp.nbc) stoat::pg::mma884(acc[j], a, brow[j * 8]);
        }
      }
      const bool used = st.ms[g * t.nt + n] != 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= sp.nbc) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = (nb0 + j) * 8 + 2 * (lane % 4) + e;
          const double y = st.ys[stoat::pg::y_index(t, k, n)];
          const double resid = used ? y - acc[j][e] : 0.0;
          rss[j][e] = rss[j][e] + resid * resid;
        }
      }
    }
  });
  // over the 8 sample rows of a fragment (lanes with equal lane % 4)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      for (int off = 4; off < 32; off <<= 1) {
        rss[j][e] = rss[j][e] + __shfl_xor_sync(0xffffffffu, rss[j][e], off);
      }
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= sp.nbc) continue;
      const int k = (nb0 + j) * 8 + 2 * lane;
      red[warp * t.KT + k] = rss[j][0];
      red[warp * t.KT + k + 1] = rss[j][1];
    }
  }
}

// kRows: pass_b_rows<kRows> (Pp = 8 kRows), or pass_b_generic for 0
template <int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    perm_ols_main_kernel(const double* __restrict__ X,
                         const uint8_t* __restrict__ mask,
                         const double* __restrict__ phenos,
                         const double* __restrict__ work,
                         double* __restrict__ t1_out,
                         double* __restrict__ df_out, Tile t) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  double* C = reinterpret_cast<double*>(smem + t.off_c);
  double* beta = reinterpret_cast<double*>(smem + t.off_extra);
  double* red = beta + t.R * t.CS;
  const int tid = threadIdx.x;
  const int P = t.P;
  const int64_t stride = work_stride(P);
  int64_t s0, k0;
  stoat::pg::block_coords(t, &s0, &k0);

  // pass A: X^T Y, then beta = inv X^T y per (snarl, row), m in order
  stoat::pg::product(t, smem, X, mask, phenos, s0, k0, C);
  __syncthreads();
  for (int e = tid; e < t.R * t.KT; e += kThreads) {
    const int r = e / t.KT;
    const int k = e - r * t.KT;
    const int g = r / t.Pp;
    const int i = r - g * t.Pp;
    const int64_t s = s0 + g;
    double acc = 0.0;
    if (i < P && s < t.S) {
      const double* inv = work + s * stride + 2 * P * P;
      const double* xty = C + g * t.Pp * t.CS + k;
      for (int m = 0; m < P; ++m) acc = acc + inv[i * P + m] * xty[m * t.CS];
    }
    beta[r * t.CS + k] = acc;
  }
  __syncthreads();

  // pass B: the residual sums of squares
  if constexpr (kRows > 0) {
    pass_b_rows<kRows>(t, smem, X, mask, phenos, s0, k0, beta, red);
  } else {
    pass_b_generic(t, smem, X, mask, phenos, s0, k0, beta, red);
  }
  __syncthreads();

  // t1 per (snarl, row)
  const Split sp = generic_split(t);
  for (int e = tid; e < t.G * t.KT; e += kThreads) {
    const int gg = e % t.G;
    const int k = e / t.G;
    const int64_t s = s0 + gg;
    if (s >= t.S || k0 + k >= t.K) continue;
    double r_sum = 0.0;
    if (kRows > 0) {
      r_sum = red[gg * t.KT + k];
    } else {
      const int w0 = gg + t.G * ((k / 8) / sp.nbc);
      for (int m = 0; m < sp.mb_step; ++m) {
        r_sum = r_sum + red[(w0 + m * t.G * sp.ns_count) * t.KT + k];
      }
    }
    const double* ws = work + s * stride;
    const double df_res = ws[stride - 1];
    const double mse = r_sum / df_res;
    const double beta1 = beta[(gg * t.Pp + 1) * t.CS + k];
    const double se1 = sqrt(ws[2 * P * P + 1 * P + 1] * mse);
    t1_out[(k0 + k) * t.S + s] = beta1 / se1;
    df_out[(k0 + k) * t.S + s] = df_res;
  }
}

// pass_b_rows takes Pp <= 32 at KT = 64 (nt = 32, the Y stage swizzled)
template <int kRows>
cudaError_t launch_main(const Tile& t, cudaStream_t st, const void* X,
                        const void* mask, const void* phenos, void* work,
                        void* t1_out, void* df_out) {
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        perm_ols_main_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t groups = (t.S + t.G - 1) / t.G;
  perm_ols_main_kernel<kRows><<<unsigned(groups * t.n_kt), kThreads, t.smem,
                                st>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const double*>(phenos), static_cast<const double*>(work),
      static_cast<double*>(t1_out), static_cast<double*>(df_out), t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int perm_ols_launch(const void* X, const void* mask,
                               const void* ncols, const void* phenos,
                               void* work, void* t1_out, void* df_out,
                               int64_t S, int64_t N, int64_t P, int64_t K,
                               void* stream) {
  if (P < 2) return int(cudaErrorInvalidValue);  // beta1 needs a column 1
  if (S <= 0 || K <= 0) return int(cudaGetLastError());
  Tile t;
  if (!stoat::pg::plan_tile(&t, S, N, P, K, X, mask, phenos, main_extra)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  perm_ols_inverse_kernel<<<unsigned((S + kInvWarps - 1) / kInvWarps),
                            kInvWarps * 32, 0, st>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), static_cast<double*>(work), S, N,
      int(P));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const bool rows = t.KT == 64 && t.Pp <= 32;
  switch (rows ? t.Pp / 8 : 0) {
    case 1:
      return int(launch_main<1>(t, st, X, mask, phenos, work, t1_out, df_out));
    case 2:
      return int(launch_main<2>(t, st, X, mask, phenos, work, t1_out, df_out));
    case 3:
      return int(launch_main<3>(t, st, X, mask, phenos, work, t1_out, df_out));
    case 4:
      return int(launch_main<4>(t, st, X, mask, phenos, work, t1_out, df_out));
    default:
      return int(launch_main<0>(t, st, X, mask, phenos, work, t1_out, df_out));
  }
}

extern "C" const char* perm_ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
