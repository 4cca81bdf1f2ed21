// K16b + K16c: the covariate-adjusted logistic score test of the binary
// permutation test with covariates (vcf -b -c --permutations).
//
// Replaces stoat_tpu/pipeline/permutation.py _score_precompute_jit
// (:193-197, body _score_test_precompute :155-190, _ldlt_ill :145-152) and
// _perm_score_pvalues (:200-214) up to its chi-squared tail.  Two entry
// points.  score_precompute, once per chunk, for snarl s with design X
// [N, PT], used rows, ncols, the reduced design Z [N, C1] and the working
// weights w [N]:
//
//   D       = X on the variant columns 1 <= t < ncols, 0 elsewhere
//   W       = w on the used rows, 0 elsewhere
//   G       = Z^T W Z;  L_g D_g L_g^T its LDL^T;  bad_g = ill(D_g)
//   V       = D^T W D - (D^T W Z) G^-1 (Z^T W D), plus 1 on the diagonal of
//             the other columns;  L_v D_v L_v^T its LDL^T
//   Vinv    = V^-1 by solves against the identity
//   df      = max(ncols - 1, 1)
//   allbad  = bad | bad_g | ill(D_v) | the sum of Vinv not finite
//             | ncols - 1 < 1
//   where ill(D) = min |D_j| <= 1e-10 max(max |D_j|, 1e-300), false when a
//   pivot is NaN (jnp.min and jnp.max propagate NaN);
//
// score_perm, for every phenotype residual row e_k [N]:
//
//   U = D^T (used e_k) [PT],  T[k, s] = U^T Vinv U
//
// The chi-squared tail of max(T, 0) on df (csrc/chi2_tail.cu) and the
// +inf of allbad or a non-finite T (torch ops) follow
// (pipeline/permutation.py).  The LDL^T
// is ldlt_device.cuh (Q2, K11), a zero pivot divided as 1.
//
// What bounds them on the card: score_precompute reads X and writes D
// (2 S N PT 8 bytes, 1.6 GB per chunk at S = 8,192, N = 2,504, PT = 5:
// 0.49 ms at 3.35 TB/s); score_perm does 2 N Pp flops per (k, s) (Pp = PT
// rounded up to 8), 3.3e11 per chunk at K = 1,001, 4.9 ms at the card's 67
// TFLOP/s float64 tensor-core peak.
// Design: score_precompute, one block per snarl, streams the rows through
// shared memory in tiles, writes D's rows, and sums the entries of D^T W D,
// D^T W Z and Z^T W Z, each thread owning entries and adding the tile's
// rows in order; thread 0 does the small algebra.  score_perm is the tile
// product of perm_gemm_device.cuh with A = D and Y = e: one block per group
// of G snarls x KT residual rows (the K tile fastest) forms U on the
// float64 tensor cores, and one thread per (snarl, row) forms T, reading
// V^-1 through the read-only cache.  The residual matrix is read from L2
// once per snarl group.
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

constexpr int kThreads = 128;
constexpr int kMaxTileRows = 128;
constexpr size_t kBudget = 44 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ bool ldlt_ill(const double* Dpiv, int n) {
  bool nan = false;
  double amax = 0.0, amin = INFINITY;
  for (int i = 0; i < n; ++i) {
    const double a = fabs(Dpiv[i]);
    if (isnan(a)) {
      nan = true;
    } else {
      amax = a > amax ? a : amax;
      amin = a < amin ? a : amin;
    }
  }
  amax = amax > 1e-300 ? amax : 1e-300;
  return !nan && amin <= 1e-10 * amax;
}

// scratch doubles per snarl of score_precompute
int64_t precompute_work(int64_t PT, int64_t C1) {
  return 2 * PT * PT + 2 * PT * C1 + 2 * C1 * C1 + C1 + PT
         + (PT > C1 ? PT : C1);
}

__global__ void score_precompute_kernel(
    const double* __restrict__ X, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ ncols, const uint8_t* __restrict__ bad,
    const double* __restrict__ Z, const double* __restrict__ w,
    double* __restrict__ work, double* __restrict__ D_out,
    double* __restrict__ vinv_out, double* __restrict__ df_out,
    uint8_t* __restrict__ allbad_out, int64_t N, int PT, int C1,
    int64_t work_stride, int TR) {
  extern __shared__ double smem[];
  double* xs = smem;                 // [TR * PT]
  double* zs = xs + TR * PT;         // [TR * C1]
  double* ws = zs + TR * C1;         // [TR] the weights on used rows

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const int nc = ncols[s];
  const double* Xs = X + s * N * PT;
  double* Ds = D_out + s * N * PT;
  const uint8_t* msrc = mask + s * N;
  double* Vf = work + s * work_stride;               // [PT, PT]
  double* Az = Vf + PT * PT;                          // [PT, C1]
  double* G = Az + PT * C1;                           // [C1, C1]
  double* Lg = G + C1 * C1;                           // [C1, C1]
  double* Dg = Lg + C1 * C1;                          // [C1]
  double* GinvAt = Dg + C1;                           // [C1, PT]
  double* Lv = GinvAt + C1 * PT;                      // [PT, PT]
  double* Dv = Lv + PT * PT;                          // [PT]
  double* col = Dv + PT;                              // [max(PT, C1)]
  double* vinv = vinv_out + s * PT * PT;

  // entries: D^T W D (upper triangle), D^T W Z, Z^T W Z (upper triangle)
  const int n_v = PT * (PT + 1) / 2;
  const int n_a = PT * C1;
  const int n_g = C1 * (C1 + 1) / 2;
  const int n_entries = n_v + n_a + n_g;
  auto upper = [](int q, int n, int& i, int& j) {
    i = 0;
    j = q;
    while (j >= n - i) {
      j -= n - i;
      ++i;
    }
    j += i;
  };
  auto vm = [&](int t) { return t >= 1 && t < nc ? 1.0 : 0.0; };
  for (int q = tid; q < n_entries; q += kThreads) {
    int i, j;
    if (q < n_v) {
      upper(q, PT, i, j);
      Vf[i * PT + j] = 0.0;
    } else if (q < n_v + n_a) {
      Az[q - n_v] = 0.0;
    } else {
      upper(q - n_v - n_a, C1, i, j);
      G[i * C1 + j] = 0.0;
    }
  }
  __syncthreads();
  for (int64_t n0 = 0; n0 < N; n0 += TR) {
    const int rows = int(N - n0 < TR ? N - n0 : TR);
    for (int e = tid; e < rows * PT; e += kThreads) {
      const double d = Xs[n0 * PT + e] * vm(e % PT);
      xs[e] = d;
      Ds[n0 * PT + e] = d;
    }
    for (int e = tid; e < rows * C1; e += kThreads) zs[e] = Z[n0 * C1 + e];
    for (int r = tid; r < rows; r += kThreads) {
      ws[r] = w[n0 + r] * (msrc[n0 + r] ? 1.0 : 0.0);
    }
    __syncthreads();
    for (int q = tid; q < n_entries; q += kThreads) {
      double acc = 0.0;
      int i, j;
      if (q < n_v) {
        upper(q, PT, i, j);
        for (int r = 0; r < rows; ++r) {
          acc = acc + xs[r * PT + i] * ws[r] * xs[r * PT + j];
        }
        Vf[i * PT + j] += acc;
      } else if (q < n_v + n_a) {
        i = (q - n_v) / C1;
        j = (q - n_v) % C1;
        for (int r = 0; r < rows; ++r) {
          acc = acc + xs[r * PT + i] * ws[r] * zs[r * C1 + j];
        }
        Az[q - n_v] += acc;
      } else {
        upper(q - n_v - n_a, C1, i, j);
        for (int r = 0; r < rows; ++r) {
          acc = acc + ws[r] * zs[r * C1 + i] * zs[r * C1 + j];
        }
        G[i * C1 + j] += acc;
      }
    }
    __syncthreads();
  }
  if (tid != 0) return;

  for (int i = 0; i < PT; ++i) {
    for (int j = i + 1; j < PT; ++j) Vf[j * PT + i] = Vf[i * PT + j];
  }
  for (int i = 0; i < C1; ++i) {
    for (int j = i + 1; j < C1; ++j) G[j * C1 + i] = G[i * C1 + j];
  }
  stoat::ldlt_factor(G, Lg, Dg, C1);
  const bool bad_g = ldlt_ill(Dg, C1);
  // G^-1 (D^T W Z)^T, one column of Z^T W D at a time
  for (int p = 0; p < PT; ++p) {
    for (int c = 0; c < C1; ++c) col[c] = Az[p * C1 + c];
    stoat::ldlt_solve(Lg, Dg, col, C1);
    for (int c = 0; c < C1; ++c) GinvAt[c * PT + p] = col[c];
  }
  // V, padded; Vf becomes V in place
  for (int p = 0; p < PT; ++p) {
    for (int q = 0; q < PT; ++q) {
      double acc = 0.0;
      for (int c = 0; c < C1; ++c) {
        acc = acc + Az[p * C1 + c] * GinvAt[c * PT + q];
      }
      Vf[p * PT + q] = Vf[p * PT + q] - acc;
    }
    Vf[p * PT + p] = Vf[p * PT + p] + (1.0 - vm(p));
  }
  stoat::ldlt_factor(Vf, Lv, Dv, PT);
  const bool bad_v = ldlt_ill(Dv, PT);
  double total = 0.0;
  for (int m = 0; m < PT; ++m) {
    for (int i = 0; i < PT; ++i) col[i] = i == m ? 1.0 : 0.0;
    stoat::ldlt_solve(Lv, Dv, col, PT);
    for (int i = 0; i < PT; ++i) {
      vinv[i * PT + m] = col[i];
      total = total + col[i];
    }
  }
  const double df = double(nc - 1);
  df_out[s] = df > 1.0 ? df : 1.0;
  allbad_out[s] =
      bad[s] || bad_g || bad_v || !isfinite(total) || df < 1.0 ? 1 : 0;
}

__global__ void __launch_bounds__(stoat::pg::kThreads, 2)
    score_perm_kernel(const double* __restrict__ D,
                      const uint8_t* __restrict__ mask,
                      const double* __restrict__ vinv,
                      const double* __restrict__ e,
                      double* __restrict__ T_out, stoat::pg::Tile t) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  double* U = reinterpret_cast<double*>(smem + t.off_c);
  const int tid = threadIdx.x;
  const int PT = t.P;
  int64_t s0, k0;
  stoat::pg::block_coords(t, &s0, &k0);

  // U = D^T (used e_k) as the tile product
  stoat::pg::product(t, smem, D, mask, e, s0, k0, U);
  __syncthreads();
  // T = U^T V^-1 U, one thread per (snarl, row), in the parent's order;
  // V^-1 through the read-only cache
  for (int x = tid; x < t.G * t.KT; x += stoat::pg::kThreads) {
    const int g = x % t.G;
    const int k = x / t.G;
    const int64_t s = s0 + g;
    if (s >= t.S || k0 + k >= t.K) continue;
    const double* u = U + g * t.Pp * t.CS + k;
    const double* Vi = vinv + s * PT * PT;
    double T = 0.0;
    for (int p = 0; p < PT; ++p) {
      double vu = 0.0;
      for (int q = 0; q < PT; ++q) {
        vu = vu + __ldg(Vi + p * PT + q) * u[q * t.CS];
      }
      T = T + u[p * t.CS] * vu;
    }
    T_out[(k0 + k) * t.S + s] = T;
  }
}

// rows per tile: as many as kBudget allows, at most
// kMaxTileRows, at least 16; 0 when even that exceeds the card's limit
int tile_rows(size_t per_row, size_t* smem) {
  int TR = kMaxTileRows;
  if (TR * per_row > kBudget) {
    TR = int(kBudget / per_row);
    if (TR < 16) TR = 16;
  }
  *smem = size_t(TR) * per_row;
  return *smem > kMaxSmem ? 0 : TR;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

extern "C" int score_precompute_launch(const void* X, const void* mask,
                                       const void* ncols, const void* bad,
                                       const void* Z, const void* w,
                                       void* work, void* D_out,
                                       void* vinv_out, void* df_out,
                                       void* allbad_out, int64_t S,
                                       int64_t N, int64_t PT, int64_t C1,
                                       int64_t work_stride, void* stream) {
  if (PT < 1 || C1 < 1 || work_stride < precompute_work(PT, C1)) {
    return int(cudaErrorInvalidValue);
  }
  if (S <= 0) return int(cudaGetLastError());
  size_t smem = 0;
  const int TR = tile_rows(size_t(PT + C1 + 1) * 8, &smem);
  if (TR == 0) return int(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(score_precompute_kernel, smem);
  if (err != cudaSuccess) return int(err);
  score_precompute_kernel<<<unsigned(S), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), static_cast<const uint8_t*>(bad),
      static_cast<const double*>(Z), static_cast<const double*>(w),
      static_cast<double*>(work), static_cast<double*>(D_out),
      static_cast<double*>(vinv_out), static_cast<double*>(df_out),
      static_cast<uint8_t*>(allbad_out), N, int(PT), int(C1), work_stride,
      TR);
  return int(cudaGetLastError());
}

extern "C" int score_perm_launch(const void* D, const void* mask,
                                 const void* vinv, const void* e,
                                 void* T_out, int64_t S, int64_t N,
                                 int64_t PT, int64_t K, void* stream) {
  if (PT < 1) return int(cudaErrorInvalidValue);
  if (S <= 0 || K <= 0) return int(cudaGetLastError());
  stoat::pg::Tile t;
  if (!stoat::pg::plan_tile(&t, S, N, PT, K, D, mask, e, nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem(score_perm_kernel, size_t(t.smem));
  if (err != cudaSuccess) return int(err);
  const int64_t groups = (S + t.G - 1) / t.G;
  score_perm_kernel<<<unsigned(groups * t.n_kt), stoat::pg::kThreads, t.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(D), static_cast<const uint8_t*>(mask),
      static_cast<const double*>(vinv), static_cast<const double*>(e),
      static_cast<double*>(T_out), t);
  return int(cudaGetLastError());
}

extern "C" const char* score_test_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
