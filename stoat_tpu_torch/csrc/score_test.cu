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
// is ldlt_device.cuh (Q2, K11), a zero pivot divided as 1.  The Gram's sums
// run on the tensor cores in another order than the plain version's, so
// V^-1 is held to it by a relative bound; D, df and allbad are exact.
//
// What bounds them on the card: score_precompute reads X and writes D
// (2 S N PT 8 bytes, 1.6 GB per chunk at S = 8,192, N = 2,504, PT = 5:
// 0.49 ms at 3.35 TB/s; its Gram, 2 S N (PT + C1)^2 flops, 0.04 ms on the
// float64 tensor cores); score_perm does 2 N Pp flops per (k, s) (Pp = PT
// rounded up to 8), 3.3e11 per chunk at K = 1,001, 4.9 ms at the card's 67
// TFLOP/s float64 tensor-core peak.
// Design: score_precompute takes a snarl a warp, 8 snarls a block.  The
// block streams tiles of RT rows (32 at PT = 5, C1 = 3) through a
// two-stage cp.async ring in shared memory, 16-byte copies where aligned:
// each warp its own snarl's X rows (contiguous, RT PT doubles), and the
// block once the rows of Z and w that its 8 warps share (the parent read
// them from L2 for every snarl).  A warp writes D = X x (1 or 0) back to
// the stage and to D_out (16-byte stores, bit for bit a product by 1.0 or
// 0.0), forms w x used for the tile's rows, and sums the upper 8 x 8 tiles
// of the Gram F = [D | Z]^T diag(w used) [D | Z] with mma.sync.m8n8k4
// float64, the A fragment the row times w used, two chains summed in a
// fixed order (rows past N and columns past PT + C1 an exact 0, never
// skipped: 0 x NaN); at PT + C1 = 8 F is one tile, wider designs loop over
// tiles.  F's entries are added tile after tile in the rows' order, then
// mirrored.  The algebra runs on the warp: lane 0 factors G = Z^T W Z and
// V, the PT solves for G^-1 Z^T W D and against the identity go one a
// lane, V one entry a lane, and the pivot tests and the sum of V^-1 are
// reduced by shuffles.  It works in shared memory (4 blocks an SM), or in
// the wrapper's per-snarl scratch where PT or C1 is too wide.  The step 0
// variants of the parent (tools/kernel_ab.py on an H100) put its time in
// the per-entry sums (36 of 128 threads busy) and thread 0's algebra.
// score_perm is the tile
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

using stoat::pg::cp_async16;
using stoat::pg::cp_async8;
using stoat::pg::cp_async_commit;
using stoat::pg::cp_async_wait;
using stoat::pg::mma884;

constexpr int kSpWarps = 8;   // score_precompute: a snarl a warp
constexpr int kSpThreads = kSpWarps * 32;
// at most 72 KB a block, three blocks an SM (3 (smem + 1 KB reserved)
// within the SM's 228 KB); tiles of 32 rows (36 KB at PT = 5, C1 = 3) run
// four, as many as 64 registers a thread allow, and took 0.757 ms a chunk
// against 0.809 at 64 rows (three) and 1.206 at 16 (tools/kernel_ab.py on
// an H100)
constexpr size_t kSpBudget = 72 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// doubles of a snarl's algebra (shared memory or the wrapper's scratch):
// the Gram F [Q, Q] of [D | Z], Q = PT + C1; G and L_g [C1, C1] and D_g
// [C1]; G^-1 Z^T W D, a row [C1] per column of D; V, L_v and V^-1's
// columns [PT, PT] each and D_v [PT]
__host__ __device__ int64_t precompute_work(int64_t PT, int64_t C1) {
  const int64_t Q = PT + C1;
  return Q * Q + 2 * C1 * C1 + C1 + PT * C1 + 3 * PT * PT + PT;
}

// score_precompute's geometry, planned on the host and passed by value;
// offsets in doubles of dynamic shared memory
struct SPlan {
  int64_t S, N, work_stride;
  int PT, C1, Q;
  int RT;             // rows a tile, a multiple of 8
  int n_tiles;        // 8 x 8 tiles of F's upper triangle
  int alg_smem;       // the algebra in shared memory (else the scratch)
  int off_z, off_w;   // in a stage: X [kSpWarps, RT, PT], Z [RT, C1], w [RT]
  int stage;          // doubles of a stage
  int off_wu, off_alg;
  int smem;           // bytes
};

bool plan_precompute(SPlan* pl, int64_t S, int64_t N, int64_t PT,
                     int64_t C1, int64_t work_stride) {
  pl->S = S;
  pl->N = N;
  pl->work_stride = work_stride;
  pl->PT = int(PT);
  pl->C1 = int(C1);
  pl->Q = int(PT + C1);
  const int nq = (pl->Q + 7) / 8;
  pl->n_tiles = nq * (nq + 1) / 2;
  const int64_t alg = precompute_work(PT, C1);
  // the largest tile of rows within the budget, the algebra in shared
  // memory if it can be; else 8 rows a tile within the card's limit
  for (int pass = 0; pass < 3; ++pass) {
    const int alg_smem = pass == 0 ? 1 : 0;
    const size_t limit = pass < 2 ? kSpBudget : kMaxSmem;
    for (int64_t RT = pass < 2 ? 32 : 8; RT >= 8; RT -= 8) {
      const int64_t stage = kSpWarps * RT * PT + RT * C1 + RT;
      const int64_t total = 2 * stage + kSpWarps * RT +
                            (alg_smem ? kSpWarps * alg : 0);
      if (size_t(total) * 8 <= limit) {
        pl->RT = int(RT);
        pl->alg_smem = alg_smem;
        pl->off_z = int(kSpWarps * RT * PT);
        pl->off_w = int(pl->off_z + RT * C1);
        pl->stage = int(stage);
        pl->off_wu = int(2 * stage);
        pl->off_alg = int(2 * stage + kSpWarps * RT);
        pl->smem = int(total * 8);
        return true;
      }
    }
  }
  return false;
}

// The pivot test of stoat_tpu's _ldlt_ill over a warp: some |D_j| <= 1e-10
// max(max |D_j|, 1e-300), false when a pivot is NaN (jnp.min and jnp.max
// propagate NaN)
__device__ bool warp_ill(const double* Dpiv, int n, int lane) {
  bool nan = false;
  double amax = 0.0, amin = INFINITY;
  for (int i = lane; i < n; i += 32) {
    const double a = fabs(Dpiv[i]);
    if (isnan(a)) {
      nan = true;
    } else {
      amax = a > amax ? a : amax;
      amin = a < amin ? a : amin;
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  for (int off = 16; off > 0; off >>= 1) {
    const double hi = __shfl_xor_sync(0xffffffffu, amax, off);
    const double lo = __shfl_xor_sync(0xffffffffu, amin, off);
    amax = hi > amax ? hi : amax;
    amin = lo < amin ? lo : amin;
  }
  amax = amax > 1e-300 ? amax : 1e-300;
  return !nan && amin <= 1e-10 * amax;
}

// the upper-triangle tile at index idx: (mt, nt), mt <= nt, nt outermost
__device__ inline void upper_tile(int idx, int* mt, int* nt) {
  int n = 0;
  while (idx > n) {
    idx -= n + 1;
    ++n;
  }
  *mt = idx;
  *nt = n;
}

__global__ void __launch_bounds__(kSpThreads) score_precompute_kernel(
    const double* __restrict__ X, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ ncols, const uint8_t* __restrict__ bad,
    const double* __restrict__ Z, const double* __restrict__ w,
    double* __restrict__ work, double* __restrict__ D_out,
    double* __restrict__ vinv_out, double* __restrict__ df_out,
    uint8_t* __restrict__ allbad_out, SPlan pl) {
  extern __shared__ __align__(16) double sp_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;   // the fragment's column of [D | Z]
  const int tq = lane & 3;    // its row of 4
  const int64_t s = int64_t(blockIdx.x) * kSpWarps + warp;
  const bool active = s < pl.S;
  const int64_t sa = active ? s : 0;
  const int64_t N = pl.N;
  const int PT = pl.PT, C1 = pl.C1, Q = pl.Q, RT = pl.RT;
  const int nc = ncols[sa];
  const double* Xs = X + sa * N * PT;
  double* Ds = D_out + sa * N * PT;
  const uint8_t* ms = mask + sa * N;
  double* F = pl.alg_smem
                  ? sp_smem + pl.off_alg + warp * precompute_work(PT, C1)
                  : work + sa * pl.work_stride;
  double* wu = sp_smem + pl.off_wu + warp * RT;   // [RT] w x used
  const bool vec_x =
      ((reinterpret_cast<uintptr_t>(Xs) | reinterpret_cast<uintptr_t>(Ds)) &
       15) == 0;
  const bool vec_z = (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  const bool vec_w = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto vm = [&](int t) { return t >= 1 && t < nc ? 1.0 : 0.0; };

  if (active) {
    for (int e = lane; e < Q * Q; e += 32) F[e] = 0.0;
  }

  // stage b: rows r0 .. r0 + RT of the warp's X (its own snarl) and of the
  // shared Z and w, 16-byte copies where aligned
  auto copy = [&](double* dst, const double* src, int64_t n, bool vec,
                  int first, int step) {
    if (vec) {
      for (int64_t e = 2 * first; e < n; e += 2 * step) {
        if (e + 1 < n) {
          cp_async16(dst + e, src + e, 16);
        } else {
          cp_async8(dst + e, src + e, 8);
        }
      }
    } else {
      for (int64_t e = first; e < n; e += step) cp_async8(dst + e, src + e, 8);
    }
  };
  auto stage = [&](int b, int64_t r0) {
    double* st = sp_smem + b * pl.stage;
    const int64_t rows = N - r0 < RT ? N - r0 : RT;
    if (active) {
      copy(st + warp * RT * PT, Xs + r0 * PT, rows * PT, vec_x, lane, 32);
    }
    copy(st + pl.off_z, Z + r0 * C1, rows * C1, vec_z, tid, kSpThreads);
    copy(st + pl.off_w, w + r0, rows, vec_w, tid, kSpThreads);
    cp_async_commit();
  };

  const int64_t n_rt = (N + RT - 1) / RT;
  if (n_rt > 0) stage(0, 0);
  for (int64_t it = 0; it < n_rt; ++it) {
    const int64_t r0 = it * RT;
    if (it + 1 < n_rt) {
      stage(int((it + 1) & 1), r0 + RT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      double* st = sp_smem + int(it & 1) * pl.stage;
      double* xs = st + warp * RT * PT;
      const double* zs = st + pl.off_z;
      const double* ws = st + pl.off_w;
      const int rows = int(N - r0 < RT ? N - r0 : RT);
      // D = X x (1 on the variant columns, 0 elsewhere): in the stage and
      // to D_out, 16-byte streaming stores where aligned (0.739 against
      // 0.760 ms a chunk with plain ones, tools/kernel_ab.py on an H100)
      const int n = rows * PT;
      double* dst = Ds + r0 * PT;
      if (vec_x) {
        for (int e = 2 * lane; e < n; e += 64) {
          if (e + 1 < n) {
            double2 v = *reinterpret_cast<double2*>(xs + e);
            v.x = v.x * vm(e % PT);
            v.y = v.y * vm((e + 1) % PT);
            *reinterpret_cast<double2*>(xs + e) = v;
            __stcs(reinterpret_cast<double2*>(dst + e), v);
          } else {
            const double d = xs[e] * vm(e % PT);
            xs[e] = d;
            dst[e] = d;
          }
        }
      } else {
        for (int e = lane; e < n; e += 32) {
          const double d = xs[e] * vm(e % PT);
          xs[e] = d;
          dst[e] = d;
        }
      }
      for (int r = lane; r < RT; r += 32) {
        wu[r] = r < rows ? ws[r] * (ms[r0 + r] ? 1.0 : 0.0) : 0.0;
      }
      __syncwarp();
      // the upper tiles of F += [D | Z]^T diag(wu) [D | Z] over the tile's
      // rows, on the float64 tensor cores: two chains of m8n8k4, summed in a
      // fixed order; rows past N and columns past Q give an exact 0
      for (int tile = 0; tile < pl.n_tiles; ++tile) {
        int mt, nt;
        upper_tile(tile, &mt, &nt);
        const int ca = 8 * mt + gq;
        const int cb = 8 * nt + gq;
        const double* pa = ca < PT ? xs + ca : zs + (ca - PT);
        const double* pb = cb < PT ? xs + cb : zs + (cb - PT);
        int sa_ = ca < PT ? PT : C1;
        int sb_ = cb < PT ? PT : C1;
        if (ca >= Q) {
          pa = xs;
          sa_ = 0;
        }
        if (cb >= Q) {
          pb = xs;
          sb_ = 0;
        }
        double c0[2] = {0.0, 0.0}, c1[2] = {0.0, 0.0};
        for (int k = 0; k < RT; k += 8) {
          const int r = k + tq;
          const int r4 = r + 4;
          const double a0 = pa[r * sa_], b0 = pb[r * sb_];
          const double a1 = pa[r4 * sa_], b1 = pb[r4 * sb_];
          const double fa0 = r < rows && ca < Q ? a0 * wu[r] : 0.0;
          const double fb0 = r < rows && cb < Q ? b0 : 0.0;
          const double fa1 = r4 < rows && ca < Q ? a1 * wu[r4] : 0.0;
          const double fb1 = r4 < rows && cb < Q ? b1 : 0.0;
          mma884(c0, fa0, fb0);
          mma884(c1, fa1, fb1);
        }
        // C[gq][2 tq + e] of the tile, the upper entries
        const int i = 8 * mt + gq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * tq + e;
          if (i < Q && j < Q && i <= j) F[i * Q + j] += c0[e] + c1[e];
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  __syncwarp();

  // the algebra, spread over the warp
  double* Gm = F + Q * Q;       // [C1, C1]
  double* Lg = Gm + C1 * C1;    // [C1, C1]
  double* Dg = Lg + C1 * C1;    // [C1]
  double* GA = Dg + C1;         // [PT, C1]: G^-1 (Z^T W D)[:, p] in row p
  double* V = GA + PT * C1;     // [PT, PT]
  double* Lv = V + PT * PT;     // [PT, PT]
  double* Dv = Lv + PT * PT;    // [PT]
  double* VT = Dv + PT;         // [PT, PT]: V^-1 e_m in row m
  for (int e = lane; e < Q * Q; e += 32) {
    const int i = e / Q;
    const int j = e - i * Q;
    if (i > j) F[e] = F[j * Q + i];
  }
  __syncwarp();
  for (int e = lane; e < C1 * C1; e += 32) {
    Gm[e] = F[(PT + e / C1) * Q + PT + e % C1];
  }
  for (int e = lane; e < PT * PT; e += 32) V[e] = F[(e / PT) * Q + e % PT];
  __syncwarp();
  if (lane == 0) stoat::ldlt_factor(Gm, Lg, Dg, C1);
  __syncwarp();
  const bool bad_g = warp_ill(Dg, C1, lane);
  // G^-1 (D^T W Z)^T, a column of Z^T W D a lane
  for (int p = lane; p < PT; p += 32) {
    double* x = GA + p * C1;
    for (int c = 0; c < C1; ++c) x[c] = F[p * Q + PT + c];
    stoat::ldlt_solve(Lg, Dg, x, C1);
  }
  __syncwarp();
  // V, padded, an entry a lane
  for (int e = lane; e < PT * PT; e += 32) {
    const int p = e / PT;
    const int q = e - p * PT;
    double acc = 0.0;
    for (int c = 0; c < C1; ++c) {
      acc = acc + F[p * Q + PT + c] * GA[q * C1 + c];
    }
    double v = V[e] - acc;
    if (p == q) v = v + (1.0 - vm(p));
    V[e] = v;
  }
  __syncwarp();
  if (lane == 0) stoat::ldlt_factor(V, Lv, Dv, PT);
  __syncwarp();
  const bool bad_v = warp_ill(Dv, PT, lane);
  // V^-1 by solves against the identity, a column a lane
  double total = 0.0;
  for (int m = lane; m < PT; m += 32) {
    double* x = VT + m * PT;
    for (int i = 0; i < PT; ++i) x[i] = i == m ? 1.0 : 0.0;
    stoat::ldlt_solve(Lv, Dv, x, PT);
    for (int i = 0; i < PT; ++i) total = total + x[i];
  }
  __syncwarp();
  double* vinv = vinv_out + s * PT * PT;
  for (int e = lane; e < PT * PT; e += 32) {
    vinv[e] = VT[(e % PT) * PT + e / PT];
  }
  for (int off = 16; off > 0; off >>= 1) {
    total = total + __shfl_xor_sync(0xffffffffu, total, off);
  }
  if (lane == 0) {
    const double df = double(nc - 1);
    df_out[s] = df > 1.0 ? df : 1.0;
    allbad_out[s] =
        bad[s] || bad_g || bad_v || !isfinite(total) || df < 1.0 ? 1 : 0;
  }
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
  if (PT < 1 || C1 < 1 || N < 0 || work_stride < precompute_work(PT, C1)) {
    return int(cudaErrorInvalidValue);
  }
  if (S <= 0) return int(cudaGetLastError());
  SPlan pl;
  if (!plan_precompute(&pl, S, N, PT, C1, work_stride)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem(score_precompute_kernel,
                                     size_t(pl.smem));
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = (S + kSpWarps - 1) / kSpWarps;
  score_precompute_kernel<<<unsigned(blocks), kSpThreads, pl.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), static_cast<const uint8_t*>(bad),
      static_cast<const double*>(Z), static_cast<const double*>(w),
      static_cast<double*>(work), static_cast<double*>(D_out),
      static_cast<double*>(vinv_out), static_cast<double*>(df_out),
      static_cast<uint8_t*>(allbad_out), pl);
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
