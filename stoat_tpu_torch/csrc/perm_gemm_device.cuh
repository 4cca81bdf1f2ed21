// The tile product of the permutation kernels, on the float64 tensor cores:
// shared by perm_ols.cu (K16a) and score_test.cu's score_perm (K16c).
//
// For G snarls s0 .. s0 + G - 1 and KT phenotype (residual) rows k0 ..
// k0 + KT - 1 one block computes
//
//   C[g Pp + p, k] = sum_n A_s[n, p] Y[k0 + k, n],   s = s0 + g, p < P
//
// with A [S, N, P] the designs (rows of unused samples zero), masked by
// used [S, N] as the tile is read, and Y [K, N] unmasked: the product of
// stoat_tpu's A^T (y_k * used), 0 x NaN = NaN included.  Pp is P rounded
// up to 8, so one block of 8 rows holds one snarl's columns when P <= 8.
//
// What bounds it on the card: float64 operations, 2 S K N Pp per product,
// at the H100's 67 TFLOP/s float64 tensor-core peak (mma.sync; wgmma has
// no float64); the [K, N] Y matrix (20 MB at K = 1,001, N = 2,504) stays in
// the 50 MB L2.  Design: mma.sync.m16n8k8 float64 (sm_90; score_perm
// took 1.19x as long with m8n8k4 on an H100, tools/kernel_ab.py), each
// warp a 32 x 16 tile (2 x 2 blocks of 16 x 8) accumulated in registers
// over every sample; the samples in steps of nt through a two-stage
// cp.async ring in shared
// memory (the G snarls' [nt, P] slices of A, contiguous per snarl, the
// [KT, nt] slice of Y, swizzled, and the G x nt mask bytes; 16-byte copies
// where the source is 16-byte aligned, else 8-byte ones; ragged edges
// zero-filled).  Once a stage has landed, the rows of unused samples in
// the A slices are zeroed there, so the fragment loop reads no mask.
// Blocks are ordered with the K tile fastest, so the K tiles of one snarl
// group run together and read its A from L2.  Every sum has a fixed order:
// no atomics.  The tensor cores fuse each multiply-add whatever -fmad
// says.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stoat {
namespace pg {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 227 * 1024;

// The block's geometry, planned on the host (plan_tile) and passed by value.
struct Tile {
  int64_t S, N, K;
  int P;        // design columns
  int Pp;       // P rounded up to 8
  int G;        // snarls per block: 64 / Pp rounded down to a power of two
  int R;        // product rows, G Pp
  int KT;       // phenotype rows per block: 64, or 16 for wide designs
  int nt;       // samples per stage: 32, or 8 for wide designs
  int XS;       // doubles of one snarl's slice in a stage, nt P
  int YS;       // row stride of the Y stage: nt, or nt + 4 at nt = 8
  int swz;      // the Y stage's 16-byte units swizzled (nt = 32)
  int CS;       // row stride of the product tile, KT + 4
  int n_kt;     // K tiles
  int vec_x;    // 16-byte copies of A (N P even, 16-byte aligned)
  int vec_y;    // 16-byte copies of Y (N even, 16-byte aligned)
  int vec_m;    // 4-byte copies of the mask (N % 4 == 0, aligned)
  // byte offsets in dynamic shared memory: the two stages of A, Y and the
  // mask, the product tile C (inside the ring when one pass covers it),
  // the kernel's own region, and the total
  int off_y, off_m, off_c, off_extra;
  int smem;
};

__device__ __forceinline__ void mma884(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(c[0]), "=d"(c[1])
      : "d"(a), "d"(b), "d"(c[0]), "d"(c[1]));
}

__device__ __forceinline__ void mma16808(double (&c)[4], const double (&a)[4],
                                         const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=d"(c[0]), "=d"(c[1]), "=d"(c[2]), "=d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]),
        "d"(c[0]), "d"(c[1]), "d"(c[2]), "d"(c[3]));
}

// Where Y[k][n] of a stage lies: with swz, the 16-byte unit n / 2 of row k
// is stored at unit (n / 2) ^ s(k), s(k) = 4 (k & 1) + (k & 2), so that
// the product's B fragments (rows k..k+3, samples n..n+3) and pass B's
// pairs (rows k, k+1, samples n..n+7) hit 16 different banks.
__device__ __forceinline__ int y_swz(const Tile& t, int k) {
  return t.swz ? ((k & 1) << 2) | (k & 2) : 0;
}

__device__ __forceinline__ int y_index(const Tile& t, int k, int n) {
  return k * t.YS + ((((n >> 1) ^ y_swz(t, k))) << 1) + (n & 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16, 8 or 4) with the first `src_bytes` from global
// memory and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One stage's buffers (b = 0, 1) inside the ring.
struct Stage {
  double* xs;     // [G, XS]
  double* ys;     // [KT, YS]
  uint8_t* ms;    // [G, nt]
};

__device__ __forceinline__ Stage stage_of(const Tile& t, char* smem, int b) {
  Stage st;
  st.xs = reinterpret_cast<double*>(smem) + b * t.G * t.XS;
  st.ys = reinterpret_cast<double*>(smem + t.off_y) + b * t.KT * t.YS;
  st.ms = reinterpret_cast<uint8_t*>(smem + t.off_m) + b * t.G * t.nt;
  return st;
}

// Start the copies of the stage of samples n0 .. n0 + nt - 1; what lies
// beyond N, S or K is zero-filled.  A mask that cp.async cannot copy (N
// not a multiple of 4) is loaded by the threads themselves.
__device__ inline void load_stage(const Tile& t, Stage st,
                                  const double* __restrict__ A,
                                  const uint8_t* __restrict__ mask,
                                  const double* __restrict__ Y, int64_t s0,
                                  int64_t k0, int64_t n0) {
  const int tid = threadIdx.x;
  const int rows = int(t.N - n0 < t.nt ? t.N - n0 : t.nt);
  const int P = t.P;
  if (t.vec_x) {
    const int per = t.XS / 2;
    for (int c = tid; c < t.G * per; c += kThreads) {
      const int g = c / per;
      const int e = 2 * (c - g * per);
      const int64_t s = s0 + g;
      const int avail = s < t.S ? rows * P - e : 0;
      const int bytes = avail >= 2 ? 16 : (avail == 1 ? 8 : 0);
      const double* src = bytes ? A + (s * t.N + n0) * P + e : A;
      cp_async16(st.xs + g * t.XS + e, src, bytes);
    }
  } else {
    for (int c = tid; c < t.G * t.XS; c += kThreads) {
      const int g = c / t.XS;
      const int e = c - g * t.XS;
      const int64_t s = s0 + g;
      const bool ok = s < t.S && e < rows * P;
      cp_async8(st.xs + c, ok ? A + (s * t.N + n0) * P + e : A, ok ? 8 : 0);
    }
  }
  if (t.vec_y) {
    const int per = t.nt / 2;
    for (int c = tid; c < t.KT * per; c += kThreads) {
      const int kk = c / per;
      const int e = 2 * (c - kk * per);
      const int64_t k = k0 + kk;
      const int avail = k < t.K ? rows - e : 0;
      const int bytes = avail >= 2 ? 16 : (avail == 1 ? 8 : 0);
      const double* src = bytes ? Y + k * t.N + n0 + e : Y;
      cp_async16(st.ys + y_index(t, kk, e), src, bytes);
    }
  } else {
    for (int c = tid; c < t.KT * t.nt; c += kThreads) {
      const int kk = c / t.nt;
      const int e = c - kk * t.nt;
      const int64_t k = k0 + kk;
      const bool ok = k < t.K && e < rows;
      cp_async8(st.ys + y_index(t, kk, e), ok ? Y + k * t.N + n0 + e : Y,
                ok ? 8 : 0);
    }
  }
  if (t.vec_m) {
    // N and n0 are multiples of 4, so a word is all in or all out
    const int per = t.nt / 4;
    for (int c = tid; c < t.G * per; c += kThreads) {
      const int g = c / per;
      const int e = 4 * (c - g * per);
      const int64_t s = s0 + g;
      const bool ok = s < t.S && e < rows;
      cp_async4(st.ms + g * t.nt + e, ok ? mask + s * t.N + n0 + e : mask,
                ok ? 4 : 0);
    }
  } else {
    for (int c = tid; c < t.G * t.nt; c += kThreads) {
      const int g = c / t.nt;
      const int e = c - g * t.nt;
      const int64_t s = s0 + g;
      st.ms[c] = s < t.S && e < rows ? mask[s * t.N + n0 + e] : 0;
    }
  }
}

// Walk the samples stage by stage through the two-stage ring, calling
// compute(stage) on each once its copies have landed and the rows of its
// unused samples are zeroed in A.  Every thread of the block calls it (it
// holds __syncthreads).
template <typename Compute>
__device__ __forceinline__ void sweep(const Tile& t, char* smem,
                             const double* __restrict__ A,
                             const uint8_t* __restrict__ mask,
                             const double* __restrict__ Y, int64_t s0,
                             int64_t k0, Compute&& compute) {
  const int64_t n_st = (t.N + t.nt - 1) / t.nt;
  if (n_st == 0) return;
  load_stage(t, stage_of(t, smem, 0), A, mask, Y, s0, k0, 0);
  cp_async_commit();
  for (int64_t i = 0; i < n_st; ++i) {
    if (i + 1 < n_st) {
      load_stage(t, stage_of(t, smem, int((i + 1) & 1)), A, mask, Y, s0, k0,
                 (i + 1) * t.nt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage st = stage_of(t, smem, int(i & 1));
    for (int row = threadIdx.x; row < t.G * t.nt; row += kThreads) {
      if (!st.ms[row]) {
        double* x = st.xs + (row / t.nt) * t.XS + (row % t.nt) * t.P;
        for (int p = 0; p < t.P; ++p) x[p] = 0.0;
      }
    }
    __syncthreads();
    compute(st);
    __syncthreads();
  }
}

// C [R, CS] in shared memory = the tile product above, for the block's
// snarls s0 .. and rows k0 ..  Warp units of 2 x 2 m16n8 blocks (32 rows
// x 16 phenotypes), ordered (m unit, n unit); eight at a time, one sweep
// over the samples each.
__device__ __forceinline__ void product(const Tile& t, char* smem,
                               const double* __restrict__ A,
                               const uint8_t* __restrict__ mask,
                               const double* __restrict__ Y, int64_t s0,
                               int64_t k0, double* C) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_un = t.KT / 16;
  const int units = (t.R + 31) / 32 * n_un;
  for (int u0 = 0; u0 < units; u0 += kWarps) {
    const int u = u0 + warp;
    const bool active = u < units;
    const int um = u / n_un;
    const int un = u - um * n_un;
    double acc[2][2][4];
    int a_off[4];
    bool a_ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = um * 32 + q * 8 + lane / 4;
      const int g = r / t.Pp;
      const int p = r - g * t.Pp;
      a_ok[q] = active && r < t.R && p < t.P;
      a_off[q] = g * t.XS + p;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
      }
    }
    // B fragments: rows k = (un 2 + j) 8 + lane / 4, whose swizzle depends
    // on lane / 4 alone
    int b_off[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) b_off[j] = ((un * 2 + j) * 8 + lane / 4) * t.YS;
    const int sw = y_swz(t, lane / 4);
    const int P = t.P;
    const int steps = t.nt / 8;
    sweep(t, smem, A, mask, Y, s0, k0, [&](const Stage& st) {
      if (!active) return;
#pragma unroll 4
      for (int ks = 0; ks < steps; ++ks) {
        const int n0 = ks * 8 + lane % 4;
        const int n1 = n0 + 4;
        double a[2][4], b[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = a_ok[2 * i] ? st.xs[a_off[2 * i] + n0 * P] : 0.0;
          a[i][1] = a_ok[2 * i + 1] ? st.xs[a_off[2 * i + 1] + n0 * P] : 0.0;
          a[i][2] = a_ok[2 * i] ? st.xs[a_off[2 * i] + n1 * P] : 0.0;
          a[i][3] = a_ok[2 * i + 1] ? st.xs[a_off[2 * i + 1] + n1 * P] : 0.0;
        }
        const int y0 = (((n0 >> 1) ^ sw) << 1) + (n0 & 1);
        const int y1 = (((n1 >> 1) ^ sw) << 1) + (n1 & 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = st.ys[b_off[j] + y0];
          b[j][1] = st.ys[b_off[j] + y1];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) mma16808(acc[i][j], a[i], b[j]);
        }
      }
    });
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = um * 32 + (2 * i + h) * 8 + lane / 4;
          if (r >= t.R) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = (un * 2 + j) * 8 + 2 * (lane % 4);
            C[r * t.CS + col] = acc[i][j][2 * h];
            C[r * t.CS + col + 1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

// The block's snarl group and K tile, the K tile fastest.
__device__ __forceinline__ void block_coords(const Tile& t, int64_t* s0,
                                             int64_t* k0) {
  const int64_t b = blockIdx.x;
  *s0 = (b / t.n_kt) * t.G;
  *k0 = (b % t.n_kt) * int64_t(t.KT);
}

inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Plan the tile for A [S, N, P], Y [K, N] and the mask: (KT, nt) = (64,
// 32), or (16, 8) for the wide designs where that does not fit (P >= 121
// in perm_ols, P >= 186 in score_perm; up to P = 504 and 792), with
// extra_bytes(t) of the kernel's own region after the product tile (none
// for nullptr).  Returns false when neither fits.
inline bool plan_tile(Tile* t, int64_t S, int64_t N, int64_t P, int64_t K,
                      const void* A, const void* mask, const void* Y,
                      size_t (*extra_bytes)(const Tile&)) {
  static const int kShapes[][2] = {{64, 32}, {16, 8}};
  t->S = S;
  t->N = N;
  t->K = K;
  t->P = int(P);
  t->Pp = int((P + 7) / 8 * 8);
  int G = 1;
  while (2 * G * t->Pp <= 64) G *= 2;
  t->G = G;
  t->R = G * t->Pp;
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  t->vec_x = (N * P) % 2 == 0 && addr(A) % 16 == 0;
  t->vec_y = N % 2 == 0 && addr(Y) % 16 == 0;
  t->vec_m = N % 4 == 0 && addr(mask) % 4 == 0;
  for (const auto& shape : kShapes) {
    t->KT = shape[0];
    t->nt = shape[1];
    t->XS = t->nt * t->P;
    t->swz = t->nt >= 16;
    t->YS = t->swz ? t->nt : t->nt + 4;
    t->CS = t->KT + 4;
    t->n_kt = int((K + t->KT - 1) / t->KT);
    const size_t xs = 2 * size_t(t->G) * t->XS * 8;
    const size_t ys = 2 * size_t(t->KT) * t->YS * 8;
    const size_t ms = 2 * size_t(t->G) * t->nt;
    const size_t ring = align16(xs + ys + ms);
    const size_t c = size_t(t->R) * t->CS * 8;
    const int units = (t->R + 31) / 32 * (t->KT / 16);
    const bool alias = units <= kWarps && c <= ring;
    t->off_y = int(xs);
    t->off_m = int(xs + ys);
    t->off_c = alias ? 0 : int(ring);
    t->off_extra = int(alias ? ring : ring + align16(c));
    const size_t total =
        size_t(t->off_extra) + (extra_bytes ? align16(extra_bytes(*t)) : 0);
    if (total <= kMaxSmem) {
      t->smem = int(total);
      return true;
    }
  }
  return false;
}

}  // namespace pg
}  // namespace stoat
