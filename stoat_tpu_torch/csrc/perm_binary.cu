// K15: the binary permutation test's counts, tables and chi-squared
// statistics for K packed phenotype masks against one chunk's membership.
//
// Replaces stoat_tpu/pipeline/permutation.py _perm_binary_pvalues (:79-100)
// up to its chi-squared tail, and the membership it is given
// (_ChunkDevice, :245-261: membership_words, stoat_tpu/pipeline/packed.py
// :294).  Two entry points:
//
//   perm_membership  mem[p, w] = tail[w] & AND_k words[idx[p, k], w], 0 on
//                    an invalid path, and g_all[p] = its popcount: once per
//                    chunk, whatever the number of permutations
//   perm_binary      for permutation k and snarl s, over the snarl's path
//                    columns j (p = sidx[s, j], -1 padding):
//                      g1 = popcount(mem[p] & mask[k]),  g0 = g_all[p] - g1
//                    then the table, filter and statistic of
//                    binary_tables_device.cuh (K3's own code, so the
//                    statistic has K3's bits for the same counts):
//                      stat[k, s], df[k, s],
//                      bad[k, s] = filtered | invalid | zero expected
//
// The chi-squared tail (csrc/chi2_tail.cu) and the +inf of bad tables (a
// torch op) follow (pipeline/permutation.py).
//
// What bounds perm_binary on the card: the case counts are a product of
// 0/1 matrices, g1[(s, j), k] = sum_h M[p(s, j), h] mask[k, h] over the
// haplotype bits h: 2 x (real paths) x K x 32 W operations, 2.5e11 per
// chunk at 24,576 real paths, K = 1,001 and W = 157 words (2,504
// samples), 0.12 ms at the H100's 1,979 TOP/s int8 tensor-core rate (its
// binary tensor-core rate is not published); its bytes (the [P, W]
// membership, the K x W masks, 17 bytes of output per (k, s)) take less.
// The parent design's population counts, one per (permutation, path,
// word), run at 16 an SM a clock on compute capability 9.0: 3.9e9 of
// them could not take less than 0.92 ms (its loads bound it before that).
// Design: a block takes a row tile of whole snarls, the (snarl, column)
// pairs of floor(64 / Pmax) snarls (at least one; a zero row for -1 and
// past the tile's snarls), rounded up to a multiple of 64 rows, and a
// tile of 128 masks, the mask tile fastest in the grid, so that a row
// tile's membership is read from device memory once and from L2 after.
// Words go through a two-stage cp.async ring in shared memory, 32 words
// (1,024 haplotypes) a stage; a row starts anywhere (W words after the
// one before), so its words are copied in 16-byte blocks from the
// boundary at or before them, past the row's end zero-filled, and sit at
// the row's shift.  Each of the 8 warps takes a unit of 32 rows x 32
// masks and accumulates its counts in registers on the tensor cores'
// binary product, mma.sync.m16n8k256 b1 AND + POPC into s32 (BMMA): eight
// words are one k256 step and each fragment register is one whole word,
// so nothing is expanded.  It is exact, and took 0.816 ms a chunk against
// 1.079 for the int8 product (mma.sync.m16n8k32 u8 on the bits expanded
// to 0/1 bytes in registers, two integer operations a register), the
// counts equal to the bit; units of 32 rows in 8 warps (80 registers,
// three blocks an SM) 0.700 against 0.814 for 64 rows in 4 (127
// registers) (tools/kernel_ab.py on an H100).  The counts then go to
// shared memory (int32) and each thread takes (snarl, permutation) pairs,
// the permutation fastest, so that a warp's lanes share a snarl (its kept
// columns, and so the table's branches, are the same for every mask), and
// runs binary_table on the snarl's columns; a second kernel for the tables
// over [K, S Pmax] counts in device memory took 1.128 against 1.079 ms.
// Wider snarls (a unit per 32 rows, the warps in rounds) and very wide
// ones (counts that would not fit: tiles of 32 or 8 masks) use the same
// code.
// perm_membership is membership_counts.cu writing the words: one warp per
// path, lanes over W.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "binary_tables_device.cuh"
#include "perm_gemm_device.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;   // perm_membership
constexpr int kWarps = 8;           // perm_binary: a unit a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMI = 2;              // m16 tiles of a unit
constexpr int kUnitRows = 16 * kMI;
constexpr int kTileRows = 64;       // rows a row tile aims at
constexpr int kStages = 2;          // the ring's stages
constexpr int kMaxShift = 5;        // log2 of the most words a stage
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void perm_membership_kernel(
    const uint32_t* __restrict__ words,   // [E+1, W]
    const int32_t* __restrict__ idx,      // [P, K]
    const uint8_t* __restrict__ valid,    // [P]
    const uint32_t* __restrict__ tail,    // [W]
    uint32_t* __restrict__ mem,           // [P, W]
    int32_t* __restrict__ g_all,          // [P]
    int64_t P, int64_t K, int64_t W) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // uniform across the warp
  const bool ok = valid[p] != 0;
  const int32_t* rows = idx + p * K;
  unsigned int n = 0;
  for (int64_t w = lane; w < W; w += 32) {
    uint32_t m = 0;
    if (ok) {
      m = tail[w];
      for (int64_t k = 0; k < K; ++k) m &= words[int64_t(rows[k]) * W + w];
    }
    mem[p * W + w] = m;
    n += __popc(m);
  }
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_down_sync(0xffffffffu, n, off);
  }
  if (lane == 0) g_all[p] = int32_t(n);
}

// A perm_binary launch's geometry, planned on the host (plan_binary) and
// passed by value.
struct Plan {
  int64_t S, K, Pmax, W;
  int64_t n_kt;   // mask tiles
  int nsn;        // snarls of a row tile
  int RB;         // rows of a row tile: nsn Pmax rounded up to 64
  int KT;         // masks of a tile
  int n_mc;       // mask chunks of a unit (8 NI masks each) in the tile
  int RR;         // rows staged for a round: its units' row chunks
  int rounds;     // rounds of kWarps units (one a warp)
  int WT;         // words a stage, a power of two
  int WS;         // row stride of the stages in words, WT + 4
  int CS;         // row stride of the counts, KT + 1
  int off_counts; // byte offsets in dynamic shared memory
  int off_rows;
  int smem;
};

// The words of a row before it in its 16-byte block: where its words go in
// a stage (the buffers are 16-byte aligned)
__device__ __forceinline__ int shift_of(const uint32_t* row) {
  return int(reinterpret_cast<uintptr_t>(row) >> 2) & 3;
}

__device__ __forceinline__ void bmma168256(int32_t (&c)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NI: n8 tiles of masks in a warp's unit (4: 32 masks; 1: 8 masks); a
// unit is kMI m16 tiles of rows
template <int NI>
__global__ void __launch_bounds__(kThreads) perm_binary_kernel(
    const uint32_t* __restrict__ mem,     // [P, W]
    const int32_t* __restrict__ g_all,    // [P]
    const uint32_t* __restrict__ masks,   // [K, W]
    const int32_t* __restrict__ sidx,     // [S, Pmax]
    Plan pl, double min_individuals, double min_haplotypes,
    double maf_threshold,
    double* __restrict__ stat_out,        // [K, S]
    double* __restrict__ df_out,          // [K, S]
    uint8_t* __restrict__ bad_out) {      // [K, S]
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);  // [kStages][RR + KT][WS]
  int32_t* counts = reinterpret_cast<int32_t*>(smem + pl.off_counts);
  int32_t* prow = reinterpret_cast<int32_t*>(smem + pl.off_rows);  // [RB]
  int32_t* grow = prow + pl.RB;                                     // [RB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragments' row (A) and column (B)
  const int t = lane & 3;    // the fragments' words c + t and c + 4 + t
  const int64_t kt = int64_t(blockIdx.x) % pl.n_kt;
  const int64_t s0 = int64_t(blockIdx.x) / pl.n_kt * pl.nsn;
  const int64_t k0 = kt * pl.KT;
  const int64_t Pmax = pl.Pmax;
  const int64_t W = pl.W;
  const int tile_rows = int(pl.nsn * Pmax);

  // each row's path (-1: a zero row) and its g_all
  for (int r = tid; r < pl.RB; r += kThreads) {
    int32_t p = -1;
    if (r < tile_rows) {
      const int64_t sl = r / Pmax;
      if (s0 + sl < pl.S) p = sidx[(s0 + sl) * Pmax + (r - sl * Pmax)];
    }
    prow[r] = p;
    grow[r] = p >= 0 ? g_all[p] : 0;
  }
  __syncthreads();

  const int stage_words = (pl.RR + pl.KT) * pl.WS;
  const int n_units = pl.RB / kUnitRows * pl.n_mc;
  const int64_t n_st = (W + pl.WT - 1) / pl.WT;
  for (int round = 0; round < pl.rounds; ++round) {
    const int row_lo = kWarps * round / pl.n_mc * kUnitRows;
    const int u = kWarps * round + warp;
    const bool has_unit = u < n_units;
    const int rc = has_unit ? u / pl.n_mc : 0;
    const int mc = has_unit ? u % pl.n_mc : 0;

    // stage b: words w0 .. w0 + WT of the round's rows (membership rows
    // 0 .. RR) and of the tile's masks (rows RR .. RR + KT), zero-filled
    // past W, past the tile and on -1 rows.  A row starts anywhere (W words
    // after the one before), so its words are copied from the 16-byte
    // boundary at or before its word w0 in WS / 4 16-byte copies
    // (cp.async.cg, reading nothing past the row), and its word w0 lands at
    // its shift, (row start) mod 4, the same in every stage
    auto stage = [&](int b, int64_t w0) {
      uint32_t* base = ring + b * stage_words;
      const int per_row = pl.WS >> 2;
      const int n_items = (pl.RR + pl.KT) * per_row;
      const int64_t left = W - w0;
      for (int e = tid; e < n_items; e += kThreads) {
        const int row = e / per_row;
        const int j = e - row * per_row;
        const uint32_t* src = nullptr;
        if (row < pl.RR) {
          const int r = row_lo + row;
          const int32_t p = r < pl.RB ? prow[r] : -1;
          if (p >= 0) src = mem + int64_t(p) * W;
        } else {
          const int64_t k = k0 + (row - pl.RR);
          if (k < pl.K) src = masks + k * W;
        }
        int words = 0;
        if (src != nullptr) {
          const int d = shift_of(src);
          src = src + w0 - d + 4 * j;
          const int64_t n = d + left - 4 * j;
          words = n < 0 ? 0 : n > 4 ? 4 : int(n);
        }
        stoat::pg::cp_async16(base + row * pl.WS + 4 * j,
                              words > 0 ? src : mem, 4 * words);
      }
      stoat::pg::cp_async_commit();
    };

    int32_t acc[kMI][NI][4];
#pragma unroll
    for (int m = 0; m < kMI; ++m) {
#pragma unroll
      for (int n = 0; n < NI; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
      }
    }
    // the smem offsets of the lane's fragment rows in a stage, shift
    // included: A rows g, g + 8 of each m16 tile, B rows g of each n8 tile
    int aoff[kMI][2], boff[NI];
    if (has_unit) {
#pragma unroll
      for (int m = 0; m < kMI; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rc * kUnitRows - row_lo + 16 * m + 8 * h + g;
          const int r = row_lo + row;
          const int32_t p = r < pl.RB ? prow[r] : -1;
          aoff[m][h] = row * pl.WS + (p >= 0 ? shift_of(mem + int64_t(p) * W)
                                             : 0);
        }
      }
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int row = pl.RR + mc * 8 * NI + 8 * n + g;
        const int64_t k = k0 + mc * 8 * NI + 8 * n + g;
        boff[n] = row * pl.WS + (k < pl.K ? shift_of(masks + k * W) : 0);
      }
    }
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_st) {
        stage(i, i * pl.WT);
      } else {
        stoat::pg::cp_async_commit();
      }
    }
    for (int64_t st = 0; st < n_st; ++st) {
      const int64_t next = st + kStages - 1;
      if (next < n_st) {
        stage(int(next % kStages), next * pl.WT);
      } else {
        stoat::pg::cp_async_commit();
      }
      stoat::pg::cp_async_wait<kStages - 1>();
      __syncthreads();
      if (has_unit) {
        const uint32_t* base = ring + int(st % kStages) * stage_words;
        const int64_t left = W - st * pl.WT;
        const int wt = int(left < pl.WT ? left : pl.WT);
        // a k256 step, eight words: the lane's registers hold whole words,
        // A's rows g and g + 8 and B's row g, words c + t and c + 4 + t
        // (k 32 t .. and 128 + 32 t ..); words past the stage's are 0
        for (int c = 0; c < wt; c += 8) {
          uint32_t a[kMI][4], b[NI][2];
          const int c0 = c + t, c1 = c + 4 + t;
          const bool in0 = c0 < wt, in1 = c1 < wt;
#pragma unroll
          for (int m = 0; m < kMI; ++m) {
            a[m][0] = in0 ? base[aoff[m][0] + c0] : 0u;
            a[m][1] = in0 ? base[aoff[m][1] + c0] : 0u;
            a[m][2] = in1 ? base[aoff[m][0] + c1] : 0u;
            a[m][3] = in1 ? base[aoff[m][1] + c1] : 0u;
          }
#pragma unroll
          for (int n = 0; n < NI; ++n) {
            b[n][0] = in0 ? base[boff[n] + c0] : 0u;
            b[n][1] = in1 ? base[boff[n] + c1] : 0u;
          }
#pragma unroll
          for (int m = 0; m < kMI; ++m) {
#pragma unroll
            for (int n = 0; n < NI; ++n) bmma168256(acc[m][n], a[m], b[n]);
          }
        }
      }
      __syncthreads();
    }
    // the unit's counts (the ring is free: every warp is past the last
    // stage's sync)
    if (has_unit) {
#pragma unroll
      for (int m = 0; m < kMI; ++m) {
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const int row = rc * kUnitRows + 16 * m + g;
          const int col = mc * 8 * NI + 8 * n + 2 * t;
          int32_t* c0 = counts + row * pl.CS + col;
          int32_t* c8 = c0 + 8 * pl.CS;
          c0[0] = acc[m][n][0];
          c0[1] = acc[m][n][1];
          c8[0] = acc[m][n][2];
          c8[1] = acc[m][n][3];
        }
      }
    }
  }
  __syncthreads();

  // the tables: (snarl, permutation) pairs, the permutation fastest, so
  // that a warp's lanes share a snarl: its kept columns (those with
  // g_all > 0) and so its branches are the same for every mask
  for (int q = tid; q < pl.nsn * pl.KT; q += kThreads) {
    const int kk = q % pl.KT;
    const int sl = q / pl.KT;
    const int64_t s = s0 + sl;
    const int64_t k = k0 + kk;
    if (s >= pl.S || k >= pl.K) continue;
    const int rbase = int(sl * Pmax);
    auto column = [&](int64_t j, double& x0, double& x1) {
      const int r = rbase + int(j);
      const int32_t p = prow[r];
      if (p < 0) {
        x0 = 0.0;
        x1 = 0.0;
        return false;
      }
      const int32_t g1 = counts[r * pl.CS + kk];
      x0 = double(grow[r] - g1);
      x1 = double(g1);
      return true;
    };
    const stoat::BinaryTable tb = stoat::binary_table(
        column, Pmax, min_individuals, min_haplotypes, maf_threshold);
    const int64_t o = k * pl.S + s;
    stat_out[o] = tb.stat;
    df_out[o] = tb.df;
    bad_out[o] = tb.filtered || tb.invalid || tb.zexp ? 1 : 0;
  }
}

// The geometry of a launch with NI n8 tiles a unit and KT masks a tile, in
// the largest stage (32 words down to 4) that fits the card's shared
// memory; false when none does.
bool plan_binary(Plan* pl, int64_t S, int64_t K, int64_t Pmax, int64_t W,
                 int NI, int KT) {
  pl->S = S;
  pl->K = K;
  pl->Pmax = Pmax;
  pl->W = W;
  pl->nsn = Pmax >= kTileRows ? 1 : int(kTileRows / (Pmax > 0 ? Pmax : 1));
  const int64_t rows = int64_t(pl->nsn) * Pmax;
  const int64_t RB = rows > kTileRows
                         ? (rows + kTileRows - 1) / kTileRows * kTileRows
                         : kTileRows;
  if (RB > (int64_t(1) << 20)) return false;
  pl->RB = int(RB);
  pl->KT = KT;
  pl->n_mc = KT / (8 * NI);
  pl->RR = kUnitRows * (kWarps / pl->n_mc);
  if (pl->RR > pl->RB) pl->RR = pl->RB;
  pl->rounds = (pl->RB / kUnitRows * pl->n_mc + kWarps - 1) / kWarps;
  pl->CS = KT + 1;
  pl->n_kt = (K + KT - 1) / KT;
  const size_t counts = size_t(pl->RB) * pl->CS * 4;
  const size_t rows_bytes = size_t(pl->RB) * 8;
  for (int shift = kMaxShift; shift >= 2; --shift) {
    pl->WT = 1 << shift;
    pl->WS = pl->WT + 4;
    const size_t ring = size_t(kStages) * (pl->RR + KT) * pl->WS * 4;
    // one round: the counts take the ring's place once it is done with
    const size_t main = pl->rounds == 1 ? (ring > counts ? ring : counts)
                                        : ring + counts;
    pl->off_counts = pl->rounds == 1 ? 0 : int(ring);
    pl->off_rows = int((main + 15) / 16 * 16);
    const size_t smem = size_t(pl->off_rows) + rows_bytes;
    if (smem <= kMaxSmem) {
      pl->smem = int(smem);
      return true;
    }
  }
  return false;
}

}  // namespace

extern "C" int perm_membership_launch(const void* words, const void* idx,
                                      const void* valid, const void* tail,
                                      void* mem, void* g_all, int64_t P,
                                      int64_t K, int64_t W, void* stream) {
  if (P > 0) {
    const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
    perm_membership_kernel<<<unsigned(blocks), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(tail),
        static_cast<uint32_t*>(mem), static_cast<int32_t*>(g_all), P, K, W);
  }
  return int(cudaGetLastError());
}

extern "C" int perm_binary_launch(const void* mem, const void* g_all,
                                  const void* masks, const void* sidx,
                                  int64_t K, int64_t S, int64_t Pmax,
                                  int64_t W, double min_individuals,
                                  double min_haplotypes, double maf_threshold,
                                  void* stat_out, void* df_out, void* bad_out,
                                  void* stream) {
  if (K <= 0 || S <= 0) return int(cudaGetLastError());
  if (Pmax < 0 || W < 0) return int(cudaErrorInvalidValue);
  // the stages copy 16-byte blocks from the buffers' starts on
  if (((reinterpret_cast<uintptr_t>(mem) | reinterpret_cast<uintptr_t>(masks)) &
       15) != 0) {
    return int(cudaErrorInvalidValue);
  }
  // tiles of 128 masks; for snarls too wide for their counts, 32, then 8
  Plan pl;
  int NI = 4;
  if (!plan_binary(&pl, S, K, Pmax, W, 4, 128) &&
      !plan_binary(&pl, S, K, Pmax, W, 4, 32)) {
    NI = 1;
    if (!plan_binary(&pl, S, K, Pmax, W, 1, 8)) {
      return int(cudaErrorInvalidValue);
    }
  }
  const int64_t blocks = (S + pl.nsn - 1) / pl.nsn * pl.n_kt;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  const auto kernel = NI == 4 ? perm_binary_kernel<4> : perm_binary_kernel<1>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<unsigned(blocks), kThreads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mem), static_cast<const int32_t*>(g_all),
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(sidx),
      pl, min_individuals, min_haplotypes, maf_threshold,
      static_cast<double*>(stat_out), static_cast<double*>(df_out),
      static_cast<uint8_t*>(bad_out));
  return int(cudaGetLastError());
}

extern "C" const char* perm_binary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
