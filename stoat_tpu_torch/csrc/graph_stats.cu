// K6: graph mode's statistics, chi-squared 2x2, Fisher and chi-squared 2xN,
// and both chi-squared tails, in one launch.
//
// Replaces stoat_tpu/graph/association.py _graph_stats_fused (:496-513),
// which chains stoat_tpu/stats/chi2.py chi2_2x2 (:32-85) and chi2_2xn
// (:89-133) and stoat_tpu/stats/fisher.py fisher_exact_2x2 (:165) on the
// [B, Pmax] walk-set partition counts of the native graph core, the
// chi-squared tails inside that one jitted program.  Row b holds k <= Pmax
// partitions: G0 (controls) and G1 (cases), int32 sample tallies, and a
// column mask.  Per row the kernel writes
//
//   - p22: the chi-squared upper tail (df 1) of the 2x2 statistic of
//     (G0[b, 0], G0[b, 1], G1[b, 0], G1[b, 1]), NaN where a margin is zero
//     (invalid), DBL_MAX where an expected count is zero;
//   - pf: the Fisher p of the same table, through fisher_device.cuh's
//     fisher_single (the graph's walks are short: see below);
//   - pn: the chi-squared upper tail of the 2xN statistic over the masked
//     columns, summed in column order, df = max(columns - 1, 1), NaN where
//     invalid.
//
// The statistics' operations and their order are those of stats/chi2.py
// and stats/fisher.py in the port, and the tails are chi2_tail_device.cuh's
// pieces (start, the series and the continued fraction, finish), which
// chi2_tail.cu (K5) runs: with -fmad=false every output is bitwise what
// the parent's chain gave (this kernel's statistics, then K5 twice), the
// plain version's statistics run through K5 on the card
// (stats/chi2.py finish_chi2_pvalues).
//
// What bounds it on the card: not bytes (at 106,957 rows of 4 columns it
// reads 3.9 MB of counts and mask and writes 2.6 MB) but dependent chains:
// Fisher's scan and the tails' loops run a data-dependent number of steps
// of float64 divisions, and a warp runs as long as its slowest lane, so
// what sets the time is how many chains the SMs hold at once (registers)
// and how long the longest chain of a thread is.  The parent launched
// this kernel, then K5 twice, with seven outputs and two constant tensors
// allocated between them.
//
// Design (A/B'd on the card against the parent and against one thread a
// row, PERF.md section 6): a block owns kRows rows, two threads a row.
//   1. The block stages its rows of G0, G1 and the mask in shared memory
//      with coalesced loads (where kRows rows of Pmax columns fit beside
//      the slots in the default 48 KB; wider rows are read where they lie).
//   2. Thread r < kRows computes row r's 2x2 statistic and flags, thread
//      kRows + r the row's 2xN statistic, as before (warp-uniform roles).
//   3. Each thread classifies its own tail (chi2_tail::start, the masks
//      first); one that runs no loop is written at once, one that does is
//      staged in shared memory by its branch, the power series from the
//      front and the continued fraction from the back (a ballot and a
//      shared count per branch), as chi2_tail.cu's one-wave kernel stages
//      them, so that only the warp at the boundary holds both loops.
//   4. The staged loops run one a thread, the first kRows on the 2xN
//      threads, which have no scan, while the 2x2 threads run Fisher (and
//      a loop of their own only when more than kRows elements loop).
// Fisher is fisher_single here, not the block scan fisher_scan that K4
// runs: the graph's 90 haplotypes give walks of a few dozen steps, where
// fisher_scan divides ratios past the walk's end and holds 96 registers
// against 62 (0.1174 ms against 0.0719 with both tails, on the card).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "chi2_tail_device.cuh"
#include "fisher_device.cuh"

namespace {

constexpr int kRows = 128;              // rows a block
constexpr int kThreads = 2 * kRows;     // two threads a row

// an element that runs a loop, staged for the thread that will run it:
// which output (0 p22, 1 pn) and row in ``index``
struct Slot {
  double a, x, ax, stat;
  int64_t index;
};

// the rows staged beside the slots within the default 48 KB of shared
// memory
constexpr size_t kStageBudget = 48 * 1024 - kThreads * sizeof(Slot) - 64;

// the tail of one element: the masks first (finish_chi2_pvalues' order),
// then chi2_tail::start; returns its branch, its p written if it is done
__device__ __forceinline__ int classify(double stat, double df, bool invalid,
                                        bool zexp, double* p,
                                        chi2_tail::Element* e) {
  using namespace chi2_tail;
  if (invalid || zexp) {
    *p = invalid ? NAN : DBL_MAX;
    return kDone;
  }
  double q;
  const int branch = start(stat, df, e, &q);
  if (branch == kDone) *p = finish(q, stat);
  return branch;
}

__global__ void __launch_bounds__(kThreads)
    graph_stats_kernel(const int32_t* __restrict__ g0,
                       const int32_t* __restrict__ g1,
                       const uint8_t* __restrict__ mask,
                       double* __restrict__ p22, double* __restrict__ pf,
                       double* __restrict__ pn, int64_t B, int64_t Pm,
                       bool staged) {
  using namespace chi2_tail;
  extern __shared__ int32_t rows_s[];     // G0, G1 [kRows, Pm], then mask
  __shared__ Slot slots[kThreads];
  __shared__ int counts[2];               // series, fractions staged
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  // threads [0, kRows) take the rows' 2x2 table and Fisher, threads
  // [kRows, 2 kRows) their 2xN table: warp-uniform roles
  const bool wide = t >= kRows;
  const int r = wide ? t - kRows : t;
  const int64_t b0 = int64_t(blockIdx.x) * kRows;
  const int64_t n_rows = B - b0 < kRows ? B - b0 : kRows;
  if (t < 2) counts[t] = 0;

  // 1. the block's rows, coalesced (they are contiguous in G0, G1, mask)
  const int32_t* r0 = g0 + (b0 + r) * Pm;
  const int32_t* r1 = g1 + (b0 + r) * Pm;
  const uint8_t* rm = mask + (b0 + r) * Pm;
  if (staged) {
    int32_t* s0 = rows_s;
    int32_t* s1 = rows_s + kRows * Pm;
    uint8_t* sm = reinterpret_cast<uint8_t*>(rows_s + 2 * kRows * Pm);
    for (int64_t i = t; i < n_rows * Pm; i += kThreads) {
      s0[i] = g0[b0 * Pm + i];
      s1[i] = g1[b0 * Pm + i];
      sm[i] = mask[b0 * Pm + i];
    }
    r0 = s0 + r * Pm;
    r1 = s1 + r * Pm;
    rm = sm + r * Pm;
  }
  __syncthreads();

  // 2. the thread's statistic: the 2x2 (stats/chi2.py chi2_2x2_stat, on
  // the first two columns, unmasked as in the JAX program: padding is
  // zero) or the 2xN (chi2_2xn_stat: the sums of integer counts are exact
  // in any order; the statistic sums in column order)
  const bool live = r < n_rows;
  const int64_t b = b0 + r;
  double stat = 0.0, df = 1.0;
  bool invalid = false, zexp = false;
  double a = 0.0, bb = 0.0, c = 0.0, d = 0.0;
  if (live && !wide) {
    a = double(r0[0]);
    bb = double(r0[1]);
    c = double(r1[0]);
    d = double(r1[1]);
    const double row1 = a + bb;
    const double row2 = c + d;
    const double col1 = a + c;
    const double col2 = bb + d;
    const double total = row1 + row2;
    invalid = row1 == 0.0 || row2 == 0.0 || col1 == 0.0 || col2 == 0.0;
    const double safe_total = invalid ? 1.0 : total;
    double ea = row1 * col1 / safe_total;
    double eb = row1 * col2 / safe_total;
    double ec = col1 * row2 / safe_total;
    double ed = col2 * row2 / safe_total;
    zexp = ea == 0.0 || eb == 0.0 || ec == 0.0 || ed == 0.0;
    if (zexp) {
      ea = 1.0;
      eb = 1.0;
      ec = 1.0;
      ed = 1.0;
    }
    const double da = a - ea, db = bb - eb, dc = c - ec, dd = d - ed;
    stat = da * da / ea + db * db / eb + dc * dc / ec + dd * dd / ed;
  } else if (live) {
    double tot = 0.0, row0 = 0.0, rowc = 0.0;
    int ncols = 0;
    bool any_zero_col = false;
    for (int64_t j = 0; j < Pm; ++j) {
      if (!rm[j]) continue;
      const double v0 = double(r0[j]), v1 = double(r1[j]);
      tot = tot + (v0 + v1);
      row0 = row0 + v0;
      rowc = rowc + v1;
      ncols += 1;
      any_zero_col = any_zero_col || (v0 + v1) == 0.0;
    }
    invalid = tot == 0.0 || row0 == 0.0 || rowc == 0.0 || any_zero_col;
    const double safe = tot == 0.0 ? 1.0 : tot;
    for (int64_t j = 0; j < Pm; ++j) {
      double term = 0.0;
      if (rm[j]) {
        const double v0 = double(r0[j]), v1 = double(r1[j]);
        const double ct = v0 + v1;
        double e0 = row0 * ct / safe;
        double e1 = rowc * ct / safe;
        e0 = e0 > 0.0 ? e0 : 1.0;
        e1 = e1 > 0.0 ? e1 : 1.0;
        const double d0 = v0 - e0, d1 = v1 - e1;
        term = d0 * d0 / e0 + d1 * d1 / e1;
      }
      stat = stat + term;
    }
    df = double(ncols - 1 > 1 ? ncols - 1 : 1);
  }

  // 3. the thread's tail: classified, and staged by branch if it runs a
  // loop (the series from the front, the fractions from the back)
  int branch = kDone;
  Element e;
  if (live) branch = classify(stat, df, invalid, zexp, (wide ? pn : p22) + b,
                              &e);
  const unsigned series_lanes = __ballot_sync(~0u, branch == kSeries);
  const unsigned fraction_lanes = __ballot_sync(~0u, branch == kFraction);
  int base_series = 0;
  int base_fraction = 0;
  if (lane == 0) {
    base_series = atomicAdd(&counts[0], __popc(series_lanes));
    base_fraction = atomicAdd(&counts[1], __popc(fraction_lanes));
  }
  base_series = __shfl_sync(~0u, base_series, 0);
  base_fraction = __shfl_sync(~0u, base_fraction, 0);
  if (branch != kDone) {
    const int slot =
        branch == kSeries
            ? base_series + __popc(series_lanes & below)
            : kThreads - 1 - (base_fraction + __popc(fraction_lanes & below));
    slots[slot] = Slot{e.a, e.x, e.ax, stat, wide ? B + b : b};
  }
  __syncthreads();

  // 4. the loops: slot j on thread (j + kRows) mod kThreads, so that the
  // 2xN threads, which have no scan, take the first kRows of them; then
  // the 2x2 threads' scans (fisher_device.cuh)
  const int n_series = counts[0];
  const int n_loops = n_series + counts[1];
  const int j = wide ? t - kRows : t + kRows;
  if (j < n_loops) {
    const bool is_series = j < n_series;
    const Slot sl = slots[is_series ? j : kThreads - 1 - (j - n_series)];
    const Element el{sl.a, sl.x, sl.ax};
    const double q = is_series ? series(el) : fraction(el);
    const bool second = sl.index >= B;
    (second ? pn : p22)[second ? sl.index - B : sl.index] =
        finish(q, sl.stat);
  }
  if (live && !wide) pf[b] = stoat::fisher_single(a, bb, c, d);
}

}  // namespace

extern "C" int graph_stats_launch(const void* g0, const void* g1,
                                  const void* mask, void* p22, void* pf,
                                  void* pn, int64_t B, int64_t Pm,
                                  void* stream) {
  if (Pm < 2) return int(cudaErrorInvalidValue);  // the 2x2 needs 2 columns
  if (B > 0) {
    const size_t stage = size_t(kRows) * size_t(Pm) *
                         (2 * sizeof(int32_t) + sizeof(uint8_t));
    const bool staged = stage <= kStageBudget;
    const int64_t blocks = (B + kRows - 1) / kRows;
    graph_stats_kernel<<<unsigned(blocks), kThreads, staged ? stage : 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(g0), static_cast<const int32_t*>(g1),
        static_cast<const uint8_t*>(mask), static_cast<double*>(p22),
        static_cast<double*>(pf), static_cast<double*>(pn), B, Pm, staged);
  }
  return int(cudaGetLastError());
}

extern "C" const char* graph_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
