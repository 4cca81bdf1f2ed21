// K5: chi-squared upper-tail p-values, and the NA masking of the binary
// tables.
//
// Replaces stoat_tpu/stats/special.py chi2_sf (:30-50) ->
// jax.scipy.special.gammaincc (JAX's igammac), behind
// stoat_tpu/stats/chi2.py finish_chi2_pvalues (:137-146).  For every
// element i of a flat [n]:
//
//   p = chi2_sf(stat[i], df[i % df_period])    (chi2_tail_device.cuh)
//   with the masks: invalid[i] ? NaN : zexp[i] ? DBL_MAX : p
//
// Given no masks (null pointers) it writes p alone: the permutation test's
// [K, S] tails (pipeline/permutation.py binary_perm_pvalues and
// score_perm_pvalues through stats/special.py chi2_sf), as student_t.cu
// does for linear_pvalues.  df_period is n where df has stat's shape, and
// S where the score test's statistics [K, S] share one df [S]: no [K, S]
// df is written or read.
//
// What bounds it on the card: neither bytes (26 per element) nor flops,
// but the loops' dependent chains of float64 divisions, run to each
// element's own convergence, and lanes left idle in a warp: by elements
// of the other branch (the power series and the continued fraction are
// two loops, and a warp that holds both runs both one after the other),
// and by elements that need fewer iterations than their neighbours.  Each
// thread first classifies an element (chi2_tail::start: the masks, the
// prefactor with XLA's lgamma) and writes at once the ones that run no
// loop, the masked ones included; the kernel then decides only which lane
// runs which loop, never what a loop computes.  Two designs, by size:
//   - a call that fills the card in one wave (the chunks' [S], the graph's
//     rows): a block a tile of 256 elements, one a thread; the block
//     stages its loop elements in shared memory, the series from the
//     front and the fractions from the back (a ballot and a shared count
//     per branch), and thread t runs slot t, so that only the warp at the
//     boundary holds both loops: latency, one chain a lane;
//   - a larger call (the permutation pass's [K, S], 8.2e6 elements):
//     warps take batches of 256 elements in turn from a counter in global
//     memory, classify them and stage the batch's loop elements in shared
//     memory (a, x, the prefactor, the statistic and a 16-bit offset; one
//     loop's elements first, then the other's, the first being the one the
//     previous batch ended with); each lane takes the list's next
//     element, from shared memory, as soon as its own has converged, and
//     when the list is handed out the warp classifies its next batch while
//     the lanes that still iterate keep their element: lanes idle only
//     where a warp holds both loops and at the end of the call; one vote
//     an iteration says whether a lane is free.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "chi2_tail_device.cuh"

namespace {

using chi2_tail::Element;
using chi2_tail::Fraction;
using chi2_tail::Series;

constexpr int kThreads = 256;      // the one-wave kernel's block
constexpr int kWarpThreads = 128;  // the batch kernel's block
constexpr int kBatch = 256;

// element i classified: its p written if it runs no loop (the masks
// first, as finish_chi2_pvalues applies them); else its branch and *e
__device__ __forceinline__ int classify(const double* __restrict__ stat,
                                        const double* __restrict__ df,
                                        const uint8_t* __restrict__ invalid,
                                        const uint8_t* __restrict__ zexp,
                                        double* __restrict__ p, int64_t n,
                                        int64_t df_period, int64_t i,
                                        Element* e) {
  using namespace chi2_tail;
  const double s = stat[i];
  if (invalid != nullptr && (invalid[i] || zexp[i])) {
    p[i] = invalid[i] ? NAN : DBL_MAX;
    return kDone;
  }
  double q;
  const int branch =
      start(s, df[df_period == n ? i : i % df_period], e, &q);
  if (branch == kDone) p[i] = finish(q, s);
  return branch;
}

// an element that runs a loop, staged for the thread that will run it
struct Slot {
  double a, x, ax, stat;
  int64_t index;
};

__global__ void __launch_bounds__(kThreads)
    chi2_tail_kernel(const double* __restrict__ stat,
                     const double* __restrict__ df,
                     const uint8_t* __restrict__ invalid,
                     const uint8_t* __restrict__ zexp,
                     double* __restrict__ p, int64_t n, int64_t df_period) {
  using namespace chi2_tail;
  __shared__ Slot slots[kThreads];
  __shared__ int counts[2];  // series, fractions staged in this tile
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  int branch = kDone;
  Element e;
  if (i < n) branch = classify(stat, df, invalid, zexp, p, n, df_period, i, &e);
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
    slots[slot] = Slot{e.a, e.x, e.ax, stat[i], i};
  }
  __syncthreads();
  const int n_series = counts[0];
  const int t = threadIdx.x;
  if (t < n_series + counts[1]) {
    const bool is_series = t < n_series;
    const Slot sl = slots[is_series ? t : kThreads - 1 - (t - n_series)];
    const Element el{sl.a, sl.x, sl.ax};
    const double q = is_series ? series(el) : fraction(el);
    p[sl.index] = finish(q, sl.stat);
  }
}

__device__ unsigned long long batch_counter;

// a lane's loop: the series' or the fraction's starting values and state
union Loop {
  Series series;
  Fraction fraction;
};

// a loop element of a batch, staged in shared memory by the warp that
// classified it: its a, x, prefactor, statistic and offset in the batch
struct Staged {
  double a, x, ax, stat;
  uint16_t offset;
};

__global__ void __launch_bounds__(kWarpThreads)
    chi2_tail_warp_kernel(const double* __restrict__ stat,
                          const double* __restrict__ df,
                          const uint8_t* __restrict__ invalid,
                          const uint8_t* __restrict__ zexp,
                          double* __restrict__ p, int64_t n,
                          int64_t df_period) {
  using namespace chi2_tail;
  // a batch's loop elements, staged where a lane takes them: the series
  // from the front, the fractions from the back
  __shared__ Staged staged[kWarpThreads / 32][kBatch];
  Staged* slot = staged[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the batch being handed out, the same in every lane: its first element,
  // which loop comes first in its list (the one the previous batch's list
  // ended with, so that lanes change loops once a batch), how many
  // elements run that loop, its loop elements, the first not yet taken
  int64_t base = 0;
  bool series_first = false;
  int n_first = 0;
  int count = 0;
  int next = 0;
  bool more = true;
  // a lane's element
  bool busy = false;
  bool is_series = false;
  int64_t i = 0;
  double s = 0.0;
  Element e;
  Loop loop;
  while (true) {
    if (next == count && more) {
      // the batch is handed out: classify the next one, the lanes that
      // are still iterating keeping their element
      unsigned long long batch = 0;
      if (lane == 0) batch = atomicAdd(&batch_counter, 1ull);
      base = int64_t(__shfl_sync(~0u, batch, 0)) * kBatch;
      more = base < n;
      series_first = !series_first;
      const int first = series_first ? kSeries : kFraction;
      n_first = 0;
      int n_second = 0;
      for (int j = 0; more && j < kBatch; j += 32) {
        const int64_t k = base + j + lane;
        int branch = kDone;
        Element ek;
        if (k < n) {
          branch = classify(stat, df, invalid, zexp, p, n, df_period, k, &ek);
        }
        const unsigned first_lanes = __ballot_sync(~0u, branch == first);
        const unsigned second_lanes =
            __ballot_sync(~0u, branch != kDone && branch != first);
        if (branch != kDone) {
          const int at =
              branch == first
                  ? n_first + __popc(first_lanes & below)
                  : kBatch - 1 - (n_second + __popc(second_lanes & below));
          slot[at] = Staged{ek.a, ek.x, ek.ax, stat[k], uint16_t(j + lane)};
        }
        n_first += __popc(first_lanes);
        n_second += __popc(second_lanes);
      }
      count = more ? n_first + n_second : 0;
      next = 0;
      __syncwarp();
    }
    // a lane without an element takes the batch's next one
    const unsigned idle = __ballot_sync(~0u, !busy);
    const int left = count - next;
    if (!busy) {
      const int k = next + __popc(idle & below);
      if (k < count) {
        const bool in_first = k < n_first;
        is_series = in_first == series_first;
        const Staged st = slot[in_first ? k : kBatch - 1 - (k - n_first)];
        i = base + st.offset;
        s = st.stat;
        e = Element{st.a, st.x, st.ax};
        if (is_series) {
          series_begin(e, &loop.series);
        } else {
          fraction_begin(e, &loop.fraction);
        }
        busy = true;
      }
    }
    next += min(__popc(idle), left);
    if (!__any_sync(~0u, busy)) {
      if (!more) break;
      continue;
    }
    // iterate until a lane has converged: one vote an iteration
    do {
      if (busy) {
        const bool done = is_series ? series_step(e, &loop.series)
                                    : fraction_step(&loop.fraction);
        if (done) {
          p[i] = finish(is_series ? series_end(e, loop.series)
                                  : fraction_end(e, loop.fraction),
                        s);
          busy = false;
        }
      }
    } while (__all_sync(~0u, busy));
    __syncwarp();
  }
}

// blocks of ``kernel`` resident on the current card at once (every SM
// full): the card's own answer, computed at its first launch there and
// kept in ``cache`` by device index (a device past the cache asks again)
constexpr int kMaxDevices = 64;

template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, std::atomic<int>* cache) {
  int device = 0;
  cudaGetDevice(&device);
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached) {
    const int got = cache[device].load(std::memory_order_relaxed);
    if (got > 0) return got;
  }
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cached) cache[device].store(blocks, std::memory_order_relaxed);
  return blocks;
}

std::atomic<int> tile_blocks_of[kMaxDevices];
std::atomic<int> warp_blocks_of[kMaxDevices];

}  // namespace

extern "C" int chi2_tail_launch(const void* stat, const void* df,
                                const void* invalid, const void* zexp,
                                void* p, int64_t n, int64_t df_period,
                                void* stream) {
  if ((invalid == nullptr) != (zexp == nullptr) || df_period < 1 ||
      (n > 0 && n % df_period != 0)) {
    return int(cudaErrorInvalidValue);
  }
  const int tile_blocks =
      resident_blocks(chi2_tail_kernel, kThreads, tile_blocks_of);
  const int warp_blocks =
      resident_blocks(chi2_tail_warp_kernel, kWarpThreads, warp_blocks_of);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const double*>(stat);
  const auto* d = static_cast<const double*>(df);
  const auto* inv = static_cast<const uint8_t*>(invalid);
  const auto* ze = static_cast<const uint8_t*>(zexp);
  auto* out = static_cast<double*>(p);
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  if (n > 0 && tiles <= tile_blocks) {
    chi2_tail_kernel<<<unsigned(tiles), kThreads, 0, s>>>(st, d, inv, ze,
                                                         out, n, df_period);
  } else if (n > 0) {
    // the batch counter starts at 0 for every launch (the calls of one
    // stream run in turn, as the port's do)
    void* counter = nullptr;
    cudaGetSymbolAddress(&counter, batch_counter);
    cudaMemsetAsync(counter, 0, sizeof(unsigned long long), s);
    const int64_t batches = (n + kBatch - 1) / kBatch;
    const int64_t blocks = (batches + kWarpThreads / 32 - 1) /
                           (kWarpThreads / 32);
    chi2_tail_warp_kernel<<<unsigned(blocks < warp_blocks ? blocks
                                                           : warp_blocks),
                            kWarpThreads, 0, s>>>(st, d, inv, ze, out, n,
                                                  df_period);
  }
  return int(cudaGetLastError());
}

extern "C" const char* chi2_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
