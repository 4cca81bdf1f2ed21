// K10: two-tailed Student-t p-values of the per-snarl OLS statistics, and
// the NA masking of degenerate snarls.
//
// Replaces stoat_tpu/stats/linreg.py finish_linear_pvalues (:206) ->
// stoat_tpu/stats/special.py student_t_sf2 (:53) -> jax.scipy.special
// .betainc (JAX 0.9 regularized_incomplete_beta_impl, from XLA's math.cc),
// followed by the jnp.where(degenerate, nan, .) of stoat_tpu/pipeline/
// quantitative.py:339-347.  For every snarl i:
//
//   p        = t1 finite ? I_x(df/2, 1/2) with x = df / (df + t1^2) : 1.0
//   outputs  = degenerate ? NaN : (p, beta1, se1, r2)
//
// Given no masking arrays (null pointers), it writes p alone: the
// permutation test's finish_linear_pvalues over its [K * S] statistics
// (stoat_tpu/pipeline/permutation.py:115, stats/linreg.py linear_pvalues).
//
// I_x(a, b) is the Lentz-Thompson-Barnett continued fraction (DLMF
// 8.17.22), at most 599 iterations, on (a, b, x) when x < (a+1)/(a+b+2)
// and on (b, a, 1-x) with 1 - result otherwise, times the prefactor
// x^a (1-x)^b / (a B(a, b)) from lgamma.  It is the plain version's
// (stats/special.py betainc_plain) arithmetic, operation for operation;
// -fmad=false keeps every multiply and add separately rounded.  Two
// behaviours are kept on purpose: subnormal x, prefactor and p are
// flushed to 0 (XLA flushes them under the JAX package), and each element
// stops iterating at its own convergence, where JAX stops only when the
// whole batch has converged (a few ulps of difference).
//
// What bounds it on the card: the continued fraction's dependent chain of
// float64 divisions (up to 599 iterations for large df near the branch
// point), not bytes: it reads 6 and writes 4 doubles per snarl.  Each
// iteration divides three times: the partial numerator (a function of n,
// a, b and x alone), then 1 + num / c and 1 / (1 + num d), which carry the
// chain.  The direct and the mirrored fraction are one loop, but their
// elements take very different numbers of iterations, and a warp runs as
// long as its slowest lane.  Two designs, by size:
//   - a call that fits in one wave (the chunks' [S]): one element a
//     thread, start to end, nothing on the chain but the iteration:
//     latency;
//   - a larger call (the permutation pass's [K * S], 8.2e6 elements):
//     warps take batches of 256 elements in turn from a counter in global
//     memory and set them up, an element a lane at a time (the NA
//     masking, the masks of the incomplete beta, after which an element
//     may need no fraction, the branch, and the prefactor from lgamma),
//     staging in shared memory the elements that need the fraction;
//     each lane takes the list's next element as soon as its own has
//     converged, and when the list is handed out the warp sets up its
//     next batch while the lanes that still iterate keep their element:
//     lanes idle only at the end of the call; one vote an iteration says
//     whether a lane is free.
// In both, the loop computes the next iteration's partial numerator before
// it divides along the chain (the independent division issued ahead of
// the dependent ones), with its operands selected rather than branched
// on, so that lanes at different iterations run the same instructions.
// Every element's operations are the plain version's, in its order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cmath>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // the one-wave kernel's block
constexpr int kBatchThreads = 128;  // the batch kernel's block
constexpr int kBatch = 256;
constexpr int kIterations = 600;
constexpr double kHalfEps = 1.1102230246251565e-16;  // float64 eps / 2
constexpr double kDblMin = 2.2250738585072014e-308;
constexpr double kTwoTiny = 2.0 * kDblMin;

__device__ __forceinline__ double flush(double v) {
  return fabs(v) < kDblMin ? 0.0 : v;
}

// partial numerator n >= 2 of the continued fraction, in JAX's order:
//   n even, m = (n - 1) / 2 = 0:  -(a + b) * x / (a + 1)
//   n even, m > 0:  -(a + m) * (a + b + m) * x / ((a + 2m) * (a + 2m + 1))
//   n odd:           m * (b - m) * x / ((a + 2m - 1) * (a + 2m))
// as one sequence of operations whose operands are selected, so that lanes
// at different n run the same instructions: the factors that m = 0 lacks
// are 1.0, and a product by 1.0 is exact (n = 1's numerator is 1.0)
__device__ __forceinline__ double cf_numerator(int n, double a, double b,
                                               double x) {
  const double m = double((n - 1) / 2);
  const bool even = (n & 1) == 0;
  const bool first = m == 0.0;
  const double f1 = even ? (first ? -(a + b) : -(a + m)) : m;
  const double f2 = even ? (first ? 1.0 : a + b + m) : b - m;
  const double q1 = even ? (first ? a + 1.0 : a + 2.0 * m) : a + 2.0 * m - 1.0;
  const double q2 = even ? (first ? 1.0 : a + 2.0 * m + 1.0) : a + 2.0 * m;
  return f1 * f2 * x / (q1 * q2);
}

// I_x(a, b)'s arguments for the fraction: x = df / (df + t^2), then
// (a, b, x) = (df / 2, 1 / 2, x), or (1 / 2, df / 2, 1 - x) where the
// fraction is mirrored (rapid false); the masks of betainc_plain
struct Beta {
  double a, b, x;
  bool rapid, is_zero, is_one, is_nan;
};

__device__ __forceinline__ Beta beta_args(double t, double nu) {
  const double ta = fabs(t);
  Beta e;
  e.x = flush(nu / (nu + ta * ta));
  e.a = nu * 0.5;
  e.b = 0.5;
  const double inf = INFINITY;
  const bool a_is_zero = e.a == 0.0 || e.b == inf;
  const bool b_is_zero = e.b == 0.0 || e.a == inf;
  const bool x_is_zero = e.x == 0.0;
  const bool x_is_one = e.x == 1.0;
  e.is_zero = (b_is_zero && !x_is_one) || (a_is_zero && x_is_zero);
  e.is_one = (a_is_zero && !x_is_zero) || (b_is_zero && x_is_one);
  e.is_nan = e.a < 0.0 || e.b < 0.0 || e.x < 0.0 || e.x > 1.0 ||
             (a_is_zero && b_is_zero) || isnan(e.a) || isnan(e.b) ||
             isnan(e.x);
  e.rapid = e.x < (e.a + 1.0) / (e.a + e.b + 2.0);
  if (!e.rapid) {
    const double a_orig = e.a;
    e.a = e.b;
    e.b = a_orig;
    e.x = 1.0 - e.x;
  }
  return e;
}

// x^a (1-x)^b / (a B(a, b)) from lgamma, with JAX's a < 2 tiny branch
__device__ double prefactor(const Beta& e) {
  const double lbeta_small_a = lgamma(e.b) - lgamma(e.a + e.b);
  if (e.a < kTwoTiny) return flush(exp(log1p(-e.x) * e.b - lbeta_small_a));
  const double lbeta = lgamma(e.a) + lbeta_small_a;
  return flush(flush(exp(log(e.x) * e.a + log1p(-e.x) * e.b - lbeta)) / e.a);
}

// the Lentz-Thompson-Barnett iteration n of the fraction on (a, b, x),
// partial denominators 0, 1, 1, ..., one step at a time
struct Fraction {
  double h, c, d, num;
  int n;
};

__device__ __forceinline__ void fraction_begin(const Beta& e, Fraction* f) {
  f->h = kHalfEps;
  f->c = kHalfEps;
  f->d = 0.0;
  f->num = 1.0;  // iteration 1's numerator
  f->n = 1;
}

// iteration f->n; true once the element has converged or run 599
__device__ __forceinline__ bool fraction_step(const Beta& e, Fraction* f) {
  // iteration n + 1's numerator, off the chain of c and d
  const double next = cf_numerator(f->n + 1, e.a, e.b, e.x);
  double cn = 1.0 + f->num / f->c;
  if (fabs(cn) < kHalfEps) cn = kHalfEps;
  double dn = 1.0 + f->num * f->d;
  if (fabs(dn) < kHalfEps) dn = kHalfEps;
  dn = 1.0 / dn;
  const double delta = cn * dn;
  f->c = cn;
  f->d = dn;
  f->h = f->h * delta;
  if (!(fabs(delta - 1.0) >= kHalfEps)) return true;  // NaN stops too
  f->num = next;
  f->n += 1;
  return f->n >= kIterations;
}

// p of the element: flush(I_x) from the fraction and the prefactor
__device__ __forceinline__ double beta_end(const Beta& e, double cf,
                                           double factor) {
  double result = flush(cf * factor);
  if (!e.rapid) result = 1.0 - result;
  return flush(result);
}

// element i's setup: the NA masking, then p where no fraction is needed
// (a degenerate snarl, a t that is not finite, a mask of the incomplete
// beta); else false with *e set and the prefactor returned in *factor
__device__ __forceinline__ bool setup(
    const double* __restrict__ t1, const double* __restrict__ df,
    const uint8_t* __restrict__ degenerate, const double* __restrict__ beta,
    const double* __restrict__ se, const double* __restrict__ r2,
    double* __restrict__ p_out, double* __restrict__ beta_out,
    double* __restrict__ se_out, double* __restrict__ r2_out, int64_t i,
    Beta* e, double* factor) {
  const bool deg = degenerate != nullptr && degenerate[i] != 0;
  if (degenerate != nullptr) {
    beta_out[i] = deg ? NAN : beta[i];
    se_out[i] = deg ? NAN : se[i];
    r2_out[i] = deg ? NAN : r2[i];
  }
  const double t = t1[i];
  if (deg) {
    p_out[i] = NAN;
  } else if (!isfinite(t)) {
    p_out[i] = 1.0;
  } else {
    *e = beta_args(t, df[i]);
    if (e->is_nan) {
      p_out[i] = NAN;
    } else if (e->is_one) {
      p_out[i] = 1.0;
    } else if (e->is_zero) {
      p_out[i] = 0.0;
    } else {
      *factor = prefactor(*e);
      return false;
    }
  }
  return true;
}

// a call that fits in one wave (the chunks' [S]): one element a thread,
// start to end, no bookkeeping on the chain
__global__ void __launch_bounds__(kThreads) student_t_kernel(
    const double* __restrict__ t1, const double* __restrict__ df,
    const uint8_t* __restrict__ degenerate, const double* __restrict__ beta,
    const double* __restrict__ se, const double* __restrict__ r2,
    double* __restrict__ p_out, double* __restrict__ beta_out,
    double* __restrict__ se_out, double* __restrict__ r2_out, int64_t S) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= S) return;
  Beta e;
  double factor = 0.0;
  if (setup(t1, df, degenerate, beta, se, r2, p_out, beta_out, se_out,
            r2_out, i, &e, &factor)) {
    return;
  }
  Fraction f;
  fraction_begin(e, &f);
  while (!fraction_step(e, &f)) {
  }
  p_out[i] = beta_end(e, f.h, factor);
}

__device__ unsigned long long batch_counter;

// a larger call (the permutation pass's [K * S]): warps take batches of
// kBatch elements in turn; setup an element a lane at a time, the pending
// ones listed (their prefactor in p_out until the end); a lane takes the
// list's next element when it has none, and when the list is handed out
// the warp sets up its next batch while the lanes that still iterate keep
// their element
// a listed element of a batch, staged in shared memory by the warp that
// set it up: the fraction's arguments, its prefactor, its offset in the
// batch
struct Staged {
  double a, b, x, factor;
  uint16_t offset;
  bool rapid;
};

__global__ void __launch_bounds__(kBatchThreads) student_t_batch_kernel(
    const double* __restrict__ t1, const double* __restrict__ df,
    const uint8_t* __restrict__ degenerate, const double* __restrict__ beta,
    const double* __restrict__ se, const double* __restrict__ r2,
    double* __restrict__ p_out, double* __restrict__ beta_out,
    double* __restrict__ se_out, double* __restrict__ r2_out, int64_t S) {
  __shared__ Staged staged[kBatchThreads / 32][kBatch];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Staged* list = staged[threadIdx.x >> 5];
  // the batch being handed out, the same in every lane: its first element,
  // its listed elements, the first not yet taken
  int64_t base = 0;
  int count = 0;
  int next = 0;
  bool more = true;
  // a lane's element
  bool busy = false;
  int64_t i = 0;
  double factor = 0.0;
  Beta e;
  Fraction f;
  while (true) {
    if (next == count && more) {
      unsigned long long batch = 0;
      if (lane == 0) batch = atomicAdd(&batch_counter, 1ull);
      base = int64_t(__shfl_sync(~0u, batch, 0)) * kBatch;
      more = base < S;
      count = 0;
      for (int j = 0; more && j < kBatch; j += 32) {
        const int64_t k = base + j + lane;
        bool pending = false;
        Beta ek;
        double fk = 0.0;
        if (k < S) {
          pending = !setup(t1, df, degenerate, beta, se, r2, p_out, beta_out,
                           se_out, r2_out, k, &ek, &fk);
        }
        const unsigned lanes = __ballot_sync(~0u, pending);
        if (pending) {
          list[count + __popc(lanes & below)] =
              Staged{ek.a, ek.b, ek.x, fk, uint16_t(j + lane), ek.rapid};
        }
        count += __popc(lanes);
      }
      next = 0;
      __syncwarp();
    }
    const unsigned idle = __ballot_sync(~0u, !busy);
    const int left = count - next;
    if (!busy) {
      const int rank = __popc(idle & below);
      if (rank < left) {
        const Staged st = list[next + rank];
        i = base + st.offset;
        e.a = st.a;
        e.b = st.b;
        e.x = st.x;
        e.rapid = st.rapid;
        factor = st.factor;
        fraction_begin(e, &f);
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
      if (busy && fraction_step(e, &f)) {
        p_out[i] = beta_end(e, f.h, factor);
        busy = false;
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

std::atomic<int> wave_of[kMaxDevices];
std::atomic<int> batch_blocks_of[kMaxDevices];

}  // namespace

extern "C" int student_t_launch(const void* t1, const void* df,
                                const void* degenerate, const void* beta,
                                const void* se, const void* r2, void* p_out,
                                void* beta_out, void* se_out, void* r2_out,
                                int64_t S, void* stream) {
  const int wave = resident_blocks(student_t_kernel, kThreads, wave_of);
  const int batch_blocks = resident_blocks(student_t_batch_kernel,
                                           kBatchThreads, batch_blocks_of);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const double*>(t1);
  const auto* d = static_cast<const double*>(df);
  const auto* deg = static_cast<const uint8_t*>(degenerate);
  const auto* b = static_cast<const double*>(beta);
  const auto* e = static_cast<const double*>(se);
  const auto* r = static_cast<const double*>(r2);
  auto* po = static_cast<double*>(p_out);
  auto* bo = static_cast<double*>(beta_out);
  auto* eo = static_cast<double*>(se_out);
  auto* ro = static_cast<double*>(r2_out);
  const int64_t blocks = (S + kThreads - 1) / kThreads;
  if (S > 0 && blocks <= wave) {
    student_t_kernel<<<unsigned(blocks), kThreads, 0, s>>>(
        t, d, deg, b, e, r, po, bo, eo, ro, S);
  } else if (S > 0) {
    // the batch counter starts at 0 for every launch (the calls of one
    // stream run in turn, as the port's do)
    void* counter = nullptr;
    cudaGetSymbolAddress(&counter, batch_counter);
    cudaMemsetAsync(counter, 0, sizeof(unsigned long long), s);
    const int64_t batches = (S + kBatch - 1) / kBatch;
    const int64_t grid = (batches + kBatchThreads / 32 - 1) /
                         (kBatchThreads / 32);
    student_t_batch_kernel<<<unsigned(grid < batch_blocks ? grid
                                                           : batch_blocks),
                             kBatchThreads, 0, s>>>(t, d, deg, b, e, r, po,
                                                    bo, eo, ro, S);
  }
  return int(cudaGetLastError());
}

extern "C" const char* student_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
