// K6: graph mode's statistics, chi-squared 2x2, Fisher and chi-squared 2xN,
// one thread per snarl row.
//
// Replaces stoat_tpu/graph/association.py _graph_stats_fused (:496-513),
// which chains stoat_tpu/stats/chi2.py chi2_2x2 (:32-85) and chi2_2xn
// (:89-133) and stoat_tpu/stats/fisher.py fisher_exact_2x2 (:165) on the
// [B, Pmax] walk-set partition counts of the native graph core.  Row b
// holds k <= Pmax partitions: G0 (controls) and G1 (cases), int32 sample
// tallies, and a column mask.  Per row the kernel writes
//
//   - the 2x2 statistic of (G0[b, 0], G0[b, 1], G1[b, 0], G1[b, 1]) with
//     its invalid (a zero margin) and zero-expected flags;
//   - the Fisher p of the same table, through fisher_device.cuh, the
//     device function fisher.cu runs;
//   - the 2xN statistic over the masked columns, summed in column order,
//     its df = max(columns - 1, 1) and its invalid flag.
//
// The operations and their order are those of stats/chi2.py and
// stats/fisher.py in the port; with -fmad=false every output is bitwise
// equal to the plain version.  The two tails then run on csrc/chi2_tail.cu
// (K5, stats/chi2.py finish_chi2_pvalues), as on the ``vcf -b`` path.
//
// What bounds it on the card: launch latency.  At 100,000 rows of 4
// columns it reads 3.2 MB of counts and writes 4.4 MB, microseconds of
// memory time; Fisher's data-dependent loops take the rest.  Fusing the
// chi-squared tail in is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "fisher_device.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void graph_stats_kernel(const int32_t* __restrict__ g0,
                                   const int32_t* __restrict__ g1,
                                   const uint8_t* __restrict__ mask,
                                   double* __restrict__ stat22,
                                   uint8_t* __restrict__ invalid22,
                                   uint8_t* __restrict__ zexp22,
                                   double* __restrict__ pfisher,
                                   double* __restrict__ statn,
                                   double* __restrict__ dfn,
                                   uint8_t* __restrict__ invalidn, int64_t B,
                                   int64_t Pm) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* r0 = g0 + b * Pm;
  const int32_t* r1 = g1 + b * Pm;
  const uint8_t* rm = mask + b * Pm;

  // chi-squared 2x2 (stats/chi2.py chi2_2x2_stat) and Fisher on the first
  // two columns, unmasked as in the JAX program (padding is zero)
  const double a = double(r0[0]), bb = double(r0[1]);
  const double c = double(r1[0]), d = double(r1[1]);
  const double row1 = a + bb;
  const double row2 = c + d;
  const double col1 = a + c;
  const double col2 = bb + d;
  const double total = row1 + row2;
  const bool invalid = row1 == 0.0 || row2 == 0.0 || col1 == 0.0 ||
                       col2 == 0.0;
  const double safe_total = invalid ? 1.0 : total;
  double ea = row1 * col1 / safe_total;
  double eb = row1 * col2 / safe_total;
  double ec = col1 * row2 / safe_total;
  double ed = col2 * row2 / safe_total;
  const bool zero_expected = ea == 0.0 || eb == 0.0 || ec == 0.0 ||
                             ed == 0.0;
  if (zero_expected) {
    ea = 1.0;
    eb = 1.0;
    ec = 1.0;
    ed = 1.0;
  }
  const double da = a - ea, db = bb - eb, dc = c - ec, dd = d - ed;
  stat22[b] = da * da / ea + db * db / eb + dc * dc / ec + dd * dd / ed;
  invalid22[b] = invalid;
  zexp22[b] = zero_expected;
  pfisher[b] = stoat::fisher_single(a, bb, c, d);

  // chi-squared 2xN (stats/chi2.py chi2_2xn_stat): the sums of integer
  // counts are exact in any order; the statistic sums in column order
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
  invalidn[b] = tot == 0.0 || row0 == 0.0 || rowc == 0.0 || any_zero_col;
  const double safe = tot == 0.0 ? 1.0 : tot;
  double stat = 0.0;
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
  statn[b] = stat;
  dfn[b] = double(ncols - 1 > 1 ? ncols - 1 : 1);
}

}  // namespace

extern "C" int graph_stats_launch(const void* g0, const void* g1,
                                  const void* mask, void* stat22,
                                  void* invalid22, void* zexp22,
                                  void* pfisher, void* statn, void* dfn,
                                  void* invalidn, int64_t B, int64_t Pm,
                                  void* stream) {
  if (Pm < 2) return int(cudaErrorInvalidValue);  // the 2x2 needs 2 columns
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    graph_stats_kernel<<<unsigned(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(g0), static_cast<const int32_t*>(g1),
        static_cast<const uint8_t*>(mask), static_cast<double*>(stat22),
        static_cast<uint8_t*>(invalid22), static_cast<uint8_t*>(zexp22),
        static_cast<double*>(pfisher), static_cast<double*>(statn),
        static_cast<double*>(dfn), static_cast<uint8_t*>(invalidn), B, Pm);
  }
  return int(cudaGetLastError());
}

extern "C" const char* graph_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
