// K13: masked OLS of (snarl, gene) pairs for the eQTL mode, one block per
// snarl.
//
// Replaces stoat_tpu/pipeline/quantitative.py eqtl_regress_pairs (:599-623)
// up to its Student-t tail.  The JAX program gathers X[pair_snarl] into
// [B, N, PT] and runs stoat_tpu/stats/linreg.py linear_regression_batch
// (:212; linear_regression_stats_batch :141, _ols_unrolled_body :47) on
// y = expr[gene] * used, so every pair rebuilds its snarl's X^T X.  A
// snarl's X and its inverse do not depend on the gene: here the pairs come
// as CSR by snarl (pair_off [S + 1], pair_gene [B], in the (snarl, gene)
// order of the host's loop) and, per snarl s with pairs b in
// pair_off[s] .. pair_off[s + 1]:
//
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   inv    = A^-1 by LDL^T, or the Jacobi pseudo-inverse when a real pivot
//            is below 1e-10 or not finite (ols_device.cuh, as ols.cu and
//            perm_ols.cu): once per snarl
//   for each pair b, gene g = pair_gene[b], y = expr[g] * used:
//            beta = inv X^T y;  mean = (sum of y over the used rows) / n_used
//            rss, tss = sums over the used rows of (y - X beta)^2 and
//            (y - mean)^2;  df_res = max(n_used - ncols + 1, 1)
//            out[b] = (beta_1 / se_1, df_res, beta_1,
//                      se_1 = sqrt(inv_11 rss / df_res), 1 - rss / tss)
//
// The Student-t tail and the NA of degenerate snarls follow in
// student_t.cu over [B] (pipeline/quantitative.py eqtl_regress_pairs).
//
// What bounds it on the card: memory.  Each input read once and each output
// written once is X (S * N * PT * 8 bytes, 1.15 GB per chunk at S = 8,192,
// N = 2,504, PT = 7), the [G, N] expression rows and 40 bytes per pair:
// 0.35 ms at 3.35 TB/s; its float64 work, about (4 PT + 4) N per pair
// (7.2e9 at 90,000 pairs), is 0.1 ms at 67 TFLOP/s.  Design:
// ols_block_device.cuh with the snarl's genes kG = 16 at a time: the
// snarl's first R rows of X held in shared memory across the batches, the
// 8 x 8 tiles of [X | m]^T [X | y_0 .. y_15] on the float64 tensor cores,
// one a pass over the rows (three at PT = 7; the first batch's also give
// X^T X), the inverse once by warp 0, then residual passes in which every
// thread takes rows for 4 genes at a time (no spills; 8 genes a residual
// pass spilled 8 registers and took 1.15x as long, and batches of 8 genes
// 1.12x as long, tools/kernel_ab.py on an H100).  Each pair's expression row is read from L2 in each tile pass
// that holds it and in its residual pass.  The tensor cores fuse their
// multiply-adds whatever -fmad says; the algebra is separately rounded, as
// the plain version's.  A block whose snarl has no pair (filtered snarls,
// padding) leaves at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "ols_block_device.cuh"

namespace {

constexpr int kGenes = 16;     // genes a batch
constexpr int kResidual = 4;   // genes a residual pass

template <bool kAlgSmem>
__global__ void __launch_bounds__(stoat::ob::kThreads, 3)
    eqtl_ols_kernel(const double* __restrict__ X,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ ncols, stoat::ob::Rows ys,
                    double* __restrict__ work, stoat::ob::Out out, int64_t N,
                    int P, int64_t R) {
  stoat::ob::ols_block<kGenes, kResidual, true, kAlgSmem>(
      X, mask, ncols, ys, work, out, N, P, R);
}

}  // namespace

// scratch doubles per snarl: the algebra's where it does not fit in shared
// memory, else none
extern "C" int64_t eqtl_ols_work_doubles(int64_t P) {
  return stoat::ob::work_doubles<kGenes>(P);
}

extern "C" int eqtl_ols_launch(const void* X, const void* mask,
                               const void* ncols, const void* pair_off,
                               const void* pair_gene, const void* expr,
                               void* work, void* t1_out, void* df_out,
                               void* beta1_out, void* se1_out, void* r2_out,
                               int64_t S, int64_t N, int64_t P,
                               void* stream) {
  const stoat::ob::Rows rows{static_cast<const double*>(expr),
                             static_cast<const int32_t*>(pair_off),
                             static_cast<const int32_t*>(pair_gene)};
  const stoat::ob::Out out{
      static_cast<double*>(t1_out), static_cast<double*>(df_out),
      static_cast<double*>(beta1_out), static_cast<double*>(se1_out),
      static_cast<double*>(r2_out)};
  return stoat::ob::launch<kGenes>(
      eqtl_ols_kernel<true>, eqtl_ols_kernel<false>,
      static_cast<const double*>(X), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), rows, static_cast<double*>(work),
      out, S, N, P, static_cast<cudaStream_t>(stream));
}

extern "C" const char* eqtl_ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
