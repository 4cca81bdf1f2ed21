// K9: batched masked OLS, one regression per snarl.
//
// Replaces stoat_tpu/stats/linreg.py linear_regression_stats_batch (:141;
// _ols_unrolled_body :47 for P <= 8, the matrix branch :150-202 above)
// with stoat_tpu/stats/linalg.py ldlt_factor (:33), ldlt_solve (:90),
// jacobi_eigh (:113) and sym_pinv (:170), on y = phenotype * used.  For
// snarl s with design X [N, P] (rows of unused samples zero), the used-row
// mask and ncols:
//
//   y      = pheno * used, pheno the phenotype row [N] that every snarl
//            shares; a null mask uses every row (the mixed model's rotated
//            designs)
//   A      = X^T X, plus 1 on the diagonal of padded columns (j >= ncols)
//   L, D   = unpivoted LDL^T of A; bad = some real |D_j| < 1e-10 or not
//            finite
//   inv    = A^-1 by solves against the identity, or, when bad, the
//            Jacobi pseudo-inverse (12 cyclic sweeps, eigenvalues with
//            |w| <= 1e-6 dropped)
//   beta   = inv X^T y; rss, tss over used rows; r2 = 1 - rss / tss
//   df_res = max(n_used - ncols + 1, 1); se1 = sqrt(inv_11 rss / df_res)
//   out    = (beta1 / se1, df_res, beta1, se1, r2)
//
// What bounds it on the card: memory.  Each input read once and each
// output written once is X, the mask and the phenotype row: S N (8 P + 1)
// bytes, 1.17 GB per chunk at S = 8192, N = 2,504, P = 7 (0.35 ms at 3.35
// TB/s).  Design: ols_block_device.cuh with one y a snarl (kG = 1): the
// snarl's first R rows of X held in shared memory, [X | m]^T [X | y] on
// the float64 tensor cores in one pass (at P = 7 one 8 x 8 tile), the
// algebra by warp 0 in shared memory, then a residual pass on every
// thread.  The tensor cores fuse their multiply-adds whatever -fmad says;
// the algebra is separately rounded, as the plain version's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC
//        (stoat_tpu_torch/kernels/build.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "ols_block_device.cuh"

namespace {

template <bool kAlgSmem>
__global__ void __launch_bounds__(stoat::ob::kThreads, 3)
    ols_kernel(const double* __restrict__ X, const uint8_t* __restrict__ mask,
               const int32_t* __restrict__ ncols, stoat::ob::Rows ys,
               double* __restrict__ work, stoat::ob::Out out, int64_t N,
               int P, int64_t R) {
  stoat::ob::ols_block<1, 1, false, kAlgSmem>(X, mask, ncols, ys, work, out,
                                               N, P, R);
}

}  // namespace

// scratch doubles per snarl: the algebra's where it does not fit in shared
// memory, else none
extern "C" int64_t ols_work_doubles(int64_t P) {
  return stoat::ob::work_doubles<1>(P);
}

extern "C" int ols_launch(const void* X, const void* pheno,
                          const void* mask, const void* ncols, void* work,
                          void* t1_out, void* df_out, void* beta1_out,
                          void* se1_out, void* r2_out, int64_t S, int64_t N,
                          int64_t P, void* stream) {
  const stoat::ob::Rows rows{static_cast<const double*>(pheno), nullptr,
                             nullptr};
  const stoat::ob::Out out{
      static_cast<double*>(t1_out), static_cast<double*>(df_out),
      static_cast<double*>(beta1_out), static_cast<double*>(se1_out),
      static_cast<double*>(r2_out)};
  return stoat::ob::launch<1>(
      ols_kernel<true>, ols_kernel<false>, static_cast<const double*>(X),
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(ncols), rows, static_cast<double*>(work),
      out, S, N, P, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ols_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
