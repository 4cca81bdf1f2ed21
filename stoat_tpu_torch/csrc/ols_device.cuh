// The normal equations of one masked OLS: the inverse of X^T X by LDL^T,
// or the Jacobi pseudo-inverse of a rank-deficient snarl.  Shared by
// perm_ols.cu (K16a, normal_inverse on one thread) and
// ols_block_device.cuh (K9 and K13, the same steps spread over a warp).
//
// From A = X^T X (the padded columns' diagonal already set to 1), the
// inverse by the unpivoted LDL^T of ldlt_device.cuh solved against the
// identity, or, when a real pivot (j < ncols) is below 1e-10 or not
// finite, the Jacobi pseudo-inverse (12 cyclic sweeps, eigenvalues with
// |w| <= 1e-6 dropped): stoat_tpu/stats/linreg.py _ols_unrolled_body
// (:47-137) with stoat_tpu/stats/linalg.py jacobi_eigh and sym_pinv, in the
// operation order of the port's plain version (stats/linreg.py,
// stats/linalg.py).  Built with -fmad=false.

#pragma once

#include <cmath>

#include "ldlt_device.cuh"

namespace stoat {

constexpr double kLdltTol = 1e-10;  // stats_test.cpp:401
constexpr double kPinvTol = 1e-6;   // stats_test.cpp:386
constexpr int kSweeps = 12;

// one Jacobi rotation of rows/columns p, q of A (P x P), accumulated in V
__device__ inline void jacobi_rotate(double* A, double* V, int P, int p,
                                     int q) {
  const double app = A[p * P + p];
  const double aqq = A[q * P + q];
  const double apq = A[p * P + q];
  const bool small = fabs(apq) < 1e-300;
  const double apq_safe = small ? 1.0 : apq;
  const double tau = (aqq - app) / (2.0 * apq_safe);
  // jnp.sign: NaN stays NaN
  const double sg = tau > 0.0 ? 1.0 : (tau < 0.0 ? -1.0 : tau);
  double t = sg / (fabs(tau) + sqrt(1.0 + tau * tau));
  if (tau == 0.0) t = 1.0;
  double c = 1.0 / sqrt(1.0 + t * t);
  double s = t * c;
  if (small) {
    c = 1.0;
    s = 0.0;
  }
  for (int k = 0; k < P; ++k) {
    const double rp = A[p * P + k];
    const double rq = A[q * P + k];
    A[p * P + k] = c * rp - s * rq;
    A[q * P + k] = s * rp + c * rq;
  }
  for (int k = 0; k < P; ++k) {
    const double cp = A[k * P + p];
    const double cq = A[k * P + q];
    A[k * P + p] = c * cp - s * cq;
    A[k * P + q] = s * cp + c * cq;
  }
  for (int k = 0; k < P; ++k) {
    const double vp = V[k * P + p];
    const double vq = V[k * P + q];
    V[k * P + p] = c * vp - s * vq;
    V[k * P + q] = s * vp + c * vq;
  }
}

// Whether the factor's pivots call for the pseudo-inverse: a real pivot
// (j < nc) below kLdltTol in magnitude, or not finite.
__device__ inline bool rank_deficient(const double* D, int P, int nc) {
  bool bad = false;
  for (int j = 0; j < nc && j < P; ++j) {
    bad = bad || fabs(D[j]) < kLdltTol || !isfinite(D[j]);
  }
  return bad;
}

// inv = the Jacobi pseudo-inverse of A (sym_pinv; L, V and col are
// scratch of P x P, P x P and P doubles)
__device__ inline void jacobi_pinv(const double* A, double* L, double* inv,
                                   double* V, double* col, int P) {
  for (int e = 0; e < P * P; ++e) {
    L[e] = A[e];
    V[e] = (e / P == e % P) ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int p = 0; p < P - 1; ++p) {
      for (int q = p + 1; q < P; ++q) jacobi_rotate(L, V, P, p, q);
    }
  }
  for (int p = 0; p < P; ++p) {
    const double w = L[p * P + p];
    col[p] = fabs(w) > kPinvTol ? 1.0 / (w == 0.0 ? 1.0 : w) : 0.0;
  }
  for (int i = 0; i < P; ++i) {
    for (int j = 0; j < P; ++j) {
      double acc = 0.0;
      for (int p = 0; p < P; ++p) {
        acc = acc + V[i * P + p] * col[p] * V[j * P + p];
      }
      inv[i * P + j] = acc;
    }
  }
}

// inv = A^-1 or its pseudo-inverse (P x P each; L, V, D and col are
// scratch of P x P, P x P, P and P doubles), on one thread.  Returns
// whether the pseudo-inverse was taken.
__device__ inline bool normal_inverse(const double* A, double* L,
                                      double* inv, double* V, double* D,
                                      double* col, int P, int nc) {
  ldlt_factor(A, L, D, P);
  const bool bad = rank_deficient(D, P, nc);
  // the inverse, one identity column at a time (ldlt_solve)
  for (int m = 0; m < P; ++m) {
    for (int i = 0; i < P; ++i) col[i] = i == m ? 1.0 : 0.0;
    ldlt_solve(L, D, col, P);
    for (int i = 0; i < P; ++i) inv[i * P + m] = col[i];
  }
  // Jacobi pseudo-inverse (sym_pinv): L becomes the working copy of A
  if (bad) jacobi_pinv(A, L, inv, V, col, P);
  return bad;
}

}  // namespace stoat
