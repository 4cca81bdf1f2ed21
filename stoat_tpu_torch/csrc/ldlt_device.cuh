// The unpivoted LDL^T factor and solve of a small symmetric P x P matrix
// on one thread, shared by ols.cu (K9) and logreg.cu (K11).
//
// The operation order is that of stats/linalg.py ldlt_factor and
// ldlt_solve in the port (stoat_tpu/stats/linreg.py _ols_unrolled_body's
// order): sequential subtractions, (L_ik * L_jk) * D_k, a zero pivot
// divided as 1.  Built with -fmad=false, each multiply and add is rounded
// as the plain version rounds it.

#pragma once

namespace stoat {

// A = L D L^T: L unit lower triangular (its strict lower part written),
// D the pivots
__device__ inline void ldlt_factor(const double* A, double* L, double* D,
                                   int P) {
  for (int j = 0; j < P; ++j) {
    double dj = A[j * P + j];
    for (int k = 0; k < j; ++k) dj = dj - L[j * P + k] * L[j * P + k] * D[k];
    D[j] = dj;
    const double dj_safe = dj == 0.0 ? 1.0 : dj;
    for (int i = j + 1; i < P; ++i) {
      double s = A[i * P + j];
      for (int k = 0; k < j; ++k) s = s - L[i * P + k] * L[j * P + k] * D[k];
      L[i * P + j] = s / dj_safe;
    }
  }
}

// x = (L D L^T)^-1 x in place: forward substitution, the diagonal, then
// backward substitution
__device__ inline void ldlt_solve(const double* L, const double* D,
                                  double* x, int P) {
  for (int i = 0; i < P; ++i) {
    double s = x[i];
    for (int k = 0; k < i; ++k) s = s - L[i * P + k] * x[k];
    x[i] = s;
  }
  for (int t = P - 1; t >= 0; --t) {
    double s = x[t] / (D[t] == 0.0 ? 1.0 : D[t]);
    for (int k = t + 1; k < P; ++k) s = s - L[k * P + t] * x[k];
    x[t] = s;
  }
}

}  // namespace stoat
