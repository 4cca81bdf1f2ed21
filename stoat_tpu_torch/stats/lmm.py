"""Linear mixed model (EMMAX) for ``vcf -q -k --lmm``.

The port of stoat_tpu/stats/lmm.py.  The reference declares an LMM and
parses kinship matrices but never implements the model; stoat_tpu adds one
behind ``--lmm``:

  y = X b + u + e,   u ~ N(0, sg^2 K),  e ~ N(0, se^2 I),  delta = se^2/sg^2

  1. once per dataset (host, float64 numpy): eigendecompose K = U S U^T and
     REML-profile delta on a log10 grid with golden-section refinement
     (``fit_null_reml``; LmmContext, _solve_spd, reml_loglik and
     fit_null_reml are copies of stoat_tpu/stats/lmm.py:54-160, numpy as
     there, so both packages fit the same null model)
  2. per snarl (device): GLS == OLS on rows rotated by
     W = diag(1/sqrt(S + delta)) U^T, against y_rot = W y, with every row
     of every design kept (``lmm_regression_batch``, K14, :163-184).

EMMAX semantics: every phenotyped sample stays in every test (a sample
with no allele call contributes genotype 0), unlike the OLS path, which
drops such samples per snarl.  The reported R^2 is on the rotated scale.

The rotation is one [N, N] x [N, S * PT] float64 product (torch.matmul, on
the card a library GEMM, as XLA leaves stoat_tpu's einsum to its own dot);
the OLS that follows is K9 (csrc/ols.cu on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from stoat_tpu_torch.stats.linreg import linear_regression_row_stats

__all__ = ["LmmContext", "fit_null_reml", "lmm_regression_batch",
           "lmm_rotate", "reml_loglik"]

_DELTA_GRID = np.logspace(-5.0, 5.0, 121)
_GOLDEN_ITERS = 60


@dataclass
class LmmContext:
    """Dataset-level LMM state shared by every snarl test."""

    rot: np.ndarray        # [N, N]  W = diag(1/sqrt(S+delta)) U^T
    y_rot: np.ndarray      # [N]     rotated phenotype
    delta: float           # se^2 / sg^2 at the REML optimum
    sigma_g2: float
    sigma_e2: float
    loglik: float          # REML LL at the optimum

    @property
    def heritability(self) -> float:
        """Pseudo-heritability h^2 = sg^2/(sg^2+se^2) = 1/(1+delta)."""
        return 1.0 / (1.0 + self.delta)


def _solve_spd(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve with a pseudo-inverse fallback for singular designs
    (collinear/constant covariate columns) — the OLS path survives
    exactly this via its LDLT tolerance + SVD fallback
    (stats_test.cpp:398-421); the LMM null fit must not crash either."""
    try:
        return np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(A) @ b


def reml_loglik(delta: float, S: np.ndarray, yt: np.ndarray,
                X0t: np.ndarray, logdet_XtX: float) -> float:
    """REML profile log-likelihood at ``delta`` (rotated inputs)."""
    n = yt.shape[0]
    q = X0t.shape[1]
    w = 1.0 / (S + delta)
    XtWX = X0t.T @ (w[:, None] * X0t)
    beta = _solve_spd(XtWX, X0t.T @ (w * yt))
    r = yt - X0t @ beta
    R = float(np.sum(w * r * r))
    _sign, logdet_XtWX = np.linalg.slogdet(XtWX)
    nq = n - q
    return 0.5 * (nq * np.log(nq / (2.0 * np.pi)) - nq - nq * np.log(R)
                  - float(np.sum(np.log(S + delta))) - logdet_XtWX
                  + logdet_XtX)


def fit_null_reml(phenotype: np.ndarray, kinship: np.ndarray,
                  covar: Optional[np.ndarray] = None) -> LmmContext:
    """Fit the null model y = [1|covars] b + u + e by REML over delta.

    ``kinship`` must already be ordered to the phenotype's samples.
    """
    y = np.asarray(phenotype, np.float64)
    n = y.shape[0]
    K = np.asarray(kinship, np.float64)
    if K.shape != (n, n):
        raise ValueError(f"kinship is {K.shape}, expected ({n}, {n})")
    K = 0.5 * (K + K.T)
    S, U = np.linalg.eigh(K)
    S = np.clip(S, 0.0, None)

    X0 = np.ones((n, 1))
    if covar is not None and covar.size:
        X0 = np.concatenate([X0, np.asarray(covar, np.float64)], axis=1)
    yt = U.T @ y
    X0t = U.T @ X0
    _s, logdet_XtX = np.linalg.slogdet(X0.T @ X0)

    lls = np.array([reml_loglik(d, S, yt, X0t, logdet_XtX)
                    for d in _DELTA_GRID])
    best = int(np.argmax(lls))
    lo = _DELTA_GRID[max(best - 1, 0)]
    hi = _DELTA_GRID[min(best + 1, len(_DELTA_GRID) - 1)]

    # golden-section refine in log space
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c = b - phi * (b - a)
    d = a + phi * (b - a)
    fc = reml_loglik(np.exp(c), S, yt, X0t, logdet_XtX)
    fd = reml_loglik(np.exp(d), S, yt, X0t, logdet_XtX)
    for _ in range(_GOLDEN_ITERS):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = reml_loglik(np.exp(c), S, yt, X0t, logdet_XtX)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = reml_loglik(np.exp(d), S, yt, X0t, logdet_XtX)
    delta = float(np.exp(0.5 * (a + b)))
    ll = reml_loglik(delta, S, yt, X0t, logdet_XtX)

    w = 1.0 / (S + delta)
    XtWX = X0t.T @ (w[:, None] * X0t)
    beta = _solve_spd(XtWX, X0t.T @ (w * yt))
    r = yt - X0t @ beta
    R = float(np.sum(w * r * r))
    sigma_g2 = R / (n - X0.shape[1])
    rot = (np.sqrt(w)[:, None] * U.T)

    return LmmContext(rot=rot, y_rot=rot @ y, delta=delta,
                      sigma_g2=sigma_g2, sigma_e2=delta * sigma_g2,
                      loglik=float(ll))


def lmm_rotate(rot: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """rot @ X[s] for every design s: float64 [S, N, PT] from rot [N, N]
    and X [S, N, PT] (stoat_tpu's einsum "mn,snp->smp").

    X is laid out as [N, S * PT] (one copy) so that the rotation is a
    single [N, N] x [N, S * PT] product: as S products of width PT, each
    would read all of rot again (410 GB per 8,192-snarl chunk at N =
    2,504).  The result is copied back to [S, N, PT]."""
    S, N, PT = X.shape
    flat = X.permute(1, 0, 2).reshape(N, S * PT)
    return torch.matmul(rot, flat).reshape(N, S, PT).permute(1, 0, 2) \
        .contiguous()


def lmm_regression_batch(X: torch.Tensor, rot: torch.Tensor,
                         y_rot: torch.Tensor, ncols: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """Batched per-snarl GLS as rotated OLS (K14): (t1, df_res, beta1,
    se1, r2), float64 [S] each.

    X float64 [S, N, PT]: EMMAX designs over all samples (intercept 1
    everywhere, genotype 0 where uncalled, padded columns zero); ``rot``
    [N, N] and ``y_rot`` [N] from :func:`fit_null_reml`; ``ncols`` int32
    [S].  The rotated rows are all used and every design's y is y_rot:
    the OLS takes the row and no mask (linear_regression_row_stats), so
    neither an [S, N] y nor an all-true mask is built.  The p-values
    follow in the caller."""
    return linear_regression_row_stats(lmm_rotate(rot, X), y_rot, None,
                                       ncols)
