"""Batched masked OLS (K9) and its p-value rule, float64.

The port of stoat_tpu/stats/linreg.py.  One call solves every snarl of a
chunk: X [B, N, P] is ``[1 | variant dosages | covariates | zero padding]``
with all-zero rows for samples a snarl does not use, ``y`` is 0 on those
rows, and ``ncols`` counts each snarl's real columns.  Semantics
(stats_test.cpp:383-506, through stoat_tpu):

  - padded columns get a 1 on the diagonal of X^T X, so they stay inert;
  - (X^T X)^-1 by an unpivoted LDL^T solved against the identity; a snarl
    with a real pivot |D| < 1e-10 (or not finite) takes the Jacobi
    pseudo-inverse with eigenvalue tolerance 1e-6 instead;
  - df_res = max(n - ncols + 1, 1); the first variant column is reported.

The plain version follows ``_ols_unrolled_body`` (linreg.py:47-137) for
every P: the JAX matrix branch for P > 8 (:150-202) is the same recursion
summed in another order.  CUDA tensors run csrc/ols.cu, and the p-values
and NA masking that follow (``student_t_pvalues``) csrc/student_t.cu.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, check_tensor, launch
from stoat_tpu_torch.stats.linalg import ldlt_factor, ldlt_solve, sym_pinv
from stoat_tpu_torch.stats.special import student_t_sf2_plain

__all__ = ["LDLT_TOL", "PINV_TOL", "linear_regression_stats",
           "linear_regression_stats_plain", "finish_linear_pvalues",
           "STUDENT_T_KEYS", "student_t_pvalues", "student_t_pvalues_plain"]

LDLT_TOL = 1e-10  # stats_test.cpp:401
PINV_TOL = 1e-6   # stats_test.cpp:386

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def linear_regression_stats_plain(X: torch.Tensor, y: torch.Tensor,
                                  row_mask: torch.Tensor,
                                  ncols: torch.Tensor) -> Stats:
    """Plain PyTorch version of :func:`linear_regression_stats`."""
    B, N, P = X.shape
    real = torch.arange(P, device=X.device)[None, :] < ncols[:, None]
    XtX = torch.einsum("bnp,bnq->bpq", X, X)
    XtX = XtX + torch.diag_embed(torch.where(real, 0.0, 1.0))
    Xty = torch.einsum("bnp,bn->bp", X, y)

    L, D = ldlt_factor(XtX)
    bad = (real & ((D.abs() < LDLT_TOL) | ~torch.isfinite(D))).any(dim=-1)
    eye = torch.eye(P, dtype=X.dtype, device=X.device).expand(B, P, P)
    inv = ldlt_solve(L, D, eye)
    if bool(bad.any()):
        # the pseudo-inverse of the rank-deficient snarls only: each
        # snarl's result depends on its own matrix alone
        rows = bad.nonzero().squeeze(-1)
        inv = inv.clone()
        inv[rows] = sym_pinv(XtX[rows], tol=PINV_TOL)

    beta = torch.zeros(B, P, dtype=X.dtype, device=X.device)
    for m in range(P):
        beta = beta + inv[:, :, m] * Xty[:, m, None]
    y_pred = X[:, :, 0] * beta[:, 0, None]
    for j in range(1, P):
        y_pred = y_pred + X[:, :, j] * beta[:, j, None]
    resid = torch.where(row_mask, y - y_pred, 0.0)
    rss = (resid * resid).sum(dim=-1)

    n_used = row_mask.sum(dim=-1).to(torch.float64)
    n_safe = torch.where(n_used == 0, 1.0, n_used)
    y_mean = torch.where(row_mask, y, 0.0).sum(dim=-1) / n_safe
    dev = y - y_mean[:, None]
    tss = torch.where(row_mask, dev * dev, 0.0).sum(dim=-1)
    r2 = 1.0 - rss / tss

    df_res = torch.clamp(n_used - ncols.to(torch.float64) + 1.0, min=1.0)
    mse = rss / df_res
    beta1 = beta[:, 1]
    se1 = torch.sqrt(inv[:, 1, 1] * mse)
    return beta1 / se1, df_res, beta1, se1, r2


def _ols_cuda(X, y, row_mask, ncols) -> Stats:
    device = X.device
    B, N, P = X.shape
    check_tensor(X, "X", torch.float64, (B, N, P), device)
    check_tensor(y, "y", torch.float64, (B, N), device)
    check_tensor(row_mask, "row_mask", torch.bool, (B, N), device)
    check_tensor(ncols, "ncols", torch.int32, (B,), device)
    # per snarl: X^T X, its factor, the inverse and Jacobi's V (P x P
    # each), then D, X^T y, beta and a solve column (P each), sums (4)
    work = torch.empty((B, 4 * P * P + 4 * P + 4), dtype=torch.float64,
                       device=device)
    out = [torch.empty(B, dtype=torch.float64, device=device)
           for _ in range(5)]
    launch("ols", [VOIDP] * 10 + [I64] * 3,
           [X.data_ptr(), y.data_ptr(), row_mask.data_ptr(),
            ncols.data_ptr(), work.data_ptr(),
            *(t.data_ptr() for t in out), B, N, P], device)
    return tuple(out)


def linear_regression_stats(X: torch.Tensor, y: torch.Tensor,
                            row_mask: torch.Tensor,
                            ncols: torch.Tensor) -> Stats:
    """Batched OLS: (t1, df_res, beta1, se1, r2), float64 [B] each.

    X float64 [B, N, P] (rows of unused samples and padded columns all
    zero), y float64 [B, N] (0 on unused rows), row_mask bool [B, N],
    ncols int32 [B].  stoat_tpu's linear_regression_stats_batch.

    CUDA tensors run csrc/ols.cu, one block per snarl: it reads X twice
    (the normal equations, then the residuals), so it is bound by those
    2 * B * N * P * 8 bytes; the P x P algebra runs on one thread per
    snarl.  CPU tensors run the plain version."""
    if kernels_enabled(X.device):
        return _ols_cuda(X, y, row_mask, ncols)
    return linear_regression_stats_plain(X, y, row_mask, ncols)


def finish_linear_pvalues(t1: torch.Tensor,
                          df_res: torch.Tensor) -> torch.Tensor:
    """Two-tailed Student-t p of ``t1``; NaN or infinite t1 gives 1.0
    (stats_test.cpp:479-485, stoat_tpu/stats/linreg.py:206-209)."""
    p = student_t_sf2_plain(t1.abs(), df_res)
    return torch.where(torch.isfinite(t1), p, 1.0)


STUDENT_T_KEYS = ("p", "beta", "se", "r2")


def student_t_pvalues_plain(t1, df_res, degenerate, beta1, se1, r2
                            ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`student_t_pvalues`."""
    nan = float("nan")
    p = finish_linear_pvalues(t1, df_res)
    return {key: torch.where(degenerate, nan, v)
            for key, v in zip(STUDENT_T_KEYS, (p, beta1, se1, r2))}


def _student_t_cuda(t1, df_res, degenerate, beta1, se1, r2):
    device = t1.device
    S = t1.shape[0]
    ins = (t1, df_res, beta1, se1, r2)
    for name, t in zip(("t1", "df_res", "beta1", "se1", "r2"), ins):
        check_tensor(t, name, torch.float64, (S,), device)
    check_tensor(degenerate, "degenerate", torch.bool, (S,), device)
    out = {key: torch.empty(S, dtype=torch.float64, device=device)
           for key in STUDENT_T_KEYS}
    launch("student_t", [VOIDP] * 10 + [I64],
           [t1.data_ptr(), df_res.data_ptr(), degenerate.data_ptr(),
            beta1.data_ptr(), se1.data_ptr(), r2.data_ptr(),
            *(out[key].data_ptr() for key in STUDENT_T_KEYS), S], device)
    return out


def student_t_pvalues(t1: torch.Tensor, df_res: torch.Tensor,
                      degenerate: torch.Tensor, beta1: torch.Tensor,
                      se1: torch.Tensor, r2: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """The chunk's output statistics: {p, beta, se, r2}, float64 [S].

    p is the two-tailed Student-t tail of ``t1`` on ``df_res`` degrees of
    freedom (K10; 1.0 where t1 is not finite, subnormal p flushed to 0);
    every statistic is NaN where ``degenerate`` (stoat_tpu/pipeline/
    quantitative.py:339-347).

    CUDA tensors run csrc/student_t.cu, one thread per snarl, which is
    bound by the continued fraction's iterations, not by bytes.  CPU
    tensors run the plain version."""
    if kernels_enabled(t1.device):
        return _student_t_cuda(t1, df_res, degenerate, beta1, se1, r2)
    return student_t_pvalues_plain(t1, df_res, degenerate, beta1, se1, r2)
