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
The pipelines pass the phenotype as one row and the mask
(:func:`linear_regression_row_stats`); the kernel forms y on chip.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, build, check_tensor, launch
from stoat_tpu_torch.stats.linalg import ldlt_factor, ldlt_solve, sym_pinv
from stoat_tpu_torch.stats.special import student_t_sf2_plain

__all__ = ["LDLT_TOL", "PINV_TOL", "normal_inverse_plain",
           "ols_from_inverse_plain", "linear_regression_stats",
           "linear_regression_row_stats", "linear_regression_stats_plain",
           "finish_linear_pvalues",
           "linear_pvalues", "STUDENT_T_KEYS", "student_t_pvalues",
           "student_t_pvalues_plain"]

LDLT_TOL = 1e-10  # stats_test.cpp:401
PINV_TOL = 1e-6   # stats_test.cpp:386

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def normal_inverse_plain(X: torch.Tensor,
                         ncols: torch.Tensor) -> torch.Tensor:
    """(X^T X)^-1 [B, P, P], the padded columns' diagonal set to 1, by
    LDL^T against the identity, or the Jacobi pseudo-inverse of the snarls
    with a real pivot below LDLT_TOL or not finite (csrc/ols_device.cuh)."""
    B, N, P = X.shape
    real = torch.arange(P, device=X.device)[None, :] < ncols[:, None]
    XtX = torch.einsum("bnp,bnq->bpq", X, X)
    XtX = XtX + torch.diag_embed(torch.where(real, 0.0, 1.0))
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
    return inv


def ols_from_inverse_plain(X: torch.Tensor, y: torch.Tensor,
                           row_mask: torch.Tensor, ncols: torch.Tensor,
                           inv: torch.Tensor) -> Stats:
    """The statistics of :func:`linear_regression_stats` given the
    inverse of :func:`normal_inverse_plain`: the part that depends on y."""
    B, N, P = X.shape
    Xty = torch.einsum("bnp,bn->bp", X, y)
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


def linear_regression_stats_plain(X: torch.Tensor, y: torch.Tensor,
                                  row_mask: torch.Tensor,
                                  ncols: torch.Tensor) -> Stats:
    """Plain PyTorch version of :func:`linear_regression_stats`."""
    return ols_from_inverse_plain(X, y, row_mask, ncols,
                                  normal_inverse_plain(X, ncols))


def _ols_cuda(X, row, row_mask, ncols) -> Stats:
    """csrc/ols.cu on the phenotype row [N] that every snarl shares;
    ``row_mask`` None uses every row."""
    device = X.device
    B, N, P = X.shape
    check_tensor(X, "X", torch.float64, (B, N, P), device)
    check_tensor(row, "row", torch.float64, (N,), device)
    if row_mask is not None:
        check_tensor(row_mask, "row_mask", torch.bool, (B, N), device)
    check_tensor(ncols, "ncols", torch.int32, (B,), device)
    lib = build.load("ols")
    lib.ols_work_doubles.argtypes = [I64]
    lib.ols_work_doubles.restype = I64
    work = torch.empty((B, lib.ols_work_doubles(P)), dtype=torch.float64,
                       device=device)
    out = [torch.empty(B, dtype=torch.float64, device=device)
           for _ in range(5)]
    launch("ols", [VOIDP] * 10 + [I64] * 3,
           [X.data_ptr(), row.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(),
            ncols.data_ptr(), work.data_ptr(),
            *(t.data_ptr() for t in out), B, N, P], device)
    return tuple(out)


def linear_regression_stats(X: torch.Tensor, y: torch.Tensor,
                            row_mask: torch.Tensor,
                            ncols: torch.Tensor) -> Stats:
    """Batched OLS: (t1, df_res, beta1, se1, r2), float64 [B] each.

    X float64 [B, N, P] (rows of unused samples and padded columns all
    zero), y float64 [B, N] (0 on unused rows), row_mask bool [B, N],
    ncols int32 [B].  stoat_tpu's linear_regression_stats_batch, with its
    signature, for the parity tests: it runs the plain version on CPU
    tensors and raises on CUDA tensors, whose y the kernel forms on chip
    from one row (the pipelines' :func:`linear_regression_row_stats`)."""
    if kernels_enabled(X.device):
        raise ValueError("linear_regression_stats runs on CPU tensors; "
                         "CUDA tensors go through "
                         "linear_regression_row_stats")
    return linear_regression_stats_plain(X, y, row_mask, ncols)


def linear_regression_row_stats(X: torch.Tensor, row: torch.Tensor,
                                row_mask: Optional[torch.Tensor],
                                ncols: torch.Tensor) -> Stats:
    """:func:`linear_regression_stats` of y = row * row_mask, the
    statistics of one phenotype row float64 [N] against every design,
    without the [B, N] y: the entry point of the pipelines.  ``row_mask``
    bool [B, N], or None when every row is used (the mixed model's rotated
    designs: no all-true mask either).

    CUDA tensors run csrc/ols.cu on the row and the mask (a null pointer
    for None): the kernel forms y = row[n] * (used ? 1 : 0) on chip, bit
    for bit ``row[None, :] * row_mask``.  It reads each snarl's X once (the
    rows it cannot hold in shared memory twice), so it is bound by those
    B * N * P * 8 bytes.  CPU tensors run the plain version on that y."""
    if kernels_enabled(X.device):
        return _ols_cuda(X, row, row_mask, ncols)
    B, N, _ = X.shape
    if row_mask is None:
        row_mask = torch.ones((B, N), dtype=torch.bool, device=X.device)
    return linear_regression_stats_plain(X, row[None, :] * row_mask,
                                         row_mask, ncols)


def finish_linear_pvalues(t1: torch.Tensor,
                          df_res: torch.Tensor) -> torch.Tensor:
    """Two-tailed Student-t p of ``t1``; NaN or infinite t1 gives 1.0
    (stats_test.cpp:479-485, stoat_tpu/stats/linreg.py:206-209)."""
    p = student_t_sf2_plain(t1.abs(), df_res)
    return torch.where(torch.isfinite(t1), p, 1.0)


def linear_pvalues(t1: torch.Tensor, df_res: torch.Tensor) -> torch.Tensor:
    """:func:`finish_linear_pvalues` of statistics of any shape, with no
    NA masking (the permutation test's [K, S]).

    CUDA tensors run csrc/student_t.cu over the flattened statistics,
    writing p alone; CPU tensors run the plain version."""
    if not kernels_enabled(t1.device):
        return finish_linear_pvalues(t1, df_res)
    device = t1.device
    n = t1.numel()
    check_tensor(t1, "t1", torch.float64, tuple(t1.shape), device)
    check_tensor(df_res, "df_res", torch.float64, tuple(t1.shape), device)
    p = torch.empty_like(t1)
    launch("student_t", [VOIDP] * 10 + [I64],
           [t1.data_ptr(), df_res.data_ptr(), None, None, None, None,
            p.data_ptr(), None, None, None, n], device)
    return p


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
    # the four outputs are the rows of one allocation
    out = torch.empty((len(STUDENT_T_KEYS), S), dtype=torch.float64,
                      device=device)
    launch("student_t", [VOIDP] * 10 + [I64],
           [t1.data_ptr(), df_res.data_ptr(), degenerate.data_ptr(),
            beta1.data_ptr(), se1.data_ptr(), r2.data_ptr(),
            *(row.data_ptr() for row in out), S], device)
    return dict(zip(STUDENT_T_KEYS, out.unbind(0)))


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
