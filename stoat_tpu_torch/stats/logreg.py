"""Batched IRLS logistic regression with Wald tests and Holm selection
(K11), float64.

The port of stoat_tpu/stats/logreg.py logistic_regression_batch (:44-135),
the model of ``vcf -b -c``.  For every snarl of a chunk, on its design X
[N, P] = [intercept | variant dosages | zero padding] (rows of unused
samples all zero), y [N] (0 on those rows), the used-row mask and ncols:

  - penalised Newton steps: sigmoid(X beta), weights prob (1 - prob)
    clamped to [1e-8, 1] on the used rows, H = X^T W X + 1e-4 I over all
    P columns (a padded column's diagonal is 1e-4), gradient X^T (y - prob)
    - 1e-4 beta, the step by an unpivoted LDL^T solve (D == 0 divides by
    1); a step that is not finite fails the snarl; the snarl converges
    when ||beta_new - beta_old|| < 1e-6; at most 100 steps;
  - a snarl that failed or never converged is NA (stats_test.cpp:107,119);
  - se from the diagonal of H^-1 at the final beta (LDL^T against the
    identity), the Wald z = beta / se, p = 2 (1 - ndtr(|z|));
  - Holm over the variant columns 1 <= j < ncols (m counts them all),
    through a stable sort with NaN last, min((m - i) p, 1), a running
    maximum, and the first column with the smallest adjusted p.  When no
    variant p is finite every adjusted p is +inf and the selection falls on
    column 0, the intercept (as jnp.argmin does).

Covariates never enter the model: the reference shadows them
(stoat_tpu/stats/logreg.py:9-14), and ``vcf -b -c`` keeps that.

The plain version computes sigmoid as 1 / (1 + exp(-z)), the formula XLA
lowers ``jax.nn.sigmoid`` to on the CPU.  JAX runs all 100 iterations
with inactive snarls frozen; the plain version steps only the snarls
still active and stops when none is, which gives the same result.  CUDA
tensors run csrc/logreg.cu, one block per snarl.
"""

from __future__ import annotations

from typing import Dict

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, build, check_tensor, launch
from stoat_tpu_torch.stats.linalg import ldlt_factor, ldlt_solve
from stoat_tpu_torch.stats.special import normal_sf2_plain

__all__ = ["LOGREG_KEYS", "MAX_ITER", "logistic_regression",
           "logistic_regression_plain"]

MAX_ITER = 100   # stats_test.hpp:109
_TOL = 1e-6      # stats_test.hpp:110
_L2 = 1e-4       # stats_test.hpp:111
_EPS = 1e-8      # stats_test.hpp:112

# the wrapper's outputs: the statistics, then each snarl's Newton steps
LOGREG_KEYS = ("p", "beta", "se", "iters")


def _hessian(X, beta, row_mask):
    """(X^T W X + 1e-4 I [B, P, P], prob [B, N]) at ``beta``."""
    z = torch.bmm(X, beta[:, :, None])[:, :, 0]
    prob = 1.0 / (1.0 + torch.exp(-z))
    w = torch.clamp(prob * (1.0 - prob), _EPS, 1.0)
    w = torch.where(row_mask, w, 0.0)
    H = torch.bmm((X * w[:, :, None]).transpose(1, 2), X)
    eye = torch.eye(X.shape[2], dtype=X.dtype, device=X.device)
    return H + _L2 * eye, prob


def _irls(X, y, row_mask):
    """Newton iterations: (beta [B, P], na [B], iters int32 [B])."""
    B, N, P = X.shape
    beta = torch.zeros(B, P, dtype=X.dtype, device=X.device)
    beta_old = beta.clone()
    # logreg.py:91-94: a NaN in X[:, 0, 0] starts the snarl inactive
    active = (X[:, 0, 0] * 0.0) < 1.0
    failed = torch.zeros_like(active)
    iters = torch.zeros(B, dtype=torch.int32, device=X.device)
    for _ in range(MAX_ITER):
        idx = active.nonzero().squeeze(-1)
        if idx.numel() == 0:
            break
        everyone = idx.numel() == B
        Xa, ya, ma = ((X, y, row_mask) if everyone
                      else (X[idx], y[idx], row_mask[idx]))
        ba, bo = beta[idx], beta_old[idx]
        H, prob = _hessian(Xa, ba, ma)
        resid = torch.where(ma, ya - prob, 0.0)
        grad = torch.bmm(Xa.transpose(1, 2), resid[:, :, None])[:, :, 0]
        grad = grad - _L2 * ba
        L, D = ldlt_factor(H)
        delta = ldlt_solve(L, D, grad[:, :, None])[:, :, 0]
        bad = ~torch.isfinite(delta).all(dim=-1)
        new_beta = ba + torch.where(bad[:, None], 0.0, delta)
        diff = torch.sqrt(((new_beta - bo) ** 2).sum(dim=-1))
        still = ~bad & ~(diff < _TOL)
        beta[idx] = new_beta
        beta_old[idx] = torch.where(still[:, None], new_beta, bo)
        failed[idx] = failed[idx] | bad
        active[idx] = still
        iters[idx] += 1
    return beta, active | failed, iters


def _wald_holm(X, row_mask, ncols, beta):
    """(p, beta, se) of the selected column, before the NA masking."""
    B, N, P = X.shape
    H, _ = _hessian(X, beta, row_mask)
    L, D = ldlt_factor(H)
    eye = torch.eye(P, dtype=X.dtype, device=X.device).expand(B, P, P)
    cov = ldlt_solve(L, D, eye)
    se = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    p_all = normal_sf2_plain((beta / se).abs())

    col = torch.arange(P, device=X.device)
    variant = (col[None, :] < ncols[:, None]) & (col[None, :] >= 1)
    m = variant.sum(dim=-1).to(torch.float64)
    inf = float("inf")
    p_masked = torch.where(variant, p_all, inf)
    # a stable ascending sort puts NaN after +inf, as jnp.argsort does
    p_sorted, order = torch.sort(p_masked, dim=-1, stable=True)
    valid = torch.isfinite(p_sorted)
    i = torch.arange(P, dtype=torch.float64, device=X.device)
    raw = torch.clamp((m[:, None] - i) * torch.where(valid, p_sorted, 0.0),
                      max=1.0)
    adj_sorted = torch.cummax(torch.where(valid, raw, inf), dim=1).values
    adj = torch.full_like(p_all, inf).scatter(1, order, adj_sorted)
    # the first minimum; all +inf selects column 0
    sel = torch.argmin(torch.where(variant, adj, inf), dim=-1)[:, None]
    return (adj.gather(1, sel)[:, 0], beta.gather(1, sel)[:, 0],
            se.gather(1, sel)[:, 0])


def logistic_regression_plain(X: torch.Tensor, y: torch.Tensor,
                              row_mask: torch.Tensor, ncols: torch.Tensor,
                              degenerate=None) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`logistic_regression`; without
    ``degenerate`` no snarl is masked beyond its own NA rule."""
    beta, na, iters = _irls(X, y, row_mask)
    stats = _wald_holm(X, row_mask, ncols, beta)
    if degenerate is not None:
        na = na | degenerate
    out = {key: torch.where(na, float("nan"), v)
           for key, v in zip(LOGREG_KEYS, stats)}
    out["iters"] = iters
    return out


def _logreg_cuda(X, y, row_mask, ncols, degenerate):
    device = X.device
    S, N, P = X.shape
    check_tensor(X, "X", torch.float64, (S, N, P), device)
    check_tensor(y, "y", torch.float64, (S, N), device)
    check_tensor(row_mask, "row_mask", torch.bool, (S, N), device)
    check_tensor(ncols, "ncols", torch.int32, (S,), device)
    check_tensor(degenerate, "degenerate", torch.bool, (S,), device)
    lib = build.load("logreg")
    lib.logreg_work_doubles.argtypes = [I64]
    lib.logreg_work_doubles.restype = I64
    work = torch.empty((S, lib.logreg_work_doubles(P)), dtype=torch.float64,
                       device=device)
    out = {key: torch.empty(S, dtype=torch.float64, device=device)
           for key in LOGREG_KEYS[:3]}
    out["iters"] = torch.empty(S, dtype=torch.int32, device=device)
    launch("logreg", [VOIDP] * 10 + [I64] * 3,
           [X.data_ptr(), y.data_ptr(), row_mask.data_ptr(),
            ncols.data_ptr(), degenerate.data_ptr(), work.data_ptr(),
            *(out[key].data_ptr() for key in LOGREG_KEYS), S, N, P], device)
    return out


def logistic_regression(X: torch.Tensor, y: torch.Tensor,
                        row_mask: torch.Tensor, ncols: torch.Tensor,
                        degenerate: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-snarl logistic regression of a chunk: {p, beta, se} float64 [S],
    NaN where the snarl is NA or ``degenerate``, and ``iters`` int32 [S],
    the Newton steps each snarl took.

    X float64 [S, N, P] (rows of unused samples and padded columns zero),
    y float64 [S, N] (0 on unused rows), row_mask bool [S, N], ncols int32
    [S], degenerate bool [S].  CUDA tensors run csrc/logreg.cu, one block
    per snarl, which holds the snarl's rows of X in shared memory across
    its Newton steps: it is bound by reading X once, S * N * P * 8 bytes.
    CPU tensors run the plain version."""
    if kernels_enabled(X.device):
        return _logreg_cuda(X, y, row_mask, ncols, degenerate)
    return logistic_regression_plain(X, y, row_mask, ncols, degenerate)
