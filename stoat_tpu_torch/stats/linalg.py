"""Float64 dense linear algebra on batched small matrices, plain PyTorch.

The port of stoat_tpu/stats/linalg.py, the plain side of the OLS kernel
(csrc/ols.cu):

  - ``ldlt_factor`` / ``ldlt_solve``: the unpivoted LDL^T recursion, in the
    operation order of stoat_tpu/stats/linreg.py _ols_unrolled_body
    (sequential subtractions, ``(L_ik * L_jk) * D_k``), which the kernel
    repeats; solving against the identity gives Eigen's ``ldlt.solve(I)``
    inverse.
  - ``jacobi_eigh``: cyclic Jacobi, 12 fixed sweeps over the lexicographic
    (p, q) pairs, with the ``small``/``tau`` rules of linalg.py:135-143.
  - ``sym_pinv``: the pseudo-inverse of a symmetric matrix with an absolute
    eigenvalue tolerance.

Matrices are [B, P, P] with P the design width (a few columns); every
loop below runs over P, and each step is one elementwise op on [B]-sized
slices, so the batch stays vectorised.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ldlt_factor", "ldlt_solve", "jacobi_eigh", "sym_pinv"]


def ldlt_factor(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted LDL^T of batched symmetric [B, P, P]: (L [B, P, P] with a
    unit diagonal, D [B, P]).  A zero pivot divides by 1 instead."""
    B, P, _ = A.shape
    L = [[None] * P for _ in range(P)]
    D = [None] * P
    for j in range(P):
        dj = A[:, j, j]
        for k in range(j):
            dj = dj - L[j][k] * L[j][k] * D[k]
        D[j] = dj
        dj_safe = torch.where(dj == 0.0, 1.0, dj)
        for i in range(j + 1, P):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s / dj_safe
    Lm = torch.zeros_like(A)
    for i in range(P):
        Lm[:, i, i] = 1.0
        for j in range(i):
            Lm[:, i, j] = L[i][j]
    return Lm, torch.stack(D, dim=-1)


def ldlt_solve(L: torch.Tensor, D: torch.Tensor,
               rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L D L^T) X = rhs for [B, P, M] right-hand sides, from the
    factor of :func:`ldlt_factor`: forward substitution, the diagonal, then
    backward substitution, each a sequential subtraction."""
    P = L.shape[1]
    z = [None] * P
    for i in range(P):
        s = rhs[:, i, :]
        for k in range(i):
            s = s - L[:, i, k, None] * z[k]
        z[i] = s
    D_safe = torch.where(D == 0.0, 1.0, D)
    x = [None] * P
    for t in range(P - 1, -1, -1):
        s = z[t] / D_safe[:, t, None]
        for k in range(t + 1, P):
            s = s - L[:, k, t, None] * x[k]
        x[t] = s
    return torch.stack(x, dim=1)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1, 0 or 1, and NaN for NaN (torch.sign gives 0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def jacobi_eigh(A: torch.Tensor, sweeps: int = 12
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic Jacobi eigendecomposition of batched symmetric [B, P, P]:
    (w [B, P], V [B, P, P]) with A ~ V diag(w) V^T."""
    B, P, _ = A.shape
    A = A.clone()
    V = torch.eye(P, dtype=A.dtype, device=A.device).expand(B, P, P).clone()
    if P == 1:
        return A[:, :, 0], torch.ones_like(A)
    pairs = [(p, q) for p in range(P - 1) for q in range(p + 1, P)]
    for _ in range(sweeps):
        for p, q in pairs:
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            small = apq.abs() < 1e-300
            apq_safe = torch.where(small, 1.0, apq)
            tau = (aqq - app) / (2.0 * apq_safe)
            t = _sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, 1.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(small, 1.0, c)[:, None]
            s = torch.where(small, 0.0, s)[:, None]
            row_p, row_q = A[:, p, :].clone(), A[:, q, :].clone()
            A[:, p, :] = c * row_p - s * row_q
            A[:, q, :] = s * row_p + c * row_q
            col_p, col_q = A[:, :, p].clone(), A[:, :, q].clone()
            A[:, :, p] = c * col_p - s * col_q
            A[:, :, q] = s * col_p + c * col_q
            vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
            V[:, :, p] = c * vp - s * vq
            V[:, :, q] = s * vp + c * vq
    return torch.diagonal(A, dim1=1, dim2=2).clone(), V


def sym_pinv(A: torch.Tensor, tol: float = 1e-6,
             sweeps: int = 12) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of symmetric [B, P, P] with an absolute
    eigenvalue tolerance: sum_p (V_ip / w_p) V_jp over |w_p| > tol, summed
    in p order."""
    w, V = jacobi_eigh(A, sweeps=sweeps)
    winv = torch.where(w.abs() > tol,
                       1.0 / torch.where(w == 0, 1.0, w), 0.0)
    P = A.shape[1]
    out = torch.zeros_like(A)
    for p in range(P):
        out = out + (V[:, :, p] * winv[:, p, None])[:, :, None] \
            * V[:, None, :, p]
    return out
