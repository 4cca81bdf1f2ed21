"""Batched two-sided Fisher exact test for 2x2 tables (K4).

The port of stoat_tpu/stats/fisher.py (fisher_exact_2x2 :165,
_fisher_single :39): PLINK's three-phase relative-probability scan, whose
p-values the reference pins bit for bit.  The plain version below is a
masked batched loop, one lane per table, that performs on every lane the
same float64 operations in the same order as ``_fisher_single``; a lane
leaves a loop exactly when the scalar code would.  CUDA tensors run
csrc/fisher.cu, one thread per table on csrc/fisher_device.cuh's
fisher_scan (the ratios divided a block ahead of the chain of multiplies
and adds), built with -fmad=false so that it is bitwise equal to the
plain version.

Output conventions: NaN = "NA" (a zero row or column margin), 0.0 on
overflow of the scan, 1.0 when no table was as likely as the observed one.
A p-value below DBL_MIN is 0.0: XLA, under the JAX package, flushes
subnormal float64 results to zero, and the port keeps its output strings.
"""

from __future__ import annotations

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, check_tensor, launch

__all__ = ["fisher_exact_2x2", "fisher_exact_2x2_plain"]

# PLINK's constants with maximum usable double precision
_EPS2 = 9.094947017729282e-13
_BIAS = 1.0339757656912846e-25
_DBL_MAX = 1.7976931348623157e308
_DBL_MIN = 2.2250738585072014e-308


def fisher_exact_2x2_plain(m11: torch.Tensor, m12: torch.Tensor,
                           m21: torch.Tensor, m22: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fisher_exact_2x2` (float64 [N])."""
    m11, m12, m21, m22 = (x.to(torch.float64) for x in (m11, m12, m21, m22))
    na = (((m11 + m12) == 0) | ((m21 + m22) == 0) | ((m11 + m21) == 0)
          | ((m12 + m22) == 0))
    # canonical order: m12 <= m21, m11 <= m22, left of centre
    m12, m21 = torch.minimum(m12, m21), torch.maximum(m12, m21)
    m11, m22 = torch.minimum(m11, m22), torch.maximum(m11, m22)
    swap = (m11 * m22) > (m12 * m21)
    m11, m12 = torch.where(swap, m12, m11), torch.where(swap, m11, m12)
    m21, m22 = torch.where(swap, m22, m21), torch.where(swap, m21, m22)
    tprob0 = (1.0 - _EPS2) * _BIAS

    # phase 1: right tail while the relative probability stays >= bias
    c11, c12, c21, c22 = m11, m12, m21, m22
    prob = torch.full_like(m11, tprob0)
    cprob = torch.zeros_like(m11)
    tprob = torch.full_like(m11, tprob0)
    status = torch.zeros_like(m11, dtype=torch.int32)  # 1 under, 2 overflow
    run = ~na & (c12 > 0.5)
    while bool(run.any()):
        n11 = c11 + 1.0
        n22 = c22 + 1.0
        probn = prob * ((c12 * c21) / (n11 * n22))
        overflow = ~torch.isfinite(probn) | (probn > _DBL_MAX)
        under = probn < _BIAS
        tprob = torch.where(run & under, tprob + probn, tprob)
        cprob = torch.where(run & ~(under | overflow), cprob + probn, cprob)
        status = torch.where(run & overflow, 2,
                             torch.where(run & under, 1, status))
        c11 = torch.where(run, n11, c11)
        c22 = torch.where(run, n22, c22)
        c12 = torch.where(run, c12 - 1.0, c12)
        c21 = torch.where(run, c21 - 1.0, c21)
        prob = torch.where(run, probn, prob)
        run = run & (status == 0) & (c12 > 0.5)
    overflow_zero = status == 2
    early_one = ~overflow_zero & (cprob == 0.0)

    # phase 2: after a phase-1 break below the bias, keep adding the right
    # tail into tprob until an addition no longer changes it
    run = ~na & (status == 1) & (c12 > 0.5)
    while bool(run.any()):
        n11 = c11 + 1.0
        n22 = c22 + 1.0
        probn = prob * ((c12 * c21) / (n11 * n22))
        nxt = tprob + probn
        stalled = nxt <= tprob
        tprob = torch.where(run, nxt, tprob)
        c11 = torch.where(run, n11, c11)
        c22 = torch.where(run, n22, c22)
        c12 = torch.where(run, c12 - 1.0, c12)
        c21 = torch.where(run, c21 - 1.0, c21)
        prob = torch.where(run, probn, prob)
        run = run & ~stalled & (c12 > 0.5)

    # phase 3: left tail from the canonical table, a do-while that stops
    # when an addition no longer changes tprob
    num = tprob
    c11, c12, c21, c22 = m11, m12, m21, m22
    prob = torch.full_like(m11, tprob0)
    run = ~na & (m11 > 0)
    while bool(run.any()):
        n12 = c12 + 1.0
        n21 = c21 + 1.0
        probn = prob * ((c11 * c22) / (n12 * n21))
        pre = tprob
        nxt = tprob + probn
        stalled = nxt <= pre
        tprob = torch.where(run, nxt, tprob)
        num = torch.where(run, torch.where(stalled, pre, nxt), num)
        c12 = torch.where(run, n12, c12)
        c21 = torch.where(run, n21, c21)
        c11 = torch.where(run, c11 - 1.0, c11)
        c22 = torch.where(run, c22 - 1.0, c22)
        prob = torch.where(run, probn, prob)
        run = run & ~stalled & (c11 > 0.5)

    p = num / (cprob + num)
    # stoat_tpu's XLA backends flush subnormal results to zero
    p = torch.where(p < _DBL_MIN, 0.0, p)
    p = torch.where(early_one, 1.0, p)
    p = torch.where(overflow_zero, 0.0, p)
    return torch.where(na, float("nan"), p)


def _fisher_cuda(m11, m12, m21, m22):
    device = m11.device
    n = m11.shape[0]
    for name, t in (("m11", m11), ("m12", m12), ("m21", m21),
                    ("m22", m22)):
        check_tensor(t, name, torch.float64, (n,), device)
    out = torch.empty(n, dtype=torch.float64, device=device)
    launch("fisher", [VOIDP] * 5 + [I64],
           [m11.data_ptr(), m12.data_ptr(), m21.data_ptr(), m22.data_ptr(),
            out.data_ptr(), n], device)
    return out


def fisher_exact_2x2(m11: torch.Tensor, m12: torch.Tensor,
                     m21: torch.Tensor, m22: torch.Tensor) -> torch.Tensor:
    """Two-sided Fisher exact p-values for float64 [N] tables
    [[m11, m12], [m21, m22]]; NaN = "NA".

    CUDA tensors run csrc/fisher.cu; CPU tensors the plain version.  The
    kernel is bound by dependent float64 arithmetic in loops of
    data-dependent length: one thread per table, its divisions taken off
    the chain.  The main path runs the same scan inside
    ``pipeline/binary.py binary_stats``."""
    if kernels_enabled(m11.device):
        return _fisher_cuda(m11, m12, m21, m22)
    return fisher_exact_2x2_plain(m11, m12, m21, m22)
