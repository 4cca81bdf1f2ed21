"""Batched Pearson chi-squared statistics for 2x2 and 2xN tables.

Plain PyTorch counterparts of stoat_tpu/stats/chi2.py:32-146, float64,
with the same operations in the same order.  On the main path the
hand-written kernel csrc/binary_tables.cu computes both statistics per
snarl; these functions are its plain version's building blocks, and
``finish_chi2_pvalues`` is the tail's entry point (csrc/chi2_tail.cu on
CUDA tensors).  A zero row or column margin makes a table invalid
("NA"); a zero expected count gives the DBL_MAX sentinel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.stats.special import chi2_sf_plain, chi2_tail_cuda

__all__ = ["chi2_2x2_stat", "chi2_2xn_stat", "finish_chi2_pvalues",
           "finish_chi2_pvalues_plain"]

_DBL_MAX = 1.7976931348623157e308


def chi2_2x2_stat(a, b, c, d
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stat, invalid, zero_expected) for tables [g0=(a, b); g1=(c, d)]."""
    a, b, c, d = (x.to(torch.float64) for x in (a, b, c, d))
    row1 = a + b
    row2 = c + d
    col1 = a + c
    col2 = b + d
    total = row1 + row2
    invalid = (row1 == 0) | (row2 == 0) | (col1 == 0) | (col2 == 0)
    safe_total = torch.where(invalid, torch.ones_like(total), total)
    ea = row1 * col1 / safe_total
    eb = row1 * col2 / safe_total
    ec = col1 * row2 / safe_total
    ed = col2 * row2 / safe_total
    zero_expected = (ea == 0) | (eb == 0) | (ec == 0) | (ed == 0)
    one = torch.ones_like(ea)
    ea = torch.where(zero_expected, one, ea)
    eb = torch.where(zero_expected, one, eb)
    ec = torch.where(zero_expected, one, ec)
    ed = torch.where(zero_expected, one, ed)
    da, db, dc, dd = a - ea, b - eb, c - ec, d - ed
    stat = da * da / ea + db * db / eb + dc * dc / ec + dd * dd / ed
    return stat, invalid, zero_expected


def chi2_2xn_stat(g0, g1, col_mask
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stat, df, invalid) for [B, N] tables with a column mask.

    The statistic sums the columns in index order (the kernel's order);
    df = max(kept columns - 1, 1)."""
    zero = torch.zeros((), dtype=torch.float64, device=g0.device)
    g0 = torch.where(col_mask, g0.to(torch.float64), zero)
    g1 = torch.where(col_mask, g1.to(torch.float64), zero)
    col_totals = g0 + g1
    total = col_totals.sum(dim=-1)
    row0 = g0.sum(dim=-1)
    row1 = g1.sum(dim=-1)
    ncols = col_mask.sum(dim=-1)
    any_zero_col = (col_mask & (col_totals == 0)).any(dim=-1)
    invalid = (total == 0) | (row0 == 0) | (row1 == 0) | any_zero_col
    safe_total = torch.where(total == 0, torch.ones_like(total), total)
    e0 = row0[:, None] * col_totals / safe_total[:, None]
    e1 = row1[:, None] * col_totals / safe_total[:, None]
    one = torch.ones_like(e0)
    e0 = torch.where(col_mask & (e0 > 0), e0, one)
    e1 = torch.where(col_mask & (e1 > 0), e1, one)
    d0 = g0 - e0
    d1 = g1 - e1
    term = torch.where(col_mask, d0 * d0 / e0 + d1 * d1 / e1, zero)
    stat = torch.zeros_like(total)
    for j in range(term.shape[-1]):
        stat = stat + term[:, j]
    df = torch.clamp(ncols - 1, min=1).to(torch.float64)
    return stat, df, invalid


def finish_chi2_pvalues_plain(stat, df, invalid,
                              zero_expected) -> torch.Tensor:
    """Plain PyTorch version of :func:`finish_chi2_pvalues`."""
    p = chi2_sf_plain(stat, df)
    p = torch.where(zero_expected, torch.full_like(p, _DBL_MAX), p)
    return torch.where(invalid, torch.full_like(p, float("nan")), p)


def finish_chi2_pvalues(stat, df, invalid, zero_expected) -> torch.Tensor:
    """Tail of the statistics above: NaN when invalid, DBL_MAX when an
    expected count is zero, else the chi-squared survival function (K5).

    CUDA tensors run csrc/chi2_tail.cu, which applies both masks in the
    same launch; CPU tensors run the plain version."""
    if kernels_enabled(stat.device):
        return chi2_tail_cuda(stat, df, invalid, zero_expected)
    return finish_chi2_pvalues_plain(stat, df, invalid, zero_expected)
