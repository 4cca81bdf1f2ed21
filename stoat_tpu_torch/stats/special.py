"""Chi-squared tail (K5), float64 (stoat_tpu/stats/special.py:30-50).

The tail stays a library special function, ``torch.special.gammaincc``,
as the JAX package leaves it to ``jax.scipy.special.gammaincc``.  At or
below a statistic of 85 the reference computes ``1 - cdf`` in double
precision; ``1 - (1 - q)`` reproduces that rounding from the accurate
upper tail.  Above 85 it evaluates the tail in 50-digit arithmetic, which
the direct upper tail matches in float64.
"""

from __future__ import annotations

import torch

__all__ = ["CHI2_HIGH_PRECISION_THRESHOLD", "chi2_sf"]

CHI2_HIGH_PRECISION_THRESHOLD = 85.0
_DBL_MIN = 2.2250738585072014e-308


def chi2_sf(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Survival function of the chi-squared distribution (float64)."""
    stat = stat.to(torch.float64)
    df = df.to(torch.float64)
    q = torch.special.gammaincc(df * 0.5, stat * 0.5)
    # XLA, under the JAX package, flushes subnormal results to zero: a
    # tail below DBL_MIN prints as "0" there, and here
    q = torch.where(q < _DBL_MIN, 0.0, q)
    low = 1.0 - (1.0 - q)
    return torch.where(stat > CHI2_HIGH_PRECISION_THRESHOLD, q, low)
