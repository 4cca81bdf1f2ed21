"""Multiple-testing corrections: Holm step-down and Benjamini–Hochberg.

The port's copy of stoat_tpu/corrections.py: host work over one
p-vector, in numpy, never a device stage.  Vectorized NumPy
re-implementations of the reference's scalar loops:
  - Holm: the reference's src/utils.cpp:61-87 (used inside logistic
    regression when a snarl has >2 effective paths, stats_test.cpp:157-167).
  - BH: the reference's src/post_processing.cpp:7-38 (the ``BHcorrect``
    subcommand and post-processing).

Both are pure functions over float arrays and run fine on host; BH over the
global p-vector is a sort — it stays on host 0 in the sharded pipeline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["adjusted_holm", "adjust_pvalues_bh"]


def adjusted_holm(p_values: np.ndarray) -> np.ndarray:
    """Holm-Bonferroni step-down with monotonicity (utils.cpp:61-87).

    adjusted[i] (in sorted order) = max(prev, min(1, (m - i) * p_sorted[i])),
    then scattered back to the original positions.
    """
    p = np.asarray(p_values, dtype=np.float64)
    m = p.shape[-1]
    order = np.argsort(p, axis=-1, kind="stable")
    p_sorted = np.take_along_axis(p, order, axis=-1)
    ranks = np.arange(m, 0, -1, dtype=np.float64)
    raw = np.minimum(p_sorted * ranks, 1.0)
    adj = np.maximum.accumulate(raw, axis=-1)
    out = np.empty_like(adj)
    np.put_along_axis(out, order, adj, axis=-1)
    return out


def adjust_pvalues_bh(p_values: np.ndarray) -> np.ndarray:
    """Benjamini–Hochberg adjustment (post_processing.cpp:7-38).

    adjusted[i] (sorted ascending) = p_sorted[i] * n / (i + 1), then a
    reverse cumulative-min enforces monotonicity, clamped to [0, 1], and
    scattered back to the input order.

    Pinned oracle (tests/unittest/post_processing_unit.cpp:12-46):
      [0.01, 0.04, 0.03, 0.002, 0.05] -> [0.025, 0.05, 0.05, 0.01, 0.05]
    """
    p = np.asarray(p_values, dtype=np.float64)
    n = p.shape[-1]
    if n == 0:
        return p.copy()
    order = np.argsort(p, axis=-1, kind="stable")
    p_sorted = np.take_along_axis(p, order, axis=-1)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    adj = p_sorted * n / ranks
    adj = np.minimum.accumulate(adj[..., ::-1], axis=-1)[..., ::-1]
    adj = np.minimum(adj, 1.0)
    out = np.empty_like(adj)
    np.put_along_axis(out, order, adj, axis=-1)
    return out
