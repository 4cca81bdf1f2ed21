"""Rooflines: the least time the card could take for a kernel's calls.

Each kernel has a file of its own, ``roofline/<kernel>.py``, with its
device kernels' names (``KERNELS``) and ``work(call)``: the bytes and the
float64 operations that the shapes of one call need, each input read
once and each output written once, whatever kernel implements the step.
A kernel's share is its bound over its device time in the traced window,
where the bound of a call is the larger of its operations over the
published float64 peak and its bytes over the memory bandwidth.

The peaks are NVIDIA's data sheet for the H100 SXM (a frozen copy of
chip_smoke.py's HBM_BYTES_S and F64_FLOPS, lines 262-273 at the commit
that added this benchmark): 3.35 TB/s of HBM3 and 67 TFLOP/s of float64
on the tensor cores, at the full power limit of 700 W.  The card's power
limit is printed beside every share.
"""

from __future__ import annotations

import importlib
import math
import re
from typing import Optional

HBM_BYTES_S = 3.35e12
F64_FLOPS = 67e12


def bound_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / F64_FLOPS)


def kernel_pattern(names) -> "re.Pattern":
    """Whole kernel names: ``perm_ols_kernel`` and a template instance
    ``perm_ols_main_kernel<...>``, never ``ols_kernel`` for ``perm_ols``."""
    return re.compile(rf"(?<![A-Za-z0-9_])({'|'.join(names)})_kernel\b")


def share(ctx, kernel: str) -> Optional[float]:
    """100 x bound / device time of ``kernel``'s calls in the window
    (%), or None when the window made no call or the trace kept none of
    its records.  A call's device time is each of its device kernels'
    mean record times its launches a call (the records a window drops
    are not taken as time saved)."""
    calls = ctx.calls.get(kernel, [])
    mod = importlib.import_module(f"gwasbench.roofline.{kernel}")
    if not calls:
        return None
    bound = sum(bound_seconds(*mod.work(c)) for c in calls) / len(calls)
    per_call = 0.0
    for name in mod.KERNELS:
        recs = ctx.kernel_records(kernel_pattern([name]))
        if recs:
            per_call += sum(recs) / len(recs) * math.ceil(
                len(recs) / len(calls))
    if per_call <= 0.0:
        return None
    ctx.notes.append(
        f"roofline {kernel}: {len(calls)} calls, bound "
        f"{bound * 1e3:.4f} ms a call, device {per_call * 1e3:.4f} ms a "
        f"call, peaks {F64_FLOPS:.3g} FLOP/s float64 and {HBM_BYTES_S:.3g} "
        f"B/s; card {ctx.card}")
    return 100.0 * bound / per_call
