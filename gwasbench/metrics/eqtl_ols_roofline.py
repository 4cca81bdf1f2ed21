"""Kernel K13, csrc/eqtl_ols.cu: its roofline bound over its device time
in the traced window, % (gwasbench/roofline/eqtl_ols.py): the bound of
the window's mean call from the program's counters over the mean device
time of the kernel's records times its launches a call (the records a
window drops are not taken as time saved)."""

import math

from gwasbench.roofline import F64_FLOPS, HBM_BYTES_S, bound_seconds, \
    kernel_pattern
from gwasbench.roofline import eqtl_ols


def read(ctx):
    call = eqtl_ols.calls(ctx)
    if call is None:
        return None
    recs = ctx.kernel_records(kernel_pattern(eqtl_ols.KERNELS))
    if not recs:
        return None
    per_call = sum(recs) / len(recs) * math.ceil(len(recs) / call["n"])
    bound = bound_seconds(*eqtl_ols.work(call))
    ctx.notes.append(
        f"roofline eqtl_ols: {call['n']} calls, mean S {call['S']:.1f}, "
        f"pairs {call['B']:.1f}, N {call['N']:.0f}, PT {call['PT']:.1f}, "
        f"bound {bound * 1e3:.4f} ms a call, device {per_call * 1e3:.4f} "
        f"ms a call, peaks {F64_FLOPS:.3g} FLOP/s float64 and "
        f"{HBM_BYTES_S:.3g} B/s; card {ctx.card}")
    return 100.0 * bound / per_call
