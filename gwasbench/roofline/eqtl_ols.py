"""eqtl_ols (K13, csrc/eqtl_ols.cu): the OLS of every (snarl, gene) pair
of a chunk, X^T X and its inverse once a snarl.  A call's work, as the
kernel's header accounts for it: X [S, N, PT] float64 of the S snarls
with pairs read, the [G, N] expression rows read, 40 bytes a pair
written; the operations X^T X once a snarl (S N PT (PT + 1)) and per pair
X^T y and the residual pass ((4 PT + 4) N).

The program does not hand its calls' shapes to the harness: its counters
do (``runner._eqtl_chromosome``, summed over a job's calls): ``eqtl.calls``,
``eqtl.snarls``, ``eqtl.pairs``, ``eqtl.genes``, ``eqtl.samples`` and
``eqtl.columns``.  :func:`calls` rebuilds the window's mean call from
them; N and PT are the same in every call of a job, so the bound of the
mean call times the calls is the window's, less only where PT differs
between calls (then the bound is low, never high).  A program without
the counters gives no call.
"""

from __future__ import annotations

from typing import Dict, Optional

KERNELS = ("eqtl_ols",)


def work(call):
    S, N, PT, B, G = call["S"], call["N"], call["PT"], call["B"], call["G"]
    nbytes = S * N * PT * 8 + G * N * 8 + 40 * B
    flops = S * N * PT * (PT + 1) + B * N * (4 * PT + 4)
    return nbytes, flops


def calls(ctx) -> Optional[Dict]:
    """The window's mean call and its count (``n``), from the program's
    counters, or None when the window made no call."""
    from gwasbench.program_trace import counter_total
    n = counter_total(ctx, "eqtl.calls")
    if not n:
        return None
    mean = {key: counter_total(ctx, f"eqtl.{name}") / n for key, name in
            (("S", "snarls"), ("B", "pairs"), ("G", "genes"),
             ("N", "samples"), ("PT", "columns"))}
    return dict(mean, n=n)
