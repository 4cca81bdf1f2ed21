"""The eQTL mode's pairing: seconds a job in the program's span
``runner.eqtl_pairs`` (each chunk's unfiltered snarls paired with the
genes in their windows, and the pairs uploaded) on the job's thread
(gwasbench/program_trace.py).
None where the program records no such span (an older commit)."""

from gwasbench.program_trace import thread_seconds, window

SPAN = "runner.eqtl_pairs"


def read(ctx):
    w = window(ctx)
    if w is None or not any(r.name == SPAN for r in w.records):
        return None
    return thread_seconds(ctx, (SPAN,))
