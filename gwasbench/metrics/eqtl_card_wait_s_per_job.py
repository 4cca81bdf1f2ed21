"""The eQTL mode's waits on the card: seconds a job in the program's span
``runner.eqtl_wait_card`` (the host blocked on each chunk's filter flags
and on its pairs' statistics) on the job's thread
(gwasbench/program_trace.py).
None where the program records no such span (an older commit)."""

from gwasbench.program_trace import thread_seconds, window

SPAN = "runner.eqtl_wait_card"


def read(ctx):
    w = window(ctx)
    if w is None or not any(r.name == SPAN for r in w.records):
        return None
    return thread_seconds(ctx, (SPAN,))
