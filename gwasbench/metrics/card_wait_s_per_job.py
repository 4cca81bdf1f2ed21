"""The card as the permutation pass waits for it: seconds a job in the
program's span ``perm.wait_card`` (the device-to-host copies of each
chunk's accounting) on the job's thread (gwasbench/program_trace.py)."""

from gwasbench.program_trace import thread_seconds


def read(ctx):
    return thread_seconds(ctx, ("perm.wait_card",))
