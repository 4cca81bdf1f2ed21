"""The permutation pass's host rows: seconds a job in the program's span
``perm.rows`` (the permutation indices, each job's observed and permuted
rows and their upload) on the job's thread
(gwasbench/program_trace.py)."""

from gwasbench.program_trace import thread_seconds


def read(ctx):
    return thread_seconds(ctx, ("perm.rows",))
