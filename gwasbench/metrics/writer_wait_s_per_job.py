"""The main table's writer thread as the job waits for it: seconds a job
in the program's span ``runner.wait_writer`` (a submit to the full queue
and the final drain) on the job's thread (gwasbench/program_trace.py)."""

from gwasbench.program_trace import thread_seconds


def read(ctx):
    return thread_seconds(ctx, ("runner.wait_writer",))
