"""The native VCF ingest as the job waits for it: seconds a job in the
program's own spans ``runner.wait_ingest`` (the main table's wait on its
prefetch thread) and ``perm.ingest`` (the permutation pass's in-line
reads) on the job's thread (gwasbench/program_trace.py)."""

from gwasbench.program_trace import thread_seconds


def read(ctx):
    return thread_seconds(ctx, ("runner.wait_ingest", "perm.ingest"))
