"""The host's pack and upload, convert.py: GiB a job copied from the host
to the device, the program's counter ``h2d_bytes`` (every
``convert.upload``) over the window's jobs (gwasbench/program_trace.py)."""

from gwasbench.program_trace import counter_total, window


def read(ctx):
    total = counter_total(ctx, "h2d_bytes")
    return None if total is None else total / 2**30 / window(ctx).jobs
