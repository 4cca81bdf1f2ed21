"""The native VCF ingest, native/stoat_core.cpp through pipeline/runner.py
iter_chromosome_matrices: seconds a job inside the harness's span around
each next() of the generator, in both callers (the runner's prefetch
thread and the pass)."""


def read(ctx):
    return ctx.span_seconds("ingest")
