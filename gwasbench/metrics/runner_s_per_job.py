"""The main table's layer, pipeline/runner.py run_vcf_analysis: seconds a
job inside the harness's span around each call."""


def read(ctx):
    return ctx.span_seconds("runner")
