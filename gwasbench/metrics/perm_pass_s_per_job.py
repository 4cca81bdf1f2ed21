"""The permutation pass, pipeline/permutation.py run_permutation_test:
seconds a job inside the harness's span around each call."""


def read(ctx):
    return ctx.span_seconds("perm_pass")
