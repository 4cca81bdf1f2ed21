"""The CLI and its input parsing, cli.py and io/: seconds a job inside
the harness's span around ``cli.main`` but outside the main table's and
the permutation pass's spans (reading the VCF header, the phenotype,
covariate and snarl files; what runs between the two)."""


def read(ctx):
    job = ctx.span_seconds("job")
    if job is None:
        return None
    return job - sum(ctx.span_seconds(name) or 0.0
                     for name in ("runner", "perm_pass"))
