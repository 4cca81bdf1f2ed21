"""The permutation pass's useful work: 100 x the snarls whose observed p
is finite (``perm.snarls_tested``, the rows the table prints with a
P_ASY) over the snarls the permutation kernels computed
(``perm.snarls_computed``, padding included), the program's counters
over the window's jobs (gwasbench/program_trace.py), %."""

from gwasbench.program_trace import counter_total


def read(ctx):
    tested = counter_total(ctx, "perm.snarls_tested")
    computed = counter_total(ctx, "perm.snarls_computed")
    if tested is None or not computed:
        return None
    return 100.0 * tested / computed
