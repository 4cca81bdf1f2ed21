"""The card: seconds a job in which a kernel, copy or set ran on it (the
union of torch.profiler's device intervals over the traced window, over
the jobs).  Steadier than the job's wall, which the host paces."""


def read(ctx):
    busy = ctx.busy_s
    return busy / ctx.jobs if busy is not None and ctx.jobs else None
