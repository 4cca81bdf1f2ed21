"""The card: the share of the traced window in which no kernel, copy or
set ran on it, % (100 - the union of torch.profiler's device intervals
over the window)."""


def read(ctx):
    busy, window = ctx.busy_s, ctx.window_s
    if busy is None or not window:
        return None
    return 100.0 * (window - busy) / window
