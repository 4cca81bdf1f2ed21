"""The card: torch.cuda.max_memory_allocated() over the window (the peak
statistics reset at its start), GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.on_card and ctx.peak_bytes else None
