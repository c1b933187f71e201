"""`encode_chunks_per_s` (chunks/s): every chunk whose pooled row was
complete and read back in the window, over the window's seconds (host
clock)."""


def read(ctx) -> float:
    win = ctx.window
    return sum(c.units for c in win.calls) / win.seconds
