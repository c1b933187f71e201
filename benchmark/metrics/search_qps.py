"""`search_qps` (queries/s): every query answered in the window, its scores
and ids on the host, over the window's seconds (host clock)."""


def read(ctx) -> float:
    win = ctx.window
    return sum(c.units for c in win.calls) / win.seconds
