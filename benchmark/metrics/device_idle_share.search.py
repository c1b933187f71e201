"""`device_idle_share.search` (%): the share of the traced window in which
no kernel, copy or memset ran on the card."""


def read(ctx) -> float | None:
    trace = ctx.window.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * trace.idle_share
