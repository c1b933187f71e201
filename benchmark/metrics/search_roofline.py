"""`search_roofline` (%): the least time the card could take for the
traced window's search calls, over the traced window's length. A call's
bound is the larger of its bytes over 3.35 TB/s and its int8 operations
over 1,979 TOP/s, for the work the configuration's plan needs
(`yardstick.search_call_work`)."""

from benchmark import yardstick


def read(ctx) -> float | None:
    trace = ctx.window.trace
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    if trace is None or not traced or trace.window_s <= 0:
        return None
    cfg, traffic = ctx.config, ctx.traffic
    bound = yardstick.bound_s(*yardstick.search_call_work(
        cfg["rows"], cfg["dim"], traffic["batch"], traffic["k"]), "int8")
    return 100.0 * len(traced) * bound / trace.window_s
