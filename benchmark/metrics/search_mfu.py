"""`search_mfu` (%): the whole search call's share of the card's peak: the
traced calls' int8 operations (2 b n d a call, the first stage's products;
the rescore's are under a thousandth of them) over the traced window and
1,979 TOP/s. `search_roofline` is the same calls against the larger of
their bytes and their operations."""

from benchmark import yardstick


def read(ctx) -> float | None:
    trace = ctx.window.trace
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    if trace is None or not traced or trace.window_s <= 0:
        return None
    cfg, traffic = ctx.config, ctx.traffic
    _, ops = yardstick.search_call_work(cfg["rows"], cfg["dim"],
                                        traffic["batch"], traffic["k"])
    return (100.0 * len(traced) * ops / yardstick.PEAK_OPS_S["int8"]
            / trace.window_s)
