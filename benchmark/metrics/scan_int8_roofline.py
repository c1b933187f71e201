"""`scan_int8_roofline` (%): kernel C (`scan_topk_int8`, its `wgmma` route)
against its bound: the traced calls' count times one scan's bound
(`yardstick.scan_int8_work` at the plan's first-stage width), over the
kernel's summed device time in the traced window."""

from benchmark import yardstick

KERNEL = "scan_topk_int8"


def read(ctx) -> float | None:
    trace = ctx.window.trace
    if trace is None:
        return None
    seconds, launches = trace.op_seconds(KERNEL)
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    if not launches or not traced or seconds <= 0:
        return None
    cfg, traffic = ctx.config, ctx.traffic
    n, d, b = cfg["rows"], cfg["dim"], traffic["batch"]
    k1 = yardstick.int8_first_stage_width(traffic["k"], n)
    bound = yardstick.bound_s(*yardstick.scan_int8_work(n, d, b, k1), "int8")
    return 100.0 * len(traced) * bound / seconds
