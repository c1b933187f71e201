"""`encode_mfu` (%): the encoder's model FLOPs over the live tokens of the
chunks encoded (`yardstick.encoder_flops`: 2 x the non-embedding
parameters a live token, plus QK^T and PV over the live key-query pairs),
over the seconds those calls took (host clock) and the card's 989 TFLOP/s
in bf16. Read over the calls the profiler did not record."""

from benchmark import yardstick


def read(ctx) -> float | None:
    calls, seconds = ctx.window.steady()
    calls = [c for c in calls if c.units]
    if not calls or seconds <= 0:
        return None
    flops = sum(yardstick.encoder_flops(
        ctx.config, ctx.state.inputs_of(c.index)[1].sum(1)) for c in calls)
    return 100.0 * flops / seconds / yardstick.PEAK_OPS_S["bf16"]
