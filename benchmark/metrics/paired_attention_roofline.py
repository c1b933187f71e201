"""`paired_attention_roofline` (%): the `paired_attention` kernel against
its bound: for each traced call, one launch a layer on that batch's mask
as the traffic hands it (padded to the batch's longest chunk), each
bounded by `yardstick.attention_work` (the key tiles its mask needs) at
3.35 TB/s or 989 TFLOP/s; over the kernel's summed device time in the
traced window."""

from benchmark import yardstick

KERNEL = "paired_attn_bf16_kernel"


def read(ctx) -> float | None:
    trace = ctx.window.trace
    if trace is None:
        return None
    seconds, launches = trace.op_seconds(KERNEL)
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    if not launches or not traced or seconds <= 0:
        return None
    cfg = ctx.config
    bound = sum(yardstick.bound_s(*yardstick.attention_work(
        ctx.state.inputs_of(c.index)[1], cfg["num_attention_heads"]), "bf16")
        for c in traced)
    return 100.0 * cfg["num_hidden_layers"] * bound / seconds
