"""Reading the program's own spans and counters (`lattice_tpu_torch/utils/
tracing.py`'s process tracer) after a run's window.

The program's hot spans and counters record only while a `torch.profiler`
session records, so after a `--trace 1` run the tracer holds the traced
window's calls and nothing of set-up, warm-up or the check. A program
without such a span or counter leaves it out, and the readers here
return None."""

from __future__ import annotations


def _tracer():
    from lattice_tpu_torch.utils.tracing import get_tracer
    return get_tracer()


def traced_calls(ctx) -> int:
    """The window's traced calls that gave answers."""
    return sum(1 for c in ctx.window.calls if c.traced and c.units)


def span_ms_per_call(ctx, name: str) -> float | None:
    """The span's total, in ms, over the traced, answered calls; None where
    the span never recorded."""
    stats = _tracer().spans.get(name)
    calls = traced_calls(ctx)
    if stats is None or not stats.count or not calls:
        return None
    return stats.total_ms / calls


def counter(name: str) -> int | None:
    """The counter's value; None where it never counted."""
    return getattr(_tracer(), "counters", {}).get(name)
