"""`search_first_stage_ms` (ms): the program's host time in its span
`search.first_stage` (`_ShadowView._first_stage` in `ops/quant.py`: the
launches of kernels C and B, their buffers and the slice), over the
traced, answered calls (`program_spans.span_ms_per_call`)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    return program_spans.span_ms_per_call(ctx, "search.first_stage")
