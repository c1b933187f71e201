"""`search_quantize_ms` (ms): the program's host time in its span
`search.quantize` (`_ShadowView._two_stage` in `ops/quant.py`: the
queries' normalisation and int8 quantization), over the traced, answered
calls (`program_spans.span_ms_per_call`)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    return program_spans.span_ms_per_call(ctx, "search.quantize")
