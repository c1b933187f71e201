"""`search_rescore_ms` (ms): the program's host time in its span
`search.rescore` (`scan_topk._exact_rescore`: the gather, f32 product and
stable top-k of the widened candidates), over the traced, answered calls
(`program_spans.span_ms_per_call`)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    return program_spans.span_ms_per_call(ctx, "search.rescore")
