"""`search_plan_ms` (ms): the program's host time in its span
`search.plan` (`ChunkStore._resolve_plan`: the decision table and its
serve lock), over the traced, answered calls
(`program_spans.span_ms_per_call`)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    return program_spans.span_ms_per_call(ctx, "search.plan")
