"""`encode_host_prep_ms` (ms): the program's host time in its span
`encode.host_prep`, `UniXcoderModel._encode_device_host` up to the
forward (the arrays' conversion, truncation and pad to the length bucket,
the uploads of ids and mask), over the traced, answered calls
(`program_spans.span_ms_per_call`)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    return program_spans.span_ms_per_call(ctx, "encode.host_prep")
