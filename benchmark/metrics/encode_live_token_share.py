"""`encode_live_token_share` (%): the share of the tokens the encoder ran
that were live, over the traced calls: 100 x the program's counter
`encode.tokens_live` (each batch's mask sum) over `encode.tokens_padded`
(B x the batch's length bucket)."""

from benchmark import program_spans


def read(ctx) -> float | None:
    live = program_spans.counter("encode.tokens_live")
    padded = program_spans.counter("encode.tokens_padded")
    if live is None or not padded:
        return None
    return 100.0 * live / padded
