"""Peaks of the card and the work each measured thing needs, counted from
the configuration's and the traffic's shapes, never from the program's
objects, so that a share keeps reading the same work whatever implements it.

The peaks are the H100's published rates (SXM, dense), as
`lattice_tpu_torch/tools/dissect.py` states them; `bound_s` is its
`bound` in seconds; `attention_work` is `chip_smoke.py`'s count of what
`paired_attention` needs on a mask (frozen copies)."""

from __future__ import annotations

import numpy as np

BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(n_bytes: float, ops: float, kind: str) -> float:
    """The least time the card could take: the bytes moved once over its
    memory rate, or the operations over its dense peak for `kind`."""
    return max(n_bytes / BYTES_S, ops / PEAK_OPS_S[kind])


def int8_first_stage_width(k: int, n: int) -> int:
    """How many int8 candidates the quantized plan rescores a query:
    max(k, 16), at most 4k and n."""
    return min(max(k, 16), 4 * k, n)


def scan_int8_work(n: int, d: int, b: int, k1: int) -> tuple[float, float]:
    """(bytes, int8 operations) of one flat int8 scan of n rows against b
    int8 queries: each row's d bytes, 4-byte scale and 1-byte validity
    read once, the queries and their scales, the [b, k1] f32 scores and
    i32 ids written once; 2 b n d operations."""
    return (n * (d + 4 + 1) + b * (d + 4) + b * k1 * 8, 2.0 * b * n * d)


def search_call_work(n: int, d: int, b: int, k: int) -> tuple[float, float]:
    """(bytes, int8 operations) of one two-stage search of b raw f32
    queries over n bf16 rows with an int8 shadow: the shadow, its scales
    and the rows' validity read once, the queries, the rescore's k1 bf16
    rows a query, the [b, k] scores and ids written. The rescore's
    2 b k1 d f32 operations are under a thousandth of the scan's and are
    left out."""
    k1 = int8_first_stage_width(k, n)
    return (n * (d + 4 + 1) + b * d * 4 + b * k1 * d * 2 + b * k * 8,
            2.0 * b * n * d)


def attention_work(mask: np.ndarray, heads: int, head_dim: int = 64
                   ) -> tuple[float, float]:
    """Bytes and operations that bf16 `paired_attention` needs on `mask`
    [B, L]: q and the mask read once, the K and V rows of every 64-key tile
    that holds a live key (of every tile, for a row without one), the f32
    context written once; both products over the keys of those tiles."""
    b, ln = mask.shape
    tiles = -(-ln // 64)
    live = np.zeros((b, tiles * 64), dtype=bool)
    live[:, :ln] = mask > 0
    live = live.reshape(b, tiles, 64).any(-1)
    run = live | ~live.any(1, keepdims=True)
    width = np.minimum(ln - 64 * np.arange(tiles), 64)
    keys = float((run * width).sum())
    w = heads * head_dim
    n_bytes = 2 * b * ln * w + 2 * 2 * keys * w + 4 * b * ln + 4 * b * ln * w
    return n_bytes, 4.0 * w * ln * keys


def encoder_nonembedding_params(config: dict) -> int:
    """Parameters outside the three embedding tables: per layer the four
    attention projections, the two FFN projections (weights and biases)
    and two LayerNorms; and the embeddings' LayerNorm."""
    h, i = config["hidden_size"], config["intermediate_size"]
    per_layer = 4 * (h * h + h) + (h * i + i) + (i * h + h) + 2 * 2 * h
    return config["num_hidden_layers"] * per_layer + 2 * h


def encoder_flops(config: dict, lengths: np.ndarray) -> float:
    """Model FLOPs of a forward over chunks of `lengths` live tokens: 2 x the
    non-embedding parameters a live token, plus QK^T and PV over the live
    key-query pairs (4 x hidden x length^2 a chunk and layer)."""
    lengths = np.asarray(lengths, dtype=np.float64)
    return (2.0 * encoder_nonembedding_params(config) * lengths.sum()
            + config["num_hidden_layers"] * 4.0 * config["hidden_size"]
            * float((lengths ** 2).sum()))
