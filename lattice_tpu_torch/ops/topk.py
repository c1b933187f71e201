"""Flat cosine score + exact top-k selection, as plain torch code.

Port of `lattice_tpu/ops/topk.py`. Rows are L2-normalized at insert time,
so the dot product is cosine similarity:

    scores = Q @ E^T          (row-dtype inputs, f32 accumulation)
    scores[:, ~valid] = NEG_INF
    stable top-k              (ties rank the lower row id first)

This module runs on any device and holds no kernel: it is the `"flat"`
plan of `ChunkStore`, the exact reference the scan kernels
(`ops/scan_topk.py`) are held against, and the oracle of the tests.

Two numeric rules carry over from the JAX version:
- `lax.top_k` ranks equal scores by the lower index; `torch.topk` makes no
  such promise, so selection here is a stable descending sort.
- XLA's `preferred_element_type=f32` keeps the product of bf16 inputs in
  f32. Here the inputs are widened to f32 (exact for bf16) and multiplied
  with TF32 off (`full_f32`), which is the same arithmetic.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

NEG_INF = -1e30


_TF32_LOCK = threading.Lock()
_tf32_depth = 0          # full_f32 blocks open, in every thread
_tf32_saved = False      # the flag as the first of them found it


@contextlib.contextmanager
def full_f32():
    """f32 matrix products at full precision on the card: TF32 is off
    inside every block (PyTorch's default, stated and enforced here).
    The flag is process-wide and blocks overlap across threads
    (`QueryEngine` scores in a worker thread), so a lock and a depth count
    guard it: the first block to open saves the flag and clears it, the
    last to close restores it, the others only count."""
    global _tf32_depth, _tf32_saved
    with _TF32_LOCK:
        if _tf32_depth == 0:
            _tf32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


def l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Host-side normalization applied at insert/query time."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, eps)


def l2_normalize_t(x: torch.Tensor) -> torch.Tensor:
    """Device-side counterpart of `l2_normalize` (f32 out)."""
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def stable_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, sorted, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def batched_matmul_scores(queries: torch.Tensor,
                          embeddings: torch.Tensor) -> torch.Tensor:
    """Raw [B, N] cosine scores: queries cast to the row dtype, products
    and sums in f32."""
    q = queries.to(embeddings.dtype).to(torch.float32)
    with full_f32():
        return q @ embeddings.to(torch.float32).T


def flat_topk(queries: torch.Tensor, embeddings: torch.Tensor,
              valid: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k. Returns (scores [B,k] f32, indices [B,k] i32)."""
    scores = batched_matmul_scores(queries, embeddings)
    scores = torch.where(valid[None, :].to(torch.bool), scores,
                         torch.full_like(scores, NEG_INF))
    return stable_topk(scores, k)


def flat_topk_filtered(queries: torch.Tensor, embeddings: torch.Tensor,
                       valid: torch.Tensor, filter_mask: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k restricted to rows passing the payload filter."""
    return flat_topk(queries, embeddings, valid & filter_mask, k)


def merge_topk(scores_a: torch.Tensor, idx_a: torch.Tensor,
               scores_b: torch.Tensor, idx_b: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k lists into one; on equal scores list `a` wins, as
    the earlier position does under `lax.top_k`."""
    scores = torch.cat([scores_a, scores_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top, pos = stable_topk(scores, k)
    return top, torch.gather(idx, -1, pos.to(torch.int64))


def blocked_topk(score_block, n: int, k: int, block: int = 1 << 17
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over `score_block(lo, hi)` -> masked [B, hi-lo] f32
    score slabs, `block` rows at a time, merged in row order. Exact for
    any block split, ties included: `merge_topk` keeps the earlier (lower
    row id) list first on equal scores."""
    if n == 0:
        raise ValueError("blocked_topk: no rows")
    best = None
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s, i = stable_topk(score_block(lo, hi), min(k, hi - lo))
        i = i + lo
        if s.shape[-1] < k:  # block smaller than k: pad to merge width
            pad = k - s.shape[-1]
            s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, pad))
        best = (s, i) if best is None else merge_topk(*best, s, i, k)
    return best


def flat_topk_blocked(queries: torch.Tensor, embeddings: torch.Tensor,
                      valid: torch.Tensor, k: int, block: int = 1 << 17
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flat_topk` with bounded memory: each step holds one [B, block] f32
    score slab and one f32 copy of `block` rows, so a 1M x 768 corpus
    never needs a full f32 copy."""
    q = queries.to(embeddings.dtype).to(torch.float32)
    keep = valid.to(torch.bool)

    def score_block(lo, hi):
        with full_f32():
            s = q @ embeddings[lo:hi].to(torch.float32).T
        return torch.where(keep[None, lo:hi], s, torch.full_like(s, NEG_INF))

    return blocked_topk(score_block, embeddings.shape[0], k, block)


# ---- NumPy oracle ------------------------------------------------------


def topk_oracle(
    queries: np.ndarray, embeddings: np.ndarray, valid: np.ndarray, k: int,
    filter_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact brute-force reference implementation (float64)."""
    q = np.asarray(queries, dtype=np.float64)
    e = np.asarray(embeddings, dtype=np.float64)
    scores = q @ e.T
    keep = np.asarray(valid, dtype=bool)
    if filter_mask is not None:
        keep = keep & np.asarray(filter_mask, dtype=bool)
    scores[:, ~keep] = -np.inf
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, idx, axis=1)
    return top, idx.astype(np.int32)
