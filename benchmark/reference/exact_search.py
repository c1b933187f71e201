"""The plain reference of a vector search: an exact f32 scan, and the
judge of the program's answers against it.

It imports nothing of the program. From the benchmark's own f32 rows it
works out again what the store holds (each row normalized, then rounded to
the store's dtype) and scores every query against every row in f32 with
TF32 off. The numbers it compares, each against its limit:
- `bad_slots`: answer slots that never came or say nothing: a missing query
  or slot, an id outside the corpus or twice in one answer, a score that
  is not finite, scores out of descending order;
- `score_err`: the widest gap between an answer's score and the exact
  score of the row it names;
- `miss_share`: the share of the exact top-k that the answers leave out,
  counting a left-out row only where its exact score lies above the exact
  score of every row the answer gave by more than `TIE`.
`lower_precision_search` is the control: the same scan with bf16 products
and bf16 scores, in the program's place."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TIE = 1e-6            # exact scores this close count as one
BLOCK = 1 << 16       # rows scored at a time


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32, the flags put back after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def stored_rows(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """What a cosine store holds of `rows`: each normalized, in `dtype`."""
    return normalize(rows).to(dtype)


def _blocked_topk(score, n: int, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over `score(lo, hi)` -> [Q, hi - lo] f32 slabs of `BLOCK`
    rows, merged in row order, ties to the lower id."""
    best_s = best_i = None
    for lo in range(0, n, BLOCK):
        s = score(lo, min(lo + BLOCK, n))
        top, idx = torch.topk(s, min(k, s.shape[1]), dim=1)
        idx = idx + lo
        if best_s is not None:
            top, idx = torch.cat([best_s, top], 1), torch.cat([best_i, idx], 1)
        order = torch.argsort(-top, dim=1, stable=True)[:, :k]
        best_s, best_i = top.gather(1, order), idx.gather(1, order)
    return best_s, best_i


def exact_topk(queries: torch.Tensor, rows: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k (f32 scores, int64 ids) of normalized queries over
    every row."""
    with full_f32():
        return _blocked_topk(
            lambda lo, hi: queries @ rows[lo:hi].to(torch.float32).T,
            rows.shape[0], k)


def scores_of(queries: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
    """Exact f32 scores of the rows `ids` [Q, k] names (ids in range)."""
    with full_f32():
        return torch.einsum("qd,qkd->qk", queries,
                            rows[ids].to(torch.float32))


def lower_precision_search(queries: torch.Tensor, rows: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The control: normalized queries and the rows in bf16, bf16 scores,
    top-k by those. Scores [Q, k] f32, ids int32."""
    q = normalize(queries).to(torch.bfloat16)
    s, i = _blocked_topk(
        lambda lo, hi: (q @ rows[lo:hi].to(torch.bfloat16).T).float(),
        rows.shape[0], k)
    return s, i.to(torch.int32)


def judge(queries: torch.Tensor, answers: list[tuple[np.ndarray, np.ndarray]],
          rows: torch.Tensor, k: int) -> dict[str, float]:
    """The three numbers over every (raw query batch, (scores, ids))
    answer; `rows` is what the store holds."""
    n = rows.shape[0]
    bad = score_err = missed = 0.0
    asked = 0
    for q_raw, (scores, ids) in zip(queries, answers):
        q = normalize(q_raw)
        b = q.shape[0]
        asked += b * k
        scores = np.asarray(scores, dtype=np.float64)
        ids = np.asarray(ids, dtype=np.int64)
        if scores.ndim != 2 or ids.shape != scores.shape or ids.shape[1] > k:
            bad += b * k
            continue
        got = min(ids.shape[0], b)
        bad += (b - got) * k + (k - ids.shape[1]) * got
        ids, scores = ids[:got], scores[:got]
        ok = (ids >= 0) & (ids < n) & np.isfinite(scores)
        srt = np.ones_like(ok)
        srt[:, 1:] = scores[:, 1:] <= scores[:, :-1]
        for r in range(got):
            _, first = np.unique(ids[r], return_index=True)
            dup = np.ones(ids.shape[1], dtype=bool)
            dup[first] = False
            ok[r] &= ~dup
        ok &= srt
        bad += float((~ok).sum())
        safe = torch.from_numpy(np.where(ok, ids, 0)).to(rows.device)
        qg = q[:got]
        exact = scores_of(qg, rows, safe).double().cpu().numpy()
        if ok.any():
            score_err = max(score_err,
                            float(np.abs(scores - exact)[ok].max()))
        floor = np.where(ok, exact, np.inf).min(axis=1)
        top_s, top_i = exact_topk(qg, rows, k)
        top_s = top_s.double().cpu().numpy()
        top_i = top_i.cpu().numpy()
        for r in range(got):
            given = set(ids[r][ok[r]].tolist())
            for s, i in zip(top_s[r], top_i[r]):
                if int(i) not in given and s > floor[r] + TIE:
                    missed += 1
    return {"bad_slots": bad, "score_err": score_err,
            "miss_share": missed / max(asked, 1)}
