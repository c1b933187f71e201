"""The plain reference of the UniXcoder encoder: a RoBERTa forward in f32
(TF32 off) under the Hugging Face parameter names, mean-pooled over the
live tokens, and the judge of the program's pooled rows against it.

It imports nothing of the program and takes the benchmark's own weights.
Per layer, post-LayerNorm as RoBERTa: self-attention over the live keys
(masked keys take no weight), the output projection, residual and
LayerNorm, the exact-GELU FFN, residual and LayerNorm. Embeddings: word +
position (RoBERTa's: the live tokens counted from pad id + 1) + token type
0, then LayerNorm. The pool is the mean of the final hidden states over
the live tokens.

`precision="fp8"` is the control: every product's two operands rounded to
float8 e4m3 with one scale per tensor, the next step below the bf16 that
the configuration computes in; the rest as in f32.

The numbers it compares:
- `bad_rows`: answer rows that never came or hold a value that is not
  finite;
- `row_err`: the widest relative gap ||program - reference|| /
  ||reference|| over the rows."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.exact_search import full_f32

BLOCK = 32            # chunks per forward
FP8_MAX = 448.0       # largest finite float8 e4m3


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _matmul(precision: str):
    if precision == "fp8":
        return lambda a, b: _fp8(a) @ _fp8(b)
    return torch.matmul


def forward(w: dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
            mask: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Pooled [B, hidden] f32 rows of int64 `ids` and `mask` [B, L]."""
    mm = _matmul(precision)
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = h // heads
    eps = cfg["layer_norm_eps"]
    b, ln = ids.shape

    def dense(x, name):
        return mm(x, w[name + ".weight"].T) + w[name + ".bias"]

    def norm(x, name):
        return F.layer_norm(x, (h,), w[name + ".weight"], w[name + ".bias"],
                            eps)

    live = mask > 0
    positions = torch.cumsum(live.long(), 1) * live + cfg["pad_token_id"]
    x = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][positions]
         + w["embeddings.token_type_embeddings.weight"][0])
    x = norm(x, "embeddings.LayerNorm")
    key_bias = torch.where(live, 0.0, -math.inf)[:, None, None, :]
    for n in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{n}."

        def split(t):
            return t.view(b, ln, heads, hd).transpose(1, 2)

        q = split(dense(x, pre + "attention.self.query"))
        k = split(dense(x, pre + "attention.self.key"))
        v = split(dense(x, pre + "attention.self.value"))
        p = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
                          + key_bias, dim=-1)
        ctx = mm(p, v).transpose(1, 2).reshape(b, ln, h)
        x = norm(x + dense(ctx, pre + "attention.output.dense"),
                 pre + "attention.output.LayerNorm")
        mid = F.gelu(dense(x, pre + "intermediate.dense"), approximate="none")
        x = norm(x + dense(mid, pre + "output.dense"),
                 pre + "output.LayerNorm")
    m = live.to(torch.float32)[:, :, None]
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def pooled(w: dict[str, torch.Tensor], cfg: dict, ids: np.ndarray,
           mask: np.ndarray, precision: str = "f32") -> torch.Tensor:
    """`forward` over host arrays in blocks of `BLOCK` chunks of like
    length, each block cut to its longest chunk; rows in input order."""
    device = next(iter(w.values())).device
    lengths = np.asarray(mask).sum(1)
    order = np.argsort(-lengths, kind="stable")
    out = torch.empty((len(lengths), cfg["hidden_size"]), device=device)
    with torch.no_grad(), full_f32():
        for lo in range(0, len(order), BLOCK):
            sel = order[lo:lo + BLOCK]
            top = max(int(lengths[sel].max()), 1)
            i = torch.from_numpy(np.ascontiguousarray(ids[sel, :top])).to(device)
            m = torch.from_numpy(np.ascontiguousarray(mask[sel, :top])).to(device)
            out[torch.from_numpy(sel).to(device)] = forward(w, cfg, i, m,
                                                            precision)
    return out


def judge(expected: list[torch.Tensor], answers: list[np.ndarray]
          ) -> dict[str, float]:
    """`bad_rows` and `row_err` of each answer [B, hidden] against its
    reference rows."""
    bad, err = 0.0, 0.0
    for ref, got in zip(expected, answers):
        ref = ref.double().cpu().numpy()
        got = np.asarray(got, dtype=np.float64)
        if got.ndim != 2 or got.shape[1] != ref.shape[1]:
            bad += ref.shape[0]
            continue
        n = min(got.shape[0], ref.shape[0])
        bad += ref.shape[0] - n
        fine = np.isfinite(got[:n]).all(1)
        bad += float((~fine).sum())
        if fine.any():
            gap = np.linalg.norm(got[:n] - ref[:n], axis=1)
            rel = gap / np.maximum(np.linalg.norm(ref[:n], axis=1), 1e-30)
            err = max(err, float(rel[fine].max()))
    return {"bad_rows": bad, "row_err": err}
