"""Int8 quantized scoring: half the bytes of bf16 per scanned row.

Port of the int8 half of `lattice_tpu/ops/quant.py`. Symmetric per-row
scales,

    q_i8[i, :] = round(e[i, :] / max(max_abs(e[i, :]) * (1/127), 1e-12))
    score(q, i) ~= (q_q . q_i8[i]) * scale_q * scale_i

rounded half to even and clipped to +-127, exactly as the JAX version
rounds, so both packages hold bit-identical shadows. `QuantizedView`
keeps the int8 shadow of a store's rows on the store's device; its
two-stage search scans the shadow through kernel C (`scan_topk_int8`,
plain version on the CPU) and rescores the widened candidates exactly
against the full-precision rows. The int4 tier has not been ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.ops import scan_topk as scan_ops
from lattice_tpu_torch.ops.topk import NEG_INF, l2_normalize_t

__all__ = ["NEG_INF", "QuantizedView", "int8_topk", "quantize_rows",
           "quantize_rows_device"]

# Rows quantized per step: bounds the f32 temporaries of a 1M-row shadow
# build to one block (a full f32 copy of 1M x 768 would be 3.2 GB).
QUANT_BLOCK = 1 << 17


def quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization. Returns (values i8, scales f32)."""
    x = np.asarray(x, dtype=np.float32)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.maximum(scales, 1e-12)
    values = np.clip(np.rint(x / safe), -127, 127).astype(np.int8)
    return values, scales[:, 0]


def _quant8_block(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # XLA folds `amax / 127.0` into a multiply by the f32 reciprocal of
    # 127; the same multiply here keeps the scales (and so the values) bit
    # for bit those of `quantize_rows_device` in the JAX package
    scales = amax * (1.0 / 127.0)
    safe = torch.clamp(scales, min=1e-12)
    values = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return values, scales[:, 0]


def quantize_rows_device(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row quantization on the tensor's own device, `QUANT_BLOCK` rows at a
    time into preallocated outputs."""
    n, d = x.shape
    if n <= QUANT_BLOCK:
        return _quant8_block(x)
    values = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    for lo in range(0, n, QUANT_BLOCK):
        hi = min(lo + QUANT_BLOCK, n)
        values[lo:hi], scales[lo:hi] = _quant8_block(x[lo:hi])
    return values, scales


def int8_topk(q_values: torch.Tensor, q_scales: torch.Tensor,
              e_values: torch.Tensor, e_scales: torch.Tensor,
              valid: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact quantized cosine top-k (the plain version of kernel C)."""
    return scan_ops.scan_topk_int8_plain(q_values, q_scales, e_values,
                                         e_scales, valid, k)


_l2n = l2_normalize_t


class QuantizedView:
    """Int8 shadow of an embedding matrix for fast first-stage scanning.

    Two-stage search: the int8 scan selects k1 candidates, then the
    full-precision rows rescore them (a gather of k1 rows per query).
    `update_rows` writes re-quantized rows into the shadow in place.
    """

    def __init__(self, embeddings: torch.Tensor):
        self.values, self.scales = quantize_rows_device(embeddings)
        self.n, self.d = self.values.shape

    def memory_bytes(self) -> int:
        return self.values.numel() + self.scales.numel() * 4

    def update_rows(self, rows: torch.Tensor, idx: torch.Tensor) -> None:
        """O(delta) upsert, in place: re-quantize just the changed rows."""
        v, s = quantize_rows_device(rows.to(torch.float32))
        self.values[idx] = v
        self.scales[idx] = s

    def _first_stage(self, q_values: torch.Tensor, q_scales: torch.Tensor,
                     valid: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Kernel C (+ kernel B) on the card, the plain version on the CPU.
        Its output is sorted, so slicing the widened list to k is exact."""
        s, i = scan_ops.binned_topk_int8(q_values, q_scales, self.values,
                                         self.scales, valid, k)
        return s[:, :k], i[:, :k]

    def search_device(self, queries: torch.Tensor, valid: torch.Tensor,
                      k: int, full_precision: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-stage search on the view's device; raw queries in. The
        rescore takes `int8_first_stage_width(k, n)` candidates."""
        k1 = scan_ops.int8_first_stage_width(k, self.n)
        q = _l2n(queries).contiguous()
        q_values, q_scales = quantize_rows_device(q)
        if full_precision is None:
            return self._first_stage(q_values, q_scales, valid, k)
        s1, cand = self._first_stage(q_values, q_scales, valid, k1)
        return scan_ops._exact_rescore(q, full_precision, s1, cand, k)

    def search(self, queries: np.ndarray, valid: torch.Tensor, k: int,
               full_precision: torch.Tensor | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: numpy in/out around `search_device`."""
        q = torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(queries), dtype=np.float32)).to(self.values.device)
        s, i = self.search_device(q, valid, k, full_precision)
        return s.cpu().numpy(), i.cpu().numpy()
