"""Int8 and packed-int4 quantized scoring: a half or a quarter of the
bytes of bf16 per scanned row.

Port of `lattice_tpu/ops/quant.py`. Symmetric per-row scales,

    q_i8[i, :] = round(e[i, :] / max(max_abs(e[i, :]) * (1/127), 1e-12))
    score(q, i) ~= (q_q . q_i8[i]) * scale_q * scale_i

rounded half to even and clipped to +-127, exactly as the JAX version
rounds, so both packages hold bit-identical shadows. `QuantizedView`
keeps the int8 shadow of a store's rows on the store's device; its
two-stage search scans the shadow through kernel C (`scan_topk_int8`,
plain version on the CPU) and rescores the widened candidates exactly
against the full-precision rows.

The int4 tier (`Int4View`, the 4x-capacity mode) steps by amax/7, clips to
+-7 and packs two values per byte in the JAX layout: [N, d/2] int8 whose
low nibble holds v + 8 for dims [0, d/2) and whose high nibble holds v for
dims [d/2, d). Queries stay int8. Its first stage is kernel D
(`scan_topk_int4`); the candidates rescore against the full-precision rows
or, with no rows resident, against the dequantized packed rows
(`int4_dequant_rescore`). JAX fused normalize, quantize, scan and rescore
into one XLA execution to save relay dispatches; here they are plain
calls on one stream.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.ops import scan_topk as scan_ops
from lattice_tpu_torch.ops.scan_topk import unpack_int4
from lattice_tpu_torch.ops.topk import (NEG_INF, full_f32, l2_normalize_t,
                                        stable_topk)

__all__ = ["Int4View", "NEG_INF", "QuantizedView", "int4_dequant_rescore",
           "int4_topk", "int8_topk", "quantize_rows", "quantize_rows_device",
           "quantize_rows_int4", "quantize_rows_int4_device", "unpack_int4",
           "unpack_int4_oracle"]

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


def _blocked_rows(x: torch.Tensor, fn, width: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """`fn` over `QUANT_BLOCK` rows at a time into preallocated outputs of
    [N, width] int8 values and [N] f32 scales."""
    n = x.shape[0]
    if n <= QUANT_BLOCK:
        return fn(x)
    values = torch.empty((n, width), dtype=torch.int8, device=x.device)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    for lo in range(0, n, QUANT_BLOCK):
        hi = min(lo + QUANT_BLOCK, n)
        values[lo:hi], scales[lo:hi] = fn(x[lo:hi])
    return values, scales


def quantize_rows_device(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row quantization on the tensor's own device, `QUANT_BLOCK` rows at a
    time into preallocated outputs."""
    return _blocked_rows(x, _quant8_block, x.shape[1])


def int8_topk(q_values: torch.Tensor, q_scales: torch.Tensor,
              e_values: torch.Tensor, e_scales: torch.Tensor,
              valid: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact quantized cosine top-k (the plain version of kernel C)."""
    return scan_ops.scan_topk_int8_plain(q_values, q_scales, e_values,
                                         e_scales, valid, k)


_l2n = l2_normalize_t


def _rows_rescore(rows: torch.Tensor | None):
    """The exact f32 rescore of a first stage against resident rows, or
    None when the caller keeps none."""
    if rows is None:
        return None
    return lambda q, s1, cand, k: scan_ops._exact_rescore(q, rows, s1, cand,
                                                          k)


class _ShadowView:
    """What the int8 and int4 shadows share: in-place upkeep and the
    two-stage search with its host entry. A subclass names its quantizer,
    its first-stage scan, the width its rescore widens to and how many
    dims a stored byte holds."""

    _per_byte = 1

    def __init__(self, embeddings: torch.Tensor):
        self.values, self.scales = self._quantize(embeddings)

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def d(self) -> int:
        return self.values.shape[1] * self._per_byte

    def memory_bytes(self) -> int:
        return self.values.numel() + self.scales.numel() * 4

    def update_rows(self, rows: torch.Tensor, idx: torch.Tensor) -> None:
        """O(delta) upsert, in place: re-quantize just the changed rows."""
        v, s = self._quantize(rows.to(torch.float32))
        self.values[idx] = v
        self.scales[idx] = s

    def _first_stage(self, q_values: torch.Tensor, q_scales: torch.Tensor,
                     valid: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The view's kernel (+ kernel B) on the card, the plain version on
        the CPU. Its output is sorted, so slicing the widened list to k is
        exact."""
        s, i = self._scan(q_values, q_scales, self.values, self.scales,
                          valid, k)
        return s[:, :k], i[:, :k]

    def _two_stage(self, queries: torch.Tensor, valid: torch.Tensor, k: int,
                   rescore) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw queries in. Without `rescore`, the first stage alone at
        width k; else `rescore(q, s1, cand, k)` of `_width(k, n)`
        candidates."""
        q = _l2n(queries).contiguous()
        q_values, q_scales = quantize_rows_device(q)
        if rescore is None:
            return self._first_stage(q_values, q_scales, valid, k)
        s1, cand = self._first_stage(q_values, q_scales, valid,
                                     self._width(k, self.n))
        return rescore(q, s1, cand, k)

    def search(self, queries: np.ndarray, valid: torch.Tensor, k: int,
               full_precision: torch.Tensor | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: numpy in/out around `search_device`."""
        q = torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(queries), dtype=np.float32)).to(self.values.device)
        s, i = self.search_device(q, valid, k, full_precision)
        return s.cpu().numpy(), i.cpu().numpy()


class QuantizedView(_ShadowView):
    """Int8 shadow of an embedding matrix for fast first-stage scanning.

    Two-stage search: the int8 scan (kernel C + B) selects
    `int8_first_stage_width(k, n)` candidates, then the full-precision rows
    rescore them (a gather of k1 rows per query). `update_rows` writes
    re-quantized rows into the shadow in place.
    """

    _quantize = staticmethod(quantize_rows_device)
    _scan = staticmethod(scan_ops.binned_topk_int8)
    _width = staticmethod(scan_ops.int8_first_stage_width)

    def search_device(self, queries: torch.Tensor, valid: torch.Tensor,
                      k: int, full_precision: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-stage search on the view's device; raw queries in. Without
        `full_precision`, the first stage alone at width k."""
        return self._two_stage(queries, valid, k,
                               _rows_rescore(full_precision))


# ---- int4 tier --------------------------------------------------------------


def _even_dim(d: int) -> None:
    if d % 2:
        raise ValueError("int4 packing needs an even dim")


def quantize_rows_int4(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int4, packed two per byte. Returns (packed [N, d/2]
    int8, scales [N] f32). d must be even."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    _even_dim(d)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    scales = (amax / 7.0).astype(np.float32)
    safe = np.maximum(scales, 1e-12)
    v = np.clip(np.rint(x / safe), -7, 7).astype(np.int32)
    lo = v[:, : d // 2]
    hi = v[:, d // 2:]
    packed = ((hi << 4) | (lo + 8)).astype(np.int8)  # biased low nibble
    return packed, scales[:, 0]


def _quant4_block(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.float32)
    d = x.shape[-1]
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # XLA folds `amax / 7.0` into a multiply by the f32 reciprocal of 7, as
    # it does for 127 (`_quant8_block`): the same multiply keeps the scales
    # bit for bit those of the JAX `quantize_rows_int4_device`
    scales = amax * (1.0 / 7.0)
    safe = torch.clamp(scales, min=1e-12)
    v = torch.clamp(torch.round(x / safe), -7, 7).to(torch.int32)
    lo = v[:, : d // 2]
    hi = v[:, d // 2:]
    packed = ((hi << 4) | (lo + 8)).to(torch.int8)  # biased low nibble
    return packed, scales[:, 0]


def quantize_rows_int4_device(x: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int4 quantization on the tensor's own device, blocked like
    `quantize_rows_device`."""
    _even_dim(x.shape[1])
    return _blocked_rows(x, _quant4_block, x.shape[1] // 2)


def unpack_int4_oracle(packed: np.ndarray) -> np.ndarray:
    x = np.asarray(packed, dtype=np.int32)
    lo = (x & 0xF) - 8
    hi = x >> 4
    return np.concatenate([lo, hi], axis=-1).astype(np.int8)


def int4_topk(q_values: torch.Tensor, q_scales: torch.Tensor,
              e_packed: torch.Tensor, e_scales: torch.Tensor,
              valid: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact int4-corpus cosine top-k (the plain version of kernel D)."""
    return scan_ops.scan_topk_int4_plain(q_values, q_scales, e_packed,
                                         e_scales, valid, k)


def int4_dequant_rescore(q_norm: torch.Tensor, e_packed: torch.Tensor,
                         e_scales: torch.Tensor, s1: torch.Tensor,
                         cand: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-mode second stage: rescore the first stage's candidates
    against their own dequantized packed rows, f32 (TF32 off), with no
    full-precision rows resident. Slots the first stage scored NEG_INF
    are never promoted."""
    c = cand.to(torch.int64)
    rows = unpack_int4(e_packed[c]).to(torch.float32) * e_scales[c][..., None]
    with full_f32():
        scores = torch.einsum("bd,bkd->bk", q_norm.to(torch.float32), rows)
    scores = torch.where(s1 > NEG_INF / 2, scores,
                         torch.full_like(scores, NEG_INF))
    top, pos = stable_topk(scores, min(k, scores.shape[-1]))
    return top, torch.gather(cand, -1, pos.to(torch.int64))


class Int4View(_ShadowView):
    """Packed-int4 shadow of an embedding matrix: the 4x capacity tier.

    Two-stage search as `QuantizedView`: the int4 scan (kernel D + B)
    selects `int4_first_stage_width(k, n)` = max(8k, 32) candidates, which
    rescore against the full-precision rows when the caller keeps them, or
    against the packed rows themselves in capacity mode
    (`dequant_rescore=True`), which fixes selection ties and the query's
    int8 rounding but not the rows' int4 error. `update_rows` writes
    re-quantized rows into the shadow in place.
    """

    _per_byte = 2
    _scan = staticmethod(scan_ops.binned_topk_int4)
    _width = staticmethod(scan_ops.int4_first_stage_width)

    @staticmethod
    def _quantize(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return quantize_rows_int4_device(rows)

    @classmethod
    def from_packed(cls, values: torch.Tensor, scales: torch.Tensor
                    ) -> "Int4View":
        """Adopt already-packed [N, d/2] int8 nibbles and [N] f32 scales:
        the build of a corpus whose f32 (or bf16) rows never fit beside
        the shadow, quantized block by block with
        `quantize_rows_int4_device`."""
        self = cls.__new__(cls)
        self.values, self.scales = values, scales
        return self

    def search_device(self, queries: torch.Tensor, valid: torch.Tensor,
                      k: int, full_precision: torch.Tensor | None = None,
                      dequant_rescore: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-stage search on the view's device (queries int8, rows int4);
        raw queries in. With neither `full_precision` nor
        `dequant_rescore`, the first stage alone at width k."""
        rescore = _rows_rescore(full_precision)
        if rescore is None and dequant_rescore:
            rescore = self._dequant_rescore
        return self._two_stage(queries, valid, k, rescore)

    def _dequant_rescore(self, q, s1, cand, k):
        return int4_dequant_rescore(q, self.values, self.scales, s1, cand, k)
