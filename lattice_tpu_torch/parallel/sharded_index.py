"""Corpus-sharded search: a top-k per shard, then one merge (torch port).

Port of `lattice_tpu/parallel/sharded_index.py`. The [N, d] rows split
into equal row blocks, one per logical shard of the mesh (padded with
invalid zero rows); queries are replicated to each shard's device. Each
shard selects its local top-k with the single-device kernels: kernel A +
B (`scan_topk.fused_topk`) over bf16 or f32 rows, kernel C or D + B and an
exact in-shard rescore for the quantized view; the plain versions on the
CPU. The shards' [B, k] lists then go to the lead device and kernel B
(`merge_candidates`) re-selects the global top-k: the port's
`all_gather` + `lax.top_k`, with ties to the lower global id as
`lax.top_k` ranks shard-major lists. A multislice mesh merges within each
slice first, then across slices.

Every shard is launched before any is read back: the wrappers enqueue on
each device's current stream, and the copies to the lead device order
themselves after them. On one card the shards run one after another on
its stream; they measure the cost of sharding, not scale-out.

Left behind: the TPU's Pallas gates (tile picks, the 64-slot cap of the
quantized first stage) and its forced row-major [N, 1] column layouts.
Validity and scales stay [N] vectors. The quantized first stage keeps the
XLA width (8k or 4k, floor 32 or 16); on the card it is capped at the
kernel's longest list (kernel C's 128, kernel D's 512), and a shard whose
k itself exceeds that raises `KernelError`.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import quant
from lattice_tpu_torch.ops import scan_topk as scan_ops
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.topk import NEG_INF, full_f32, stable_topk
from lattice_tpu_torch.parallel.mesh import (DeviceMesh, make_mesh,
                                             replicated, row_sharded,
                                             rows_per_shard)


def _tensor(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor of `x` (host arrays wrapped, tensors kept where they are),
    cast to `dtype` if given."""
    t = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x)))
    return t if dtype is None else t.to(dtype)


def _torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def merge_topk_axis(scores: list[torch.Tensor], ids: list[torch.Tensor],
                    k_out: int, lead: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The candidate merge of every sharded view: the shards' [B, k] lists
    (global ids) gathered on `lead` in shard order, then kernel B's top
    k_out (`merge_candidates`; its plain version on the CPU). The payload
    is k pairs a shard, never rows."""
    s = torch.cat([x.to(lead, non_blocking=True) for x in scores], dim=1)
    i = torch.cat([x.to(lead, non_blocking=True) for x in ids], dim=1)
    return scan_ops.merge_candidates(s, i, min(k_out, s.shape[1]))


def merge_shards(mesh: DeviceMesh, scores: list[torch.Tensor],
                 ids: list[torch.Tensor], k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard lists into the global top-k on the mesh's lead
    device: within each slice on its first device, then across slices (a
    mesh without a dcn axis is one slice)."""
    devices = mesh.row_devices
    parts = [merge_topk_axis([scores[j] for j in sl], [ids[j] for j in sl],
                             k, devices[sl[0]])
             for sl in mesh.slices]
    if len(parts) == 1:
        return parts[0]
    return merge_topk_axis([p[0] for p in parts], [p[1] for p in parts], k,
                           mesh.lead)


class _RowSharded:
    """What the sharded views share: the mesh, the row split, the masks
    and the row ids of a mutation, shard by shard."""

    def __init__(self, n: int, mesh: DeviceMesh | None):
        self.mesh = mesh or make_mesh()
        self.multislice = self.mesh.multislice
        self.devices = self.mesh.row_devices
        self.n_rows = n
        self.rows_per_shard = rows_per_shard(self.mesh, n)

    @property
    def capacity(self) -> int:
        return self.rows_per_shard * len(self.devices)

    def _mask_shards(self, mask) -> list[torch.Tensor | None]:
        """A [<= capacity] bool row mask, padded with False and split."""
        if mask is None:
            return [None] * len(self.devices)
        m = _tensor(mask, torch.bool).reshape(-1)
        return row_sharded(self.mesh, torch.nn.functional.pad(
            m, (0, self.capacity - m.shape[0])))

    def _by_shard(self, rows: np.ndarray):
        """(shard, positions in `rows`, local row tensor on its device) for
        every shard that `rows` touch."""
        shard = rows // self.rows_per_shard
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            local = rows[sel] - s * self.rows_per_shard
            yield int(s), sel, torch.as_tensor(local, dtype=torch.int64,
                                               device=self.devices[s])

    def _rows_in_capacity(self, rows) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        return rows[rows < self.capacity]

    def _global(self, s: int, ids: torch.Tensor) -> torch.Tensor:
        return ids + s * self.rows_per_shard


class ShardedIndex(_RowSharded):
    """Row-sharded view of an embedding matrix for search.

    Mutations are O(delta): `update_rows` / `invalidate_rows` write the
    touched rows on their shards, the bytes moved being the delta rows. A
    row id past the padded capacity returns False, and the caller
    rebuilds (the store sizes the view to its own capacity, which grows
    geometrically)."""

    def __init__(self, embeddings, valid, mesh: DeviceMesh | None = None,
                 dtype: str | torch.dtype = "bfloat16"):
        emb = _tensor(embeddings)
        super().__init__(emb.shape[0], mesh)
        self.dtype = _torch_dtype(dtype)
        self.embeddings = row_sharded(self.mesh, emb, self.dtype)
        self.valid = row_sharded(self.mesh, _tensor(valid, torch.bool))

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.embeddings + self.valid)

    def update_rows(self, vectors, rows) -> bool:
        """Write `vectors` at `rows` on their shards. False (the caller must
        rebuild) iff a row id is past the padded capacity."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size == 0:
            return True
        if int(rows.max()) >= self.capacity:
            return False
        vals = _tensor(vectors, torch.float32)
        for s, sel, local in self._by_shard(rows):
            dev = self.devices[s]
            self.embeddings[s][local] = vals[torch.as_tensor(sel)].to(
                dev, self.dtype)
            self.valid[s][local] = True
        self.n_rows = max(self.n_rows, int(rows.max()) + 1)
        return True

    def invalidate_rows(self, rows) -> None:
        rows = self._rows_in_capacity(rows)
        for s, _, local in self._by_shard(rows):
            self.valid[s][local] = False

    def search_device(self, queries: torch.Tensor, k: int,
                      mask=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Global (scores [B, k'] f32, row ids [B, k'] i32) on the lead
        device, k' = min(k, shards x min(k, rows a shard)); raw queries
        in. `mask` ([<= capacity] bool, e.g. a payload filter) ANDs into
        each shard's validity."""
        k_local = min(k, self.rows_per_shard)
        q = topk_ops.l2_normalize_t(queries).contiguous()
        out_s, out_i = [], []
        for s, (q_d, emb, val, m) in enumerate(zip(
                replicated(self.mesh, q), self.embeddings, self.valid,
                self._mask_shards(mask))):
            s_l, i_l = scan_ops.fused_topk(q_d, emb,
                                           val if m is None else val & m,
                                           k_local)
            out_s.append(s_l)
            out_i.append(self._global(s, i_l))
        return merge_shards(self.mesh, out_s, out_i, k)

    def search(self, queries: np.ndarray, k: int,
               mask: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: numpy in and out around `search_device`."""
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32)))
        s, i = self.search_device(q.to(self.mesh.lead), k, mask)
        return s.cpu().numpy(), i.cpu().numpy()


def _quantize_rows(x: torch.Tensor, bits: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    fn = (quant.quantize_rows_device if bits == 8
          else quant.quantize_rows_int4_device)
    return fn(x)


def _quantize_shards(mesh: DeviceMesh, x, bits: int
                     ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-row quantized values and scales of `x`, split like
    `row_sharded`. Host rows quantize on the host (`quantize_rows`, as the
    JAX view does); device rows quantize a shard at a time on its device."""
    if not isinstance(x, torch.Tensor):
        host = quant.quantize_rows if bits == 8 else quant.quantize_rows_int4
        values, scales = host(np.asarray(x, np.float32))
        return (row_sharded(mesh, torch.from_numpy(values)),
                row_sharded(mesh, torch.from_numpy(scales)))
    per = rows_per_shard(mesh, x.shape[0])
    width = x.shape[1] if bits == 8 else x.shape[1] // 2
    values, scales = [], []
    for i, dev in enumerate(mesh.row_devices):
        v = torch.zeros((per, width), dtype=torch.int8, device=dev)
        sc = torch.zeros((per,), dtype=torch.float32, device=dev)
        part = x[i * per:(i + 1) * per]
        if part.shape[0]:
            v[:part.shape[0]], sc[:part.shape[0]] = _quantize_rows(
                part.to(dev), bits)
        values.append(v)
        scales.append(sc)
    return values, scales


def _dequant_rescore(q: torch.Tensor, values: torch.Tensor,
                     scales: torch.Tensor, bits: int, s1: torch.Tensor,
                     c1: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rescore first-stage candidates against their own dequantized rows
    (f32, TF32 off); slots the first stage scored NEG_INF stay NEG_INF."""
    c = c1.to(torch.int64)
    rows = values[c]
    if bits == 4:
        rows = scan_ops.unpack_int4(rows)
    emb = rows.to(torch.float32) * scales[c][..., None]
    with full_f32():
        sc = torch.einsum("bd,bkd->bk", q, emb)
    sc = torch.where(s1 > NEG_INF / 2, sc, torch.full_like(sc, NEG_INF))
    top, pos = stable_topk(sc, k)
    return top, torch.gather(c1, -1, pos.to(torch.int64))


class ShardedQuantizedIndex(_RowSharded):
    """Quantized row-sharded view: 2x (int8) or 4x (int4) corpus a device.

    The `ShardedIndex` plan with symmetric per-row int8 values (`bits=8`)
    or packed nibbles (`bits=4`) and f32 scales on each shard (ops/quant.py
    math). Each shard widens its first stage (kernel C or D + B) and
    rescores the candidates exactly against its own dequantized rows, or,
    with `keep_full_precision=True`, against a bf16 copy of the rows kept
    beside the planes (the speed configuration, which forfeits the
    capacity win for exact ordering). Mutations are O(delta) as in
    `ShardedIndex`."""

    def __init__(self, embeddings, valid, mesh: DeviceMesh | None = None,
                 bits: int = 8, keep_full_precision: bool = False):
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        n = embeddings.shape[0]
        super().__init__(n, mesh)
        self.bits = bits
        self.value_shards, self.scale_shards = _quantize_shards(
            self.mesh, embeddings, bits)
        self.valid_shards = row_sharded(self.mesh,
                                        _tensor(valid, torch.bool))
        self.full_precision = (
            row_sharded(self.mesh, _tensor(embeddings), torch.bfloat16)
            if keep_full_precision else None)

    def memory_bytes(self) -> int:
        fp = (sum(t.numel() * 2 for t in self.full_precision)
              if self.full_precision is not None else 0)
        return sum(v.numel() + s.numel() * 4 + m.numel() for v, s, m in zip(
            self.value_shards, self.scale_shards, self.valid_shards)) + fp

    # flat views over the shards, gathered on the lead device
    @property
    def values(self) -> torch.Tensor:
        return torch.cat([v.to(self.mesh.lead) for v in self.value_shards])

    @property
    def scales(self) -> torch.Tensor:
        return torch.cat([s.to(self.mesh.lead) for s in self.scale_shards])

    @property
    def valid(self) -> torch.Tensor:
        return torch.cat([v.to(self.mesh.lead) for v in self.valid_shards])

    def update_rows(self, vectors, rows) -> bool:
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size == 0:
            return True
        if int(rows.max()) >= self.capacity:
            return False
        vecs = _tensor(vectors, torch.float32)
        nv, ns = _quantize_rows(vecs, self.bits)
        for s, sel, local in self._by_shard(rows):
            dev, pick = self.devices[s], torch.as_tensor(sel)
            self.value_shards[s][local] = nv[pick].to(dev)
            self.scale_shards[s][local] = ns[pick].to(dev)
            self.valid_shards[s][local] = True
            if self.full_precision is not None:
                self.full_precision[s][local] = vecs[pick].to(
                    dev, torch.bfloat16)
        self.n_rows = max(self.n_rows, int(rows.max()) + 1)
        return True

    def invalidate_rows(self, rows) -> None:
        rows = self._rows_in_capacity(rows)
        for s, _, local in self._by_shard(rows):
            self.valid_shards[s][local] = False

    def stage_width(self, k: int, rescore: bool, device: torch.device
                    ) -> tuple[int, int]:
        """(k a shard keeps, its first-stage width): the XLA widths, int4
        8x (floor 32), int8 4x (floor 16), capped by the rows of a shard
        and, on the card, by the kernel's longest list."""
        k_local = min(k, self.rows_per_shard)
        widen, floor = (8, 32) if self.bits == 4 else (4, 16)
        kk = (min(max(widen * k, floor), self.rows_per_shard) if rescore
              else k_local)
        if device.type == "cuda":
            cap = scan_ops.MAX_K1 if self.bits == 8 else scan_ops.MAX_K1_LONG
            if k_local > cap:
                raise KernelError(
                    f"sharded int{self.bits} search: k={k_local} a shard "
                    f"exceeds the kernel's longest list ({cap})")
            kk = min(kk, cap)
        return k_local, kk

    def search_device(self, queries: torch.Tensor, k: int, mask=None,
                      rescore: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Global (scores, row ids) on the lead device; raw queries in.
        By default each shard widens its first stage and rescores its
        candidates before the merge, so scores come back f32-ordered;
        `rescore=False` keeps the raw quantized scan."""
        k_local, kk = self.stage_width(k, rescore, self.mesh.lead)
        q = topk_ops.l2_normalize_t(queries).contiguous()
        qv, qs = quant.quantize_rows_device(q)
        scan = (scan_ops.scan_topk_int8 if self.bits == 8
                else scan_ops.scan_topk_int4)
        fps = self.full_precision or [None] * len(self.devices)
        out_s, out_i = [], []
        for s, (q_d, qv_d, qs_d, m) in enumerate(zip(
                replicated(self.mesh, q), replicated(self.mesh, qv),
                replicated(self.mesh, qs), self._mask_shards(mask))):
            values, scales = self.value_shards[s], self.scale_shards[s]
            val = self.valid_shards[s]
            s1, c1 = scan(qv_d, qs_d, values, scales,
                          val if m is None else val & m, kk)
            if not rescore:
                sl, il = s1[:, :k_local], c1[:, :k_local]
            elif fps[s] is not None:
                sl, il = scan_ops._exact_rescore(q_d, fps[s], s1, c1,
                                                 k_local)
            else:
                sl, il = _dequant_rescore(q_d, values, scales, self.bits,
                                          s1, c1, k_local)
            out_s.append(sl)
            out_i.append(self._global(s, il))
        return merge_shards(self.mesh, out_s, out_i, k)

    def search(self, queries: np.ndarray, k: int,
               mask: np.ndarray | None = None, rescore: bool = True
               ) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: numpy in and out around `search_device`."""
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32)))
        s, i = self.search_device(q.to(self.mesh.lead), k, mask, rescore)
        return s.cpu().numpy(), i.cpu().numpy()


def tree_merge_topk(scores: list[torch.Tensor], ids: list[torch.Tensor],
                    k: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The pairwise reduce ladder, the alternative to the one-step merge
    for very large D x k: ceil(log2 D) rounds, in round r shard j (j a
    multiple of 2^(r+1)) merges the lists shard j + 2^r held at the start
    of the round (`ops/topk.merge_topk`, its own list first on ties).
    Returns every shard's (scores, ids); shard 0 holds the global top-k."""
    cur = list(zip(scores, ids))
    n = len(cur)
    stride = 1
    while stride < n:
        prev = list(cur)
        for j in range(0, n, 2 * stride):
            rs, rx = prev[(j + stride) % n]
            s, x = prev[j]
            cur[j] = topk_ops.merge_topk(s, x, rs.to(s.device),
                                         rx.to(x.device), k)
        stride *= 2
    return cur
