"""The corpus-wide hybrid deep rank where the rows live (torch port).

Port of `lattice_tpu/parallel/sharded_rank.py`: the hybrid ranking pass
of the reference (`query/engine.py:102-220`, `ranking/scorer.py:9-126`),
which on one device is `ops/ranking.hybrid_rank_device_packed_batch`. The
fuse is row-local (every row's score depends on its own cosine, reach,
degree, quality and match bit), so the plan is `ShardedIndex`'s:

- rows [N, d], validity, degree, quality (and the scales of a quantized
  tier) split by rows over the mesh;
- the per-query packed evidence ([Q, R] reach, [Q, M] match rows, [Q, 4]
  / [Q, 8] tables) is small and replicated; each shard rebases the global
  row ids into its own window and drops the rest;
- each shard fuses its rows (`ops/ranking.fuse_packed`) and selects its
  top-k (`_select_topk`: kernel B's positional entry on the card), with
  global ids; the [Q, k] lists merge through kernel B
  (`parallel/sharded_index.merge_shards`).

Selection is exact everywhere, so the merged result equals the
single-device rank (the cosines up to the last bits a product of another
shape may move).

`bits` is the capacity ladder of the sharded index: 16 keeps the rows'
dtype, 8 symmetric per-row int8, 4 packed nibbles. The quantized cosine
(the normalized query quantized, an integer product, the two scales)
feeds the same fuse. The int8 x int8 products are summed in f32, exact
while every partial sum is an integer below 2^24 (d <= 1040 for int8 rows,
d <= 16,000 for int4 ones), else in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.ops import ranking
from lattice_tpu_torch.ops.quant import _quant8_block
from lattice_tpu_torch.ops.ranking import NEG_INF, REACH_ROW_MASK
from lattice_tpu_torch.ops.scan_topk import unpack_int4
from lattice_tpu_torch.ops.topk import full_f32, l2_normalize_t
from lattice_tpu_torch.parallel.mesh import (DeviceMesh, replicated,
                                             row_sharded)
from lattice_tpu_torch.parallel.sharded_index import (_RowSharded,
                                                      _quantize_shards,
                                                      _tensor, _torch_dtype,
                                                      merge_shards)


def _quant_scores(q: torch.Tensor, values: torch.Tensor,
                  scales: torch.Tensor, bits: int) -> torch.Tensor:
    """[Q, n] quantized cosines: the normalized queries quantized to int8,
    dotted exactly with the int8 (or unpacked int4) rows, then (acc x
    query scale) x row scale. Rows are widened `ranking.COSINE_BLOCK` at a
    time."""
    qv, qs = _quant8_block(q)
    d = qv.shape[1]
    exact_f32 = 127 * (127 if bits == 8 else 8) * d < (1 << 24)
    acc_t = torch.float32 if exact_f32 else torch.float64
    qf = qv.to(acc_t)
    n = values.shape[0]
    acc = torch.empty((q.shape[0], n), dtype=torch.float32,
                      device=values.device)
    with full_f32():
        for lo in range(0, n, ranking.COSINE_BLOCK):
            rows = values[lo:lo + ranking.COSINE_BLOCK]
            if bits == 4:
                rows = unpack_int4(rows)
            acc[:, lo:lo + rows.shape[0]] = qf @ rows.to(acc_t).T
    return acc * qs[:, None] * scales[None, :]


class ShardedHybridRank(_RowSharded):
    """Row-sharded corpus and rank columns serving the batched hybrid rank.

    Construction copies each array once onto its shards. Mutations follow
    the store: the view is rebuilt when the store's rank columns are
    (`ChunkStore.sharded_hybrid`)."""

    def __init__(self, embeddings, valid, degree, quality,
                 mesh: DeviceMesh | None = None,
                 dtype: str | torch.dtype = "bfloat16", bits: int = 16):
        if bits not in (16, 8, 4):
            raise ValueError(f"bits must be 16, 8 or 4, got {bits}")
        super().__init__(embeddings.shape[0], mesh)
        self.bits = bits
        if bits == 16:
            self.embeddings = row_sharded(self.mesh, _tensor(embeddings),
                                          _torch_dtype(dtype))
            self.scales = None
        else:
            self.embeddings, self.scales = _quantize_shards(
                self.mesh, embeddings, bits)
        self.valid = row_sharded(self.mesh, _tensor(valid, torch.bool))
        self.degree = row_sharded(self.mesh, _tensor(degree, torch.int32))
        self.quality = row_sharded(self.mesh,
                                   _tensor(quality, torch.float32))

    def _local(self, s: int, q: torch.Tensor, packed: torch.Tensor,
               rel: torch.Tensor, match: torch.Tensor, w: torch.Tensor,
               k_local: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard `s`'s fuse and selection over its own rows, inputs (raw
        queries) on its device: (scores [Q, k_local], global rows)."""
        emb, valid = self.embeddings[s], self.valid[s]
        n_local = emb.shape[0]
        if self.bits == 16:
            vec = ranking.row_scores(q, emb, valid)
        else:
            vec = _quant_scores(l2_normalize_t(q), emb, self.scales[s],
                                self.bits)
            vec.masked_fill_(~valid[None, :], NEG_INF)
        base = s * self.rows_per_shard
        rows = (packed & REACH_ROW_MASK) - base
        packed = torch.where((packed >= 0) & (rows >= 0) & (rows < n_local),
                             packed - base, -1)
        local_m = match - base
        match = torch.where((match >= 0) & (local_m >= 0)
                            & (local_m < n_local), local_m, -1)
        fused = ranking.fuse_packed(vec, packed, rel, match, self.degree[s],
                                    self.quality[s], w)
        top_s, top_i = ranking._select_topk(fused, k_local)
        return top_s, self._global(s, top_i)

    def rank_device(self, queries: torch.Tensor, packed_reach: torch.Tensor,
                    rel_table: torch.Tensor, match_rows: torch.Tensor,
                    weights: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """([Q, k] scores, [Q, k] global row ids) on the lead device. Same
        contract as `ops/ranking.hybrid_rank_device_packed_batch`: packed
        reach [Q, R] (global rows), tables [4] / [8] or per query [Q, 4] /
        [Q, 8], match rows [Q, M] (-1 pads). Slots of no row (NEG_INF,
        past the live rows) carry row 0, never a pad row's id."""
        nq = queries.shape[0]
        w = weights if weights.dim() == 2 else weights.expand(nq, -1)
        rel = rel_table if rel_table.dim() == 2 else rel_table.expand(nq, -1)
        k_local = min(k, self.rows_per_shard)
        inputs = [replicated(self.mesh, x.contiguous())
                  for x in (queries, packed_reach, rel, match_rows, w)]
        out_s, out_i = [], []
        for s, args in enumerate(zip(*inputs)):
            top_s, top_i = self._local(s, *args, k_local)
            out_s.append(top_s)
            out_i.append(top_i)
        top_s, top_i = merge_shards(self.mesh, out_s, out_i, k)
        return top_s, torch.where(top_s > NEG_INF / 2, top_i, 0)

    def rank(self, queries, packed_reach, rel_table, match_rows, weights,
             k: int) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: numpy in and out around `rank_device`."""
        lead = self.mesh.lead

        def put(a, dtype=None) -> torch.Tensor:
            return _tensor(np.asarray(a), dtype).to(lead)

        s, i = self.rank_device(
            put(np.atleast_2d(np.asarray(queries, np.float32))),
            put(packed_reach, torch.int32), put(rel_table, torch.float32),
            put(match_rows, torch.int32), put(weights, torch.float32), k)
        return s.cpu().numpy(), i.cpu().numpy()
