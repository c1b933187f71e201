"""IVF-partitioned ANN scan: k-means on the device + nprobe bucket search.

Port of `lattice_tpu/ops/ivf.py`. Past ~1M chunks a flat scan reads the
whole embedding matrix per query batch; IVF reads only the `nprobe`
buckets each query probes. Design, as in the JAX package:

- **k-means on the device**: spherical Lloyd iterations, each one
  blockwise assignment (an argmax over a [block, C] product) and an
  index-add of the rows into per-cluster sums. Plain torch: these are
  large matrix products that the JAX package left to XLA too.
- **padded bucket layout**: rows grouped by cluster into a dense
  [C, S, d] tensor with a parallel [C, S] id table (-1 = empty slot),
  every bucket capped at `max_load` x N/C rows (`_capped_layout`).
- **nprobe search**: query x centroids [B, C] -> the top-nprobe buckets
  -> scores of their rows -> top-k. One query reads nprobe·S·d rows'
  bytes instead of N·d.

On the card the bucket scan is the hand-written kernel `ivf_probe`
(`csrc/ivf_probe.cu`), which replaces `_probe_kernel` via
`ivf_search_fused` (ivf.py:759, :784); kernel B (`merge_candidates`)
merges its per-block lists. `ivf_search_batch` is its plain version: a
wrapper takes it only for tensors on the CPU, and for CUDA tensors
launches the kernel or raises.

Numbers that differ from the JAX package:
- bf16 products are taken with f32 outputs, as `preferred_element_type`
  gives: rows are widened to f32 one block at a time (exact for bf16) and
  multiplied with TF32 off (`full_f32`); no whole-matrix f32 copy is made.
- `index_add_` on CUDA adds in an order that changes from run to run, so
  the centroids of two builds on the card differ by ~1e-7 and a row at a
  near-tie between two centroids may land in either. The recall gate
  (`measure_recall`), not bit-equality, is the contract on the card.
- IVF recall depends on the corpus having cluster structure: a
  near-isotropic corpus measures low recall and the store's plan table
  refuses it.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.scan_topk import (MAX_K1, _check, _empty_lists,
                                             _on_cpu, _stream,
                                             merge_candidates)
from lattice_tpu_torch.ops.topk import NEG_INF, full_f32, stable_topk

IVF_PROBE = _build.Kernel("ivf_probe", "lattice_tpu_torch/csrc/ivf_probe.cu",
                          "lattice_tpu/ops/ivf.py:759")

# Rows per assignment block: bounds the [block, C] score slab and the f32
# copy of the block's rows (a full [N, C] slab at 1M x 1024 is 4 GB).
KMEANS_BLOCK = 65536
# must match csrc/ivf_probe.cu
PROBE_ROWS_ALIGN = 16


def _torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def _blocks(n: int):
    for lo in range(0, n, KMEANS_BLOCK):
        yield lo, min(lo + KMEANS_BLOCK, n)


def _block_scores(block: torch.Tensor, centroids: torch.Tensor
                  ) -> torch.Tensor:
    """[rows, C] f32 products of a row block with centroids already cast
    to the rows' dtype: both widened to f32, TF32 off."""
    with full_f32():
        return block.to(torch.float32) @ centroids.to(torch.float32).T


# ---- k-means ------------------------------------------------------------


def _row_sims(data: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """[N] f32 products of every row with one row of `data`."""
    v = point.to(torch.float32)
    out = torch.empty(data.shape[0], dtype=torch.float32, device=data.device)
    for lo, hi in _blocks(data.shape[0]):
        with full_f32():
            torch.mv(data[lo:hi].to(torch.float32), v, out=out[lo:hi])
    return out


def farthest_first_init(data: torch.Tensor, valid: torch.Tensor,
                        first_idx: int, n_clusters: int) -> torch.Tensor:
    """Greedy farthest-first centroid seeding, on the data's device.

    Returns [C, d] f32. Each step picks the live row least similar to
    every centroid so far (the first such row on ties, as `jnp.argmin`).
    The loop stays on the device: the chosen row is gathered with
    `index_select`, never read back to the host."""
    n, d = data.shape
    centroids = torch.zeros((n_clusters, d), dtype=torch.float32,
                            device=data.device)
    point = data[first_idx]
    centroids[0] = point.to(torch.float32)
    best_sim = _row_sims(data, point)
    keep = valid.to(torch.bool)
    inf = torch.tensor(float("inf"), device=data.device)
    for i in range(1, n_clusters):
        far = torch.argmin(torch.where(keep, best_sim, inf))
        point = torch.index_select(data, 0, far.view(1))[0]
        centroids[i] = point.to(torch.float32)
        torch.maximum(best_sim, _row_sims(data, point), out=best_sim)
    return centroids


def _assign_stats(data: torch.Tensor, valid: torch.Tensor,
                  centroids: torch.Tensor, n_clusters: int):
    """Blockwise assignment pass: per-row argmax and best similarity,
    and the per-cluster sums and counts of the live rows.

    Returns (assignments [N] i64, sums [C, d] f32, counts [C] f32,
    own_sim [N] f32)."""
    n, d = data.shape
    dev = data.device
    cent = centroids.to(data.dtype)
    sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
    assigns = torch.empty((n,), dtype=torch.int64, device=dev)
    sims = torch.empty((n,), dtype=torch.float32, device=dev)
    w_all = valid.to(torch.float32)
    for lo, hi in _blocks(n):
        block = data[lo:hi].to(torch.float32)
        scores = _block_scores(block, cent)
        assign = torch.argmax(scores, dim=-1)
        assigns[lo:hi] = assign
        sims[lo:hi] = torch.amax(scores, dim=-1)
        w = w_all[lo:hi]
        sums.index_add_(0, assign, block * w[:, None])
        counts.index_add_(0, assign, w)
    return assigns, sums, counts, sims


def kmeans_fit(data: torch.Tensor, valid: torch.Tensor,
               init_idx: Sequence[int], n_clusters: int, iters: int = 10
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means with empty-cluster reseeding, on the data's
    device, `KMEANS_BLOCK` rows at a time. `data` is [N, d] f32 or bf16,
    L2-normalized. Returns (centroids [C, d] f32, assignments [N] i32).

    Balancing happens downstream in the bucket layout (`_capped_layout`),
    as in the JAX package."""
    keep = valid.to(torch.bool)
    centroids = farthest_first_init(data, keep, int(init_idx[0]), n_clusters)
    inf = torch.tensor(float("inf"), device=data.device)
    arange = torch.arange(n_clusters, device=data.device)
    for _ in range(iters):
        _, sums, counts, sims = _assign_stats(data, keep, centroids,
                                              n_clusters)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        # empty clusters: the first one reseeds to the worst-served live
        # row (farthest from its centroid), the others keep their centroid
        worst = torch.argmin(torch.where(keep, sims, inf))
        empty = counts <= 0
        first_empty = torch.argmax(empty.to(torch.int32))
        row = torch.index_select(data, 0, worst.view(1)).to(torch.float32)
        reseeded = torch.where(((arange == first_empty) & empty)[:, None],
                               row, centroids)
        new = torch.where(empty[:, None], reseeded, new)
        norms = torch.linalg.vector_norm(new, dim=-1, keepdim=True)
        centroids = new / torch.clamp(norms, min=1e-12)
    assigns, _, _, _ = _assign_stats(data, keep, centroids, n_clusters)
    return centroids, assigns.to(torch.int32)


def assign_topc(data: torch.Tensor, centroids: torch.Tensor,
                n_clusters: int, c_top: int = 4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise top-c_top centroid (sims, ids) per row, ties to the lower
    centroid id: the capped layout's spill candidates. Returns
    ([N, c_top] f32, [N, c_top] i32)."""
    n = data.shape[0]
    c_top = min(c_top, n_clusters)
    cent = centroids.to(data.dtype)
    sims = torch.empty((n, c_top), dtype=torch.float32, device=data.device)
    ids = torch.empty((n, c_top), dtype=torch.int32, device=data.device)
    for lo, hi in _blocks(n):
        sims[lo:hi], ids[lo:hi] = stable_topk(_block_scores(data[lo:hi], cent),
                                              c_top)
    return sims, ids


def _capped_layout(top_sims: np.ndarray, top_ids: np.ndarray,
                   valid: np.ndarray, n_clusters: int,
                   max_load: float | None) -> np.ndarray:
    """Bucket-id layout with a per-bucket load cap (balanced IVF).

    A copy of the JAX package's numpy function: identical inputs give
    identical `bucket_ids`. Every bucket holds at most cap =
    ceil(max_load * N_live / C) rows (rounded up to a multiple of 8), so
    the padded bucket size S, which every probe pays for, is bounded by
    max_load instead of the largest natural cluster. Overfull clusters
    keep their LARGEST-MARGIN rows (sim(best) - sim(second)) and spill the
    rest to the row's next-best centroid with room; a spilled row is still
    found whenever its 2nd/3rd choice is probed. max_load=None reproduces
    the uncapped layout.
    """
    live = np.flatnonzero(valid)
    n_live = len(live)
    first = top_ids[live, 0]
    natural = int(np.bincount(first, minlength=n_clusters).max()) if n_live \
        else 1
    if max_load is None:
        cap = natural
    else:
        # the cap bounds skew; it must never WIDEN buckets past their
        # natural max (near-uniform corpora would otherwise pay for
        # padded slack that nothing fills)
        cap = min(int(np.ceil(max_load * max(n_live, 1) / n_clusters)),
                  natural)
    cap = max(int(np.ceil(max(cap, 1) / 8) * 8), 8)
    bucket_ids = np.full((n_clusters, cap), -1, dtype=np.int32)
    fill = np.zeros(n_clusters, dtype=np.int64)
    margin = top_sims[live, 0] - top_sims[live, 1] \
        if top_sims.shape[1] > 1 else np.zeros(n_live)
    order = np.argsort(first, kind="stable")
    sorted_first = first[order]
    starts = np.searchsorted(sorted_first, np.arange(n_clusters + 1))
    spilled: list[int] = []           # indices into `live`
    for c in range(n_clusters):
        seg = order[starts[c]:starts[c + 1]]
        if len(seg) <= cap:
            bucket_ids[c, :len(seg)] = live[seg]
            fill[c] = len(seg)
        else:
            keep = seg[np.argsort(-margin[seg], kind="stable")[:cap]]
            bucket_ids[c, :cap] = live[keep]
            fill[c] = cap
            spilled.extend(seg[np.argsort(-margin[seg],
                                          kind="stable")[cap:]].tolist())
    c_top = top_ids.shape[1]
    room = np.flatnonzero(fill < cap)
    ri = 0
    for li in spilled:
        row = live[li]
        placed = False
        for j in range(1, c_top):
            c2 = int(top_ids[row, j])
            if fill[c2] < cap:
                bucket_ids[c2, fill[c2]] = row
                fill[c2] += 1
                placed = True
                break
        if not placed:
            # guaranteed space: C*cap >= max_load * n_live > n_live
            while ri < len(room) and fill[room[ri]] >= cap:
                ri += 1
            c2 = int(room[ri])
            bucket_ids[c2, fill[c2]] = row
            fill[c2] += 1
    return bucket_ids


# ---- search: the plain version ---------------------------------------------


def probe_table(queries: torch.Tensor, centroids: torch.Tensor,
                nprobe: int) -> torch.Tensor:
    """[B, nprobe] i32: each query's top-nprobe buckets by f32 centroid
    score, ties to the lower bucket id (as `lax.top_k`)."""
    with full_f32():
        c_scores = queries.to(torch.float32) @ centroids.T
    return stable_topk(c_scores, min(nprobe, centroids.shape[0]))[1]


def probe_topk_plain(queries: torch.Tensor, probe: torch.Tensor,
                     bucket_data: torch.Tensor, bucket_ids: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `probe_topk`: the probed buckets gathered by
    index, one probe rank at a time (a [B, S, d] f32 slab each), queries
    cast to the bucket dtype, products in f32, slots with id < 0 scored
    NEG_INF, then a stable top-k over the flattened [P·S] slab, so equal
    scores rank by position (probe rank, then slot)."""
    b, p = probe.shape
    s = bucket_data.shape[1]
    q = queries.to(bucket_data.dtype).to(torch.float32)
    probe_l = probe.to(torch.int64)
    scores = torch.empty((b, p, s), dtype=torch.float32,
                         device=bucket_data.device)
    for j in range(p):
        rows = bucket_data[probe_l[:, j]].to(torch.float32)     # [B, S, d]
        with full_f32():
            scores[:, j] = torch.einsum("bd,bsd->bs", q, rows)
    ids = bucket_ids[probe_l].reshape(b, p * s)
    scores = scores.reshape(b, p * s)
    scores = torch.where(ids >= 0, scores, torch.full_like(scores, NEG_INF))
    top, pos = stable_topk(scores, min(k, p * s))
    return top, torch.gather(ids, -1, pos.to(torch.int64))


def ivf_search_batch(queries: torch.Tensor, centroids: torch.Tensor,
                     bucket_data: torch.Tensor, bucket_ids: torch.Tensor,
                     k: int, nprobe: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain nprobe search: (scores [B, k_eff] f32, row ids [B, k_eff]
    i32), k_eff = min(k, nprobe·S). Fewer live rows than k pad with
    (NEG_INF, -1). The JAX version gathered the buckets with a one-hot
    product (an MXU workaround); here they are gathered by index."""
    return probe_topk_plain(queries, probe_table(queries, centroids, nprobe),
                            bucket_data, bucket_ids, k)


def _mask_bucket_ids(bucket_ids: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Fold a [N] row mask into the [C, S] id table: filtered rows -> -1.

    Payload filters ride the `id >= 0` check of both search paths, so
    filtering costs one gather and no kernel change."""
    safe = torch.clamp(bucket_ids, min=0).to(torch.int64)
    alive = mask.to(torch.bool)[safe] & (bucket_ids >= 0)
    return torch.where(alive, bucket_ids, torch.full_like(bucket_ids, -1))


# ---- search: the kernel -------------------------------------------------


def _probe_splits(b: int, p: int, s: int, device: torch.device
                  ) -> tuple[int, int]:
    """(rows per block, blocks per probed bucket): each probed bucket's S
    rows split over enough blocks that the grid covers about two blocks
    per SM even at B=1, each block a multiple of 16 rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-2 * sms // (b * p)))
    rows = -(-s // want)
    rows = -(-rows // PROBE_ROWS_ALIGN) * PROBE_ROWS_ALIGN
    return rows, -(-s // rows)


def probe_blocks(queries: torch.Tensor, probe: torch.Tensor,
                 bucket_data: torch.Tensor, bucket_ids: torch.Tensor,
                 k1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The `ivf_probe` kernel alone on CUDA tensors: for each (query,
    probed bucket, run of rows) the sorted top-k1 (score, position =
    p·S + s), as [B, P·splits·k1] f32 and i32 for kernel B to merge."""
    _check(queries, "queries", torch.float32, 2)
    _check(probe, "probe", torch.int32, 2)
    _check(bucket_ids, "bucket_ids", torch.int32, 2)
    entry = {torch.bfloat16: "lt_ivf_probe_bf16",
             torch.float32: "lt_ivf_probe_f32"}.get(bucket_data.dtype)
    if entry is None:
        raise KernelError(f"ivf_probe: no kernel for buckets of "
                          f"{bucket_data.dtype}")
    _check(bucket_data, "bucket_data", bucket_data.dtype, 3)
    b, d = queries.shape
    c, s, d2 = bucket_data.shape
    p = probe.shape[1]
    if (d2 != d or probe.shape[0] != b or tuple(bucket_ids.shape) != (c, s)
            or not 1 <= p <= c or s < 1):
        raise KernelError(f"ivf_probe: queries {tuple(queries.shape)}, probe "
                          f"{tuple(probe.shape)}, buckets "
                          f"{tuple(bucket_data.shape)}, ids "
                          f"{tuple(bucket_ids.shape)}")
    if not 1 <= k1 <= min(p * s, MAX_K1):
        raise KernelError(f"ivf_probe: k1={k1} outside [1, min(P*S={p * s}, "
                          f"{MAX_K1})]")
    if p * s >= 2 ** 31 - 1:
        raise KernelError(f"ivf_probe: P*S={p * s} positions overflow i32")
    device = queries.device
    rows, splits = _probe_splits(b, p, s, device)
    cand_s = torch.empty((b, p * splits * k1), dtype=torch.float32,
                         device=device)
    cand_i = torch.empty((b, p * splits * k1), dtype=torch.int32,
                         device=device)
    elems = 16 // bucket_data.element_size()
    vec = int(d % elems == 0 and bucket_data.data_ptr() % 16 == 0)
    with torch.cuda.device(device):
        IVF_PROBE.launch(
            entry, queries.data_ptr(), probe.data_ptr(),
            bucket_data.data_ptr(), bucket_ids.data_ptr(), b, p, c, s, d, k1,
            rows, splits, vec, cand_s.data_ptr(), cand_i.data_ptr(),
            _stream(device))
    return cand_s, cand_i


def probe_topk(queries: torch.Tensor, probe: torch.Tensor,
               bucket_data: torch.Tensor, bucket_ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k_eff (scores [B, k_eff] f32, row ids [B, k_eff] i32) over the
    probed buckets, k_eff = min(k, P·S). CPU tensors take the plain
    version. On CUDA: `ivf_probe`, kernel B over its lists (its lower-id
    rule on positions is `lax.top_k`'s order), then positions -> row ids
    from the (masked) id table. k_eff past `MAX_K1` raises KernelError."""
    if _on_cpu(queries, probe, bucket_data, bucket_ids):
        return probe_topk_plain(queries, probe, bucket_data, bucket_ids, k)
    b, p = probe.shape
    s = bucket_data.shape[1]
    k_eff = min(k, p * s)
    if b == 0:
        return _empty_lists(0, k_eff, queries.device)
    probe = probe.to(torch.int32).contiguous()
    cand_s, cand_i = probe_blocks(queries.contiguous(), probe,
                                  bucket_data, bucket_ids, k_eff)
    top, pos = merge_candidates(cand_s, cand_i, k_eff)
    pos = pos.to(torch.int64)
    bucket = torch.gather(probe.to(torch.int64), 1, pos // s)
    return top, bucket_ids[bucket, pos % s]


def ivf_search_fused(queries: torch.Tensor, centroids: torch.Tensor,
                     bucket_data: torch.Tensor, bucket_ids: torch.Tensor,
                     nprobe: int, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused nprobe scan: centroid scores and the probe table in plain
    torch (the JAX package computed them outside the Pallas body too),
    then `probe_topk`. Returns (scores [B, k_eff], row ids [B, k_eff])."""
    return probe_topk(queries, probe_table(queries, centroids, nprobe),
                      bucket_data, bucket_ids, k)


# ---- index ------------------------------------------------------------------


class IVFIndex:
    """A built IVF partition: centroids [C, d] f32, buckets [C, S, d] and
    their id table [C, S] i32 on one device, plus a host locator.

    The JAX package's separate `bucket_valid` table is not kept: a slot is
    live exactly when its id is >= 0. Where JAX rebuilt arrays with
    `.at[].set`, `insert` and `remove` write the touched slots in place
    with index assignment."""

    def __init__(self, centroids: torch.Tensor, bucket_data: torch.Tensor,
                 bucket_ids: torch.Tensor, n_rows: int,
                 dtype: str | torch.dtype):
        self.centroids = centroids
        self.bucket_data = bucket_data
        self.bucket_ids = bucket_ids
        self.n_rows = n_rows
        self.dtype = _torch_dtype(dtype)
        # recall@10 against the exact scan on a self-sample at build time
        # (None until measure_recall runs); the store's plan table serves
        # IVF only when it clears its bar
        self.measured_recall: float | None = None
        self.measured_nprobe: int | None = None
        self.hollow = False   # buckets released, verdict kept
        # host bookkeeping for O(delta) upserts: row -> (bucket, slot) and
        # per-bucket occupancy
        self._init_locator()

    def _init_locator(self) -> None:
        ids_np = self.bucket_ids.cpu().numpy()
        max_row = max(int(ids_np.max()), self.n_rows - 1, 0)
        self._row_bucket = np.full(max_row + 1, -1, dtype=np.int32)
        self._row_pos = np.full(max_row + 1, -1, dtype=np.int32)
        occ = ids_np >= 0
        cs, ps = np.nonzero(occ)
        rows = ids_np[cs, ps]
        self._row_bucket[rows] = cs
        self._row_pos[rows] = ps
        self._fill = occ.sum(axis=1).astype(np.int64)
        self._holes: dict[int, list[int]] = {}

    def _grow_locator(self, max_row: int) -> None:
        cur = len(self._row_bucket)
        if max_row < cur:
            return
        pad = max_row + 1 - cur
        self._row_bucket = np.concatenate(
            [self._row_bucket, np.full(pad, -1, np.int32)])
        self._row_pos = np.concatenate(
            [self._row_pos, np.full(pad, -1, np.int32)])

    def _require_buckets(self) -> None:
        if self.hollow:
            raise RuntimeError(
                "hollow IVF (buckets released after a recall refusal) "
                "cannot take incremental updates; rebuild first")

    def insert(self, emb_rows: torch.Tensor, row_ids: Sequence[int]) -> None:
        """O(delta) upsert: each new row goes to its nearest centroid's
        bucket, into the first hole or the tail; if that bucket is full,
        to any bucket with room; if every bucket is full, all buckets
        widen by 8 slots once. Centroids do not move, so recall drifts
        with heavy churn and the store rebuilds past 20% churn."""
        m = int(emb_rows.shape[0])
        if m == 0:
            return
        self._require_buckets()
        data_f32 = emb_rows.to(device=self.centroids.device,
                               dtype=torch.float32)
        with full_f32():
            sims = data_f32 @ self.centroids.T
        assign = torch.argmax(sims, dim=-1).cpu().numpy()
        self._grow_locator(max(row_ids))
        cs: list[int] = []
        ps: list[int] = []
        for j, row in enumerate(row_ids):
            c, pos = self._take_slot(int(assign[j]))
            cs.append(c)
            ps.append(pos)
            self._row_bucket[row] = c
            self._row_pos[row] = pos
        dev = self.bucket_ids.device
        cs_t = torch.as_tensor(cs, dtype=torch.int64, device=dev)
        ps_t = torch.as_tensor(ps, dtype=torch.int64, device=dev)
        self.bucket_ids[cs_t, ps_t] = torch.as_tensor(
            list(row_ids), dtype=torch.int32, device=dev)
        self.bucket_data[cs_t, ps_t] = data_f32.to(self.bucket_data.dtype)

    def _take_slot(self, c: int) -> tuple[int, int]:
        holes = self._holes.get(c)
        if holes:
            return c, holes.pop()
        if self._fill[c] < self.bucket_size:
            pos = int(self._fill[c])
            self._fill[c] += 1
            return c, pos
        # home bucket full: spill to any bucket with room
        for other in np.argsort(self._fill):
            other = int(other)
            if self._holes.get(other):
                return other, self._holes[other].pop()
            if self._fill[other] < self.bucket_size:
                pos = int(self._fill[other])
                self._fill[other] += 1
                return other, pos
        # everything full: widen every bucket by 8 slots
        c_n, _, d = self.bucket_data.shape
        dev = self.bucket_data.device
        self.bucket_data = torch.cat(
            [self.bucket_data,
             torch.zeros((c_n, 8, d), dtype=self.bucket_data.dtype,
                         device=dev)], dim=1)
        self.bucket_ids = torch.cat(
            [self.bucket_ids,
             torch.full((c_n, 8), -1, dtype=torch.int32, device=dev)], dim=1)
        pos = int(self._fill[c])
        self._fill[c] += 1
        return c, pos

    def remove(self, row_ids: Sequence[int]) -> None:
        """Mark the rows' slots dead (id -1 scores NEG_INF)."""
        self._require_buckets()
        cs, ps = [], []
        for row in row_ids:
            if row >= len(self._row_bucket):
                continue
            c, p = int(self._row_bucket[row]), int(self._row_pos[row])
            if c < 0:
                continue
            cs.append(c)
            ps.append(p)
            self._holes.setdefault(c, []).append(p)
            self._row_bucket[row] = -1
            self._row_pos[row] = -1
        if not cs:
            return
        dev = self.bucket_ids.device
        cs_t = torch.as_tensor(cs, dtype=torch.int64, device=dev)
        ps_t = torch.as_tensor(ps, dtype=torch.int64, device=dev)
        self.bucket_ids[cs_t, ps_t] = -1

    @staticmethod
    def _gather_buckets(emb_dev: torch.Tensor, bucket_ids: np.ndarray,
                        dtype: torch.dtype) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
        """([C, S, d] rows of `emb_dev` in bucket order, zero where the id
        is -1; [C, S] i32 ids), both on the rows' device."""
        c, cap = bucket_ids.shape
        dev = emb_dev.device
        ids = torch.from_numpy(np.array(bucket_ids, dtype=np.int32)).to(dev)
        flat = torch.clamp(ids, min=0).reshape(-1).to(torch.int64)
        data = emb_dev[flat].reshape(c, cap, emb_dev.shape[1]).to(dtype)
        data.mul_((ids >= 0)[..., None].to(dtype))
        return data, ids

    @classmethod
    def build_from_device(cls, emb_dev: torch.Tensor, valid: np.ndarray,
                          n_clusters: int | None = None, iters: int = 10,
                          dtype: str | torch.dtype = "bfloat16",
                          seed: int = 0, max_load: float | None = 2.0
                          ) -> "IVFIndex":
        """Build from a normalized matrix on its own device.

        Only the [N, 4] spill-candidate table goes to the host (for
        `_capped_layout`); k-means runs on the stored rows' dtype, and the
        buckets are one gather of the rows on the device. `build_seconds`
        is the wall time up to a synchronized end."""
        t0 = time.perf_counter()
        valid = np.asarray(valid, dtype=bool)
        n = emb_dev.shape[0]
        if n_clusters is None:
            n_clusters = max(int(np.sqrt(max(n, 1))), 1)
        n_clusters = min(n_clusters, max(int(valid.sum()), 1))
        rng = np.random.default_rng(seed)
        live_rows = np.flatnonzero(valid)
        init = rng.choice(live_rows, size=n_clusters, replace=False) \
            if len(live_rows) >= n_clusters else \
            rng.integers(0, n, size=n_clusters)
        valid_t = torch.from_numpy(valid.copy()).to(emb_dev.device)
        centroids, _ = kmeans_fit(emb_dev, valid_t, init, n_clusters, iters)
        sims, ids = assign_topc(emb_dev, centroids, n_clusters)
        bucket_ids = _capped_layout(sims.cpu().numpy(), ids.cpu().numpy(),
                                    valid, n_clusters, max_load)
        data, ids_t = cls._gather_buckets(emb_dev, bucket_ids,
                                          _torch_dtype(dtype))
        out = cls(centroids=centroids, bucket_data=data, bucket_ids=ids_t,
                  n_rows=n, dtype=dtype)
        if emb_dev.is_cuda:
            torch.cuda.synchronize(emb_dev.device)
        out.build_seconds = time.perf_counter() - t0
        return out

    @classmethod
    def build(cls, embeddings: np.ndarray, valid: np.ndarray,
              n_clusters: int | None = None, iters: int = 10,
              dtype: str | torch.dtype = "bfloat16", seed: int = 0,
              max_load: float | None = 2.0) -> "IVFIndex":
        """Host-array entry: the rows normalized in f32 on the host, then
        `build_from_device` on the CPU. n_clusters defaults to ~sqrt(N);
        max_load 2.0 bounds bucket padding at ~2x."""
        emb = torch.from_numpy(topk_ops.l2_normalize(embeddings))
        return cls.build_from_device(emb, valid, n_clusters=n_clusters,
                                     iters=iters, dtype=dtype, seed=seed,
                                     max_load=max_load)

    @classmethod
    def restore(cls, centroids: np.ndarray, bucket_ids: np.ndarray,
                emb_dev: torch.Tensor, measured_recall: float | None,
                measured_nprobe: int | None,
                dtype: str | torch.dtype = "bfloat16",
                hollow: bool = False) -> "IVFIndex":
        """A partition from its centroids and id table (numpy, as the JAX
        package persists them) over the store's rows `emb_dev`, without
        re-running k-means: the buckets are a gather of those rows. A
        hollow restore keeps only the centroids and the verdict."""
        dev = emb_dev.device
        cent = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
        n = int(emb_dev.shape[0])
        if hollow or bucket_ids.size == 0:
            # construct with a minimal table (the locator needs one), then
            # drop it exactly as release_buckets does
            out = cls(centroids=cent,
                      bucket_data=torch.zeros((1, 1, cent.shape[1]),
                                              dtype=_torch_dtype(dtype),
                                              device=dev),
                      bucket_ids=torch.full((1, 1), -1, dtype=torch.int32,
                                            device=dev),
                      n_rows=n, dtype=dtype)
            out.release_buckets()
        else:
            data, ids = cls._gather_buckets(emb_dev, bucket_ids,
                                            _torch_dtype(dtype))
            out = cls(centroids=cent, bucket_data=data, bucket_ids=ids,
                      n_rows=n, dtype=dtype)
        out.measured_recall = (None if measured_recall is None
                               else float(measured_recall))
        out.measured_nprobe = (None if measured_nprobe is None
                               else int(measured_nprobe))
        return out

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def bucket_size(self) -> int:
        return int(self.bucket_data.shape[1])

    def search(self, queries: np.ndarray, k: int, nprobe: int = 8,
               max_batch: int | None = None,
               mask: np.ndarray | torch.Tensor | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Host entry: normalized queries in chunks of `max_batch`.
        Returns numpy (scores [B, k_eff], row ids [B, k_eff]).

        `max_batch` bounds the plain version's [B, S, d] gathers (32 by
        default, as the JAX package chunked); the kernel needs no
        chunking, so on CUDA the default is one chunk. `mask`: optional
        [N] bool row filter folded into the id table. Probe selection is
        not filter-aware; the store's plan table sends very selective
        filters to a flat plan."""
        q = topk_ops.l2_normalize(np.atleast_2d(queries))
        nprobe = min(nprobe, self.n_clusters)
        dev = self.centroids.device
        bucket_ids = self.bucket_ids
        if mask is not None:
            bucket_ids = _mask_bucket_ids(bucket_ids,
                                          torch.as_tensor(mask, device=dev))
        if max_batch is None:
            max_batch = max(len(q), 1) if dev.type == "cuda" else 32
        out_s, out_i = [], []
        for start in range(0, len(q), max_batch):
            chunk = torch.from_numpy(np.ascontiguousarray(
                q[start:start + max_batch])).to(dev)
            s, i = self._search_chunk(chunk, bucket_ids, k, nprobe)
            out_s.append(s.cpu().numpy())
            out_i.append(i.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def _search_chunk(self, chunk: torch.Tensor, bucket_ids: torch.Tensor,
                      k: int, nprobe: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        return ivf_search_fused(chunk, self.centroids, self.bucket_data,
                                bucket_ids, nprobe, k)

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int = 8,
                      mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One-chunk search that stays on the device: normalized queries
        in, (scores, row ids) tensors out. The caller bounds the batch."""
        nprobe = min(nprobe, self.n_clusters)
        bucket_ids = self.bucket_ids
        if mask is not None:
            bucket_ids = _mask_bucket_ids(bucket_ids, mask)
        return self._search_chunk(queries.to(torch.float32), bucket_ids, k,
                                  nprobe)

    def measure_recall(self, emb_dev: torch.Tensor, valid: torch.Tensor,
                       nprobe: int = 8, n_sample: int = 128, k: int = 10,
                       seed: int = 0) -> float:
        """Self-sample recall@k against the exact scan; stored on the index.

        The sampled queries are live rows themselves (where encoded search
        queries land), searched through `self.search`; the exact side is
        the blocked flat scan over the stored rows."""
        live = np.flatnonzero(valid.cpu().numpy())
        if len(live) == 0:
            self.measured_recall = 0.0
            self.measured_nprobe = nprobe
            return 0.0
        rng = np.random.default_rng(seed)
        rows = rng.choice(live, size=min(n_sample, len(live)), replace=False)
        q = emb_dev[torch.from_numpy(rows.astype(np.int64)).to(
            emb_dev.device)].to(torch.float32)
        k_eff = min(k, len(live))
        _, exact_i = topk_ops.flat_topk_blocked(q, emb_dev, valid, k_eff)
        exact_np = exact_i.cpu().numpy()
        _, got_i = self.search(q.cpu().numpy(), k_eff, nprobe=nprobe)
        hits = sum(
            len(set(got_i[i].tolist()) & set(exact_np[i].tolist()))
            for i in range(len(rows)))
        self.measured_recall = hits / (len(rows) * k_eff)
        self.measured_nprobe = nprobe
        return self.measured_recall

    def memory_bytes(self) -> int:
        cent = self.centroids.numel() * 4
        if self.hollow:
            return cent
        return (self.bucket_data.numel() * self.bucket_data.element_size()
                + self.bucket_ids.numel() * 4 + cent)

    def release_buckets(self) -> None:
        """Free the buckets but KEEP the measured-recall verdict, so a store
        remembers a refusal (a near-isotropic corpus) without holding a
        corpus-sized partition that will never serve."""
        self.bucket_data = None
        self.bucket_ids = None
        self.hollow = True
