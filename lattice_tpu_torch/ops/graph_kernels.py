"""Frontier-expansion kernels over COO/CSR relationship graphs (torch port).

Port of `lattice_tpu/ops/graph_kernels.py`. The JAX file is XLA code with
no Pallas kernel, so these are torch ops that run on the device of their
inputs. They replace the reference's variable-length Cypher traversals:
- `FIND_TRANSITIVE_CALLERS/CALLEES` `[:CALLS*1..k]` (`queries.py:2-50`)
- `FIND_CALL_CHAIN` shortestPath (`queries.py:52-67`)
- `FIND_FULL_HIERARCHY` EXTENDS*1..5 both directions (`queries.py:88-128`)
- `GET_ENTITY_CENTRALITY` in/out degree (`queries.py:314-329`)

The graph is an edge list `(src[E], dst[E])` per relationship type,
padded with (0, 0) self-loops (idempotent under reachability, so safe
padding). One BFS step gathers the reached flag of every edge's source
and scatters it to its destination. torch has no boolean scatter-or, and
an `index_put_` of booleans without accumulation keeps an arbitrary one of
the duplicates, so the step counts hits instead: an int32 `index_add_`
(integer atomics on the card, deterministic), then `> 0`. Distances live
in an `[N]` int32 tensor with the `UNREACHED` sentinel.

`khop_select` is exact: the shallowest `limit` reached nodes, ties to the
lower id, through kernel B on the negated distances on the card
(`ops/scan_topk.topk_rows`). The reference's `approx_min_k` was a TPU
workaround; on the CPU it is exact too but orders equal depths its own
way, so it matches the port as a set per depth.

`csr_expand` (host NumPy) serves the host BFS walk and the node -> row
join of `ChunkStore.RankColumns`.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.ops.scan_topk import topk_rows

UNREACHED = np.int32(2**30)

# an [E, Q] frontier step takes this many (edge, query) pairs at a time
BATCH_STEP_PAIRS = 1 << 26


def geometric_bucket(n: int, floor: int = 1024) -> int:
    """Next power-of-two capacity >= n (min `floor`). Padding to geometric
    buckets keeps the shapes of a growing graph (watch mode adds edges file
    by file) to a few sizes."""
    cap = floor
    while cap < n:
        cap *= 2
    return cap


def csr_expand(indptr: np.ndarray, indices: np.ndarray, ids: np.ndarray,
               *values: np.ndarray) -> tuple[np.ndarray, ...]:
    """Vectorized CSR adjacency expansion on the host.

    Gathers `indices[indptr[i]:indptr[i+1]]` for every i in `ids` with
    three NumPy primitives (repeat/arange/fancy-index) — no Python loop
    over rows. Aligned per-id `values` come back repeated per expanded
    entry."""
    ids = np.asarray(ids, dtype=np.int64)
    starts = indptr[ids]
    degs = (indptr[ids + 1] - starts).astype(np.int64)
    total = int(degs.sum())
    if total == 0:
        return (np.empty(0, indices.dtype),
                *(np.empty(0, v.dtype) for v in values))
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(degs) - degs, degs)
    out = indices[np.repeat(starts, degs) + offs]
    return (out, *(np.repeat(v, degs) for v in values))


def pad_edges(src: np.ndarray, dst: np.ndarray, bucket: int = 1024,
              geometric: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Pad the edge list with (0,0) self-loops to a bucket of `bucket`
    edges (or the next geometric bucket); self-loops are idempotent under
    reachability."""
    e = len(src)
    if geometric:
        padded = geometric_bucket(e, bucket)
    else:
        padded = max(bucket, ((e + bucket - 1) // bucket) * bucket)
    ps = np.zeros(padded, dtype=np.int32)
    pd = np.zeros(padded, dtype=np.int32)
    ps[:e] = src
    pd[:e] = dst
    return ps, pd


def _unreached(shape, device) -> torch.Tensor:
    return torch.full(shape, int(UNREACHED), dtype=torch.int32, device=device)


def _step(reached: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
          ) -> torch.Tensor:
    """The nodes with an edge from a reached node: [N] or [N, Q] bool."""
    hits = torch.zeros(reached.shape, dtype=torch.int32,
                       device=reached.device)
    per = max(1, BATCH_STEP_PAIRS // max(1, reached[0].numel()))
    for lo in range(0, src.shape[0], per):
        s, d = src[lo:lo + per].long(), dst[lo:lo + per].long()
        hits.index_add_(0, d, reached[s].to(torch.int32))
    return hits > 0


def _bfs(src: torch.Tensor, dst: torch.Tensor, reached: torch.Tensor,
         max_hops: int) -> torch.Tensor:
    dist = torch.where(reached, 0, _unreached(reached.shape, reached.device))
    for hop in range(max_hops):
        nxt = _step(reached, src, dst)
        dist = torch.where(nxt & ~reached, hop + 1, dist)
        reached = reached | nxt
    return dist


def bfs_distances(src: torch.Tensor, dst: torch.Tensor, seeds: torch.Tensor,
                  n_nodes: int, max_hops: int) -> torch.Tensor:
    """[n_nodes] int32 hop distance from the seed set ([N] bool) along
    src->dst edges ([E] int32); UNREACHED else. One step per hop."""
    return _bfs(src, dst, seeds.to(torch.bool), max_hops)


def degree_counts(indices: torch.Tensor, n_nodes: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """[n_nodes] int32 degree vector by a scatter-add (centrality,
    `queries.py:314-329`). Floating weights are summed in their type and
    each node's sum truncates to int32, as the reference's scatter of them
    into an int32 array does."""
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.int32,
                             device=indices.device)
    return torch.zeros(n_nodes, dtype=weights.dtype,
                       device=indices.device).index_add_(
        0, indices.long(), weights).to(torch.int32)


def nodes_on_paths(src: torch.Tensor, dst: torch.Tensor,
                   source_seeds: torch.Tensor, target_seeds: torch.Tensor,
                   n_nodes: int, max_hops: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist_from_source, dist_to_target, on_path mask): a node lies on
    some source->target path of length <= max_hops iff the two distances
    sum to at most max_hops (`FIND_ALL_PATHS`' corridor, `queries.py:69-86`;
    the paths themselves are enumerated on the host inside it)."""
    d_fwd = bfs_distances(src, dst, source_seeds, n_nodes, max_hops)
    d_bwd = bfs_distances(dst, src, target_seeds, n_nodes, max_hops)
    # clamp before adding: UNREACHED + UNREACHED overflows int32
    cap = 2**20
    total = torch.clamp(d_fwd, max=cap) + torch.clamp(d_bwd, max=cap)
    return d_fwd, d_bwd, total <= max_hops


def bidirectional_closure(src: torch.Tensor, dst: torch.Tensor,
                          seeds: torch.Tensor, n_nodes: int, max_hops: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ancestor_dist, descendant_dist) along one edge type
    (`FIND_FULL_HIERARCHY`'s EXTENDS*1..5 both ways, `queries.py:88-128`)."""
    up = bfs_distances(src, dst, seeds, n_nodes, max_hops)
    down = bfs_distances(dst, src, seeds, n_nodes, max_hops)
    return up, down


def _seed_rows(seed_ids: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[N, Q] bool with column q set at the seeds of row q of the [Q, S]
    `seed_ids` (-1 pads; other ids clip into range, as in the reference)."""
    q, s = seed_ids.shape
    dev = seed_ids.device
    flat = (seed_ids.clamp(0, n_nodes - 1).long() * q
            + torch.arange(q, device=dev)[:, None])
    hits = torch.zeros(n_nodes * q, dtype=torch.int32, device=dev)
    hits.index_add_(0, flat.reshape(-1),
                    (seed_ids >= 0).to(torch.int32).reshape(-1))
    return (hits > 0).view(n_nodes, q)


def bfs_distances_batch(src: torch.Tensor, dst: torch.Tensor,
                        seed_ids: torch.Tensor, n_nodes: int,
                        max_hops: int) -> torch.Tensor:
    """[Q, N] int32 hop distances for Q seed sets ([Q, S] int32, -1 pads)
    in one pass over the edges per hop: the frontier is [N, Q], so each
    edge moves a row of Q flags."""
    return _bfs(src, dst, _seed_rows(seed_ids, n_nodes),
                max_hops).T.contiguous()


def khop_select(dist: torch.Tensor, alive: torch.Tensor, limit: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The `limit` shallowest reached live nodes of a [N] or [Q, N]
    distance row (the Cypher `ORDER BY depth LIMIT n` tail): (depths,
    node ids), both int32, depth ascending, ties to the lower id, UNREACHED
    past the reached ones. Always exact (the reference's `exact=True`):
    kernel B on the negated distances up to 512, `stable_topk` past it
    (`topk_rows`)."""
    masked = torch.where(alive & (dist > 0), dist,
                         _unreached(dist.shape, dist.device))
    neg, idx = topk_rows(-masked.to(torch.float32), min(limit,
                                                        dist.shape[-1]))
    return (-neg).to(torch.int32), idx


def khop_batch_bounded(src: torch.Tensor, dst: torch.Tensor,
                       seed_ids: torch.Tensor, alive: torch.Tensor,
                       n_nodes: int, max_hops: int, limit: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched traversals and each query's depth selection: [Q, limit]."""
    dist = bfs_distances_batch(src, dst, seed_ids, n_nodes, max_hops)
    return khop_select(dist, alive, limit)


def khop_bounded(src: torch.Tensor, dst: torch.Tensor,
                 seed_ids: torch.Tensor, alive: torch.Tensor, n_nodes: int,
                 max_hops: int, limit: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seed scatter ([S] int32, -1 pads), BFS and depth selection of one
    traversal: [limit]."""
    seeds = _seed_rows(seed_ids[None, :], n_nodes)[:, 0]
    dist = bfs_distances(src, dst, seeds, n_nodes, max_hops)
    return khop_select(dist, alive, limit)


# ---- NumPy oracle ------------------------------------------------------


def bfs_oracle(src: np.ndarray, dst: np.ndarray, seeds: np.ndarray,
               n_nodes: int, max_hops: int) -> np.ndarray:
    """Reference BFS on the edge list (python loops, exact)."""
    adj: list[list[int]] = [[] for _ in range(n_nodes)]
    for s, d in zip(np.asarray(src), np.asarray(dst)):
        if s == 0 and d == 0:
            continue  # padding
        adj[int(s)].append(int(d))
    dist = np.full(n_nodes, UNREACHED, dtype=np.int64)
    frontier = [i for i, on in enumerate(np.asarray(seeds, dtype=bool)) if on]
    for i in frontier:
        dist[i] = 0
    for hop in range(max_hops):
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if dist[v] > hop + 1:
                    dist[v] = hop + 1
                    nxt.append(v)
        frontier = nxt
        if not frontier:
            break
    return dist
