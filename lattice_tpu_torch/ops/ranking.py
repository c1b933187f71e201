"""The hybrid-ranking fuse over node- or row-aligned tensors (torch port).

Port of `lattice_tpu/ops/ranking.py`: `FuseWeights`, `_fuse_scores`,
`_select_topk`, `fused_rank`, `fused_rank_rows`, `hybrid_rank_device`,
`fused_rank_rows_sparse`, `pack_reach` with its bit layout,
`hybrid_rank_device_packed{,_batch}`, `pack_weights` and `rank_oracle`.
The JAX file is XLA code with no Pallas kernel, so these are torch ops
that run on the device of their inputs.

The same formulas as `ResultScorer` / `HybridRanker` evaluate for every
candidate at once:
  side_g = w_g·(decay^depth · relevance) + bonus·match + w_c·cent + w_x·rich
  side_v = w_v·sim + bonus·match + w_c·cent + w_x·quality
  fused  = both present ? (side_g + side_v)/2 · boost : side_g + side_v
with centrality = min(1, degree/cap) and the mean x 1.1 duplicate-merge
rule. Every operand is f32, as in the reference; `torch.pow` and XLA's
`power` may differ in the last place.

The corpus-scale entry points score every row: the query in f32
(normalized, never rounded to the rows' dtype) against the rows widened
to f32, with TF32 off, as `lax.dot_general(f32, bf16,
preferred_element_type=f32)` computes it; rows are widened a block at a
time (`COSINE_BLOCK`), so a 1M x 768 bf16 store never needs a 3 GB f32
copy. The sparse reach and the entity matches scatter into [N] columns
(`scatter_reduce_` "amin" / "amax" with `include_self`, so the -1 pads,
clipped to a real row with UNREACHED or 0.0, change nothing), then the
fuse and the selection run on the same device. A batch of Q queries holds
one [Q, N] f32 slab: the cosines, fused in place a few queries at a time
(`FUSE_BLOCK`).

Selection is exact, sorted, ties to the lower row (`_select_topk`): kernel
B (`ops/scan_topk.topk_rows`, its positional entry) on the card for k up
to 512, `stable_topk` past it and on the CPU. The reference widened
through `approx_max_k` on the TPU; on the CPU that is exact too, but
orders exactly equal fused scores its own way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lattice_tpu_torch.ops.graph_kernels import UNREACHED
from lattice_tpu_torch.ops.scan_topk import topk_rows
from lattice_tpu_torch.ops.topk import full_f32

NEG_INF = -1e30

# rows widened to f32 at a time by the cosine (200 MB at d = 768)
COSINE_BLOCK = 1 << 16
# elements of the [Q, N] slab fused at a time
FUSE_BLOCK = 1 << 24


@dataclass(frozen=True)
class FuseWeights:
    graph_weight: float = 0.5
    vector_weight: float = 0.5
    centrality_weight: float = 0.2
    context_weight: float = 0.1
    entity_match_bonus: float = 0.3
    hybrid_boost: float = 1.1
    depth_decay: float = 0.8
    degree_cap: float = 50.0


def _fuse_scores(graph_depth: torch.Tensor, relevance: torch.Tensor,
                 vector_scores: torch.Tensor, entity_match: torch.Tensor,
                 degree: torch.Tensor, quality: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """The elementwise fuse shared by every ranking entry point; [8]
    weights, or [Q, 8] for [Q, N] columns (each query its own)."""
    w = weights.unbind(-1)
    if weights.dim() == 2:
        w = tuple(x[:, None] for x in w)
    w_g, w_v, w_c, w_x, bonus, boost, decay, cap = w
    in_graph = graph_depth < int(UNREACHED)
    has_vec = vector_scores > NEG_INF / 2
    depth_f = torch.where(in_graph, graph_depth,
                          torch.zeros_like(graph_depth)).to(torch.float32)
    base = torch.pow(decay, depth_f) * relevance
    cent = torch.clamp(degree.to(torch.float32) / cap, max=1.0)
    richness = (torch.where(in_graph, 0.5, 0.0)
                + torch.where(has_vec, 0.5, 0.0))
    zero = torch.zeros_like(relevance)

    side_g = torch.where(
        in_graph,
        w_g * base + bonus * entity_match + w_c * cent + w_x * richness,
        zero)
    side_v = torch.where(
        has_vec,
        w_v * torch.clamp(vector_scores, min=0.0) + bonus * entity_match
        + w_c * cent + w_x * quality,
        zero)
    both = in_graph & has_vec
    fused = torch.where(both, (side_g + side_v) * 0.5 * boost,
                        side_g + side_v)
    return torch.where(in_graph | has_vec, fused,
                       torch.full_like(fused, NEG_INF))


def _select_topk(fused: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over [N] or [Q, N] fused rows: sorted, ties to the lower
    row, ids int32; kernel B on the card up to k = 512 (`topk_rows`)."""
    return topk_rows(fused, k)


def fused_rank(
    graph_depth: torch.Tensor,     # [N] i32, UNREACHED where not in context
    relevance: torch.Tensor,       # [N] f32, relationship relevance (0 if none)
    vector_scores: torch.Tensor,   # [N] f32 cosine, NEG_INF where no hit
    entity_match: torch.Tensor,    # [N] f32 in [0, 1]
    degree: torch.Tensor,          # [N] i32 (in+out CALLS degree)
    quality: torch.Tensor,         # [N] f32 content-quality heuristic
    weights: torch.Tensor,         # [8] f32: packed FuseWeights
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (fused scores [k] f32, node ids [k] i32) over all N nodes,
    on the inputs' device."""
    fused = _fuse_scores(graph_depth, relevance, vector_scores, entity_match,
                         degree, quality, weights)
    return _select_topk(fused, k)


def fused_rank_rows(
    dist_nodes: torch.Tensor,      # [M] i32 BFS hop distances in NODE space
    degree_nodes: torch.Tensor,    # [M] i32 degree vector in NODE space
    row_node_ids: torch.Tensor,    # [N] i32 graph node id per row (-1 none)
    relevance: torch.Tensor,       # [M] f32 relationship relevance by node
    vector_scores: torch.Tensor,   # [N] f32 cosine per row, NEG_INF invalid
    entity_match: torch.Tensor,    # [N] f32
    quality: torch.Tensor,         # [N] f32
    weights: torch.Tensor,         # [8] f32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The graph side in node space (`bfs_distances`, `degree_counts`)
    joined to rows through the resident `row_node_ids` column, then fused
    and selected: (scores [k], rows [k])."""
    m = dist_nodes.shape[0]
    safe = row_node_ids.clamp(0, m - 1).long()
    has_node = (row_node_ids >= 0) & (row_node_ids < m)
    depth = torch.where(has_node, dist_nodes[safe],
                        int(UNREACHED)).to(torch.int32)
    degree = torch.where(has_node, degree_nodes[safe], 0).to(torch.int32)
    rel = torch.where(has_node, relevance[safe], 0.0)
    fused = _fuse_scores(depth, rel, vector_scores, entity_match, degree,
                         quality, weights)
    return _select_topk(fused, k)


def row_scores(queries: torch.Tensor, embeddings: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 cosines of the [Q, d] queries (any scale: normalized here,
    in f32) against every row, NEG_INF where a row is not valid. The rows
    are widened to f32 `COSINE_BLOCK` at a time; products and sums in f32
    with TF32 off."""
    q = queries.to(torch.float32)
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    n = embeddings.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32,
                      device=embeddings.device)
    with full_f32():
        for lo in range(0, n, COSINE_BLOCK):
            hi = min(lo + COSINE_BLOCK, n)
            out[:, lo:hi] = q @ embeddings[lo:hi].to(torch.float32).T
    return out.masked_fill_(~valid.to(torch.bool)[None, :], NEG_INF)


def hybrid_rank_device(
    query: torch.Tensor,           # [d] f32 (unnormalized ok)
    embeddings: torch.Tensor,      # [N, d] bf16/f32 corpus rows
    valid: torch.Tensor,           # [N] bool
    reach_rows: torch.Tensor,      # [R] i32 (-1 pad)
    reach_depths: torch.Tensor,    # [R] i32
    reach_rel: torch.Tensor,       # [R] f32
    row_degree: torch.Tensor,      # [N] i32
    entity_match: torch.Tensor,    # [N] f32
    quality: torch.Tensor,         # [N] f32
    weights: torch.Tensor,         # [8] f32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The hybrid query's device side: normalize, cosine of every row,
    the sparse reach scattered to rows, fuse, select."""
    vec = row_scores(query[None, :], embeddings, valid)[0]
    return fused_rank_rows_sparse(reach_rows, reach_depths, reach_rel,
                                  row_degree, vec, entity_match, quality,
                                  weights, k)


def fused_rank_rows_sparse(
    reach_rows: torch.Tensor,      # [R] i32 ROW ids the BFS reached (-1 pad)
    reach_depths: torch.Tensor,    # [R] i32 hop depths per row
    reach_rel: torch.Tensor,       # [R] f32 relationship relevance per row
    row_degree: torch.Tensor,      # [N] i32 resident degree column
    vector_scores: torch.Tensor,   # [N] f32
    entity_match: torch.Tensor,    # [N] f32
    quality: torch.Tensor,         # [N] f32
    weights: torch.Tensor,         # [8] f32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fuse fed by a sparse reach set in ROW space (the host CSR walk's
    reach, expanded node -> rows by `ChunkStore.RankColumns.rows_for_nodes`);
    a row reached twice keeps its least depth and its largest relevance."""
    n = vector_scores.shape[0]
    on = reach_rows >= 0
    safe = reach_rows.clamp(0, n - 1).long()
    depth = torch.full((n,), int(UNREACHED), dtype=torch.int32,
                       device=vector_scores.device).scatter_reduce_(
        0, safe, torch.where(on, reach_depths, int(UNREACHED)).to(
            torch.int32), "amin")
    rel = torch.zeros(n, dtype=torch.float32,
                      device=vector_scores.device).scatter_reduce_(
        0, safe, torch.where(on, reach_rel, 0.0).to(torch.float32), "amax")
    fused = _fuse_scores(depth, rel, vector_scores, entity_match,
                         row_degree, quality, weights)
    return _select_topk(fused, k)


# ---- packed sparse reach ---------------------------------------------------
# One int32 per reached row: row id (25 bits) | depth (4 bits) | rel class
# (2 bits); the sign bit marks padding. The relevance values ride in a [4]
# table per query, the entity matches as a list of rows.

REACH_ROW_BITS = 25
REACH_ROW_MASK = (1 << REACH_ROW_BITS) - 1
REACH_DEPTH_MAX = 15


def pack_reach(rows: np.ndarray, depths: np.ndarray, rel_cls: np.ndarray,
               r_cap: int) -> np.ndarray:
    """[r_cap] i32 packed reach; entries beyond len(rows) are -1 pads.
    Truncates to r_cap when the reach overflows it; a row id past 25 bits
    raises."""
    m = min(len(rows), r_cap)
    out = np.full(r_cap, -1, dtype=np.int32)
    if m:
        r = rows[:m].astype(np.int64)
        if r.max(initial=0) > REACH_ROW_MASK:
            raise ValueError("row id exceeds 25-bit packed capacity")
        d = np.minimum(depths[:m].astype(np.int64), REACH_DEPTH_MAX)
        c = rel_cls[:m].astype(np.int64) & 3
        out[:m] = (r | (d << REACH_ROW_BITS) | (c << 29)).astype(np.int32)
    return out


def _packed_columns(packed: torch.Tensor, rel_table: torch.Tensor,
                    match_rows: torch.Tensor, n: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[G, N] depth, relevance and entity-match columns of G queries'
    packed reach ([G, R]), relevance tables ([G, 4]) and match rows
    ([G, M]); each query scatters into its own row of the flat [G * N]."""
    g = packed.shape[0]
    dev = packed.device
    base = (torch.arange(g, device=dev, dtype=torch.int64) * n)[:, None]
    on = packed >= 0
    rows = packed & REACH_ROW_MASK
    depth_p = (packed >> REACH_ROW_BITS) & REACH_DEPTH_MAX
    rel_p = torch.gather(rel_table, 1, ((packed >> 29) & 3).long())
    safe = (rows.clamp(0, n - 1).long() + base).reshape(-1)
    depth = torch.full((g * n,), int(UNREACHED), dtype=torch.int32,
                       device=dev).scatter_reduce_(
        0, safe, torch.where(on, depth_p, int(UNREACHED)).to(
            torch.int32).reshape(-1), "amin")
    rel = torch.zeros(g * n, dtype=torch.float32, device=dev).scatter_reduce_(
        0, safe, torch.where(on, rel_p, 0.0).reshape(-1), "amax")
    m_safe = (match_rows.clamp(0, n - 1).long() + base).reshape(-1)
    match = torch.zeros(g * n, dtype=torch.float32,
                        device=dev).scatter_reduce_(
        0, m_safe, (match_rows >= 0).to(torch.float32).reshape(-1), "amax")
    return depth.view(g, n), rel.view(g, n), match.view(g, n)


def fuse_packed(vec: torch.Tensor, packed_reach: torch.Tensor,
                rel_table: torch.Tensor, match_rows: torch.Tensor,
                row_degree: torch.Tensor, quality: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Fuse the [Q, N] cosine slab in place with each query's packed
    evidence ([Q, R], [Q, 4], [Q, M], [Q, 8]), `FUSE_BLOCK` elements at a
    time; returns the slab."""
    q, n = vec.shape
    per = max(1, FUSE_BLOCK // max(n, 1))
    for lo in range(0, q, per):
        sl = slice(lo, lo + per)
        depth, rel, match = _packed_columns(packed_reach[sl],
                                            rel_table[sl], match_rows[sl], n)
        vec[sl] = _fuse_scores(depth, rel, vec[sl], match, row_degree,
                               quality, weights[sl])
    return vec


def hybrid_rank_device_packed(
    query: torch.Tensor,           # [d] f32 (unnormalized ok)
    embeddings: torch.Tensor,      # [N, d] bf16/f32 corpus rows
    valid: torch.Tensor,           # [N] bool
    packed_reach: torch.Tensor,    # [R] i32 (pack_reach format, -1 pad)
    rel_table: torch.Tensor,       # [4] f32 relevance per rel class
    match_rows: torch.Tensor,      # [M] i32 entity-match rows (-1 pad)
    row_degree: torch.Tensor,      # [N] i32
    quality: torch.Tensor,         # [N] f32
    weights: torch.Tensor,         # [8] f32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`hybrid_rank_device` with the reach packed (`pack_reach`) and the
    entity matches given as rows: (scores [k], rows [k])."""
    s, i = hybrid_rank_device_packed_batch(
        query[None, :], embeddings, valid, packed_reach[None, :], rel_table,
        match_rows[None, :], row_degree, quality, weights, k)
    return s[0], i[0]


def hybrid_rank_device_packed_batch(
    queries: torch.Tensor,         # [Q, d] f32 (unnormalized ok)
    embeddings: torch.Tensor,      # [N, d] bf16/f32 corpus rows
    valid: torch.Tensor,           # [N] bool
    packed_reach: torch.Tensor,    # [Q, R] i32 (pack_reach rows, -1 pad)
    rel_table: torch.Tensor,       # [4] f32, or [Q, 4] per intent
    match_rows: torch.Tensor,      # [Q, M] i32 (-1 pad)
    row_degree: torch.Tensor,      # [N] i32
    quality: torch.Tensor,         # [N] f32
    weights: torch.Tensor,         # [8] f32, or [Q, 8] per intent
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Q hybrid queries: one [Q, N] cosine slab, each query's scatter and
    fuse with its own weights and relevance table, one selection over the
    slab. Returns ([Q, k] scores, [Q, k] rows)."""
    nq = queries.shape[0]
    w_q = weights if weights.dim() == 2 else weights.expand(nq, -1)
    rel_q = rel_table if rel_table.dim() == 2 else rel_table.expand(nq, -1)
    vec = row_scores(queries, embeddings, valid)
    fused = fuse_packed(vec, packed_reach, rel_q, match_rows, row_degree,
                        quality, w_q)
    return _select_topk(fused, k)


def pack_weights(w: FuseWeights) -> np.ndarray:
    return np.asarray([
        w.graph_weight, w.vector_weight, w.centrality_weight,
        w.context_weight, w.entity_match_bonus, w.hybrid_boost,
        w.depth_decay, w.degree_cap,
    ], dtype=np.float32)


def rank_oracle(graph_depth, relevance, vector_scores, entity_match, degree,
                quality, w: FuseWeights, k: int):
    """NumPy reference of the fuse for kernel tests."""
    n = len(graph_depth)
    fused = np.full(n, NEG_INF, dtype=np.float64)
    for i in range(n):
        in_graph = graph_depth[i] < UNREACHED
        has_vec = vector_scores[i] > NEG_INF / 2
        cent = min(1.0, degree[i] / w.degree_cap)
        richness = (0.5 if in_graph else 0.0) + (0.5 if has_vec else 0.0)
        side_g = (w.graph_weight * (w.depth_decay ** graph_depth[i])
                  * relevance[i] + w.entity_match_bonus * entity_match[i]
                  + w.centrality_weight * cent
                  + w.context_weight * richness) if in_graph else 0.0
        side_v = (w.vector_weight * max(vector_scores[i], 0.0)
                  + w.entity_match_bonus * entity_match[i]
                  + w.centrality_weight * cent
                  + w.context_weight * quality[i]) if has_vec else 0.0
        if in_graph and has_vec:
            fused[i] = (side_g + side_v) / 2.0 * w.hybrid_boost
        elif in_graph or has_vec:
            fused[i] = side_g + side_v
    order = np.argsort(-fused, kind="stable")[:k]
    return fused[order], order.astype(np.int32)
