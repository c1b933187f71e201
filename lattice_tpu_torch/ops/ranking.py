"""The hybrid-ranking fuse over node- or row-aligned tensors (torch port).

Port of `lattice_tpu/ops/ranking.py:34-102, 345-376`: `FuseWeights`,
`_fuse_scores`, `_select_topk`, `fused_rank`, `pack_weights` and
`rank_oracle`. The JAX file is XLA code with no Pallas kernel, so these
are torch ops that run on the device of their inputs. The other entry
points of that file (`fused_rank_rows`, `hybrid_rank_device`,
`fused_rank_rows_sparse`, `pack_reach`, `hybrid_rank_device_packed{,
_batch}`), which the device deep path calls, are ROADMAP queue 1, item 5.

The same formulas as `ResultScorer` / `HybridRanker` evaluate for every
candidate at once:
  side_g = w_g·(decay^depth · relevance) + bonus·match + w_c·cent + w_x·rich
  side_v = w_v·sim + bonus·match + w_c·cent + w_x·quality
  fused  = both present ? (side_g + side_v)/2 · boost : side_g + side_v
with centrality = min(1, degree/cap) and the mean x 1.1 duplicate-merge
rule. Every operand is f32, as in the reference; `torch.pow` and XLA's
`power` may differ in the last place.

Selection is exact: the stable top-k of `ops/topk.py` (sorted, ties to
the lower row). The reference widened through `approx_max_k` on the TPU
and is exact on the CPU, where `approx_max_k` falls back to `top_k`; the
port keeps that exact function.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lattice_tpu_torch.ops.graph_kernels import UNREACHED
from lattice_tpu_torch.ops.topk import stable_topk

NEG_INF = -1e30


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
    """The elementwise fuse shared by every ranking entry point."""
    w_g, w_v, w_c, w_x, bonus, boost, decay, cap = weights.unbind()
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
    """Exact top-k over the [N] fused row: sorted, ties to the lower row,
    ids int32."""
    return stable_topk(fused, min(k, fused.shape[0]))


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
