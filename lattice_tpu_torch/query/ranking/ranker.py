"""Hybrid ranker: fuse graph + vector evidence.

Parity target: reference `src/lattice/query/ranking/ranker.py:18-226`:
score both sides into a keyed map, merge duplicates with mean x 1.1 boost +
field/signal union -> HYBRID source (`:171-202`), sort, dedupe with max 5
per file and 50 total (`:204-226`). Intent-dependent side weights come from
`RankingConfig.weights_for`.
"""

from __future__ import annotations

from lattice_tpu_torch.core.types import ResultSource
from lattice_tpu_torch.embeddings.indexer import VectorSearchResult
from lattice_tpu_torch.query.graph_reasoning.models import GraphContext
from lattice_tpu_torch.query.query_planner import QueryPlan
from lattice_tpu_torch.query.ranking.models import RankedResult, RankingConfig
from lattice_tpu_torch.query.ranking.scorer import ResultScorer


class HybridRanker:
    def __init__(self, config: RankingConfig | None = None):
        self.config = config or RankingConfig()
        self.scorer = ResultScorer(self.config)

    def rank_results(
        self,
        graph_context: GraphContext,
        vector_results: list[VectorSearchResult],
        plan: QueryPlan,
        limit: int | None = None,
    ) -> list[RankedResult]:
        """Reference: `ranker.py:18-226`."""
        cfg = self.config
        g_weight, v_weight = cfg.weights_for(plan.intent)
        keyed: dict[str, RankedResult] = {}

        for node in graph_context.all_nodes():
            scored = self.scorer.score_graph_node(node, plan, graph_context)
            scored.score *= g_weight
            self._merge(keyed, scored)

        for vres in vector_results:
            scored = self.scorer.score_vector_result(
                vres, plan, graph_context.centrality)
            scored.score *= v_weight
            self._merge(keyed, scored)

        ranked = sorted(keyed.values(), key=lambda r: -r.score)
        return self._dedupe(ranked, limit)

    def _merge(self, keyed: dict[str, RankedResult],
               incoming: RankedResult) -> None:
        """Duplicate merge: mean x hybrid_boost, field/signal union
        (`ranker.py:171-202`)."""
        key = incoming.get_key()
        existing = keyed.get(key)
        if existing is None:
            keyed[key] = incoming
            return
        merged_score = ((existing.score + incoming.score) / 2.0
                        * self.config.hybrid_boost)
        existing.score = merged_score
        existing.source = ResultSource.HYBRID
        existing.signals = existing.signals + incoming.signals
        if not existing.content and incoming.content:
            existing.content = incoming.content
        if not existing.relationship and incoming.relationship:
            existing.relationship = incoming.relationship
        existing.depth = min(existing.depth, incoming.depth)

    def _dedupe(self, ranked: list[RankedResult],
                limit: int | None) -> list[RankedResult]:
        """Max per-file and total caps (`ranker.py:204-226`)."""
        cfg = self.config
        cap = limit if limit is not None else cfg.max_total
        per_file: dict[str, int] = {}
        out: list[RankedResult] = []
        for result in ranked:
            n = per_file.get(result.file_path, 0)
            if n >= cfg.max_per_file:
                continue
            per_file[result.file_path] = n + 1
            out.append(result)
            if len(out) >= cap:
                break
        return out
