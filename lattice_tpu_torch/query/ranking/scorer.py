"""Per-result signal scoring.

Parity target: reference `src/lattice/query/ranking/scorer.py:9-126`:
- graph signal = depth-decayed base + entity-match bonus + relationship
  relevance + centrality (min(1, degree/50)) + context richness (`:9-77`)
- vector signal = similarity + entity match + centrality + content-length
  quality heuristic (`:79-126`)
"""

from __future__ import annotations

from lattice_tpu_torch.core.types import ResultSource
from lattice_tpu_torch.embeddings.indexer import VectorSearchResult
from lattice_tpu_torch.query.graph_reasoning.models import GraphContext, GraphNode
from lattice_tpu_torch.query.query_planner import QueryIntent, QueryPlan
from lattice_tpu_torch.query.ranking.models import (
    RankedResult,
    RankingConfig,
    RankingSignal,
)

# Relationship relevance per intent (reference `scorer.py:30-52`).
_RELATIONSHIP_RELEVANCE: dict[QueryIntent, dict[str, float]] = {
    QueryIntent.FIND_USAGE: {"caller": 1.0, "primary": 0.9},
    QueryIntent.FIND_CALLEES: {"callee": 1.0, "primary": 0.9},
    QueryIntent.FIND_CALL_CHAIN: {"chain": 1.0, "primary": 0.8},
    QueryIntent.FIND_HIERARCHY: {"ancestor": 1.0, "descendant": 1.0,
                                 "method": 0.6, "primary": 0.9},
    QueryIntent.FIND_METHODS: {"method": 1.0, "primary": 0.9},
    QueryIntent.FIND_IMPORTS: {"imports": 1.0, "primary": 0.8},
    QueryIntent.FIND_FILE_CONTEXT: {"in_file": 1.0, "primary": 0.8},
}
_DEFAULT_RELEVANCE = {"primary": 1.0, "caller": 0.7, "callee": 0.7,
                      "method": 0.6, "in_file": 0.5, "ancestor": 0.6,
                      "descendant": 0.6, "chain": 0.7, "imports": 0.5}

# Relation-directed intents ask for the MEMBERS of a relation, not the
# subject: "who calls tokenize?" is answered by tokenize's callers, yet
# the subject used to win (entity-match bonus + hybrid merge boost) and
# the golden eval pinned first-hit at rank 2-7 across every such intent.
# Two complementary moves (round-5 ordering pass):
#   * results whose graph relationship IS the asked-for relation get an
#     explicit `relation_answer` bonus signal;
#   * the subject's entity-match bonus is capped (it stays near the top
#     as context but below the actual answers).
# FIND_CALL_CHAIN is bonus-only: its expected answers INCLUDE the
# endpoints the query names, so the subject is never demoted there.
_RELATION_ANSWER_RELS: dict[QueryIntent, frozenset[str]] = {
    QueryIntent.FIND_USAGE: frozenset({"caller"}),
    QueryIntent.FIND_CALLEES: frozenset({"callee"}),
    QueryIntent.FIND_CALL_CHAIN: frozenset({"chain"}),
    QueryIntent.FIND_HIERARCHY: frozenset({"ancestor", "descendant"}),
    QueryIntent.FIND_METHODS: frozenset({"method"}),
    QueryIntent.FIND_IMPORTS: frozenset({"imports"}),
    QueryIntent.FIND_FILE_CONTEXT: frozenset({"in_file"}),
}
SUBJECT_DEMOTE_INTENTS = frozenset(
    _RELATION_ANSWER_RELS) - {QueryIntent.FIND_CALL_CHAIN}
# Capped entity-match values under subject demotion (exact / partial).
SUBJECT_EXACT_CAP = 0.45
SUBJECT_PARTIAL_CAP = 0.25
# The device deep branch's evidence walk is CALLS-only (engine
# `_deep_evidence`): its reach classes are primary/callee/caller, so the
# relation members of methods/hierarchy/imports/file-context intents can
# never appear in the reach to BE promoted. Demoting the subject there
# without a compensating answer signal is a pure ordering regression —
# the device branch demotes only where the answers ride in the reach.
DEEP_CALLS_DEMOTE_INTENTS = frozenset(
    {QueryIntent.FIND_USAGE, QueryIntent.FIND_CALLEES})


class ResultScorer:
    def __init__(self, config: RankingConfig | None = None):
        self.config = config or RankingConfig()

    def _entity_match(self, name: str, qualified_name: str,
                      plan: QueryPlan) -> float:
        demote = plan.intent in SUBJECT_DEMOTE_INTENTS
        nl = name.lower()
        ql = qualified_name.lower()
        for ent in plan.entities:
            el = ent.name.lower()
            if nl == el or ql == el or ql.endswith("." + el):
                return SUBJECT_EXACT_CAP if demote else 1.0
            if el in ql:
                return SUBJECT_PARTIAL_CAP if demote else 0.5
        return 0.0

    @staticmethod
    def _dunder(name: str) -> bool:
        return len(name) > 4 and name.startswith("__") and name.endswith("__")

    def _centrality(self, degree_pair: tuple[int, int] | None) -> float:
        if not degree_pair:
            return 0.0
        total = degree_pair[0] + degree_pair[1]
        return min(1.0, total / self.config.centrality_degree_cap)

    def score_graph_node(self, node: GraphNode, plan: QueryPlan,
                         ctx: GraphContext) -> RankedResult:
        """Reference: `scorer.py:9-77`."""
        cfg = self.config
        base = cfg.depth_decay ** max(node.depth, 0)
        relevance_map = _RELATIONSHIP_RELEVANCE.get(plan.intent, _DEFAULT_RELEVANCE)
        relevance = relevance_map.get(node.relationship,
                                      _DEFAULT_RELEVANCE.get(node.relationship, 0.5))
        entity_match = self._entity_match(node.name, node.qualified_name, plan)
        centrality = self._centrality(
            ctx.centrality.get(node.qualified_name)
            or (node.out_degree + node.in_degree > 0
                and (node.out_degree, node.in_degree) or None))
        # context richness: how many relation groups this node appears near
        richness = min(1.0, (len(ctx.paths) + len(ctx.methods) > 0) * 0.5
                       + (len(ctx.callers) + len(ctx.callees) > 0) * 0.5)
        signals = [
            RankingSignal("graph_base", base * relevance, 1.0),
            RankingSignal("entity_match", entity_match, cfg.entity_match_bonus),
            RankingSignal("centrality", centrality, cfg.centrality_weight),
            RankingSignal("context", richness, cfg.context_weight),
        ]
        if node.relationship in _RELATION_ANSWER_RELS.get(plan.intent, ()):
            signals.append(RankingSignal(
                "relation_answer", 1.0, cfg.relation_answer_bonus))
        if self._dunder(node.name):
            signals.append(RankingSignal("dunder", -1.0, cfg.dunder_penalty))
        score = sum(s.contribution for s in signals)
        return RankedResult(
            name=node.name, qualified_name=node.qualified_name,
            entity_type=node.entity_type, file_path=node.file_path,
            start_line=node.start_line, end_line=node.end_line,
            source=ResultSource.GRAPH, score=score, signals=signals,
            depth=node.depth, relationship=node.relationship,
            graph_node_id=node.qualified_name,
        )

    def score_vector_result(self, result: VectorSearchResult, plan: QueryPlan,
                            centrality: dict[str, tuple[int, int]]
                            ) -> RankedResult:
        """Reference: `scorer.py:79-126`."""
        cfg = self.config
        similarity = max(0.0, min(1.0, (result.score + 1.0) / 2.0
                                  if result.score < 0 else result.score))
        entity_match = self._entity_match(result.name.rsplit(".", 1)[-1],
                                          result.graph_node_id or result.name,
                                          plan)
        cent = self._centrality(centrality.get(result.graph_node_id))
        # content-length quality: neither trivial nor enormous (`:112-120`)
        n = len(result.content)
        quality = 1.0 if 80 <= n <= 4000 else (0.5 if n > 0 else 0.0)
        signals = [
            RankingSignal("similarity", similarity, 1.0),
            RankingSignal("entity_match", entity_match, cfg.entity_match_bonus),
            RankingSignal("centrality", cent, cfg.centrality_weight),
            RankingSignal("quality", quality, cfg.context_weight),
        ]
        if self._dunder(result.name.rsplit(".", 1)[-1]):
            signals.append(RankingSignal("dunder", -1.0, cfg.dunder_penalty))
        score = sum(s.contribution for s in signals)
        return RankedResult(
            name=result.name.rsplit(".", 1)[-1] or result.name,
            qualified_name=result.graph_node_id or result.name,
            entity_type=result.entity_type, file_path=result.file_path,
            start_line=result.start_line, end_line=result.end_line,
            source=ResultSource.VECTOR, score=score, content=result.content,
            signals=signals, graph_node_id=result.graph_node_id,
        )
