"""Hybrid ranking models and configuration.

Parity target: reference `src/lattice/query/ranking/models.py`:
- `RankingConfig` base weights graph/vector 0.5/0.5, centrality 0.2,
  context 0.1, entity-match bonus 0.3 + per-intent weight table (`:60-91`)
- `RankedResult` with signal_scores and `get_key` = file:entity:line
  (`:28-56`)
- dedupe caps: max per file 5, max total 50 (`:13-14`)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lattice_tpu_torch.core.types import ResultSource
from lattice_tpu_torch.query.query_planner import QueryIntent

MAX_RESULTS_PER_FILE = 5
MAX_TOTAL_RESULTS = 50


@dataclass(slots=True)
class RankingSignal:
    """One named scoring contribution (for explainability)."""

    name: str
    value: float
    weight: float

    @property
    def contribution(self) -> float:
        return self.value * self.weight


@dataclass(slots=True)
class RankedResult:
    """Reference: `ranking/models.py:28-56`."""

    name: str
    qualified_name: str
    entity_type: str
    file_path: str
    start_line: int
    end_line: int
    source: ResultSource
    score: float = 0.0
    content: str = ""
    signals: list[RankingSignal] = field(default_factory=list)
    depth: int = 0
    relationship: str = ""
    graph_node_id: str = ""

    def get_key(self) -> str:
        return f"{self.file_path}:{self.qualified_name or self.name}:{self.start_line}"

    @property
    def signal_scores(self) -> dict[str, float]:
        return {s.name: s.contribution for s in self.signals}


@dataclass
class RankingConfig:
    """Reference: `ranking/models.py:60-91`."""

    graph_weight: float = 0.5
    vector_weight: float = 0.5
    centrality_weight: float = 0.2
    context_weight: float = 0.1
    entity_match_bonus: float = 0.3
    # Relation-directed ordering (round-5 golden-eval pass, scorer.py):
    # bonus for results that ARE the asked-for relation's members, and a
    # small penalty keeping dunder chunks (__init__ et al.) below the
    # entity that contains them when otherwise tied.
    relation_answer_bonus: float = 0.4
    dunder_penalty: float = 0.05
    hybrid_boost: float = 1.1            # duplicate merge boost (`ranker.py:171-202`)
    depth_decay: float = 0.8             # per-hop decay of graph base score
    centrality_degree_cap: int = 50      # min(1, degree/50) (`scorer.py:60`)
    max_per_file: int = MAX_RESULTS_PER_FILE
    max_total: int = MAX_TOTAL_RESULTS

    # Per-intent (graph_weight, vector_weight) overrides
    # (reference `models.py:74-91`, e.g. FIND_CALL_CHAIN graph 0.9,
    # FIND_SIMILAR vector 0.8).
    intent_weights: dict[QueryIntent, tuple[float, float]] = field(
        default_factory=lambda: {
            QueryIntent.FIND_CALL_CHAIN: (0.9, 0.1),
            QueryIntent.FIND_USAGE: (0.8, 0.2),
            QueryIntent.FIND_CALLEES: (0.8, 0.2),
            QueryIntent.FIND_HIERARCHY: (0.85, 0.15),
            QueryIntent.FIND_METHODS: (0.8, 0.2),
            QueryIntent.FIND_IMPORTS: (0.8, 0.2),
            QueryIntent.FIND_FILE_CONTEXT: (0.7, 0.3),
            QueryIntent.FIND_DEFINITION: (0.6, 0.4),
            QueryIntent.FIND_SIMILAR: (0.2, 0.8),
            QueryIntent.FIND_EXAMPLES: (0.3, 0.7),
            QueryIntent.GENERAL_SEARCH: (0.4, 0.6),
            QueryIntent.EXPLAIN_ARCHITECTURE: (0.4, 0.6),
            QueryIntent.EXPLAIN_CODE: (0.5, 0.5),
            QueryIntent.FIND_IMPLEMENTATION: (0.5, 0.5),
            QueryIntent.DEBUG_HELP: (0.5, 0.5),
            QueryIntent.REFACTOR_HELP: (0.5, 0.5),
            QueryIntent.API_USAGE: (0.5, 0.5),
        })

    def weights_for(self, intent: QueryIntent) -> tuple[float, float]:
        return self.intent_weights.get(intent,
                                       (self.graph_weight, self.vector_weight))
