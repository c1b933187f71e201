"""The query engine: plan -> (graph || vector) -> rank -> context -> answer.

Parity target: reference `src/lattice/query/engine.py:57-556`:
- lazy sub-engine init (`:57-90`)
- `query()` pipeline with per-phase wall-clock stats (`:102-220`)
- graph + vector searches run concurrently (`:139-146`)
- graceful degradation: empty GraphContext / empty vector list on
  sub-failure (`:150-169`)
- summary-collection search added for explain-type intents (`:332-346`)
- centrality prefetch for top entities (`:348-377`)
- `search()` = retrieval without the LLM answer (`:222-260`) — the
  benchmark path (SURVEY §3.3)
- `get_statistics` (`:281-309`)

Torch port of `lattice_tpu/query/engine.py`. The engine has no device of
its own: it serves where its stores live. The graph and vector phases run
in `asyncio.to_thread` workers, so on the card the scan kernels launch
from a worker thread, on the device's current stream there. The
degradation above covers host failures only: a kernel that fails to build
or launch, the card out of memory, or a path that is not ported raises
(`_DEVICE_ERRORS`). `deep_search` serves stores below
`DEEP_DEVICE_THRESHOLD` rows through its host branch and
`ops/ranking.fused_rank` on the store's device; the resident-column
branch above it, `deep_search_batch`'s batched branch and their evidence
helpers raise `NotImplementedError` (ROADMAP queue 1, item 5), and the
sharded branch raises through `GraphStore._want_sharded` (item 11).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from lattice_tpu_torch.config.settings import QuerySettings
from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.core.types import ResultSource
from lattice_tpu_torch.embeddings.indexer import VectorIndexer, VectorSearcher
from lattice_tpu_torch.index.chunk_store import query_token_set
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.graph_kernels import UNREACHED
from lattice_tpu_torch.ops.ranking import (NEG_INF, FuseWeights, fused_rank,
                                           pack_weights)
from lattice_tpu_torch.query.context.builder import ContextBuilder
from lattice_tpu_torch.query.context.models import EnrichedContext
from lattice_tpu_torch.query.graph_reasoning.engine import GraphReasoningEngine
from lattice_tpu_torch.query.graph_reasoning.models import GraphContext
from lattice_tpu_torch.query.query_planner import (
    SUMMARY_INTENTS,
    QueryPlan,
    QueryPlanner,
)
from lattice_tpu_torch.query.ranking.models import RankedResult
from lattice_tpu_torch.query.ranking.ranker import HybridRanker
from lattice_tpu_torch.query.ranking.scorer import (
    _DEFAULT_RELEVANCE,
    _RELATIONSHIP_RELEVANCE,
    SUBJECT_DEMOTE_INTENTS,
    SUBJECT_EXACT_CAP,
)
from lattice_tpu_torch.query.responder import ResponseGenerator
from lattice_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)


# failures that are not a degraded answer: a kernel that did not build or
# launch, the card out of memory, a path that is not ported. The phases
# re-raise them rather than answer with an empty side.
_DEVICE_ERRORS = (KernelError, torch.cuda.OutOfMemoryError,
                  NotImplementedError)


def _deep_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lattice_tpu_torch yet (ROADMAP queue 1, "
        "item 5: the device deep path)")


def _weights_tuple(cfg, plan):
    """RankingConfig -> packed FuseWeights field order."""
    g_weight, v_weight = cfg.weights_for(plan.intent)
    return (g_weight, v_weight, cfg.centrality_weight, cfg.context_weight,
            cfg.entity_match_bonus, cfg.hybrid_boost, cfg.depth_decay,
            float(cfg.centrality_degree_cap))


@dataclass(slots=True)
class QueryResult:
    """Reference: `query/engine.py:21-28`. The reference's MCP tool read a
    nonexistent `query_analysis` attribute (SURVEY §2.2); `query_plan` is
    the one true name here and MCP uses it."""

    query: str
    answer: str
    results: list[RankedResult]
    query_plan: QueryPlan
    graph_context: GraphContext
    enriched_context: EnrichedContext | None = None
    phase_times_ms: dict[str, float] = field(default_factory=dict)


class QueryEngine:
    def __init__(
        self,
        graph_store: GraphStore,
        indexer: VectorIndexer,
        llm_provider=None,
        settings: QuerySettings | None = None,
    ):
        self.settings = settings or QuerySettings()
        self.graph_store = graph_store
        self.indexer = indexer
        self.planner = QueryPlanner(llm_provider)
        self.graph_engine = GraphReasoningEngine(graph_store)
        self.vector_searcher = VectorSearcher(indexer)
        self.ranker = HybridRanker()
        self.context_builder = ContextBuilder(indexer.code, indexer.summaries,
                                              graph_store=graph_store)
        self.responder = ResponseGenerator(llm_provider)

    # ---- phases --------------------------------------------------------

    def _graph_phase(self, plan: QueryPlan) -> GraphContext:
        try:
            return self.graph_engine.execute_query_plan(plan)
        except _DEVICE_ERRORS:
            raise
        except Exception as exc:
            logger.warning("graph phase failed: %s", exc)
            ctx = GraphContext()
            ctx.notes.append(f"graph search failed: {exc}")
            return ctx

    def _vector_phase(self, plan: QueryPlan, limit: int,
                      project_name: str | None = None):
        try:
            filters = {"project_name": project_name} if project_name else None
            results = self.vector_searcher.search_code(
                plan.raw_query, limit=min(limit, self.settings.max_vector_results),
                filters=filters)
            # exact-identifier channel (round 5): queries that name an
            # entity in plain words surface it even when the embedding
            # misses; duplicate rows merge (and boost) in the ranker
            results += self.vector_searcher.search_lexical(
                plan.raw_query, limit=min(limit,
                                          self.settings.max_vector_results),
                filters=filters)
            if plan.intent in SUMMARY_INTENTS and len(self.indexer.summaries):
                results += self.vector_searcher.search_summaries(
                    plan.raw_query, limit=5, filters=filters)
            return results
        except _DEVICE_ERRORS:
            raise
        except Exception as exc:
            logger.warning("vector phase failed: %s", exc)
            return []

    async def _plan_and_retrieve(self, query_text: str, limit: int,
                                 project_name: str | None):
        tracer = get_tracer()
        times: dict[str, float] = {}
        t0 = time.perf_counter()
        with tracer.span("query.planning"):
            plan = await self.planner.plan_query(query_text)
        times["planning_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        with tracer.span("query.retrieve"):
            graph_task = asyncio.to_thread(self._graph_phase, plan)
            vector_task = asyncio.to_thread(
                self._vector_phase, plan, 2 * limit, project_name)
            graph_context, vector_results = await asyncio.gather(
                graph_task, vector_task)
        elapsed = (time.perf_counter() - t0) * 1000
        times["graph_ms"] = elapsed
        times["vector_ms"] = elapsed

        # Centrality prefetch for top vector entities not already covered
        # (reference `engine.py:348-377`, capped at max_centrality_lookups).
        t0 = time.perf_counter()
        missing = []
        for vres in vector_results[: self.settings.max_centrality_lookups]:
            qn = vres.graph_node_id
            if qn and qn not in graph_context.centrality:
                nid = self.graph_store.id_of(qn)
                if nid is not None:
                    missing.append(nid)
        if missing:
            graph_context.centrality.update(
                self.graph_engine.get_centrality(missing))
        times["centrality_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        ranked = self.ranker.rank_results(graph_context, vector_results, plan,
                                          limit=limit)
        times["ranking_ms"] = (time.perf_counter() - t0) * 1000
        return plan, graph_context, vector_results, ranked, times

    # ---- public API ----------------------------------------------------

    async def query(self, query_text: str, limit: int | None = None,
                    project_name: str | None = None) -> QueryResult:
        """Full pipeline with context + answer. Reference: `engine.py:102-220`."""
        limit = limit or self.settings.search_limit
        plan, graph_context, _vec, ranked, times = \
            await self._plan_and_retrieve(query_text, limit, project_name)

        t0 = time.perf_counter()
        enriched = self.context_builder.build_enriched_context(
            plan, graph_context, ranked)
        times["context_ms"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        answer = await self.responder.generate(plan, enriched, ranked)
        times["response_ms"] = (time.perf_counter() - t0) * 1000

        return QueryResult(
            query=query_text, answer=answer, results=ranked,
            query_plan=plan, graph_context=graph_context,
            enriched_context=enriched, phase_times_ms=times,
        )

    async def search(self, query_text: str, limit: int | None = None,
                     project_name: str | None = None) -> QueryResult:
        """Retrieval without synthesis — the benchmark path.

        Reference: `engine.py:222-260` (SURVEY §3.3).
        """
        limit = limit or self.settings.search_limit
        plan, graph_context, _vec, ranked, times = \
            await self._plan_and_retrieve(query_text, limit, project_name)
        return QueryResult(
            query=query_text, answer="", results=ranked, query_plan=plan,
            graph_context=graph_context, phase_times_ms=times,
        )

    def search_sync(self, query_text: str, limit: int | None = None,
                    project_name: str | None = None) -> QueryResult:
        return asyncio.run(self.search(query_text, limit, project_name))

    def query_sync(self, query_text: str, limit: int | None = None,
                   project_name: str | None = None) -> QueryResult:
        return asyncio.run(self.query(query_text, limit, project_name))

    # ---- device-fused corpus ranking ------------------------------------

    def deep_search(self, query_text: str, limit: int | None = None
                    ) -> QueryResult:
        """Corpus-wide hybrid ranking (SURVEY §7 step 6).

        Where `search` ranks the ~70 materialized candidates host-side
        (reference semantics), this path scores EVERY chunk row: vector
        cosine for all rows in one product on the store's device, graph
        evidence (BFS depth, relationship relevance, degree) scattered
        from graph nodes to chunk rows via the graph_node_id join, then
        one fused elementwise pass + top_k (`ops/ranking.fused_rank`) on
        the store's device. Exhaustive-recall variant of the hybrid
        ranker for corpus-scale result sets.

        The one [N] score row and the validity mask come to the host
        once, the six [N] fuse columns are built there (as the
        reference does), and `fused_rank` runs on the store's device.
        Stores of `DEEP_DEVICE_THRESHOLD` rows or more take the
        resident-column path, which is ROADMAP queue 1, item 5.
        """
        limit = limit or self.settings.search_limit
        plan = self.planner.plan_heuristic(query_text)
        store = self.indexer.code
        if len(store) == 0:
            return QueryResult(query=query_text, answer="", results=[],
                               query_plan=plan,
                               graph_context=self._graph_phase(plan))
        if store.capacity >= self.DEEP_DEVICE_THRESHOLD:
            # corpus-scale: the per-payload Python walk below is O(corpus)
            # per query; the device path joins graph evidence to rows
            # through resident columns instead
            return self._deep_search_device(query_text, plan, limit)
        graph_context = self._graph_phase(plan)
        cap = store.capacity

        t0 = time.perf_counter()
        # vector side: cosine of every row, on the store's device; the
        # row of scores and the mask come to the host once
        qvec = topk_ops.l2_normalize(
            self.vector_searcher.embedder.embed(query_text)[None, :])
        emb, valid = store.device_arrays
        vec_scores = topk_ops.batched_matmul_scores(
            torch.from_numpy(qvec).to(emb.device), emb)[0].cpu().numpy()
        vec_scores = np.where(valid.cpu().numpy(), vec_scores,
                              np.float32(NEG_INF))

        # graph side scattered to rows
        depth = np.full(cap, UNREACHED, dtype=np.int32)
        relevance = np.zeros(cap, dtype=np.float32)
        degree = np.zeros(cap, dtype=np.int32)
        match = np.zeros(cap, dtype=np.float32)
        quality = np.zeros(cap, dtype=np.float32)
        relevance_map = _RELATIONSHIP_RELEVANCE.get(plan.intent,
                                                    _DEFAULT_RELEVANCE)
        demote = plan.intent in SUBJECT_DEMOTE_INTENTS
        inverted = store._inverted["graph_node_id"]
        for node in graph_context.all_nodes():
            rows = inverted.get(node.qualified_name)
            if not rows:
                continue
            rel = relevance_map.get(
                node.relationship,
                _DEFAULT_RELEVANCE.get(node.relationship, 0.5))
            if demote and node.relationship == "primary":
                # relation-directed intents: the subject is context,
                # not the answer. The fused kernel has no separate
                # entity-bonus slot, so the host scorer's cap CONSTANT
                # applies to relevance here — a deliberately stronger
                # demotion (the eval pins the resulting ordering).
                rel *= SUBJECT_EXACT_CAP
            out_deg, in_deg = graph_context.centrality.get(
                node.qualified_name, (node.out_degree, node.in_degree))
            for row in rows:
                depth[row] = min(depth[row], node.depth)
                relevance[row] = max(relevance[row], rel)
                degree[row] = out_deg + in_deg
        # relation-directed intents: the named entity is the SUBJECT,
        # not the answer — cap its match signal the way the host-path
        # scorer does so callers/subclasses/etc. outrank it here too
        # under demotion the subject gets NO match signal — the same
        # rule as the device branch, which excludes seeds from the
        # packed match slots; its capped relevance + vector cosine keep
        # it near the top as context (probed: a 0.45 cap still left
        # "who calls get_config?" ranking the subject above its callers
        # by 0.025 through the subject's query-echo cosine)
        subject_match = 0.0 if demote else 1.0
        # subject-row matching mirrors the scorer's _entity_match: bare
        # entities match by bare name; dotted entities match the row's
        # QUALIFIED name exactly or as a ".entity" suffix — last-segment
        # matching for dotted entities would also demote same-named
        # relation answers (Runner.drain as a caller of Base.drain)
        bare_names = {e.name.lower() for e in plan.entities
                      if "." not in e.name}
        dotted_names = [e.name.lower() for e in plan.entities
                        if "." in e.name]
        subject_rows: set[int] = set()
        for row, payload in store.scroll({}, limit=cap):
            name = (payload.get("name") or "").rsplit(".", 1)[-1].lower()
            qn = (payload.get("graph_node_id")
                  or payload.get("name") or "").lower()
            is_subject = (bool(name) and name in bare_names) or any(
                qn == d or qn.endswith("." + d) for d in dotted_names)
            if is_subject:
                match[row] = subject_match
                subject_rows.add(row)
            n = len(payload.get("content") or "")
            quality[row] = 1.0 if 80 <= n <= 4000 else (0.5 if n else 0.0)
        # lexical channel (round 5): plain-word identifier mentions feed
        # the same match signal the planner's extracted entities do.
        # Under subject demotion the lexical channel must not hand the
        # subject its full match back (the query literally names it, so
        # its lexical score is ~1.0 by construction).
        for row, lscore in store.lexical_candidates(
                query_token_set(query_text), limit=64):
            if demote and row in subject_rows:
                continue
            match[row] = max(match[row], float(lscore))

        cols = (depth, relevance, vec_scores, match, degree, quality,
                pack_weights(FuseWeights(
                    *_weights_tuple(self.ranker.config, plan))))
        scores, rows = fused_rank(
            *(torch.from_numpy(c).to(emb.device) for c in cols), limit)
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        elapsed_ms = (time.perf_counter() - t0) * 1000

        results = []
        for score, row in zip(scores, rows):
            payload = store.payload(int(row))
            if payload is None or score <= -1e29:
                continue
            in_graph = depth[int(row)] < UNREACHED
            results.append(RankedResult(
                name=(payload.get("name") or "").rsplit(".", 1)[-1],
                qualified_name=payload.get("graph_node_id") or "",
                entity_type=payload.get("entity_type") or "",
                file_path=payload.get("file_path") or "",
                start_line=payload.get("start_line") or 0,
                end_line=payload.get("end_line") or 0,
                source=ResultSource.HYBRID if in_graph else ResultSource.VECTOR,
                score=float(score),
                content=payload.get("content") or "",
            ))
        return QueryResult(
            query=query_text, answer="", results=results, query_plan=plan,
            graph_context=graph_context,
            phase_times_ms={"deep_fuse_ms": elapsed_ms},
        )

    # rows above which the host payload walk is replaced by the
    # device-resident join (ops/ranking.fused_rank_rows)
    DEEP_DEVICE_THRESHOLD = 100_000

    def _sharded_deep_enabled(self) -> bool:
        """Deep rank over several cards: same opt-in convention as the
        store's and graph's sharded tiers (LATTICE_SHARDED=1 with more
        than one CUDA device, `GraphStore._want_sharded`, which raises:
        ROADMAP queue 1, item 11)."""
        return self.graph_store._want_sharded()

    def _deep_search_device(self, query_text: str, plan, limit: int
                            ) -> QueryResult:
        """Corpus-scale hybrid rank: sparse host BFS + a device fuse over
        the store's resident rank columns. It needs
        `ChunkStore.device_rank_columns` and
        `ops/ranking.hybrid_rank_device_packed`, which are not ported."""
        self._sharded_deep_enabled()
        raise _deep_not_ported("QueryEngine._deep_search_device")

    def deep_search_batch(self, query_texts: list[str],
                          limit: int | None = None) -> list[QueryResult]:
        """Corpus-wide hybrid ranking for many queries. Below
        `DEEP_DEVICE_THRESHOLD` rows (or for one query) it runs
        `deep_search` per query, as the reference does; the batched
        device branch above it (`hybrid_rank_device_packed_batch`) is
        not ported."""
        if not query_texts:
            return []
        limit = limit or self.settings.search_limit
        store = self.indexer.code
        if (len(store) == 0 or len(query_texts) == 1
                or store.capacity < self.DEEP_DEVICE_THRESHOLD):
            return [self.deep_search(t, limit) for t in query_texts]
        self._sharded_deep_enabled()
        raise _deep_not_ported("QueryEngine.deep_search_batch's batched "
                               "branch")

    # the device branch's evidence: seeds, budgeted reach expanded to rows
    # through the store's resident rank columns, packed for the fuse
    # (reference `engine.py:384-408, 557-734`)
    def _deep_seeds(self, plan) -> list[int]:
        raise _deep_not_ported("QueryEngine._deep_seeds")

    def _deep_evidence(self, plan, walks=None, seeds=None) -> dict:
        raise _deep_not_ported("QueryEngine._deep_evidence")

    def _deep_evidence_batch(self, plans: list) -> list[dict]:
        raise _deep_not_ported("QueryEngine._deep_evidence_batch")

    def _pack_deep_evidence(self, evs: list[dict]):
        raise _deep_not_ported("QueryEngine._pack_deep_evidence")

    def get_statistics(self) -> dict:
        """Reference: `engine.py:281-309` (+ span aggregates, SURVEY §5)."""
        return {
            "graph": self.graph_store.stats,
            "vector": {
                "code": self.indexer.code.stats,
                "summaries": self.indexer.summaries.stats,
            },
            "spans": get_tracer().report(),
        }
