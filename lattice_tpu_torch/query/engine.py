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
(`core.errors.DEVICE_ERRORS`). `deep_search` serves stores below
`DEEP_DEVICE_THRESHOLD` rows through its host branch and
`ops/ranking.fused_rank` on the store's device; at or above it, the
device branch: a budgeted host CSR walk, expanded to rows through the
store's resident rank columns, packed (`pack_reach`) and fused with the
f32 query's cosine of every row on the store's device
(`hybrid_rank_device_packed`); `deep_search_batch` runs Q queries through
`hybrid_rank_device_packed_batch`, `DEEP_BATCH_CHUNK` at a time. With
`LATTICE_SHARDED=1` and a mesh of more than one shard (the stores' one
mesh, `parallel.mesh.visible_mesh`) both rank through the store's sharded
view (`ChunkStore.sharded_hybrid`, `parallel/sharded_rank.py`) instead, on
the same evidence.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from lattice_tpu_torch.config.settings import QuerySettings
from lattice_tpu_torch.core.errors import DEVICE_ERRORS
from lattice_tpu_torch.core.types import EdgeType, ResultSource
from lattice_tpu_torch.embeddings.indexer import VectorIndexer, VectorSearcher
from lattice_tpu_torch.index.chunk_store import query_token_set
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.graph_kernels import UNREACHED
from lattice_tpu_torch.ops.ranking import (
    NEG_INF,
    FuseWeights,
    fused_rank,
    hybrid_rank_device_packed,
    hybrid_rank_device_packed_batch,
    pack_reach,
    pack_weights,
)
from lattice_tpu_torch.query.context.builder import ContextBuilder
from lattice_tpu_torch.query.context.models import EnrichedContext
from lattice_tpu_torch.query.graph_reasoning.engine import GraphReasoningEngine
from lattice_tpu_torch.query.graph_reasoning.models import GraphContext
from lattice_tpu_torch.query.query_planner import (
    SUMMARY_INTENTS,
    QueryIntent,
    QueryPlan,
    QueryPlanner,
)
from lattice_tpu_torch.query.ranking.models import RankedResult
from lattice_tpu_torch.query.ranking.ranker import HybridRanker
from lattice_tpu_torch.query.ranking.scorer import (
    _DEFAULT_RELEVANCE,
    _RELATIONSHIP_RELEVANCE,
    DEEP_CALLS_DEMOTE_INTENTS,
    SUBJECT_DEMOTE_INTENTS,
    SUBJECT_EXACT_CAP,
)
from lattice_tpu_torch.query.responder import ResponseGenerator
from lattice_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)




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
        except DEVICE_ERRORS:
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
        except DEVICE_ERRORS:
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
        resident-column path (`_deep_search_device`).
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
    # device-resident join (ops/ranking.hybrid_rank_device_packed)
    DEEP_DEVICE_THRESHOLD = 100_000

    # max queries per batched rank: bounds its [Q, N] f32 score slab
    # (128 * 1M rows * 4 B = 512 MB)
    DEEP_BATCH_CHUNK = 128
    # reference traversal cap (`graph_reasoning/models.py:5`); the batch
    # path precomputes walks at this depth for _deep_evidence to consume,
    # so both MUST read the same constant
    DEEP_HOPS = 5

    def _sharded_deep_enabled(self) -> bool:
        """Deep rank over a mesh: the opt-in of the store's and graph's
        sharded tiers (LATTICE_SHARDED=1 with a mesh of more than one
        shard), read on the mesh the store's sharded rank runs on, which
        the graph's walk reads too (`parallel.mesh.visible_mesh`)."""
        return (os.environ.get("LATTICE_SHARDED") == "1"
                and self.indexer.code._mesh_shards() > 1)

    def _pack_deep_evidence(self, evs: list[dict]):
        """Stack per-query evidence into padded [Q, R] / [Q, M] arrays (-1
        pads, masked inside the fuse): R and M are the longest reach and
        match lists of the batch. Shared by the single-query device path
        (Q=1, row 0) and `deep_search_batch`, so the packed-reach format
        has exactly one producer."""
        r_cap = max(max(len(e["r_rows"]) for e in evs), 1)
        packed_b = np.stack([
            pack_reach(e["r_rows"], e["r_depths"], e["r_cls"], r_cap)
            for e in evs])
        m_cap = max(max(len(e["match_rows"]) for e in evs), 1)
        match_b = np.full((len(evs), m_cap), -1, np.int32)
        for i, e in enumerate(evs):
            match_b[i, :len(e["match_rows"])] = e["match_rows"]
        return packed_b, match_b

    def _deep_search_device(self, query_text: str, plan, limit: int
                            ) -> QueryResult:
        """Corpus-scale hybrid rank: sparse host BFS + device fuse.

        plan -> budgeted host CSR walk (both directions; O(edges touched))
        -> node -> row expansion through the store's resident rank
        columns -> the f32 query's cosine of every row, the packed reach
        scattered to rows, fuse and selection on the store's device (the
        reference's semantics `query/engine.py:102-220` with the ranker
        formulas of `ranking/scorer.py:9-126`). Host work per query is
        O(seeds + reached + k), never O(corpus). The sharded branch ranks
        the same evidence where the rows live (`sharded_hybrid`)."""
        t0 = time.perf_counter()
        store = self.indexer.code
        ev = self._deep_evidence(plan)
        cols = ev["cols"]
        packed_b, match_b = self._pack_deep_evidence([ev])
        qvec = np.asarray(
            self.vector_searcher.embedder.embed(query_text),
            dtype=np.float32)
        w_np = pack_weights(FuseWeights(
            *_weights_tuple(self.ranker.config, plan)))
        if self._sharded_deep_enabled():
            view = store.sharded_hybrid(self.graph_store)
            scores, rows = view.rank(qvec[None], packed_b, ev["rel_table"],
                                     match_b, w_np, limit)
            scores, rows = scores[0], rows[0]
        else:
            emb, valid = store.device_arrays

            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(a).to(emb.device)

            scores, rows = hybrid_rank_device_packed(
                put(qvec), emb, valid, put(packed_b[0]),
                put(ev["rel_table"]), put(match_b[0]), cols.degree,
                cols.quality, put(w_np), limit)
            scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        elapsed_ms = (time.perf_counter() - t0) * 1000
        results = self._deep_results(scores, rows, ev["reach_set"])
        return QueryResult(
            query=query_text, answer="", results=results, query_plan=plan,
            graph_context=self._deep_context(plan, ev),
            phase_times_ms={"deep_fuse_ms": elapsed_ms},
        )

    def deep_search_batch(self, query_texts: list[str],
                          limit: int | None = None) -> list[QueryResult]:
        """Corpus-wide hybrid ranking for many queries. Below
        `DEEP_DEVICE_THRESHOLD` rows (or for one query) it runs
        `deep_search` per query. Above it, the per-query evidence (budgeted
        walks, entity matches, per-intent weights and relevance tables)
        stacks to [Q, ...] arrays and goes to the store's device once a
        chunk of `DEEP_BATCH_CHUNK` queries, which the batched rank scores
        as one [Q, N] slab (`hybrid_rank_device_packed_batch`), or through
        the store's sharded view on the sharded branch."""
        if not query_texts:
            return []
        limit = limit or self.settings.search_limit
        store = self.indexer.code
        if (len(store) == 0 or len(query_texts) == 1
                or store.capacity < self.DEEP_DEVICE_THRESHOLD):
            return [self.deep_search(t, limit) for t in query_texts]
        t0 = time.perf_counter()
        plans = [self.planner.plan_heuristic(t) for t in query_texts]
        evs = self._deep_evidence_batch(plans)
        # one embedding call for all queries
        qvecs = np.asarray(
            self.vector_searcher.embedder.embed_batch(query_texts),
            dtype=np.float32)
        # mixed intents ride per-query weight/relevance tables
        w_b = np.stack([
            pack_weights(FuseWeights(
                *_weights_tuple(self.ranker.config, p))) for p in plans])
        rel_b = np.stack([e["rel_table"] for e in evs])
        sharded = (store.sharded_hybrid(self.graph_store)
                   if self._sharded_deep_enabled() else None)
        emb, valid = store.device_arrays
        cols = evs[0]["cols"]

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(emb.device)

        scores_parts: list[np.ndarray] = []
        rows_parts: list[np.ndarray] = []
        for lo in range(0, len(evs), self.DEEP_BATCH_CHUNK):
            sl = slice(lo, lo + self.DEEP_BATCH_CHUNK)
            packed_b, match_b = self._pack_deep_evidence(evs[sl])
            if sharded is not None:
                sc, rw = sharded.rank(qvecs[sl], packed_b, rel_b[sl],
                                      match_b, w_b[sl], limit)
            else:
                sc, rw = hybrid_rank_device_packed_batch(
                    put(qvecs[sl]), emb, valid, put(packed_b),
                    put(rel_b[sl]), put(match_b), cols.degree, cols.quality,
                    put(w_b[sl]), limit)
                sc, rw = sc.cpu().numpy(), rw.cpu().numpy()
            scores_parts.append(sc)
            rows_parts.append(rw)
        scores_b = np.concatenate(scores_parts)
        rows_b = np.concatenate(rows_parts)
        per_q_ms = (time.perf_counter() - t0) * 1000 / len(plans)
        out = []
        for text, plan, e, sc, rw in zip(query_texts, plans, evs,
                                         scores_b, rows_b):
            out.append(QueryResult(
                query=text, answer="",
                results=self._deep_results(sc, rw, e["reach_set"]),
                query_plan=plan, graph_context=self._deep_context(plan, e),
                phase_times_ms={"deep_fuse_ms": per_q_ms}))
        return out

    def _deep_evidence_batch(self, plans: list) -> list[dict]:
        """Evidence for Q plans with the BFS walks batched: all forward
        walks in one native call, all backward walks in another
        (`GraphStore._host_bfs_batch`, OpenMP across queries on
        multi-core hosts). Results are identical to the sequential path:
        `_deep_evidence` receives each plan's own walk pair and applies
        the same budget trim."""
        graph = self.graph_store
        seedss = [self._deep_seeds(p) for p in plans]
        walks: list = [None] * len(plans)
        if graph.n_edges(EdgeType.CALLS):
            hops, budget = self.DEEP_HOPS, self._reach_budget()
            fw = graph._host_bfs_batch(seedss, EdgeType.CALLS, hops,
                                       limit=budget)
            bw = graph._host_bfs_batch(seedss, EdgeType.CALLS, hops,
                                       reverse=True, limit=budget)
            walks = list(zip(fw, bw))
        return [self._deep_evidence(p, walks=w, seeds=s)
                for p, w, s in zip(plans, walks, seedss)]

    def _deep_seeds(self, plan) -> list[int]:
        """Graph seed ids for a plan's entities (exact name, then fuzzy;
        <=5 ids/entity, <=16 total, deduplicated in plan order)."""
        graph = self.graph_store
        graph._ensure_final()
        n_pad = graph._n_padded()
        seeds: list[int] = []
        for e in plan.entities:
            ids = graph.find_by_name(e.name)
            # fuzzy fallback only for confident extractions — a lone
            # 0.5-confidence capitalized word must not seed the BFS
            # with arbitrary contains-matches (same gate as
            # GraphReasoningEngine.find_entity)
            if not ids and e.confidence >= 0.6:
                ids = [nid for nid, _ in graph.find_fuzzy(e.name, limit=3)]
            seeds.extend(ids[:5])
        return list(dict.fromkeys(s for s in seeds if s < n_pad))[:16]

    @staticmethod
    def _reach_budget() -> int:
        """Per-direction evidence budget: the shallowest `budget` reached
        nodes per direction ride to the device; beyond it the depth decay
        (0.8^5 ~= 0.33) has flattened graph credit. Floor of 1: 0 would
        pass limit=0 = UNBOUNDED to the walk, then trim every reached node
        away."""
        return max(
            int(os.environ.get("LATTICE_REACH_BUDGET", 32768)) // 2, 1)

    def _deep_evidence(self, plan, walks=None, seeds=None) -> dict:
        """Host-side evidence for one deep query: seeds, budgeted BFS
        reach expanded node->row through the resident reverse CSR,
        entity-match rows, and the intent relevance table. O(seeds +
        reached + matches) host work, never O(corpus). `walks`/`seeds`
        optionally inject precomputed ((f_ids, f_d), (b_ids, b_d)) walk
        results and the seed list they were computed for (the batch path
        runs all Q queries' walks as two native calls)."""
        graph = self.graph_store
        store = self.indexer.code
        graph._ensure_final()
        relevance_map = _RELATIONSHIP_RELEVANCE.get(plan.intent,
                                                    _DEFAULT_RELEVANCE)
        rel_caller = relevance_map.get(
            "caller", _DEFAULT_RELEVANCE["caller"])
        rel_callee = relevance_map.get(
            "callee", _DEFAULT_RELEVANCE["callee"])
        rel_primary = relevance_map.get("primary", 1.0)

        if seeds is None:
            seeds = self._deep_seeds(plan)

        cols = store.device_rank_columns(graph)
        hops = self.DEEP_HOPS
        budget = self._reach_budget()
        if seeds:
            # seeds always carry their depth-0 primary credit, even in a
            # graph with no CALLS edges (hierarchy/import-only corpora)
            if graph.n_edges(EdgeType.CALLS):
                if walks is not None:
                    (f_ids, f_d), (b_ids, b_d) = walks
                else:
                    f_ids, f_d = graph._host_bfs(seeds, EdgeType.CALLS,
                                                 hops, limit=budget)
                    b_ids, b_d = graph._host_bfs(seeds, EdgeType.CALLS,
                                                 hops, reverse=True,
                                                 limit=budget)
                # the NumPy fallback walk ignores `limit`; trim to the
                # same shallowest-(depth, id) prefix the native walk
                # returns so rankings are backend-independent
                if len(f_ids) > budget:
                    o = np.lexsort((f_ids, f_d))[:budget]
                    f_ids, f_d = f_ids[o], f_d[o]
                if len(b_ids) > budget:
                    o = np.lexsort((b_ids, b_d))[:budget]
                    b_ids, b_d = b_ids[o], b_d[o]
            else:
                f_ids = b_ids = np.empty(0, np.int64)
                f_d = b_d = np.empty(0, np.int32)
            n_ids = np.concatenate([
                np.asarray(seeds, np.int64), f_ids, b_ids])
            n_depths = np.concatenate([
                np.zeros(len(seeds), np.int32), f_d, b_d])
            # rel CLASS per node (0=primary, 1=callee, 2=caller); the
            # relevance values ride in a [4] table so the reach packs to
            # one int32 per entry (pack_reach)
            n_cls = np.concatenate([
                np.zeros(len(seeds), np.uint8),
                np.full(len(f_ids), 1, np.uint8),
                np.full(len(b_ids), 2, np.uint8)])
        else:
            f_ids = b_ids = np.empty(0, np.int64)
            f_d = b_d = np.empty(0, np.int32)
            n_ids = np.empty(0, np.int64)
            n_depths = np.empty(0, np.int32)
            n_cls = np.empty(0, np.uint8)
        # relation-directed intents: the seeds ARE the subject, not the
        # answer — scale their class-0 relevance by the subject cap and
        # keep them out of the binary match slots so the relation members
        # (class 1/2 at rel 1.0) outrank them. CALLS-answer intents only:
        # this walk's reach classes are primary/callee/caller, so the
        # answers of methods/hierarchy/imports intents never ride it
        # (scorer.py's rationale at DEEP_CALLS_DEMOTE_INTENTS).
        demote = plan.intent in DEEP_CALLS_DEMOTE_INTENTS
        if demote:
            rel_primary *= SUBJECT_EXACT_CAP
        rel_table = np.asarray(
            [rel_primary, rel_callee, rel_caller, 0.0], np.float32)
        reach_set = {int(v): int(d) for v, d in zip(n_ids, n_depths)}
        # node->row expansion through the resident reverse CSR, host-side
        r_rows, r_depths, r_cls = cols.rows_for_nodes(n_ids, n_depths,
                                                      n_cls)
        match_rows: list[int] = []
        inverted = store._inverted["graph_node_id"]
        seed_rows: set[int] = set()
        for sd in seeds:
            seed_rows.update(
                inverted.get(graph.node(sd).qualified_name, ()))
        if not demote:
            match_rows.extend(seed_rows)
        # lexical channel: the packed match slots are binary, so only
        # strong name-coverage hits ride along (name coverage >= 0.6, a
        # name the query mostly spells out), capped to leave room for
        # the seeds
        match_rows.extend(
            r for r, _s in store.lexical_candidates(
                query_token_set(plan.raw_query), limit=32,
                min_name_cov=0.6)
            if not (demote and r in seed_rows))
        return {
            "seeds": seeds, "f_ids": f_ids, "f_d": f_d,
            "b_ids": b_ids, "b_d": b_d,
            "r_rows": r_rows, "r_depths": r_depths, "r_cls": r_cls,
            "rel_table": rel_table, "reach_set": reach_set,
            "match_rows": match_rows, "cols": cols,
        }

    def _deep_results(self, scores, rows, reach_set) -> list:
        graph = self.graph_store
        store = self.indexer.code
        results = []
        for score, row in zip(scores, rows):
            # sentinel check BEFORE the payload lookup: NEG_INF filler
            # slots don't reference a meaningful row
            if score <= -1e29:
                continue
            payload = store.payload(int(row))
            if payload is None:
                continue
            qn = payload.get("graph_node_id") or ""
            nid = graph.id_of(qn) if qn else None
            in_graph = nid is not None and nid in reach_set
            results.append(RankedResult(
                name=(payload.get("name") or "").rsplit(".", 1)[-1],
                qualified_name=qn,
                entity_type=payload.get("entity_type") or "",
                file_path=payload.get("file_path") or "",
                start_line=payload.get("start_line") or 0,
                end_line=payload.get("end_line") or 0,
                source=(ResultSource.HYBRID if in_graph
                        else ResultSource.VECTOR),
                score=float(score),
                content=payload.get("content") or "",
            ))
        return results

    # intents whose context is the CALLS reach the fuse ranked on
    _CALLS_INTENTS = frozenset({
        QueryIntent.FIND_USAGE, QueryIntent.FIND_CALLEES,
        QueryIntent.FIND_CALL_CHAIN, QueryIntent.FIND_SIMILAR,
        QueryIntent.FIND_EXAMPLES, QueryIntent.GENERAL_SEARCH,
    })

    def _deep_context(self, plan, ev) -> GraphContext:
        """CALLS-centric intents get their context from the SAME reach the
        fuse ranked on (no second traversal; the walk's order is depth
        order, so the head of each direction is the Cypher-capped result
        set). Intents whose context lives on other edge types
        (hierarchy/methods/imports/file structure) still run the
        reasoning engine: this path never walked those edges."""
        if not ev["seeds"]:
            return GraphContext()
        if plan.intent in self._CALLS_INTENTS:
            cap = 50
            to_node = self.graph_engine._to_node
            return GraphContext(
                primary_entities=[to_node(s, 0, "primary")
                                  for s in ev["seeds"]],
                callees=[to_node(int(v), int(d), "callee")
                         for v, d in zip(ev["f_ids"][:cap],
                                         ev["f_d"][:cap])],
                callers=[to_node(int(v), int(d), "caller")
                         for v, d in zip(ev["b_ids"][:cap],
                                         ev["b_d"][:cap])],
            )
        return self._graph_phase(plan)

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
