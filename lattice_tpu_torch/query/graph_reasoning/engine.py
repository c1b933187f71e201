"""Intent-dispatched graph reasoning over the GraphStore.

Parity target: reference `src/lattice/query/graph_reasoning/engine.py:25-483`
— entity lookup (exact then fuzzy), transitive callers/callees with bounded
hops, call chains, hierarchy, implementation context, class-with-methods,
file context with degree counts, entity centrality, and the comprehensive
fallback for top entities. Every variable-length Cypher query of
`graph_reasoning/queries.py` maps to a GraphStore/kernel traversal here.
"""

from __future__ import annotations

import logging

from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.index.graph_store import GraphStore, NodeRecord
from lattice_tpu_torch.query.graph_reasoning.models import (
    MAX_HOPS,
    MAX_PATH_LENGTH,
    MAX_RESULTS_PER_QUERY,
    GraphContext,
    GraphNode,
    GraphPath,
)
from lattice_tpu_torch.query.query_planner import QueryIntent, QueryPlan

logger = logging.getLogger(__name__)


class GraphReasoningEngine:
    def __init__(self, store: GraphStore):
        self.store = store

    # ---- helpers -------------------------------------------------------

    def _to_node(self, node_id: int, depth: int = 0,
                 relationship: str = "") -> GraphNode:
        rec: NodeRecord = self.store.node(node_id)
        return GraphNode(
            node_id=rec.node_id, qualified_name=rec.qualified_name,
            name=rec.name, entity_type=rec.entity_type.value,
            file_path=rec.file_path, start_line=rec.start_line,
            end_line=rec.end_line, depth=depth, relationship=relationship,
        )

    def find_entity(self, name: str, fuzzy: bool = True) -> list[int]:
        """Exact QN/simple-name then fuzzy CASE-scored contains.

        ``fuzzy=False`` stops at the exact tiers: low-confidence planner
        extractions (a lone capitalized English word) must not seed the
        BFS with arbitrary contains-matches.

        Reference: `engine.py:272-327` + `FIND_ENTITY_FUZZY`.
        """
        exact = self.store.find_by_name(name)
        if exact:
            return exact[:5]
        # try the last dotted segment exactly
        if "." in name:
            tail = self.store.find_by_name(name.rsplit(".", 1)[-1])
            if tail:
                return tail[:5]
        if not fuzzy:
            return []
        return [nid for nid, _ in self.store.find_fuzzy(name, limit=5)]

    def _khop_nodes(self, seed_ids: list[int], edge_type: EdgeType,
                    hops: int, reverse: bool, relationship: str
                    ) -> list[GraphNode]:
        # the Cypher result cap rides into the traversal so the device
        # path reads back O(limit), not the full [N] distance vector
        result = self.store.k_hop(seed_ids, edge_type, hops, reverse=reverse,
                                  limit=MAX_RESULTS_PER_QUERY)
        nodes = [self._to_node(nid, depth, relationship)
                 for nid, depth in result.items()]
        nodes.sort(key=lambda n: (n.depth, n.qualified_name))
        return nodes[:MAX_RESULTS_PER_QUERY]

    # ---- traversals (each replaces one Cypher query) -------------------

    def find_transitive_callers(self, seed_ids: list[int],
                                max_hops: int = MAX_HOPS) -> list[GraphNode]:
        """`FIND_TRANSITIVE_CALLERS` (`queries.py:2-25`)."""
        return self._khop_nodes(seed_ids, EdgeType.CALLS,
                                min(max_hops, MAX_HOPS), True, "caller")

    def find_transitive_callees(self, seed_ids: list[int],
                                max_hops: int = MAX_HOPS) -> list[GraphNode]:
        """`FIND_TRANSITIVE_CALLEES` (`queries.py:27-50`)."""
        return self._khop_nodes(seed_ids, EdgeType.CALLS,
                                min(max_hops, MAX_HOPS), False, "callee")

    def find_call_chains(self, src_ids: list[int], dst_ids: list[int],
                         max_len: int = MAX_PATH_LENGTH) -> list[GraphPath]:
        """`FIND_CALL_CHAIN` + `FIND_ALL_PATHS` (`queries.py:52-86`)."""
        paths: list[GraphPath] = []
        for s in src_ids[:3]:
            for t in dst_ids[:3]:
                for raw in self.store.all_paths(s, t, EdgeType.CALLS,
                                                max_len=min(max_len, MAX_PATH_LENGTH),
                                                max_paths=5):
                    nodes = [self._to_node(nid, depth=i, relationship="chain")
                             for i, nid in enumerate(raw)]
                    paths.append(GraphPath(nodes=nodes, edge_type="CALLS"))
        paths.sort(key=lambda p: p.length)
        return paths[:10]

    def find_full_hierarchy(self, seed_ids: list[int]
                            ) -> tuple[list[GraphNode], list[GraphNode]]:
        """`FIND_FULL_HIERARCHY` EXTENDS both directions (`queries.py:88-128`)."""
        ancestors = self._khop_nodes(seed_ids, EdgeType.EXTENDS, MAX_HOPS,
                                     False, "ancestor")
        descendants = self._khop_nodes(seed_ids, EdgeType.EXTENDS, MAX_HOPS,
                                       True, "descendant")
        return ancestors, descendants

    def find_class_methods(self, seed_ids: list[int]) -> list[GraphNode]:
        """`FIND_CLASS_WITH_METHODS` (`queries.py:130-160`)."""
        out: list[GraphNode] = []
        for cid in seed_ids:
            for mid in self.store.methods_of_class(cid):
                out.append(self._to_node(mid, depth=1, relationship="method"))
        return out[:MAX_RESULTS_PER_QUERY]

    def find_file_context(self, file_paths: list[str]) -> list[GraphNode]:
        """`FIND_FILE_CONTEXT` with degree counts (`queries.py:162-185`)."""
        out: list[GraphNode] = []
        for path in file_paths:
            for nid in self.store.nodes_in_file(path):
                node = self._to_node(nid, relationship="in_file")
                (node.out_degree, node.in_degree), = \
                    self.store.degree([nid], EdgeType.CALLS)
                out.append(node)
        return out[:MAX_RESULTS_PER_QUERY]

    def find_imports(self, seed_ids: list[int]) -> list[GraphNode]:
        """IMPORTS edges from the seed files (`graph/queries.py:151-158`)."""
        out: list[GraphNode] = []
        for neigh in self.store.neighbors(seed_ids, EdgeType.IMPORTS):
            for nid in neigh:
                out.append(self._to_node(nid, depth=1, relationship="imports"))
        return out[:MAX_RESULTS_PER_QUERY]

    def get_centrality(self, node_ids: list[int]) -> dict[str, tuple[int, int]]:
        """`GET_ENTITY_CENTRALITY` in/out degree (`queries.py:314-329`)."""
        out: dict[str, tuple[int, int]] = {}
        degrees = self.store.degree(node_ids, EdgeType.CALLS)
        for nid, (o, i) in zip(node_ids, degrees):
            out[self.store.node(nid).qualified_name] = (o, i)
        return out

    def implementation_context(self, seed_ids: list[int]) -> GraphContext:
        """callers + callees + file siblings in one shot
        (`FIND_IMPLEMENTATION_CONTEXT`, `queries.py:187-239`)."""
        ctx = GraphContext()
        ctx.primary_entities = [self._to_node(nid, relationship="primary")
                                for nid in seed_ids]
        ctx.callers = self.find_transitive_callers(seed_ids, 1)
        ctx.callees = self.find_transitive_callees(seed_ids, 1)
        files = {self.store.node(nid).file_path for nid in seed_ids}
        ctx.file_entities = self.find_file_context([f for f in files if f])
        return ctx

    # ---- plan execution ------------------------------------------------

    def execute_query_plan(self, plan: QueryPlan) -> GraphContext:
        """Intent dispatch. Reference: `engine.py:25-84`."""
        ctx = GraphContext()
        seed_ids: list[int] = []
        for ent in plan.entities:
            # low-confidence extractions only seed on EXACT name hits —
            # fuzzy contains-matches from a 0.5-confidence capitalized
            # English word ("... the Python tokenizer") are junk seeds
            hits = self.find_entity(ent.name,
                                    fuzzy=ent.confidence >= 0.6)
            if hits:
                seed_ids.extend(hits)
            else:
                ctx.notes.append(f"entity not found: {ent.name}")
        seed_ids = list(dict.fromkeys(seed_ids))[:10]
        if not seed_ids:
            return ctx
        ctx.primary_entities = [self._to_node(nid, relationship="primary")
                                for nid in seed_ids]
        hops = plan.max_hops if plan.multi_hop else 1
        intent = plan.intent

        if intent == QueryIntent.FIND_USAGE:
            ctx.callers = self.find_transitive_callers(seed_ids, hops)
        elif intent == QueryIntent.FIND_CALLEES:
            ctx.callees = self.find_transitive_callees(seed_ids, hops)
        elif intent == QueryIntent.FIND_CALL_CHAIN:
            src_ids, dst_ids = self._chain_endpoints(plan, seed_ids)
            ctx.paths = self.find_call_chains(src_ids, dst_ids)
            if not ctx.paths:
                ctx.notes.append("no call path found within bounds")
        elif intent == QueryIntent.FIND_HIERARCHY:
            ctx.ancestors, ctx.descendants = self.find_full_hierarchy(seed_ids)
            ctx.methods = self.find_class_methods(seed_ids)
        elif intent == QueryIntent.FIND_METHODS:
            ctx.methods = self.find_class_methods(seed_ids)
        elif intent == QueryIntent.FIND_IMPORTS:
            file_ids = [nid for nid in seed_ids
                        if self.store.node(nid).entity_type.value == "file"]
            if not file_ids:
                file_ids = self._file_nodes_of(seed_ids)
            ctx.imports = self.find_imports(file_ids)
        elif intent == QueryIntent.FIND_FILE_CONTEXT:
            files = {self.store.node(nid).file_path for nid in seed_ids}
            ctx.file_entities = self.find_file_context([f for f in files if f])
        elif intent in (QueryIntent.FIND_IMPLEMENTATION, QueryIntent.EXPLAIN_CODE,
                        QueryIntent.DEBUG_HELP, QueryIntent.REFACTOR_HELP):
            ctx = self.implementation_context(seed_ids)
        else:
            # Comprehensive fallback: callers/callees/methods for top-3
            # entities (reference `engine.py:423-452`).
            top = seed_ids[:3]
            ctx.callers = self.find_transitive_callers(top, 1)
            ctx.callees = self.find_transitive_callees(top, 1)
            ctx.methods = self.find_class_methods(top)
        ctx.centrality = self.get_centrality(seed_ids)
        return ctx

    def _chain_endpoints(self, plan: QueryPlan, seed_ids: list[int]
                         ) -> tuple[list[int], list[int]]:
        if plan.relationships:
            rel = plan.relationships[0]
            src = self.find_entity(rel.source)
            dst = self.find_entity(rel.target)
            if src and dst:
                return src, dst
        if len(plan.entities) >= 2:
            src = self.find_entity(plan.entities[0].name)
            dst = self.find_entity(plan.entities[1].name)
            if src and dst:
                return src, dst
        half = max(len(seed_ids) // 2, 1)
        return seed_ids[:half], seed_ids[half:] or seed_ids[:half]

    def _file_nodes_of(self, seed_ids: list[int]) -> list[int]:
        from lattice_tpu_torch.graph.builder import FILE_NODE_PREFIX
        out = []
        for nid in seed_ids:
            path = self.store.node(nid).file_path
            fid = self.store.id_of(FILE_NODE_PREFIX + path)
            if fid is not None:
                out.append(fid)
        return out
