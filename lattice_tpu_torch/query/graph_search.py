"""Name-based graph search convenience API.

Parity target: reference `src/lattice/query/graph_search.py:48-374`
(`GraphSearcher` over Memgraph: find_entity_by_name, find_callers/callees
by function name, class hierarchy, file dependencies, file entities,
search_by_name with entity-type validation, related entities, statistics).
Implemented over the in-process GraphStore; used by the MCP snippet tool
and available to embedders of the framework that want direct lookups
without a QueryPlan.
"""

from __future__ import annotations

from dataclasses import dataclass

from lattice_tpu_torch.core.errors import QueryError
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.graph_store import GraphStore

_VALID_ENTITY_TYPES = {e.value for e in EntityType}


@dataclass(slots=True)
class EntitySearchResult:
    """Reference: `graph_search.py:10-28`."""

    qualified_name: str
    name: str
    entity_type: str
    file_path: str
    start_line: int
    end_line: int
    score: float = 1.0


@dataclass(slots=True)
class RelatedEntityResult:
    """Reference: `graph_search.py:31-45`."""

    entity: EntitySearchResult
    relationship: str
    depth: int = 1


class GraphSearcher:
    def __init__(self, store: GraphStore):
        self.store = store

    def _materialize(self, node_id: int, score: float = 1.0) -> EntitySearchResult:
        rec = self.store.node(node_id)
        return EntitySearchResult(
            qualified_name=rec.qualified_name, name=rec.name,
            entity_type=rec.entity_type.value, file_path=rec.file_path,
            start_line=rec.start_line, end_line=rec.end_line, score=score)

    def _ids_for_name(self, name: str) -> list[int]:
        ids = self.store.find_by_name(name)
        if ids:
            return ids
        return [nid for nid, _ in self.store.find_fuzzy(name, limit=5)]

    # ---- lookups (reference `:56-118`) ---------------------------------

    def find_entity_by_name(self, name: str,
                            entity_type: str | None = None
                            ) -> list[EntitySearchResult]:
        if entity_type is not None:
            self._validate_entity_type(entity_type)
        out = [self._materialize(nid) for nid in self._ids_for_name(name)]
        if entity_type is not None:
            out = [r for r in out if r.entity_type == entity_type]
        return out

    def find_callers(self, function_name: str,
                     max_hops: int = 1) -> list[RelatedEntityResult]:
        seeds = self._ids_for_name(function_name)
        reached = self.store.k_hop(seeds, EdgeType.CALLS, max_hops,
                                   reverse=True)
        return [RelatedEntityResult(self._materialize(nid), "caller", depth)
                for nid, depth in sorted(reached.items(),
                                         key=lambda kv: kv[1])]

    def find_callees(self, function_name: str,
                     max_hops: int = 1) -> list[RelatedEntityResult]:
        seeds = self._ids_for_name(function_name)
        reached = self.store.k_hop(seeds, EdgeType.CALLS, max_hops)
        return [RelatedEntityResult(self._materialize(nid), "callee", depth)
                for nid, depth in sorted(reached.items(),
                                         key=lambda kv: kv[1])]

    def find_class_hierarchy(self, class_name: str) -> list[RelatedEntityResult]:
        """Reference: `:146-173` (ancestors + descendants)."""
        seeds = self._ids_for_name(class_name)
        out: list[RelatedEntityResult] = []
        for nid, depth in self.store.k_hop(seeds, EdgeType.EXTENDS, 5).items():
            out.append(RelatedEntityResult(self._materialize(nid),
                                           "ancestor", depth))
        for nid, depth in self.store.k_hop(seeds, EdgeType.EXTENDS, 5,
                                           reverse=True).items():
            out.append(RelatedEntityResult(self._materialize(nid),
                                           "descendant", depth))
        return out

    def find_file_dependencies(self, file_path: str) -> list[EntitySearchResult]:
        """IMPORTS edges from a file node (reference `:174-201`)."""
        from lattice_tpu_torch.graph.builder import FILE_NODE_PREFIX
        fid = self.store.id_of(FILE_NODE_PREFIX + file_path)
        if fid is None:
            return []
        return [self._materialize(nid)
                for nid in self.store.neighbors([fid], EdgeType.IMPORTS)[0]]

    def get_file_entities(self, file_path: str) -> list[EntitySearchResult]:
        """Reference: `:202-229`."""
        return [self._materialize(nid)
                for nid in self.store.nodes_in_file(file_path)
                if not self.store.node(nid).qualified_name.startswith("file:")]

    def search_by_name(self, text: str, entity_type: str | None = None,
                       limit: int = 20) -> list[EntitySearchResult]:
        """Contains-match with CASE scoring (reference `:230-262`)."""
        if entity_type is not None:
            self._validate_entity_type(entity_type)
        out = [self._materialize(nid, score)
               for nid, score in self.store.find_fuzzy(text, limit=limit * 2)]
        if entity_type is not None:
            out = [r for r in out if r.entity_type == entity_type]
        return out[:limit]

    def find_related_entities(self, name: str,
                              max_results: int = 25) -> list[RelatedEntityResult]:
        """Callers + callees + hierarchy + same-file (reference `:263-309`)."""
        out: list[RelatedEntityResult] = []
        out.extend(self.find_callers(name))
        out.extend(self.find_callees(name))
        out.extend(self.find_class_hierarchy(name))
        for seed in self._ids_for_name(name)[:1]:
            path = self.store.node(seed).file_path
            for result in self.get_file_entities(path):
                if result.qualified_name != self.store.node(seed).qualified_name:
                    out.append(RelatedEntityResult(result, "same_file"))
        seen: set[str] = set()
        unique = []
        for r in out:
            if r.entity.qualified_name not in seen:
                seen.add(r.entity.qualified_name)
                unique.append(r)
        return unique[:max_results]

    def get_statistics(self) -> dict:
        """Reference: `:310-327`."""
        return self.store.stats

    def _validate_entity_type(self, entity_type: str) -> None:
        """Reference: `:328-340`."""
        if entity_type not in _VALID_ENTITY_TYPES:
            raise QueryError(
                f"invalid entity type {entity_type!r}; "
                f"one of {sorted(_VALID_ENTITY_TYPES)}")
