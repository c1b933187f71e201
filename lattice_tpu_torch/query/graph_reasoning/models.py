"""Graph-reasoning result models.

Parity target: reference `src/lattice/query/graph_reasoning/models.py`
(`GraphNode` :18, `GraphPath` :34, `GraphContext` :42, traversal caps :5-8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Traversal caps (reference `graph_reasoning/models.py:5-8`).
MAX_HOPS = 5
MAX_RESULTS_PER_QUERY = 50
MAX_PATH_LENGTH = 10


@dataclass(slots=True)
class GraphNode:
    """Reference: `models.py:18-31`."""

    node_id: int
    qualified_name: str
    name: str
    entity_type: str
    file_path: str
    start_line: int = 0
    end_line: int = 0
    depth: int = 0                  # hops from the query entity
    relationship: str = ""          # how it relates (caller/callee/parent/...)
    in_degree: int = 0
    out_degree: int = 0


@dataclass(slots=True)
class GraphPath:
    """Reference: `models.py:34-39`."""

    nodes: list[GraphNode]
    edge_type: str = "CALLS"

    @property
    def length(self) -> int:
        return max(len(self.nodes) - 1, 0)

    def render(self) -> str:
        return " -> ".join(n.name for n in self.nodes)


@dataclass(slots=True)
class GraphContext:
    """Everything the graph side contributes to one query.

    Reference: `models.py:42-60`.
    """

    primary_entities: list[GraphNode] = field(default_factory=list)
    callers: list[GraphNode] = field(default_factory=list)
    callees: list[GraphNode] = field(default_factory=list)
    ancestors: list[GraphNode] = field(default_factory=list)
    descendants: list[GraphNode] = field(default_factory=list)
    methods: list[GraphNode] = field(default_factory=list)
    file_entities: list[GraphNode] = field(default_factory=list)
    imports: list[GraphNode] = field(default_factory=list)
    paths: list[GraphPath] = field(default_factory=list)
    centrality: dict[str, tuple[int, int]] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not (self.primary_entities or self.callers or self.callees
                    or self.ancestors or self.descendants or self.methods
                    or self.file_entities or self.paths)

    def all_nodes(self) -> list[GraphNode]:
        out: list[GraphNode] = []
        seen: set[int] = set()
        for group in (self.primary_entities, self.callers, self.callees,
                      self.ancestors, self.descendants, self.methods,
                      self.file_entities, self.imports):
            for node in group:
                if node.node_id not in seen:
                    seen.add(node.node_id)
                    out.append(node)
        for path in self.paths:
            for node in path.nodes:
                if node.node_id not in seen:
                    seen.add(node.node_id)
                    out.append(node)
        return out
