"""Enriched-context models.

Parity target: reference `src/lattice/query/context/models.py:6-45`
(`EnrichedContext`: entity contexts, call-chain & hierarchy explanations,
file summaries, code snippets, graph summary, reasoning notes; snippet
truncation cap).
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_SNIPPET_CHARS = 3000  # reference `context/models.py:6`


@dataclass(slots=True)
class EntityContext:
    """Per-entity enrichment (reference `models.py:12-30`)."""

    qualified_name: str
    name: str
    entity_type: str
    file_path: str
    start_line: int
    end_line: int
    code_snippet: str = ""
    docstring: str | None = None
    signature: str | None = None
    callers: list[str] = field(default_factory=list)
    callees: list[str] = field(default_factory=list)
    related: list[str] = field(default_factory=list)


@dataclass(slots=True)
class EnrichedContext:
    """Reference: `context/models.py:33-45`."""

    entity_contexts: list[EntityContext] = field(default_factory=list)
    call_chains: list[str] = field(default_factory=list)
    hierarchy: list[str] = field(default_factory=list)
    file_summaries: dict[str, str] = field(default_factory=dict)
    graph_summary: str = ""
    reasoning_notes: list[str] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not (self.entity_contexts or self.call_chains or self.hierarchy
                    or self.file_summaries)
