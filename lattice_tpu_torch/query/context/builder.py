"""Enriched-context construction from graph + vector evidence.

Parity target: reference `src/lattice/query/context/builder.py:32-337` —
code snippet per primary entity fetched from the vector payloads by
graph_node_id filter (`:111-134`), caller/callee one-liners (`:141-151`),
related entities (`:153-162`), call-chain "A -> B -> C" strings (`:187-199`),
hierarchy strings (`:201-219`), file summaries (`:246-277`), graph summary
sentence (`:279-302`), reasoning notes (`:304-337`).
"""

from __future__ import annotations

from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.query.context.models import (
    MAX_SNIPPET_CHARS,
    EnrichedContext,
    EntityContext,
)
from lattice_tpu_torch.query.graph_reasoning.models import GraphContext
from lattice_tpu_torch.query.query_planner import QueryPlan
from lattice_tpu_torch.query.ranking.models import RankedResult


class ContextBuilder:
    def __init__(self, code_store: ChunkStore | None = None,
                 summary_store: ChunkStore | None = None,
                 graph_store=None):
        self.code_store = code_store
        self.summary_store = summary_store
        self.graph_store = graph_store

    def _entity_neighbors(self, node_id: int) -> tuple[list[str], list[str]]:
        """Depth-1 CALLS callers/callees for ONE primary entity.

        Reference `:141-151` attaches caller/callee one-liners to each
        primary's EntityContext; fetching them per entity (one CSR row
        slice each way) keeps multi-entity plans from claiming the union
        of every primary's callers.
        """
        if self.graph_store is None:
            return [], []
        try:
            (callees,) = self.graph_store.neighbors([node_id], EdgeType.CALLS)
            (callers,) = self.graph_store.neighbors([node_id], EdgeType.CALLS,
                                                    reverse=True)
        except Exception:
            return [], []
        name = self.graph_store.node
        return ([name(n).qualified_name for n in callers[:8]],
                [name(n).qualified_name for n in callees[:8]])

    def _snippet_for(self, qualified_name: str) -> tuple[str, str | None, str | None]:
        """Fetch chunk content by graph_node_id (reference `:111-134`).

        The reference filters Qdrant by payload; here the inverted payload
        index answers directly.
        """
        if self.code_store is None:
            return "", None, None
        rows = self.code_store.scroll({"graph_node_id": qualified_name}, limit=1)
        if rows:
            payload = rows[0][1]
            return (payload.get("content", "")[:MAX_SNIPPET_CHARS],
                    payload.get("docstring"), payload.get("signature"))
        return "", None, None

    def build_enriched_context(
        self,
        plan: QueryPlan,
        graph_context: GraphContext,
        ranked: list[RankedResult],
    ) -> EnrichedContext:
        ctx = EnrichedContext()
        # Per-entity contexts for primaries (reference `:60-109`).
        # Global depth-1 lists are only the fallback when no graph store is
        # wired; with one, each primary gets its OWN depth-1 neighbors.
        callers_by_depth = [n.qualified_name for n in graph_context.callers
                            if n.depth == 1][:8]
        callees_by_depth = [n.qualified_name for n in graph_context.callees
                            if n.depth == 1][:8]
        for node in graph_context.primary_entities[:5]:
            snippet, docstring, signature = self._snippet_for(node.qualified_name)
            if not snippet:
                hit = next((r.content for r in ranked
                            if r.qualified_name == node.qualified_name
                            and r.content), "")
                snippet = hit[:MAX_SNIPPET_CHARS]
            callers, callees = self._entity_neighbors(node.node_id)
            if not callers and self.graph_store is None:
                callers = callers_by_depth
            if not callees and self.graph_store is None:
                callees = callees_by_depth
            ctx.entity_contexts.append(EntityContext(
                qualified_name=node.qualified_name,
                name=node.name,
                entity_type=node.entity_type,
                file_path=node.file_path,
                start_line=node.start_line,
                end_line=node.end_line,
                code_snippet=snippet,
                docstring=docstring,
                signature=signature,
                callers=callers,
                callees=callees,
                related=[m.qualified_name for m in graph_context.methods][:8],
            ))
        # Call-chain strings (reference `:187-199`).
        ctx.call_chains = [p.render() for p in graph_context.paths[:5]]
        # Hierarchy strings (reference `:201-219`).
        for node in graph_context.ancestors[:5]:
            ctx.hierarchy.append(f"{node.qualified_name} (ancestor, depth {node.depth})")
        for node in graph_context.descendants[:5]:
            ctx.hierarchy.append(f"{node.qualified_name} (descendant, depth {node.depth})")
        # File summaries from the summaries collection (reference `:246-277`).
        if self.summary_store is not None:
            files = {e.file_path for e in ctx.entity_contexts if e.file_path}
            for fpath in list(files)[:5]:
                rows = self.summary_store.scroll({"file_path": fpath}, limit=1)
                if rows:
                    ctx.file_summaries[fpath] = rows[0][1].get("content", "")
        ctx.graph_summary = self._graph_summary(graph_context)
        ctx.reasoning_notes = self._notes(plan, graph_context)
        return ctx

    def _graph_summary(self, g: GraphContext) -> str:
        """One-sentence structural summary (reference `:279-302`)."""
        parts = []
        if g.primary_entities:
            parts.append(f"{len(g.primary_entities)} matched entities")
        if g.callers:
            parts.append(f"{len(g.callers)} callers")
        if g.callees:
            parts.append(f"{len(g.callees)} callees")
        if g.paths:
            parts.append(f"{len(g.paths)} call paths")
        if g.ancestors or g.descendants:
            parts.append(f"{len(g.ancestors)} ancestors/{len(g.descendants)} descendants")
        if g.methods:
            parts.append(f"{len(g.methods)} methods")
        return ("Graph context: " + ", ".join(parts) + ".") if parts else \
            "Graph context: no structural matches."

    def _notes(self, plan: QueryPlan, g: GraphContext) -> list[str]:
        """Reasoning notes (reference `:304-337`)."""
        notes = list(g.notes)
        notes.append(f"intent={plan.intent.value} (source={plan.source})")
        if plan.multi_hop:
            notes.append(f"multi-hop traversal up to {plan.max_hops} hops")
        for qn, (out_deg, in_deg) in list(g.centrality.items())[:5]:
            if out_deg + in_deg > 0:
                notes.append(f"{qn}: {in_deg} callers in / {out_deg} calls out")
        return notes


def format_context_for_llm(ctx: EnrichedContext) -> str:
    """Render markdown sections (reference `context/formatter.py:4-79`)."""
    sections: list[str] = []
    if ctx.graph_summary:
        sections.append(f"## Graph overview\n{ctx.graph_summary}")
    for ec in ctx.entity_contexts:
        lines = [f"## {ec.qualified_name} ({ec.entity_type})",
                 f"Location: {ec.file_path}:{ec.start_line}-{ec.end_line}"]
        if ec.signature:
            lines.append(f"Signature: `{ec.signature}`")
        if ec.docstring:
            lines.append(f"Doc: {ec.docstring}")
        if ec.callers:
            lines.append("Called by: " + ", ".join(ec.callers))
        if ec.callees:
            lines.append("Calls: " + ", ".join(ec.callees))
        if ec.related:
            lines.append("Related: " + ", ".join(ec.related))
        if ec.code_snippet:
            lines.append(f"```\n{ec.code_snippet}\n```")
        sections.append("\n".join(lines))
    if ctx.call_chains:
        sections.append("## Call chains\n" + "\n".join(ctx.call_chains))
    if ctx.hierarchy:
        sections.append("## Hierarchy\n" + "\n".join(ctx.hierarchy))
    if ctx.file_summaries:
        lines = [f"- {path}: {summary}" for path, summary in ctx.file_summaries.items()]
        sections.append("## File summaries\n" + "\n".join(lines))
    if ctx.reasoning_notes:
        sections.append("## Notes\n" + "\n".join(f"- {n}" for n in ctx.reasoning_notes))
    return "\n\n".join(sections)
