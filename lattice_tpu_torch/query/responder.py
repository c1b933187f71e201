"""Answer synthesis.

Parity target: reference `src/lattice/query/responder.py:11-225`
(`ResponseGenerator`: traceability-focused system prompt, query/explanation
templates, context assembly with truncation). The reference's engine also
bypassed this class with a direct OpenAI call (`engine.py:391-405`, SURVEY
§2.2); here the engine always goes through the ResponseGenerator, which
degrades to a deterministic extractive answer when no LLM is configured —
so `query` works offline, not just `search`.
"""

from __future__ import annotations

import logging

from lattice_tpu_torch.query.context.builder import format_context_for_llm
from lattice_tpu_torch.query.context.models import EnrichedContext
from lattice_tpu_torch.query.query_planner import QueryIntent, QueryPlan
from lattice_tpu_torch.query.ranking.models import RankedResult

logger = logging.getLogger(__name__)

SYSTEM_PROMPT = (
    "You are a precise code-navigation assistant. Answer using ONLY the "
    "provided repository context. Always cite evidence as `file:line` for "
    "every claim. If the context does not contain the answer, say what is "
    "missing instead of guessing. Prefer structure (call chains, class "
    "hierarchy) over prose when it answers the question."
)

# Intent-specialized synthesis guidance appended to the base system prompt.
# Parity target: reference `src/lattice/query/engine.py:407-507`
# (`_get_enhanced_system_prompt`: per-intent focus blocks for callers,
# callees, call chains, hierarchy, implementation, data flow, search).
# The reference keys 7 of its intents; this table covers the same ground
# mapped onto this planner's 17-intent taxonomy.
INTENT_PROMPTS: dict[QueryIntent, str] = {
    QueryIntent.FIND_USAGE: (
        "\nIntent focus — callers: list every call site with file:line, say "
        "how each caller uses the entity (arguments, what it does with the "
        "result), and flag the most significant callers first."),
    QueryIntent.FIND_CALLEES: (
        "\nIntent focus — dependencies: list what the entity calls with "
        "file:line, explain why each dependency exists, separate essential "
        "from optional callees, and note external-library calls."),
    QueryIntent.FIND_CALL_CHAIN: (
        "\nIntent focus — call chain: show the complete path from source to "
        "target, one hop per line with file:line, describe how data changes "
        "at each hop, and mention alternative branches if any exist."),
    QueryIntent.FIND_HIERARCHY: (
        "\nIntent focus — class hierarchy: render the full inheritance tree "
        "(ancestors and descendants), state what each level adds or "
        "overrides, and name the design pattern if one applies."),
    QueryIntent.FIND_METHODS: (
        "\nIntent focus — class surface: enumerate the class's methods with "
        "signatures and one-line purposes, grouping overrides separately."),
    QueryIntent.FIND_IMPLEMENTATION: (
        "\nIntent focus — implementation deep-dive: walk through the "
        "algorithm step by step, call out key design decisions, edge-case "
        "handling, and what the code relies on to work correctly."),
    QueryIntent.EXPLAIN_CODE: (
        "\nIntent focus — explanation: walk through how the code works step "
        "by step, why it is implemented this way, and how it handles "
        "unusual inputs or errors."),
    QueryIntent.EXPLAIN_ARCHITECTURE: (
        "\nIntent focus — data/control flow: trace where data originates, "
        "what transforms it at each step, which components touch it, and "
        "where it ends up."),
    QueryIntent.FIND_DEFINITION: (
        "\nIntent focus — definition: state exactly where the entity is "
        "defined (file:line), its signature, and its docstring before any "
        "broader discussion."),
    QueryIntent.FIND_IMPORTS: (
        "\nIntent focus — imports: list what the file/module imports and "
        "what imports it, separating internal modules from third-party."),
    QueryIntent.FIND_EXAMPLES: (
        "\nIntent focus — usage examples: show concrete call sites as "
        "short snippets with file:line, preferring idiomatic uses."),
    QueryIntent.DEBUG_HELP: (
        "\nIntent focus — debugging: reason from the evidence to likely "
        "fault locations, state what each hypothesis predicts, and say "
        "which file:line to inspect or instrument next."),
    QueryIntent.REFACTOR_HELP: (
        "\nIntent focus — refactoring: identify the coupling and "
        "duplication visible in the context, propose the smallest safe "
        "change, and list every call site the change would touch."),
    QueryIntent.API_USAGE: (
        "\nIntent focus — API usage: show how to call the entity correctly "
        "(parameters, return value, errors) with evidence from real call "
        "sites in the context."),
    QueryIntent.GENERAL_SEARCH: (
        "\nIntent focus — functionality search: say where the functionality "
        "lives, which classes/functions participate, and how a developer "
        "would use or extend it."),
    QueryIntent.FIND_SIMILAR: (
        "\nIntent focus — similar code: for each match explain WHAT makes "
        "it similar (shared structure, naming, call pattern) with "
        "file:line, ordered by similarity score."),
    QueryIntent.FIND_FILE_CONTEXT: (
        "\nIntent focus — file context: summarize what the file contains, "
        "the role of each top-level entity, and how the file's entities "
        "relate to the rest of the codebase."),
}


def system_prompt_for(intent: QueryIntent) -> str:
    """Base prompt + per-intent focus block (reference `engine.py:407-507`)."""
    return SYSTEM_PROMPT + INTENT_PROMPTS.get(intent, "")

ANSWER_TEMPLATE = (
    "Question: {query}\n"
    "Detected intent: {intent}\n\n"
    "Repository context:\n{context}\n\n"
    "Answer the question with file:line citations."
)

MAX_CONTEXT_CHARS = 20000


class ResponseGenerator:
    def __init__(self, llm_provider=None):
        self.llm = llm_provider

    async def generate(self, plan: QueryPlan, context: EnrichedContext,
                       ranked: list[RankedResult]) -> str:
        rendered = format_context_for_llm(context)[:MAX_CONTEXT_CHARS]
        if self.llm is not None:
            try:
                return await self.llm.complete([
                    {"role": "system", "content": system_prompt_for(plan.intent)},
                    {"role": "user", "content": ANSWER_TEMPLATE.format(
                        query=plan.raw_query, intent=plan.intent.value,
                        context=rendered)},
                ])
            except Exception as exc:
                logger.warning("LLM answer failed (%s); extractive fallback", exc)
        return self.extractive_answer(plan, context, ranked)

    def extractive_answer(self, plan: QueryPlan, context: EnrichedContext,
                          ranked: list[RankedResult]) -> str:
        """Deterministic answer assembled from retrieved evidence."""
        lines: list[str] = []
        if context.graph_summary:
            lines.append(context.graph_summary)
        if context.call_chains:
            lines.append("Call chains:")
            lines.extend(f"  {c}" for c in context.call_chains[:5])
        if context.hierarchy:
            lines.append("Hierarchy:")
            lines.extend(f"  {h}" for h in context.hierarchy[:8])
        if ranked:
            lines.append("Top results:")
            for r in ranked[:8]:
                loc = f"{r.file_path}:{r.start_line}" if r.file_path else "?"
                rel = f" [{r.relationship}]" if r.relationship else ""
                lines.append(
                    f"  {r.qualified_name or r.name} ({r.entity_type}) {loc}"
                    f"{rel} score={r.score:.3f}")
        for ec in context.entity_contexts[:2]:
            if ec.code_snippet:
                lines.append(f"Snippet {ec.file_path}:{ec.start_line}:")
                snippet = ec.code_snippet[:600]
                lines.append("```\n" + snippet + "\n```")
        if not lines:
            lines.append("No matching entities or chunks were found for this query.")
        return "\n".join(lines)
