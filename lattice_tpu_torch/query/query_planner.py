"""Query planning: intent classification + entity extraction.

Parity target: reference `src/lattice/query/query_planner.py` — 17
`QueryIntent`s (`:24-45`), plan dataclasses (`:47-91`), an LLM planner with
JSON-schema prompt and robust JSON extraction (`:94-288`), and a
regex-heuristic fallback used on any LLM failure (`:396-465`).

In this framework the heuristic planner is the *primary* path (offline,
deterministic, zero-latency) and the LLM planner is the optional upgrade
when a provider is configured — inverting the reference's priority but
keeping both components and identical fallback semantics.
"""

from __future__ import annotations

import enum
import json
import logging
import re
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


class QueryIntent(str, enum.Enum):
    """Reference: 17 intents (`query_planner.py:24-45`)."""

    FIND_DEFINITION = "find_definition"
    FIND_USAGE = "find_usage"                  # who calls X
    FIND_CALLEES = "find_callees"              # what X calls
    FIND_CALL_CHAIN = "find_call_chain"        # path A -> B
    FIND_HIERARCHY = "find_hierarchy"          # inheritance tree
    FIND_IMPLEMENTATION = "find_implementation"
    FIND_SIMILAR = "find_similar"
    FIND_METHODS = "find_methods"              # methods of a class
    FIND_IMPORTS = "find_imports"              # file/module deps
    FIND_FILE_CONTEXT = "find_file_context"
    FIND_EXAMPLES = "find_examples"
    EXPLAIN_CODE = "explain_code"
    EXPLAIN_ARCHITECTURE = "explain_architecture"
    DEBUG_HELP = "debug_help"
    REFACTOR_HELP = "refactor_help"
    API_USAGE = "api_usage"
    GENERAL_SEARCH = "general_search"


# Intents answered primarily by graph traversal vs vector similarity
# (per-intent search type, reference `:370-394`).
GRAPH_INTENTS = {
    QueryIntent.FIND_USAGE, QueryIntent.FIND_CALLEES,
    QueryIntent.FIND_CALL_CHAIN, QueryIntent.FIND_HIERARCHY,
    QueryIntent.FIND_METHODS, QueryIntent.FIND_IMPORTS,
    QueryIntent.FIND_FILE_CONTEXT,
}
VECTOR_INTENTS = {
    QueryIntent.FIND_SIMILAR, QueryIntent.FIND_EXAMPLES,
    QueryIntent.GENERAL_SEARCH, QueryIntent.EXPLAIN_ARCHITECTURE,
}
SUMMARY_INTENTS = {
    # Intents that additionally search the summaries collection
    # (reference `engine.py:332-346`).
    QueryIntent.EXPLAIN_CODE, QueryIntent.EXPLAIN_ARCHITECTURE,
    QueryIntent.FIND_IMPLEMENTATION,
}


@dataclass(slots=True)
class ExtractedEntity:
    """Reference: `query_planner.py:47-56`."""

    name: str
    entity_type_hint: str | None = None   # class|function|method|file|None
    confidence: float = 1.0


def _confident(entities) -> bool:
    """Graph-only routing needs a seed worth trusting: a lone
    0.5-confidence capitalized English word ("... the Python tokenizer")
    must not flip hybrid -> graph and feed fuzzy junk seeds to the BFS."""
    return any(e.confidence >= 0.6 for e in entities)


@dataclass(slots=True)
class QueryRelationship:
    """Reference: `query_planner.py:58-66`."""

    source: str
    target: str
    relation: str = "CALLS"


@dataclass(slots=True)
class SubQuery:
    """Reference: `query_planner.py:68-75`."""

    text: str
    intent: "QueryIntent"


@dataclass(slots=True)
class QueryPlan:
    """Reference: `query_planner.py:77-91`."""

    raw_query: str
    intent: QueryIntent = QueryIntent.GENERAL_SEARCH
    entities: list[ExtractedEntity] = field(default_factory=list)
    relationships: list[QueryRelationship] = field(default_factory=list)
    sub_queries: list[SubQuery] = field(default_factory=list)
    multi_hop: bool = False
    max_hops: int = 3
    search_type: str = "hybrid"   # graph | vector | hybrid
    keywords: list[str] = field(default_factory=list)
    source: str = "heuristic"     # heuristic | llm

    @property
    def entity_names(self) -> list[str]:
        return [e.name for e in self.entities]


# ---- heuristic planner --------------------------------------------------

_INTENT_PATTERNS: list[tuple[QueryIntent, re.Pattern]] = [
    (QueryIntent.FIND_CALL_CHAIN,
     re.compile(r"\b(call\s*chain|path\s+(from|between)|how\s+does\s+.*\breach|flow\s+from)\b", re.I)),
    (QueryIntent.FIND_USAGE,
     re.compile(r"\b(who\s+calls|callers?\s+of|used\s+by|usages?\s+of|where\s+is\s+.*\b(used|called)|references?\s+to)\b", re.I)),
    (QueryIntent.FIND_CALLEES,
     re.compile(r"\b(what\s+does\s+.*\bcall|callees?\s+of|calls\s+(out|into)|functions?\s+called\s+by|depends?\s+on\b)", re.I)),
    (QueryIntent.FIND_HIERARCHY,
     re.compile(r"\b(inherit(s|ance)?|subclass(es)?|superclass(es)?|extends?|base\s+class(es)?|class\s+hierarchy|derived)\b", re.I)),
    (QueryIntent.FIND_METHODS,
     re.compile(r"\b(methods?\s+(of|on|in)|what\s+methods)\b", re.I)),
    (QueryIntent.FIND_IMPORTS,
     re.compile(r"\b(imports?|dependencies\s+of|what\s+does\s+.*\bimport)\b", re.I)),
    (QueryIntent.FIND_FILE_CONTEXT,
     re.compile(r"\b(what('s| is)\s+in\s+(the\s+)?file|file\s+overview|contents?\s+of\s+\S+\.(py|ts|js|tsx|jsx))\b", re.I)),
    (QueryIntent.FIND_IMPLEMENTATION,
     re.compile(r"\b(how\s+is\s+.*\bimplemented|implementation\s+of|how\s+does\s+.*\bwork)\b", re.I)),
    (QueryIntent.FIND_SIMILAR,
     re.compile(r"\b(similar\s+to|like\s+this|alternatives?\s+to|related\s+code)\b", re.I)),
    (QueryIntent.FIND_EXAMPLES,
     re.compile(r"\b(examples?\s+of|sample|how\s+to\s+use|usage\s+example)\b", re.I)),
    (QueryIntent.EXPLAIN_ARCHITECTURE,
     re.compile(r"\b(architecture|structure\s+of\s+the|overview|high.level|design\s+of)\b", re.I)),
    (QueryIntent.EXPLAIN_CODE,
     re.compile(r"\b(explain|what\s+does\s+.*\bdo|describe|understand)\b", re.I)),
    (QueryIntent.DEBUG_HELP,
     re.compile(r"\b(bug|error|exception|crash|fix|fails?|broken|traceback)\b", re.I)),
    (QueryIntent.REFACTOR_HELP,
     re.compile(r"\b(refactor|clean\s*up|simplify|restructure|improve)\b", re.I)),
    (QueryIntent.API_USAGE,
     re.compile(r"\b(api|endpoint|route|interface\s+for|public\s+methods)\b", re.I)),
    (QueryIntent.FIND_DEFINITION,
     re.compile(r"\b(where\s+is\s+.*\b(defined|declared)|definition\s+of|find\s+(the\s+)?(class|function|method)|locate)\b", re.I)),
]

_MULTI_HOP_RE = re.compile(
    r"\b(transitive(ly)?|indirect(ly)?|recursive(ly)?|all\s+the\s+way|"
    r"chain|eventually|deep(ly)?|through)\b", re.I)

_BACKTICK_RE = re.compile(r"`([^`]+)`")
_DOTTED_RE = re.compile(r"\b([A-Za-z_][\w]*(?:\.[A-Za-z_][\w]*)+)\b")
_CAMEL_RE = re.compile(r"\b([A-Z][a-z0-9]+(?:[A-Z][a-z0-9]*)+)\b")
# lowerCamelCase (fetchTasks, getStore): the dominant JS/TS function
# style — the golden eval exposed that usage queries naming them got NO
# graph phase at all (r5; UpperCamel requires a leading capital and the
# snake pattern requires an underscore)
_LOWER_CAMEL_RE = re.compile(r"\b([a-z][a-z0-9]+(?:[A-Z][a-z0-9]*)+)\b")
_SNAKE_CALL_RE = re.compile(r"\b([a-z_][a-z0-9_]*_[a-z0-9_]+)\b")
_PAREN_CALL_RE = re.compile(r"\b([A-Za-z_][\w]*)\s*\(\)")
# Single Capitalized word ("subclasses of Repository", "methods of
# Middleware"): CamelCase requires two humps, so one-word class names
# got NO graph phase at all (r5 golden-eval ordering pass). Extracted
# at low confidence; sentence-initial words are skipped by the caller.
_SINGLE_CAP_RE = re.compile(r"\b([A-Z][a-z0-9]{2,})\b")
# abbreviation periods are not sentence ends: "e.g. Repository" keeps
# Repository extractable
_ABBREV_RE = re.compile(r"\b(?:e\.g|i\.e|cf|vs|etc|et al)\.$",
                        re.IGNORECASE)
# Relation-phrase object: "callers of tokenize", "who calls tokenize"
# — the word after the relation phrase IS the subject even when it is
# a plain lowercase word no identifier pattern matches.
_REL_OBJ_RE = re.compile(
    r"\b(?:callers?|callees?|methods?|members?|subclass(?:es)?|"
    r"superclass(?:es)?|usages?|implementations?|definitions?|"
    r"dependencies)\s+of\s+([A-Za-z_][\w.]*)|"
    r"\bwho\s+calls\s+([A-Za-z_][\w.]*)|"
    r"\bwhat\s+does\s+([A-Za-z_][\w.]*)\s+(?:call|extend|import|do)\b",
    re.I)
_FILE_RE = re.compile(r"\b([\w./-]+\.(?:py|pyi|js|jsx|ts|tsx|mjs|cjs))\b")

_STOPWORDS = frozenset(
    "the a an of to in for from by with and or is are was were does do did "
    "how what where who which when why show me find all any that this "
    "function class method file code "
    # abbreviations: _DOTTED_RE would otherwise extract "e.g" as a
    # 0.9-confidence dotted entity
    "e.g i.e etc vs cf".split())


class QueryPlanner:
    """Heuristic-first planner with optional LLM upgrade."""

    def __init__(self, llm_provider=None, max_hops_default: int = 3):
        self.llm = llm_provider
        self.max_hops_default = max_hops_default

    # -- heuristic path (reference fallback `:396-465`, primary here) ----

    def plan_heuristic(self, query: str) -> QueryPlan:
        intent = QueryIntent.GENERAL_SEARCH
        for candidate, pattern in _INTENT_PATTERNS:
            if pattern.search(query):
                intent = candidate
                break
        entities = self._extract_entities(query)
        multi_hop = bool(_MULTI_HOP_RE.search(query)) or intent in (
            QueryIntent.FIND_CALL_CHAIN,)
        if intent in GRAPH_INTENTS:
            search_type = "graph" if _confident(entities) else "hybrid"
        elif intent in VECTOR_INTENTS:
            search_type = "vector"
        else:
            search_type = "hybrid"
        relationships = []
        if intent == QueryIntent.FIND_CALL_CHAIN and len(entities) >= 2:
            relationships.append(QueryRelationship(
                source=entities[0].name, target=entities[1].name,
                relation="CALLS"))
        keywords = [w for w in re.findall(r"[A-Za-z_][\w]*", query.lower())
                    if w not in _STOPWORDS][:12]
        return QueryPlan(
            raw_query=query, intent=intent, entities=entities,
            relationships=relationships, multi_hop=multi_hop,
            max_hops=5 if multi_hop else self.max_hops_default,
            search_type=search_type, keywords=keywords, source="heuristic",
        )

    def _extract_entities(self, query: str) -> list[ExtractedEntity]:
        """Backticks > files > dotted > CamelCase > snake_case > foo().

        Reference: `:415-447`.
        """
        out: list[ExtractedEntity] = []
        seen: set[str] = set()

        def add(name: str, hint: str | None, conf: float) -> None:
            name = name.strip().strip("`'\"")
            if name and name.lower() not in _STOPWORDS and name not in seen:
                seen.add(name)
                out.append(ExtractedEntity(name, hint, conf))

        for m in _BACKTICK_RE.finditer(query):
            add(m.group(1).rstrip("()"), None, 1.0)
        for m in _FILE_RE.finditer(query):
            add(m.group(1), "file", 0.95)
        stripped = _BACKTICK_RE.sub(" ", query)
        for m in _DOTTED_RE.finditer(stripped):
            if not _FILE_RE.search(m.group(1)):
                add(m.group(1), None, 0.9)
        for m in _CAMEL_RE.finditer(stripped):
            add(m.group(1), "class", 0.8)
        for m in _LOWER_CAMEL_RE.finditer(stripped):
            add(m.group(1), "function", 0.75)
        for m in _PAREN_CALL_RE.finditer(stripped):
            add(m.group(1), "function", 0.85)
        for m in _SNAKE_CALL_RE.finditer(stripped):
            add(m.group(1), "function", 0.6)
        for m in _REL_OBJ_RE.finditer(stripped):
            name = next(g for g in m.groups() if g)
            add(name.rstrip(".?!,"), None, 0.85)
        for m in _SINGLE_CAP_RE.finditer(stripped):
            # skip sentence-initial words — "Show me ..." is not an
            # entity; mid-sentence Capitalized words usually are. A word
            # is sentence-initial when nothing but whitespace or
            # end-of-sentence punctuation precedes it (offset 0 alone
            # misses leading spaces, stripped backticks, and second
            # sentences: "Find usages. Explain the flow").
            prefix = stripped[:m.start()].rstrip()
            if prefix and (prefix[-1] not in ".!?"
                           or _ABBREV_RE.search(prefix)):
                add(m.group(1), "class", 0.5)
        return out[:8]

    # -- LLM path --------------------------------------------------------

    PLAN_PROMPT = (
        "You are a code-search query planner. Classify the user's question "
        "into exactly one intent from this list:\n{intents}\n"
        "Extract code entity names mentioned (classes, functions, methods, "
        "files). Detect whether multi-hop graph traversal is needed.\n"
        "Answer with ONLY a JSON object:\n"
        '{{"intent": "...", "entities": [{{"name": "...", "type": "class|'
        'function|method|file|null"}}], "multi_hop": false, '
        '"relationships": [{{"source": "...", "target": "...", '
        '"relation": "CALLS"}}]}}\n\nQuestion: {query}'
    )

    async def plan_query(self, query: str) -> QueryPlan:
        """LLM plan with heuristic fallback. Reference: `:191-240`."""
        heuristic = self.plan_heuristic(query)
        if self.llm is None:
            return heuristic
        try:
            raw = await self.llm.complete([{
                "role": "user",
                "content": self.PLAN_PROMPT.format(
                    intents=", ".join(i.value for i in QueryIntent),
                    query=query),
            }])
            data = extract_json(raw)
            if data is None:
                return heuristic
            return self._plan_from_json(query, data, heuristic)
        except Exception as exc:
            logger.warning("LLM planning failed (%s); heuristic fallback", exc)
            return heuristic

    def _plan_from_json(self, query: str, data: dict,
                        heuristic: QueryPlan) -> QueryPlan:
        """Reference plan construction: `:290-368`."""
        try:
            intent = QueryIntent(data.get("intent", "general_search"))
        except ValueError:
            intent = heuristic.intent
        entities = [
            ExtractedEntity(e["name"], e.get("type") or None, 0.9)
            for e in data.get("entities", []) if isinstance(e, dict) and e.get("name")
        ] or heuristic.entities
        relationships = [
            QueryRelationship(r.get("source", ""), r.get("target", ""),
                              r.get("relation", "CALLS"))
            for r in data.get("relationships", []) if isinstance(r, dict)
        ]
        multi_hop = bool(data.get("multi_hop", heuristic.multi_hop))
        if intent in GRAPH_INTENTS:
            search_type = "graph" if _confident(entities) else "hybrid"
        elif intent in VECTOR_INTENTS:
            search_type = "vector"
        else:
            search_type = "hybrid"
        return QueryPlan(
            raw_query=query, intent=intent, entities=entities,
            relationships=relationships, multi_hop=multi_hop,
            max_hops=5 if multi_hop else self.max_hops_default,
            search_type=search_type, keywords=heuristic.keywords, source="llm",
        )


def extract_json(text: str) -> dict | None:
    """Robust JSON extraction: code fences -> brace slice -> None.

    Reference: `query_planner.py:242-288`.
    """
    text = text.strip()
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    if fence:
        text = fence.group(1).strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    start = text.find("{")
    if start == -1:
        return None
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                try:
                    return json.loads(text[start:i + 1])
                except json.JSONDecodeError:
                    return None
    return None
