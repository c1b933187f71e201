"""MCP tool implementations (torch port).

Port of `lattice_tpu/mcp/tools.py` (reference parity target:
`src/lattice/mcp/tools.py:64-462`) — the reference's four tools:
`index_repository` (`:64-140`), `query_code_graph` (`:143-228`),
`get_code_snippet` with a path-traversal guard (`:231-365`, guard
`:300-307`), `semantic_search` (`:368-462`), and `deep_search_batch`.
Components are constructed lazily on first use (reference
`mcp/server.py:66-98`), from the port's provider factory, persistence,
orchestrator and `QueryEngine`, on the device the context is given. The
reference's MCP query tool read a field that didn't exist on QueryResult
(SURVEY §2.2); here it reads `query_plan`, which does.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch

from lattice_tpu_torch.config.settings import Settings

logger = logging.getLogger(__name__)


TOOL_SCHEMAS: list[dict[str, Any]] = [
    {
        "name": "index_repository",
        "description": "Index a repository into the graph + vector stores.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "path": {"type": "string", "description": "repository root"},
                "project": {"type": "string"},
                "force": {"type": "boolean", "default": False},
            },
            "required": ["path"],
        },
    },
    {
        "name": "query_code_graph",
        "description": "Ask a natural-language question about the indexed "
                       "code (hybrid graph + semantic retrieval + answer).",
        "inputSchema": {
            "type": "object",
            "properties": {
                "question": {"type": "string"},
                "limit": {"type": "integer", "default": 15},
            },
            "required": ["question"],
        },
    },
    {
        "name": "get_code_snippet",
        "description": "Fetch source lines for an entity by qualified name.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "entity": {"type": "string",
                           "description": "qualified or simple name"},
                "context_lines": {"type": "integer", "default": 0},
            },
            "required": ["entity"],
        },
    },
    {
        "name": "semantic_search",
        "description": "Semantic top-k over code chunks, no synthesis.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string"},
                "limit": {"type": "integer", "default": 10},
                "language": {"type": "string"},
            },
            "required": ["query"],
        },
    },
    {
        # an extension beyond the reference's four tools: many questions
        # ranked corpus-wide in one batched engine call
        # (`QueryEngine.deep_search_batch`)
        "name": "deep_search_batch",
        "description": "Corpus-wide hybrid ranking for SEVERAL questions "
                       "at once (one batched device execution; ~Q-fold "
                       "cheaper than asking one at a time).",
        "inputSchema": {
            "type": "object",
            "properties": {
                "questions": {"type": "array",
                              "items": {"type": "string"}},
                "limit": {"type": "integer", "default": 10},
            },
            "required": ["questions"],
        },
    },
]


class ToolContext:
    """Lazy component container (reference `server.py:66-98`). The
    index loads, and `index_repository` indexes, on `device`."""

    def __init__(self, repo_path: Path, settings: Settings,
                 device: str | torch.device = "cuda"):
        self.repo_path = repo_path
        self.settings = settings
        self.device = device
        self._engine = None
        self._manifest = None

    def engine(self):
        if self._engine is None:
            from lattice_tpu_torch.embeddings.embedder import Embedder
            from lattice_tpu_torch.providers.factory import (
                get_embedding_provider,
                get_llm_provider,
            )
            from lattice_tpu_torch.query.engine import QueryEngine
            from lattice_tpu_torch.storage import persistence
            embedder = Embedder(get_embedding_provider(
                self.settings.ai, device=self.device))
            graph, indexer, manifest = persistence.load_index(
                self.repo_path / self.settings.storage.data_dir, embedder,
                device=self.device)
            self._manifest = manifest
            self._engine = QueryEngine(
                graph, indexer, get_llm_provider(self.settings.ai),
                self.settings.query)
        return self._engine

    def invalidate(self) -> None:
        self._engine = None


async def index_repository(ctx: ToolContext, args: dict) -> dict:
    """Reference: `tools.py:64-140`."""
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.providers.factory import get_embedding_provider
    from lattice_tpu_torch.storage import persistence

    repo = Path(args["path"]).resolve()
    if not repo.is_dir():
        return {"error": f"not a directory: {repo}"}
    embedder = Embedder(get_embedding_provider(ctx.settings.ai,
                                               device=ctx.device))
    orchestrator = PipelineOrchestrator(
        repo, embedder, project_name=args.get("project"),
        settings=ctx.settings, force=bool(args.get("force")),
        device=ctx.device)
    run_ctx = await orchestrator.run()
    persistence.save_index(
        repo / ctx.settings.storage.data_dir,
        run_ctx.graph_builder.store, run_ctx.indexer,
        project=run_ctx.project_name,
        provider=ctx.settings.ai.embedding_provider,
        file_hashes={f.relative_path: f.content_hash for f in run_ctx.files})
    ctx.invalidate()
    stats = run_ctx.graph_builder.store.stats
    return {
        "project": run_ctx.project_name,
        "files": len(run_ctx.files),
        "nodes": stats["nodes"],
        "edges": stats["edges"],
        "chunks": len(run_ctx.indexer.code),
        "errors": len(run_ctx.errors),
    }


async def query_code_graph(ctx: ToolContext, args: dict) -> dict:
    """Reference: `tools.py:143-228`."""
    engine = ctx.engine()
    result = await engine.query(args["question"],
                                limit=int(args.get("limit", 15)))
    return {
        "answer": result.answer,
        "intent": result.query_plan.intent.value,
        "entities": result.query_plan.entity_names,
        "sources": [
            {"name": r.qualified_name or r.name, "file": r.file_path,
             "line": r.start_line, "score": round(r.score, 4),
             "source": r.source.value}
            for r in result.results[:5]
        ],
        "phase_times_ms": {k: round(v, 1)
                           for k, v in result.phase_times_ms.items()},
    }


async def get_code_snippet(ctx: ToolContext, args: dict) -> dict:
    """Reference: `tools.py:231-365`; the guard at `:300-307` rejects any
    resolved path escaping the repository root."""
    engine = ctx.engine()
    name = args["entity"]
    context_lines = int(args.get("context_lines", 0))
    hits = engine.graph_engine.find_entity(name)
    if not hits:
        return {"error": f"entity not found: {name}"}
    rec = engine.graph_store.node(hits[0])
    if not rec.file_path:
        return {"error": f"entity has no file location: {name}"}
    full = (ctx.repo_path / rec.file_path).resolve()
    # Path-traversal guard: the resolved path must stay inside the repo.
    try:
        full.relative_to(ctx.repo_path.resolve())
    except ValueError:
        return {"error": "resolved path escapes the repository root"}
    if not full.is_file():
        return {"error": f"file missing on disk: {rec.file_path}"}
    lines = full.read_text(encoding="utf-8", errors="replace").splitlines()
    start = max(rec.start_line - 1 - context_lines, 0)
    end = min(rec.end_line + context_lines, len(lines))
    return {
        "entity": rec.qualified_name,
        "file": rec.file_path,
        "start_line": start + 1,
        "end_line": end,
        "code": "\n".join(lines[start:end]),
    }


async def semantic_search(ctx: ToolContext, args: dict) -> dict:
    """Reference: `tools.py:368-462`."""
    import asyncio

    engine = ctx.engine()
    filters = None
    if args.get("language"):
        filters = {"language": args["language"]}
    # the searcher is synchronous (device dispatch); keep the loop free
    results = await asyncio.to_thread(
        engine.vector_searcher.search_code,
        args["query"], int(args.get("limit", 10)), filters)
    return {
        "results": [
            {"name": r.name, "file": r.file_path, "line": r.start_line,
             "score": round(r.score, 4), "type": r.entity_type,
             "snippet": r.content[:400]}
            for r in results
        ],
    }


async def deep_search_batch(ctx: ToolContext, args: dict) -> dict:
    """Batched corpus-wide hybrid rank (no reference analog — the
    reference answers one question per round trip; the batch shares one
    [Q, N] cosine pass + per-query fuse). Arbitrarily long question lists
    are safe: the engine executes in chunks of `DEEP_BATCH_CHUNK` (128) so
    the device score slab stays bounded."""
    import asyncio

    engine = ctx.engine()
    questions = [str(q) for q in args.get("questions", []) if str(q)]
    if not questions:
        return {"answers": []}
    results = await asyncio.to_thread(
        engine.deep_search_batch, questions, int(args.get("limit", 10)))
    return {
        "answers": [
            {
                "question": r.query,
                "intent": r.query_plan.intent.value,
                "results": [
                    {"name": h.qualified_name or h.name,
                     "file": h.file_path, "line": h.start_line,
                     "score": round(h.score, 4),
                     "source": h.source.value}
                    for h in r.results
                ],
            }
            for r in results
        ],
    }


TOOL_HANDLERS = {
    "index_repository": index_repository,
    "query_code_graph": query_code_graph,
    "get_code_snippet": get_code_snippet,
    "semantic_search": semantic_search,
    "deep_search_batch": deep_search_batch,
}
