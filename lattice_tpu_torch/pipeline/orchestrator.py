"""Indexing pipeline orchestrator (a copy of
`lattice_tpu/pipeline/orchestrator.py`).

`PipelineContext`, component init, and six stages: scan, parse (thread
pool; `pool.map` keeps file order, so row ids are deterministic), graph
(the in-process two-phase build), embed (per-file `index_file` with
content-hash skips and `force`), summarize (extractive summaries without
an LLM, into the summaries store) and metadata, with per-file error
tolerance. The differences from the reference:

- placement is explicit: `PipelineOrchestrator(..., device="cuda")`
  (and `run_indexing`, which passes its keywords on) builds its
  `VectorIndexer` there, and the default "cuda" raises without CUDA like
  every entry point of the port; its `GraphStore`'s device methods run
  there too. The store dtype keeps the reference's rule (`index_dtype` unless
  `settings.device.platform == "cpu"`, then float32).
"""

from __future__ import annotations

import asyncio
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import torch

from lattice_tpu_torch.config.settings import Settings, get_settings
from lattice_tpu_torch.core.errors import IndexingError
from lattice_tpu_torch.core.types import PipelineStage
from lattice_tpu_torch.embeddings.chunker import CodeChunker
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer
from lattice_tpu_torch.graph.builder import GraphBuilder
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.parsing.models import FileInfo, ParsedFile
from lattice_tpu_torch.parsing.parser import CodeParser
from lattice_tpu_torch.parsing.scanner import FileScanner
from lattice_tpu_torch.pipeline.progress import ProgressTracker

logger = logging.getLogger(__name__)


@dataclass
class PipelineContext:
    """Reference: `orchestrator.py:34-52`."""

    repo_path: Path
    project_name: str
    settings: Settings
    scanner: FileScanner
    parser: CodeParser
    graph_builder: GraphBuilder
    indexer: VectorIndexer
    tracker: ProgressTracker
    summarizer: object | None = None
    metadata_generator: object | None = None
    files: list[FileInfo] = field(default_factory=list)
    parsed: list[ParsedFile] = field(default_factory=list)
    changed: list[ParsedFile] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)


class PipelineOrchestrator:
    def __init__(
        self,
        repo_path: str | Path,
        embedder: Embedder,
        project_name: str | None = None,
        settings: Settings | None = None,
        graph_builder: GraphBuilder | None = None,
        indexer: VectorIndexer | None = None,
        summarizer=None,
        metadata_generator=None,
        progress_callback=None,
        force: bool = False,
        device: str | torch.device = "cuda",
    ):
        settings = settings or get_settings()
        repo_path = Path(repo_path).resolve()
        tracker = ProgressTracker()
        if progress_callback is not None:
            tracker.add_callback(progress_callback)
        self.force = force
        self.ctx = PipelineContext(
            repo_path=repo_path,
            project_name=project_name or repo_path.name,
            settings=settings,
            scanner=FileScanner(repo_path, settings.files),
            parser=CodeParser(),
            graph_builder=graph_builder or GraphBuilder(
                GraphStore(device=device)),
            indexer=indexer or VectorIndexer(
                embedder, CodeChunker(settings.indexing),
                dtype=settings.device.index_dtype
                if settings.device.platform != "cpu" else "float32",
                device=device),
            tracker=tracker,
            summarizer=summarizer,
            metadata_generator=metadata_generator,
        )
        workers = settings.indexing.parse_workers or min(os.cpu_count() or 1, 8)
        self._parse_workers = max(workers, 1)

    # ---- stages --------------------------------------------------------

    def _stage_scan(self) -> None:
        """Reference: `orchestrator.py:195-213`."""
        ctx = self.ctx
        ctx.tracker.start_stage(PipelineStage.SCANNING)
        ctx.files = ctx.scanner.scan_all()
        ctx.tracker.advance(len(ctx.files), files_scanned=len(ctx.files))
        ctx.tracker.finish_stage()

    def _stage_parse(self) -> None:
        """Thread-pool parse. Reference: `orchestrator.py:215-324`."""
        ctx = self.ctx
        ctx.tracker.start_stage(PipelineStage.PARSING, total=len(ctx.files))
        supported = [f for f in ctx.files if ctx.parser.supports(f.language)]

        def parse_one(fi: FileInfo) -> ParsedFile | None:
            try:
                return ctx.parser.parse_file(fi)
            except Exception as exc:
                ctx.errors.append(f"parse {fi.relative_path}: {exc}")
                return None

        if self._parse_workers > 1:
            with ThreadPoolExecutor(max_workers=self._parse_workers) as pool:
                results = list(pool.map(parse_one, supported))
        else:
            results = [parse_one(fi) for fi in supported]
        ctx.parsed = [p for p in results if p is not None]
        n_entities = sum(len(p.all_entities) for p in ctx.parsed)
        ctx.tracker.advance(len(ctx.files), files_parsed=len(ctx.parsed),
                            entities_found=n_entities)
        ctx.tracker.finish_stage()

    def _stage_graph(self) -> None:
        """Reference: `orchestrator.py:326-426` (hash-check + delete-stale +
        batch build collapse into the in-process two-phase build)."""
        ctx = self.ctx
        ctx.tracker.start_stage(PipelineStage.GRAPH_BUILDING,
                                total=len(ctx.parsed))
        store = ctx.graph_builder.build(ctx.parsed, project=ctx.project_name)
        ctx.tracker.advance(
            len(ctx.parsed),
            graph_nodes=store.stats["nodes"],
            graph_edges=sum(store.stats["edges"].values()))
        ctx.tracker.finish_stage()

    async def _stage_summarize(self) -> None:
        """Reference: `orchestrator.py:428-523`. Without an LLM the
        summarizer produces deterministic extractive summaries, so the
        summaries collection is populated offline too."""
        ctx = self.ctx
        if ctx.summarizer is None:
            from lattice_tpu_torch.summarization.summarizer import CodeSummarizer
            ctx.summarizer = CodeSummarizer(None)
        changed = ctx.changed if not self.force else ctx.parsed
        ctx.tracker.start_stage(PipelineStage.SUMMARIZING, total=len(changed))
        batch = ctx.settings.indexing.max_concurrent
        for start in range(0, len(changed), batch):
            group = changed[start:start + batch]
            results = await asyncio.gather(
                *(ctx.summarizer.summarize_file(p) for p in group),
                return_exceptions=True)
            for parsed, result in zip(group, results):
                if isinstance(result, Exception):
                    ctx.errors.append(
                        f"summarize {parsed.file_info.relative_path}: {result}")
                    ctx.tracker.advance(1, errors=1)
                    continue
                if result:
                    # index_summary embeds synchronously; keep it off the
                    # event loop (async providers bridge through their own
                    # loop when called from a plain thread)
                    await asyncio.to_thread(
                        ctx.indexer.index_summary,
                        entity_qn=parsed.file_info.module_name,
                        summary=result,
                        file_path=parsed.file_info.relative_path,
                        entity_type="file",
                        language=parsed.file_info.language.value,
                        project_name=ctx.project_name,
                        content_hash=parsed.file_info.content_hash)
                # class/function entity summaries (reference summarizes
                # file + entities, `orchestrator.py:467-520`)
                for entity in parsed.classes[:10] + parsed.functions[:10]:
                    try:
                        summary = await ctx.summarizer.summarize_entity(entity)
                    except Exception:
                        continue
                    if summary:
                        await asyncio.to_thread(
                            ctx.indexer.index_summary,
                            entity_qn=entity.qualified_name,
                            summary=summary,
                            file_path=parsed.file_info.relative_path,
                            entity_type=entity.entity_type.value,
                            language=parsed.file_info.language.value,
                            project_name=ctx.project_name,
                            content_hash=parsed.file_info.content_hash)
                ctx.tracker.advance(1, summaries_created=1)
        ctx.tracker.finish_stage()

    async def _stage_metadata(self) -> None:
        """Reference: `orchestrator.py:538-605`; the local deterministic
        generator runs by default (`MetadataSettings.enabled`)."""
        ctx = self.ctx
        ctx.tracker.start_stage(PipelineStage.METADATA, total=1)
        generator = ctx.metadata_generator
        if generator is None and ctx.settings.metadata.enabled:
            try:
                from lattice_tpu_torch.metadata.generator import (
                    MetadataGenerator)
                from lattice_tpu_torch.metadata.repository import (
                    MetadataRepository)
                repo = MetadataRepository(
                    ctx.repo_path / ctx.settings.storage.data_dir,
                    ctx.settings.storage.metadata_db)
                generator = MetadataGenerator(
                    ctx.repo_path, ctx.project_name, repository=repo,
                    graph_store=ctx.graph_builder.store)
            except Exception as exc:
                ctx.errors.append(f"metadata init: {exc}")
                generator = None
        if generator is not None:
            try:
                await generator.generate_all()
            except Exception as exc:
                ctx.errors.append(f"metadata: {exc}")
                ctx.tracker.advance(0, errors=1)
        ctx.tracker.advance(1)
        ctx.tracker.finish_stage()

    def _stage_embed(self) -> None:
        """Reference: `orchestrator.py:607-682` (per-file embed+upsert with
        hash skipping)."""
        ctx = self.ctx
        ctx.tracker.start_stage(PipelineStage.EMBEDDING, total=len(ctx.parsed))
        ctx.changed = []
        for parsed in ctx.parsed:
            try:
                n = ctx.indexer.index_file(parsed, ctx.project_name,
                                           force=self.force)
                if n:
                    ctx.changed.append(parsed)
                ctx.tracker.advance(1, chunks_indexed=n)
            except Exception as exc:
                ctx.errors.append(
                    f"embed {parsed.file_info.relative_path}: {exc}")
                ctx.tracker.advance(1, errors=1)
        ctx.tracker.finish_stage()

    # ---- run -----------------------------------------------------------

    async def run(self) -> PipelineContext:
        """Reference: `orchestrator.py:158-193` (stage sequencing + failure
        stage recorded in IndexingError)."""
        ctx = self.ctx
        ctx.tracker.start()
        stage = PipelineStage.SCANNING
        try:
            self._stage_scan()
            stage = PipelineStage.PARSING
            await asyncio.to_thread(self._stage_parse)
            stage = PipelineStage.GRAPH_BUILDING
            await asyncio.to_thread(self._stage_graph)
            stage = PipelineStage.EMBEDDING
            await asyncio.to_thread(self._stage_embed)
            stage = PipelineStage.SUMMARIZING
            await self._stage_summarize()
            stage = PipelineStage.METADATA
            await self._stage_metadata()
        except Exception as exc:
            ctx.tracker.fail(f"{stage.value}: {exc}")
            raise IndexingError(f"pipeline failed in {stage.value}",
                                stage=stage.value, cause=exc) from exc
        ctx.tracker.complete()
        return ctx


async def run_indexing(repo_path: str | Path, embedder: Embedder,
                       **kwargs) -> PipelineContext:
    """Reference: `orchestrator.py:685-695`."""
    orchestrator = PipelineOrchestrator(repo_path, embedder, **kwargs)
    return await orchestrator.run()
