"""File watcher: incremental reindexing on change.

A copy of `lattice_tpu/pipeline/watcher.py`: `FileChangeHandler`
relevance filter, an asyncio queue decoupling fs events from async
processing, change handling (re-parse, delete graph entities, rebuild
graph + vectors, recalc CALLS), delete handling (graph + vectors + AST
cache), and updated/deleted/error counters. Change detection is kernel
inotify events via ctypes (`pipeline/inotify.py`) with a polling scanner
fallback: the same `FileScanner` the pipeline uses.

The differences from the reference:
- `_handle_changed` and `_handle_deleted` count a file's failure as an
  error and go on, but a kernel error, a CUDA out-of-memory or a path not
  ported (`core.errors.DEVICE_ERRORS`) raises: it is not that file's
  fault, and the stores on the card may be half updated.
- `watch_repository` takes `device` (default "cuda", which raises without
  CUDA) for the embedder, the orchestrator's stores and their graph.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from lattice_tpu_torch.config.settings import Settings, get_settings
from lattice_tpu_torch.core.errors import DEVICE_ERRORS
from lattice_tpu_torch.embeddings.indexer import VectorIndexer
from lattice_tpu_torch.graph.builder import GraphBuilder
from lattice_tpu_torch.parsing.models import FileInfo, ParsedFile
from lattice_tpu_torch.parsing.parser import CodeParser
from lattice_tpu_torch.parsing.scanner import FileScanner

logger = logging.getLogger(__name__)


@dataclass(slots=True)
class FileEvent:
    kind: str          # changed | created | deleted
    relative_path: str
    file_info: FileInfo | None = None


@dataclass
class WatchStats:
    """Reference counters (`watcher.py:104-107`)."""

    updated: int = 0
    deleted: int = 0
    errors: int = 0
    polls: int = 0


class FileWatcher:
    def __init__(
        self,
        repo_path: str | Path,
        graph_builder: GraphBuilder,
        indexer: VectorIndexer,
        parser: CodeParser | None = None,
        settings: Settings | None = None,
        project_name: str | None = None,
        poll_interval_s: float = 1.0,
        backend: str = "auto",   # auto | inotify | poll
    ):
        settings = settings or get_settings()
        self.repo_path = Path(repo_path).resolve()
        self.scanner = FileScanner(self.repo_path, settings.files)
        self.parser = parser or CodeParser()
        self.graph_builder = graph_builder
        self.indexer = indexer
        self.project_name = project_name or self.repo_path.name
        self.poll_interval_s = poll_interval_s
        self.stats = WatchStats()
        self._queue: asyncio.Queue[FileEvent] = asyncio.Queue()
        self._known: dict[str, str] = {}          # rel path -> content hash
        self._parsed_by_path: dict[str, ParsedFile] = {}
        self._running = False
        self._inotify = None
        if backend in ("auto", "inotify"):
            try:
                from lattice_tpu_torch.pipeline.inotify import InotifyBackend
                self._inotify = InotifyBackend(
                    self.repo_path, self.scanner._is_ignored)
            except OSError as exc:
                if backend == "inotify":
                    raise
                logger.info("inotify unavailable (%s); polling", exc)

    @property
    def backend_name(self) -> str:
        return "inotify" if self._inotify is not None else "poll"

    # ---- detection (replaces the watchdog Observer thread) --------------

    def prime(self, parsed_files: list[ParsedFile]) -> None:
        """Seed known-file state from an initial index run."""
        for parsed in parsed_files:
            info = parsed.file_info
            self._known[info.relative_path] = info.content_hash
            self._parsed_by_path[info.relative_path] = parsed

    def poll_once(self) -> list[FileEvent]:
        """One scan pass; emits created/changed/deleted events."""
        self.stats.polls += 1
        events: list[FileEvent] = []
        seen: set[str] = set()
        for info in self.scanner.scan():
            seen.add(info.relative_path)
            old = self._known.get(info.relative_path)
            if old is None:
                events.append(FileEvent("created", info.relative_path, info))
            elif old != info.content_hash:
                events.append(FileEvent("changed", info.relative_path, info))
        for rel in list(self._known):
            if rel not in seen:
                events.append(FileEvent("deleted", rel))
        return events

    def detect_once(self) -> list[FileEvent]:
        """Change detection step: kernel events when available, else poll.

        With inotify active only the reported paths are re-stat'ed and
        re-hashed (`FileScanner.info_for`); a queue overflow or a
        directory-level move degrades to one full `poll_once` pass.
        """
        if self._inotify is None:
            return self.poll_once()
        touched, need_full = self._inotify.drain()
        if need_full:
            return self.poll_once()
        events: list[FileEvent] = []
        for rel in sorted(touched):
            info = self.scanner.info_for(rel)
            old = self._known.get(rel)
            if info is None:
                if old is not None:
                    events.append(FileEvent("deleted", rel))
            elif old is None:
                events.append(FileEvent("created", rel, info))
            elif old != info.content_hash:
                events.append(FileEvent("changed", rel, info))
        return events

    def close(self) -> None:
        if self._inotify is not None:
            self._inotify.close()
            self._inotify = None

    # ---- processing (reference `watcher.py:208-313`) --------------------

    async def _handle_changed(self, event: FileEvent) -> None:
        info = event.file_info
        assert info is not None
        try:
            parsed = await asyncio.to_thread(self.parser.parse_file, info)
            self._parsed_by_path[info.relative_path] = parsed
            all_parsed = list(self._parsed_by_path.values())
            await asyncio.to_thread(
                self.graph_builder.rebuild_file,
                info.relative_path, parsed, all_parsed)
            await asyncio.to_thread(
                self.indexer.index_file, parsed, self.project_name, True)
            self._known[info.relative_path] = info.content_hash
            self.stats.updated += 1
            logger.info("reindexed %s", info.relative_path)
        except DEVICE_ERRORS:
            raise
        except Exception as exc:
            self.stats.errors += 1
            logger.warning("watch update failed for %s: %s",
                           info.relative_path, exc)

    async def _handle_deleted(self, event: FileEvent) -> None:
        rel = event.relative_path
        try:
            parsed = self._parsed_by_path.pop(rel, None)
            if parsed is not None:
                self.graph_builder.registry.remove_by_prefix(
                    parsed.file_info.module_name)
            self.graph_builder.store.remove_file_nodes(rel)
            self.graph_builder.store.finalize()
            self.indexer.delete_file(rel)
            self.parser.ast_cache.remove(Path(self.repo_path / rel))
            self._known.pop(rel, None)
            self.stats.deleted += 1
            logger.info("removed %s from index", rel)
        except DEVICE_ERRORS:
            raise
        except Exception as exc:
            self.stats.errors += 1
            logger.warning("watch delete failed for %s: %s", rel, exc)

    async def process_events(self, events: list[FileEvent]) -> None:
        for event in events:
            if event.kind in ("changed", "created"):
                await self._handle_changed(event)
            else:
                await self._handle_deleted(event)
        if events:
            # long-lived watch sessions accumulate freelist holes; past
            # the threshold, rewrite the matrices densely (SURVEY §7 (d);
            # row ids remap internally, the graph joins by name)
            for name, store in (("code", self.indexer.code),
                                ("summaries", self.indexer.summaries)):
                if store.maybe_compact() is not None:
                    logger.info("compacted %s store to %d live rows",
                                name, len(store))

    # ---- loop -----------------------------------------------------------

    async def run(self, max_polls: int | None = None) -> None:
        """Poll -> queue -> process loop (reference `watcher.py:181-206`)."""
        self._running = True
        polls = 0
        while self._running:
            events = await asyncio.to_thread(self.detect_once)
            await self.process_events(events)
            polls += 1
            if max_polls is not None and polls >= max_polls:
                break
            await asyncio.sleep(self.poll_interval_s)

    def stop(self) -> None:
        self._running = False


async def watch_repository(repo_path: Path, settings: Settings,
                           device: str | torch.device = "cuda") -> int:
    """CLI entry: full index on `device`, then the watch loop, persisting
    on change."""
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.providers.factory import get_embedding_provider
    from lattice_tpu_torch.storage import persistence

    # finetune_dir matches the CLI index/query path so watch-mode re-embeds
    # with the same weights the stored vectors used
    embedder = Embedder(get_embedding_provider(
        settings.ai, finetune_dir=repo_path / settings.storage.data_dir,
        device=device))
    orchestrator = PipelineOrchestrator(repo_path, embedder, settings=settings,
                                        device=device)
    ctx = await orchestrator.run()
    watcher = FileWatcher(repo_path, ctx.graph_builder, ctx.indexer,
                          ctx.parser, settings, ctx.project_name)
    watcher.prime(ctx.parsed)
    data_dir = repo_path / settings.storage.data_dir
    print(f"watching {repo_path} via {watcher.backend_name} (ctrl-c to stop)")
    last_save = time.time()
    last_full = time.time()
    dirty = False          # changes applied in memory but not yet on disk

    def _flush() -> None:
        nonlocal dirty, last_save
        persistence.save_index(
            data_dir, ctx.graph_builder.store, ctx.indexer,
            project=ctx.project_name,
            provider=settings.ai.embedding_provider,
            file_hashes=dict(watcher._known),
            weights_fingerprint=persistence.embedder_fingerprint(embedder))
        dirty = False
        last_save = time.time()

    try:
        while True:
            # periodic full reconcile guards against missed kernel events
            if time.time() - last_full > 300.0:
                events = await asyncio.to_thread(watcher.poll_once)
                last_full = time.time()
            else:
                events = await asyncio.to_thread(watcher.detect_once)
            if events:
                await watcher.process_events(events)
                dirty = True
                if time.time() - last_save > 5.0:
                    _flush()
                print(f"updated={watcher.stats.updated} "
                      f"deleted={watcher.stats.deleted} "
                      f"errors={watcher.stats.errors}")
            elif dirty and time.time() - last_save > 5.0:
                # idle after a burst: persist rather than waiting for the
                # next event (a final burst inside the 5 s window would be
                # applied in memory but never written)
                _flush()
            await asyncio.sleep(1.0 if watcher.backend_name == "poll" else 0.25)
    except KeyboardInterrupt:
        print("stopped")
    finally:
        if dirty:
            _flush()
        watcher.close()
    return 0
