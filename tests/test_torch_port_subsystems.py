"""The port's watcher, inotify backend, metadata, projects, local
database, graph statistics and watch loop.

Mirror of `tests/test_subsystems.py`'s `TestWatcher`,
`TestInotifyWatcher`, `TestSummarizer`, `TestMetadata`, `TestProjects`,
`TestOfflineSummariesIndexed`, `TestLocalDatabase`, `TestWatcherLoop`
and `TestInotifyRecursiveMoveStress` against `lattice_tpu_torch` on the
CPU. The fixture project is indexed by the port's orchestrator with its
default settings (`device="cpu"`), so its metadata stage runs too. The
MCP classes are mirrored in `tests/test_torch_port_mcp.py`.

Then the port against the JAX package on the same workspace: the
metadata record (every field but the timings), the metadata models'
`to_dict()` against pydantic's `model_dump(mode="json")`, the graph
statistics, and a projects registry written by one package and read by
the other. And what the port adds: the orchestrator writes the metadata
that the repository reads back under default settings, and records
"metadata init" / "metadata" errors as the reference does; the watcher
re-raises a kernel error, a CUDA out-of-memory or a path not ported
(`DEVICE_ERRORS`) where a file's own failure is counted; the watch entry
point's default device raises without CUDA.

Every test has a time limit (`TEST_TIME_LIMIT_S`, by SIGALRM), so that a
watcher that hangs fails its test rather than the suite.
"""

import asyncio
import json
import shutil
import signal

import numpy as np
import pytest
import torch

from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.errors import KernelError, VectorStoreError
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.pipeline.watcher import FileWatcher
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

TEST_TIME_LIMIT_S = 60


class FakeLLM:
    """Canned-response provider (reference `test_summarization.py:21-25`)."""

    def __init__(self, response="A canned summary."):
        self.response = response
        self.calls = []

    async def complete(self, messages, **kwargs):
        self.calls.append(messages)
        return self.response


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_TIME_LIMIT_S} s")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture()
def workspace(tmp_path, sample_project_path):
    root = tmp_path / "proj"
    shutil.copytree(sample_project_path, root)
    return root


@pytest.fixture()
def indexed_ws(workspace):
    embedder = Embedder(HashEmbedder(dimensions=128))
    orchestrator = PipelineOrchestrator(workspace, embedder,
                                        project_name="ws",
                                        settings=Settings(), device="cpu")
    ctx = asyncio.run(orchestrator.run())
    assert ctx.errors == []
    return workspace, ctx


class TestWatcher:
    def test_change_detection_and_reindex(self, indexed_ws):
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws")
        watcher.prime(ctx.parsed)
        assert watcher.poll_once() == []  # steady state

        target = workspace / "app" / "utils" / "validators.py"
        target.write_text(target.read_text() + (
            "\n\ndef brand_new_helper(x):\n"
            "    \"\"\"Completely new function.\"\"\"\n"
            "    return normalize_name(x)\n"))
        events = watcher.poll_once()
        assert [e.kind for e in events] == ["changed"]
        asyncio.run(watcher.process_events(events))
        assert watcher.stats.updated == 1
        store = ctx.graph_builder.store
        nid = store.id_of("app.utils.validators.brand_new_helper")
        assert nid is not None
        # new CALLS edge resolved to the sibling function
        callees = store.k_hop([nid], EdgeType.CALLS, hops=1)
        target_id = store.id_of("app.utils.validators.normalize_name")
        assert target_id in callees
        # vectors updated too
        rows = ctx.indexer.code.scroll(
            {"graph_node_id": "app.utils.validators.brand_new_helper"})
        assert rows

    def test_delete_detection(self, indexed_ws):
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws")
        watcher.prime(ctx.parsed)
        (workspace / "app" / "api" / "routes.py").unlink()
        events = watcher.poll_once()
        assert [e.kind for e in events] == ["deleted"]
        asyncio.run(watcher.process_events(events))
        assert watcher.stats.deleted == 1
        store = ctx.graph_builder.store
        assert store.id_of("app.api.routes.handle_create_user") is None
        assert ctx.indexer.code.scroll(
            {"file_path": "app/api/routes.py"}) == []

    def test_delete_triggers_compaction(self, indexed_ws, monkeypatch):
        """Past the hole threshold the watcher compacts the stores and
        search still serves the survivors."""
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws")
        watcher.prime(ctx.parsed)
        store = ctx.indexer.code
        monkeypatch.setattr(type(store), "COMPACT_MIN_CAPACITY", 8)
        monkeypatch.setattr(type(store), "COMPACT_HOLE_FRACTION", 0.001)
        cap_before = store.capacity
        (workspace / "app" / "api" / "routes.py").unlink()
        events = watcher.poll_once()
        asyncio.run(watcher.process_events(events))
        assert store.capacity <= cap_before
        assert not store._free  # compacted: no holes left
        hits = store.search(np.ones(store.dim, np.float32), k=3)[0]
        assert hits and all(h[2] for h in hits)

    def test_directory_rename_end_to_end(self, indexed_ws):
        """A subtree move must delete every old path's nodes/vectors and
        re-index them under the new module names (the reference's watcher
        missed these — SURVEY §2.2 relative-vs-absolute delete bug)."""
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws")
        watcher.prime(ctx.parsed)
        (workspace / "app" / "utils").rename(workspace / "app" / "helpers")
        events = watcher.poll_once()
        kinds = sorted(e.kind for e in events)
        assert "deleted" in kinds and "created" in kinds
        asyncio.run(watcher.process_events(events))
        store = ctx.graph_builder.store
        # old module names gone from the graph and the vector store
        assert store.id_of("app.utils.validators.normalize_name") is None
        assert ctx.indexer.code.scroll(
            {"file_path": "app/utils/validators.py"}) == []
        # re-registered under the new package name
        moved = store.id_of("app.helpers.validators.normalize_name")
        assert moved is not None
        rows = ctx.indexer.code.scroll(
            {"graph_node_id": "app.helpers.validators.normalize_name"})
        assert rows
        # steady state afterwards: no phantom events
        assert watcher.poll_once() == []


class TestInotifyWatcher:
    """Kernel-event detection path (pipeline/inotify.py)."""

    @pytest.fixture()
    def inotify_watcher(self, indexed_ws):
        from lattice_tpu_torch.pipeline.inotify import InotifyBackend
        if not InotifyBackend.available():
            pytest.skip("inotify unavailable")
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws",
                              backend="inotify")
        watcher.prime(ctx.parsed)
        yield workspace, ctx, watcher
        watcher.close()

    def test_backend_selected(self, inotify_watcher):
        _, _, watcher = inotify_watcher
        assert watcher.backend_name == "inotify"
        assert watcher.detect_once() == []  # steady state, no scan needed

    def test_change_create_delete_cycle(self, inotify_watcher):
        workspace, ctx, watcher = inotify_watcher
        target = workspace / "app" / "utils" / "validators.py"
        target.write_text(target.read_text() + "\n\nWATCH_SENTINEL = 1\n")
        events = watcher.detect_once()
        assert [(e.kind, e.relative_path) for e in events] == [
            ("changed", "app/utils/validators.py")]
        asyncio.run(watcher.process_events(events))

        new = workspace / "app" / "utils" / "fresh.py"
        new.write_text("def fresh():\n    return 1\n")
        events = watcher.detect_once()
        assert [(e.kind, e.relative_path) for e in events] == [
            ("created", "app/utils/fresh.py")]
        asyncio.run(watcher.process_events(events))
        assert ctx.graph_builder.store.id_of("app.utils.fresh.fresh")

        new.unlink()
        events = watcher.detect_once()
        assert [(e.kind, e.relative_path) for e in events] == [
            ("deleted", "app/utils/fresh.py")]
        asyncio.run(watcher.process_events(events))
        assert ctx.graph_builder.store.id_of("app.utils.fresh.fresh") is None

    def test_irrelevant_paths_filtered(self, inotify_watcher):
        workspace, _, watcher = inotify_watcher
        (workspace / "notes.txt").write_text("not source")
        (workspace / "app" / "data.json").write_text("{}")
        assert watcher.detect_once() == []

    def test_new_subtree_discovered(self, inotify_watcher):
        workspace, _, watcher = inotify_watcher
        sub = workspace / "app" / "newpkg"
        sub.mkdir()
        (sub / "mod.py").write_text("def in_new_pkg():\n    return 2\n")
        # mkdir event registers the watch and surfaces pre-existing files;
        # two drains cover either event ordering
        events = watcher.detect_once() + watcher.detect_once()
        assert ("created", "app/newpkg/mod.py") in [
            (e.kind, e.relative_path) for e in events]

    def test_recursive_move_of_deep_tree(self, inotify_watcher):
        """Recursive-move stress (the round-2 leftover): a nested package
        (3x3 dirs, 27 files) moves in ONE rename(2). The kernel emits no
        per-file events for the children — correctness rides on
        IN_MOVED_TO's recursive watch-tree walk plus the IN_MOVED_FROM /
        IN_MOVE_SELF full-rescan degrade (`pipeline/inotify.py:179-193`),
        and every old module must leave the graph + vector store while
        every new one registers (reference watcher parity,
        `src/lattice/pipeline/watcher.py:21-99`)."""
        import shutil
        workspace, ctx, watcher = inotify_watcher
        store = ctx.graph_builder.store
        root = workspace / "app" / "bigpkg"
        for a in range(3):
            for b in range(3):
                d = root / f"l{a}" / f"m{b}"
                d.mkdir(parents=True, exist_ok=True)
                for c in range(3):
                    (d / f"mod{c}.py").write_text(
                        f"def fn_{a}_{b}_{c}():\n    return {a + b + c}\n")
        # two drains cover dir-create vs watch-registration ordering
        events = watcher.detect_once() + watcher.detect_once()
        created = {e.relative_path for e in events if e.kind == "created"}
        assert len(created) == 27
        asyncio.run(watcher.process_events(events))
        assert store.id_of("app.bigpkg.l2.m2.mod2.fn_2_2_2") is not None

        shutil.move(str(root), str(workspace / "app" / "movedpkg"))
        events = watcher.detect_once() + watcher.detect_once()
        seen = {(e.kind, e.relative_path) for e in events}
        for a in range(3):
            for b in range(3):
                for c in range(3):
                    old = f"app/bigpkg/l{a}/m{b}/mod{c}.py"
                    new = f"app/movedpkg/l{a}/m{b}/mod{c}.py"
                    assert ("deleted", old) in seen
                    assert ("created", new) in seen
        asyncio.run(watcher.process_events(events))
        assert store.id_of("app.bigpkg.l1.m1.mod1.fn_1_1_1") is None
        assert store.id_of("app.movedpkg.l1.m1.mod1.fn_1_1_1") is not None
        assert ctx.indexer.code.scroll(
            {"file_path": "app/bigpkg/l0/m0/mod0.py"}) == []
        assert ctx.indexer.code.scroll(
            {"graph_node_id": "app.movedpkg.l0.m0.mod0.fn_0_0_0"})
        # the moved tree is still WATCHED under its new root: a write
        # there must surface without a full rescan
        tweak = workspace / "app" / "movedpkg" / "l0" / "m0" / "mod0.py"
        tweak.write_text(tweak.read_text() + "\ndef late_fn():\n"
                                             "    return 9\n")
        kinds = [(e.kind, e.relative_path) for e in watcher.detect_once()]
        assert ("changed", "app/movedpkg/l0/m0/mod0.py") in kinds
        # steady state afterwards
        assert watcher.detect_once() == []

    def test_poll_backend_forced(self, indexed_ws):
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws", backend="poll")
        assert watcher.backend_name == "poll"
        watcher.prime(ctx.parsed)
        (workspace / "app" / "extra.py").write_text("X = 1\n")
        kinds = [e.kind for e in watcher.detect_once()]
        assert kinds == ["created"]


class TestSummarizer:
    def test_llm_path(self, indexed_ws):
        from lattice_tpu_torch.summarization.summarizer import CodeSummarizer
        _, ctx = indexed_ws
        llm = FakeLLM("Validates user emails and normalizes names.")
        summarizer = CodeSummarizer(llm)
        parsed = next(p for p in ctx.parsed
                      if p.file_info.relative_path.endswith("validators.py"))
        summary = asyncio.run(summarizer.summarize_file(parsed))
        assert summary == "Validates user emails and normalizes names."
        assert llm.calls

    def test_offline_fallback(self, indexed_ws):
        from lattice_tpu_torch.summarization.summarizer import CodeSummarizer
        _, ctx = indexed_ws
        summarizer = CodeSummarizer(None)
        parsed = next(p for p in ctx.parsed
                      if p.file_info.relative_path.endswith("validators.py"))
        summary = asyncio.run(summarizer.summarize_file(parsed))
        assert "validators" in summary
        assert "validate_email_format" in summary

    def test_entity_summary(self, indexed_ws):
        from lattice_tpu_torch.summarization.summarizer import CodeSummarizer
        _, ctx = indexed_ws
        summarizer = CodeSummarizer(None)
        parsed = next(p for p in ctx.parsed
                      if p.file_info.relative_path.endswith("user_service.py"))
        entity = parsed.classes[0]
        summary = asyncio.run(summarizer.summarize_entity(entity))
        assert "UserService" in summary


class TestMetadata:
    def test_generate_all_offline(self, indexed_ws, tmp_path):
        from lattice_tpu_torch.metadata.generator import MetadataGenerator
        from lattice_tpu_torch.metadata.repository import MetadataRepository
        workspace, ctx = indexed_ws
        repo = MetadataRepository(tmp_path / "meta")
        generator = MetadataGenerator(
            workspace, "ws", repository=repo,
            graph_store=ctx.graph_builder.store)
        record = asyncio.run(generator.generate_all())
        assert record["status"] == "completed"
        assert record["tech_stack"]["languages"]["python"] >= 5
        dep_names = [d["name"] for d in record["dependencies"]]
        assert isinstance(dep_names, list)
        assert record["folder_structure"]["name"]
        assert any(e["kind"] for e in record["entry_points"]) or \
            record["entry_points"] == []
        assert record["core_features"]
        assert "graph TD" in record["architecture_diagram"]
        # versioning + log
        assert repo.get_latest("ws")["version"] == 1
        record2 = asyncio.run(generator.generate_all())
        assert record2["version"] == 2
        log = repo.get_log("ws")
        assert len(log) == 14  # 7 fields x 2 runs
        assert all(entry["status"] == "completed" for entry in log)

    def test_llm_polish(self, workspace, tmp_path):
        from lattice_tpu_torch.metadata.generator import MetadataGenerator
        llm = FakeLLM("A polished overview.")
        generator = MetadataGenerator(workspace, "ws", llm=llm)
        record = asyncio.run(generator.generate_all())
        assert record["project_overview"] == "A polished overview."


class TestProjects:
    def test_register_list_delete(self, indexed_ws, tmp_path):
        from lattice_tpu_torch.projects.manager import ProjectManager
        from lattice_tpu_torch.storage import persistence
        workspace, ctx = indexed_ws
        data_dir = workspace / ".lattice"
        persistence.save_index(
            data_dir, ctx.graph_builder.store, ctx.indexer, project="ws",
            provider="hash",
            file_hashes={f.relative_path: f.content_hash for f in ctx.files})
        manager = ProjectManager(registry_path=tmp_path / "registry.json")
        manager.repository.register("ws", workspace)
        index = manager.list_projects()
        assert index.get("ws") is not None
        assert index.get("ws").chunk_count > 0
        assert index.total_files > 0
        assert manager.delete_project("ws")
        assert not data_dir.exists()
        assert manager.get_project("ws") is None

    def test_cleanup_stale(self, tmp_path):
        from lattice_tpu_torch.projects.manager import ProjectManager
        manager = ProjectManager(registry_path=tmp_path / "registry.json")
        manager.repository.register("ghost", tmp_path / "nowhere")
        assert manager.cleanup() == 1
        assert manager.list_projects().projects == ()


class TestOfflineSummariesIndexed:
    def test_summaries_collection_populated(self, indexed_ws):
        _, ctx = indexed_ws
        assert len(ctx.indexer.summaries) > 0
        rows = ctx.indexer.summaries.scroll(
            {"file_path": "app/utils/validators.py"}, limit=10)
        assert rows
        assert any(p["entity_type"] == "file" for _, p in rows)
        assert any(p["entity_type"] == "function" for _, p in rows)


class TestLocalDatabase:
    def test_crud_roundtrip(self, tmp_path):
        from lattice_tpu_torch.storage.database import LocalDatabase

        async def run():
            async with LocalDatabase(tmp_path / "t.sqlite3") as db:
                await db.executescript(
                    "CREATE TABLE kv (k TEXT PRIMARY KEY, v TEXT);")
                n = await db.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?)", "a", "1")
                assert n == 1
                row = await db.fetchrow("SELECT * FROM kv WHERE k = ?", "a")
                assert row == {"k": "a", "v": "1"}
                assert await db.fetchval("SELECT COUNT(*) FROM kv") == 1
                rows = await db.fetch("SELECT * FROM kv")
                assert len(rows) == 1
                assert await db.health_check()

        asyncio.run(run())

    def test_error_wrapped(self, tmp_path):
        from lattice_tpu_torch.core.errors import StorageError
        from lattice_tpu_torch.storage.database import LocalDatabase

        async def run():
            db = LocalDatabase(tmp_path / "t.sqlite3")
            with pytest.raises(StorageError):
                await db.fetch("SELECT * FROM missing_table")

        asyncio.run(run())


class TestWatcherLoop:
    def test_run_with_max_polls(self, indexed_ws):
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, project_name="ws",
                              poll_interval_s=0.01)
        watcher.prime(ctx.parsed)
        (workspace / "app" / "newmod.py").write_text(
            "def fresh_function():\n    return 1\n")
        asyncio.run(watcher.run(max_polls=2))
        assert watcher.stats.updated == 1
        assert ctx.graph_builder.store.id_of("app.newmod.fresh_function") \
            is not None

    def test_stop_flag(self, indexed_ws):
        workspace, ctx = indexed_ws
        watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                              ctx.parser, poll_interval_s=0.01)
        watcher.prime(ctx.parsed)
        watcher.stop()
        asyncio.run(watcher.run(max_polls=1))  # returns promptly
        assert watcher.stats.polls <= 1


class TestInotifyRecursiveMoveStress:
    """Large-tree rename stress (VERDICT r1 weak #7): after `mv` of a
    deep populated subtree, every file must stay trackable — via
    surfaced events, or via the need_full_rescan flag the watcher's
    reconcile pass honors — and post-move edits must report NEW paths,
    never stale pre-move ones."""

    @pytest.fixture()
    def backend_tree(self, tmp_path):
        from lattice_tpu_torch.pipeline.inotify import InotifyBackend
        if not InotifyBackend.available():
            pytest.skip("inotify unavailable")
        # 3 levels x 4 dirs x 10 files = 640+ files, 85 watched dirs
        def populate(base, depth):
            for i in range(10):
                (base / f"f{i}.py").write_text(f"x = {i}\n")
            if depth:
                for j in range(4):
                    d = base / f"d{j}"
                    d.mkdir()
                    populate(d, depth - 1)
        root = tmp_path / "repo"
        (root / "pkg").mkdir(parents=True)
        populate(root / "pkg", 2)
        backend = InotifyBackend(root)
        yield root, backend
        backend.close()

    def test_subtree_rename_within_tree(self, backend_tree):
        root, backend = backend_tree
        (root / "pkg").rename(root / "pkg_renamed")
        touched, need_full = backend.drain()
        # the moved-in tree re-registers: either its files surface as
        # events or the rescan flag covers them
        assert need_full or any(
            p.startswith("pkg_renamed/") for p in touched)
        surfaced = {p for p in touched if p.startswith("pkg_renamed/")}
        if not need_full:
            assert len(surfaced) >= 200
        # post-move edits must arrive under the NEW path
        target = root / "pkg_renamed" / "d0" / "d1" / "f3.py"
        target.write_text("x = 999\n")
        touched2, _ = backend.drain()
        assert "pkg_renamed/d0/d1/f3.py" in touched2
        assert not any(p.startswith("pkg/") for p in touched2)

    def test_subtree_move_out_of_tree(self, backend_tree, tmp_path):
        root, backend = backend_tree
        (root / "pkg" / "d0").rename(tmp_path / "outside")
        touched, need_full = backend.drain()
        assert need_full          # files under it got no per-file events
        # the tree keeps working afterwards
        (root / "pkg" / "fresh.py").write_text("y = 1\n")
        touched2, _ = backend.drain()
        assert "pkg/fresh.py" in touched2

    def test_rapid_rename_churn_stays_consistent(self, backend_tree):
        """Stress (r2 leftover): several successive subtree renames with
        interleaved writes, drained only at the end. Whatever mix of
        per-file events and rescan flags the kernel queue produced, the
        final state must be reachable: either the full-rescan flag is
        up, or the last write under the FINAL path surfaced — and the
        backend must keep delivering events afterwards."""
        root, backend = backend_tree
        cur = root / "pkg"
        for i in range(5):
            nxt = root / f"pkg_m{i}"
            cur.rename(nxt)
            # interleave a write under the new name while events pile up
            (nxt / "d0" / f"churn{i}.py").write_text(f"c = {i}\n")
            cur = nxt
        touched, need_full = backend.drain()
        assert need_full or any(
            p == "pkg_m4/d0/churn4.py" or p.startswith("pkg_m4/")
            for p in touched)
        # liveness after the churn: a fresh write under the final name
        # must surface as a normal per-file event
        (cur / "d0" / "after.py").write_text("ok = 1\n")
        touched2, _ = backend.drain()
        assert "pkg_m4/d0/after.py" in touched2

    def test_deep_move_in_from_outside(self, backend_tree, tmp_path):
        root, backend = backend_tree
        outside = tmp_path / "import_me"
        outside.mkdir()
        for i in range(30):
            (outside / f"g{i}.py").write_text("z = 1\n")
        (outside / "sub").mkdir()
        (outside / "sub" / "inner.py").write_text("w = 1\n")
        outside.rename(root / "pkg" / "imported")
        touched, need_full = backend.drain()
        got = {p for p in touched if p.startswith("pkg/imported/")}
        assert need_full or len(got) == 31
        if not need_full:
            assert "pkg/imported/sub/inner.py" in got
        # the imported subtree is live-watched now
        (root / "pkg" / "imported" / "sub" / "inner.py").write_text("w = 2\n")
        touched2, _ = backend.drain()
        assert "pkg/imported/sub/inner.py" in touched2



# ---- the port against the JAX package, and what the port adds ----------


@pytest.fixture()
def jax_ws(workspace):
    """The JAX package's index of the same workspace (metadata off)."""
    from lattice_tpu.config.settings import Settings as JaxSettings
    from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
    from lattice_tpu.pipeline.orchestrator import (
        PipelineOrchestrator as JaxOrchestrator)
    from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
    settings = JaxSettings()
    settings.metadata.enabled = False
    ctx = asyncio.run(JaxOrchestrator(
        workspace, JaxEmbedder(JaxHash(dimensions=128)), project_name="ws",
        settings=settings).run())
    assert ctx.errors == []
    return ctx


def _without_timings(record: dict) -> dict:
    return {k: v for k, v in record.items() if k != "field_timings_ms"}


def test_metadata_record_matches_the_reference(indexed_ws, jax_ws,
                                               tmp_path):
    from lattice_tpu.metadata.generator import (
        MetadataGenerator as JaxGenerator)
    from lattice_tpu.metadata.repository import (
        MetadataRepository as JaxRepository)
    from lattice_tpu_torch.metadata.generator import MetadataGenerator
    from lattice_tpu_torch.metadata.repository import MetadataRepository
    workspace, ctx = indexed_ws
    mine = asyncio.run(MetadataGenerator(
        workspace, "ws", repository=MetadataRepository(tmp_path / "p"),
        graph_store=ctx.graph_builder.store).generate_all())
    ref = asyncio.run(JaxGenerator(
        workspace, "ws", repository=JaxRepository(tmp_path / "j"),
        graph_store=jax_ws.graph_builder.store).generate_all())
    assert list(mine) == list(ref)
    assert _without_timings(mine) == _without_timings(ref)
    assert set(mine["field_timings_ms"]) == set(ref["field_timings_ms"])
    assert MetadataRepository(tmp_path / "p").get_log("ws")[0].keys() == \
        JaxRepository(tmp_path / "j").get_log("ws")[0].keys()


def test_metadata_models_dump_as_pydantic_does():
    from lattice_tpu.metadata import models as jm
    from lattice_tpu_torch.metadata import models as pm

    def build(m):
        return m.ProjectMetadata(
            project_name="p",
            folder_structure=m.FolderNode(name="root", children=[
                m.FolderNode(name="src", children=[
                    m.FolderNode(name="a.py", type="file")]),
                m.FolderNode(name="README.md", type="file",
                             purpose="docs")]),
            tech_stack=m.TechStack(languages={"python": 3},
                                   frameworks=["PyTorch"]),
            dependencies=[m.DependencyInfo(name="numpy", version=">=1")],
            entry_points=[m.EntryPoint(name="cli", path="pkg.main:main")],
            core_features=[m.CoreFeature(name="f", description="d",
                                         key_entities=["x.y"])],
            status=m.MetadataStatus.PARTIAL,
            field_timings_ms={"tech_stack": 1.5})

    assert build(pm).to_dict() == build(jm).model_dump(mode="json")
    assert build(pm).to_record() == build(jm).to_record()
    assert pm.ProjectMetadata(project_name="q").to_dict() == \
        jm.ProjectMetadata(project_name="q").model_dump(mode="json")
    assert json.dumps(build(pm).to_dict()) == json.dumps(
        build(jm).model_dump(mode="json"))


def test_graph_statistics_match_the_reference(indexed_ws, jax_ws):
    from lattice_tpu.graph.statistics import GraphStatistics as JaxStats
    from lattice_tpu_torch.graph.statistics import GraphStatistics
    _, ctx = indexed_ws
    mine = GraphStatistics(ctx.graph_builder.store)
    ref = JaxStats(jax_ws.graph_builder.store)
    assert mine.get_statistics() == ref.get_statistics()
    for prefix in ("", "app/", "app/models/", "web/", "nowhere/"):
        assert mine.get_project_statistics(prefix) == \
            ref.get_project_statistics(prefix), prefix
    for etype in EdgeType:
        assert mine.degree_histogram(etype) == ref.degree_histogram(etype)
    assert mine.get_project_statistics("app/")["nodes"] > 10


def test_projects_registry_is_shared_with_the_reference(indexed_ws,
                                                        tmp_path):
    from lattice_tpu.projects.manager import ProjectManager as JaxManager
    from lattice_tpu_torch.projects.manager import ProjectManager
    from lattice_tpu_torch.storage import persistence
    workspace, ctx = indexed_ws
    persistence.save_index(
        workspace / ".lattice", ctx.graph_builder.store, ctx.indexer,
        project="ws", provider="hash",
        file_hashes={f.relative_path: f.content_hash for f in ctx.files})
    registry = tmp_path / "registry.json"
    ProjectManager(registry_path=registry).repository.register(
        "ws", workspace)
    ref = JaxManager(registry_path=registry)
    assert ref.get_project("ws") == JaxManager(
        registry_path=registry).list_projects().get("ws")
    mine = ProjectManager(registry_path=registry).get_project("ws")
    theirs = ref.get_project("ws")
    assert (mine.name, mine.root_path, mine.file_count, mine.node_count,
            mine.edge_count, mine.chunk_count, mine.provider, mine.dims) == \
        (theirs.name, theirs.root_path, theirs.file_count, theirs.node_count,
         theirs.edge_count, theirs.chunk_count, theirs.provider, theirs.dims)
    assert mine.chunk_count == len(ctx.indexer.code) > 0


def test_orchestrator_writes_metadata_by_default(workspace):
    """Mirror of `test_pipeline_e2e.py::TestMetadataInPipeline`: default
    settings, no generator given, and the metadata the CLI's `metadata
    show` reads back."""
    from lattice_tpu_torch.metadata.repository import MetadataRepository
    settings = Settings()
    assert settings.metadata.enabled
    ctx = asyncio.run(PipelineOrchestrator(
        workspace, Embedder(HashEmbedder(dimensions=64)), project_name="mp",
        settings=settings, device="cpu").run())
    assert ctx.errors == []
    meta = MetadataRepository(workspace / ".lattice").get_latest("mp")
    assert meta is not None and meta["version"] == 1
    assert meta["status"] in ("completed", "partial")
    assert meta["tech_stack"]["languages"]["python"] > 0
    assert meta["core_features"]


def test_orchestrator_records_metadata_errors(workspace, monkeypatch):
    from lattice_tpu_torch.metadata import repository
    settings = Settings()

    class Broken:
        async def generate_all(self):
            raise RuntimeError("disk full")
    ctx = asyncio.run(PipelineOrchestrator(
        workspace, Embedder(HashEmbedder(dimensions=64)), settings=settings,
        device="cpu", metadata_generator=Broken()).run())
    assert ctx.errors == ["metadata: disk full"]

    def refuse(*args, **kwargs):
        raise OSError("read-only")
    monkeypatch.setattr(repository.MetadataRepository, "__init__", refuse)
    ctx = asyncio.run(PipelineOrchestrator(
        workspace, Embedder(HashEmbedder(dimensions=64)), settings=settings,
        device="cpu").run())
    assert ctx.errors == ["metadata init: read-only"]


@pytest.mark.parametrize("exc", [KernelError("launch failed"),
                                 torch.cuda.OutOfMemoryError("no memory"),
                                 NotImplementedError("not ported")])
def test_watcher_reraises_device_errors(indexed_ws, monkeypatch, exc):
    workspace, ctx = indexed_ws
    watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                          ctx.parser, project_name="ws", backend="poll")
    watcher.prime(ctx.parsed)

    def fail(*args, **kwargs):
        raise exc
    target = workspace / "app" / "utils" / "validators.py"
    target.write_text(target.read_text() + "\n\nX = 1\n")
    events = watcher.poll_once()
    assert [e.kind for e in events] == ["changed"]
    monkeypatch.setattr(ctx.indexer, "index_file", fail)
    with pytest.raises(type(exc)):
        asyncio.run(watcher.process_events(events))
    assert watcher.stats.errors == 0
    (workspace / "app" / "api" / "routes.py").unlink()
    events = watcher.poll_once()
    assert ("deleted", "app/api/routes.py") in [
        (e.kind, e.relative_path) for e in events]
    monkeypatch.setattr(ctx.indexer, "delete_file", fail)
    with pytest.raises(type(exc)):
        asyncio.run(watcher.process_events(
            [e for e in events if e.kind == "deleted"]))
    assert watcher.stats.errors == 0


def test_watcher_counts_a_files_own_failure(indexed_ws, monkeypatch):
    workspace, ctx = indexed_ws
    watcher = FileWatcher(workspace, ctx.graph_builder, ctx.indexer,
                          ctx.parser, project_name="ws", backend="poll")
    watcher.prime(ctx.parsed)

    def fail(*args, **kwargs):
        raise ValueError("bad file")
    (workspace / "app" / "extra.py").write_text("X = 1\n")
    monkeypatch.setattr(ctx.indexer, "index_file", fail)
    asyncio.run(watcher.process_events(watcher.poll_once()))
    assert watcher.stats.errors == 1 and watcher.stats.updated == 0


def test_watch_repository_default_device_raises_without_cuda(workspace,
                                                             monkeypatch):
    from lattice_tpu_torch.pipeline.watcher import watch_repository
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = Settings()
    settings.ai.embedding_dimensions = 64
    with pytest.raises(VectorStoreError, match="CUDA is not available"):
        asyncio.run(watch_repository(workspace, settings))
    assert not (workspace / ".lattice").exists()


def _mutate_and_watch(workspace, ctx, watcher_cls) -> None:
    """One file changed, one created, one deleted, through a watcher."""
    watcher = watcher_cls(workspace, ctx.graph_builder, ctx.indexer,
                          ctx.parser, project_name="ws", backend="poll")
    watcher.prime(ctx.parsed)
    target = workspace / "app" / "utils" / "validators.py"
    target.write_text(target.read_text() + (
        "\n\ndef watched_helper(x):\n    return normalize_name(x)\n"))
    (workspace / "app" / "slug.py").write_text(
        "def created_by_watch(x):\n    return x + 1\n")
    (workspace / "app" / "api" / "routes.py").unlink()
    events = watcher.poll_once()
    assert sorted(e.kind for e in events) == ["changed", "created",
                                              "deleted"]
    asyncio.run(watcher.process_events(events))
    assert (watcher.stats.updated, watcher.stats.deleted,
            watcher.stats.errors) == (2, 1, 0)


def _graph_by_name(store) -> tuple:
    """Live nodes, and every edge (repeats kept) by qualified names."""
    nodes = sorted((r.qualified_name, r.entity_type.value, r.file_path,
                    r.start_line, r.end_line)
                   for r in map(store.node, range(store.n_nodes()))
                   if store._alive[r.node_id])
    edges = {}
    for et in store._edges:
        src, dst = (np.asarray(a).tolist() for a in store.edges(et))
        edges[et.value] = sorted((store._qns[a], store._qns[b])
                                 for a, b in zip(src, dst))
    return nodes, edges


def _code_rows(store, bits) -> dict:
    return {json.dumps(p, sort_keys=True): bits(store, r)
            for r, p in enumerate(store._payloads) if p is not None}


def test_watch_matches_the_reference_and_a_fresh_index(workspace, tmp_path):
    """The same three changes through the port's watcher and the JAX
    package's, on two copies: the same graph (every edge, repeats
    included: `rebuild_file` re-adds the EXTENDS, IMPORTS and
    DEFINES_METHOD edges of every file, in both packages) and the same
    code rows. Against a fresh index of the mutated tree: the same live
    nodes and code rows, and the same distinct edges but one: the CALLS
    edge from an unchanged file into the changed one, which the watch
    drops (in both packages)."""
    from lattice_tpu.config.settings import Settings as JaxSettings
    from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
    from lattice_tpu.pipeline.orchestrator import (
        PipelineOrchestrator as JaxOrchestrator)
    from lattice_tpu.pipeline.watcher import FileWatcher as JaxWatcher
    from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
    jroot = tmp_path / "jax_proj"
    shutil.copytree(workspace, jroot)
    settings = Settings()
    settings.device.index_dtype = "float32"
    jsettings = JaxSettings()
    jsettings.device.index_dtype = "float32"
    jsettings.metadata.enabled = False
    ctx = asyncio.run(PipelineOrchestrator(
        workspace, Embedder(HashEmbedder(dimensions=128)), project_name="ws",
        settings=settings, device="cpu").run())
    jctx = asyncio.run(JaxOrchestrator(
        jroot, JaxEmbedder(JaxHash(dimensions=128)), project_name="ws",
        settings=jsettings).run())
    _mutate_and_watch(workspace, ctx, FileWatcher)
    _mutate_and_watch(jroot, jctx, JaxWatcher)

    def port_bits(store, r):
        return store._emb[r].numpy().tobytes()

    def jax_bits(store, r):
        return np.asarray(store._emb[r], np.float32).tobytes()
    mine = _graph_by_name(ctx.graph_builder.store)
    assert mine == _graph_by_name(jctx.graph_builder.store)
    rows = _code_rows(ctx.indexer.code, port_bits)
    assert rows.keys() == _code_rows(jctx.indexer.code, jax_bits).keys()
    ref = _code_rows(jctx.indexer.code, jax_bits)
    for key, value in rows.items():
        assert np.allclose(np.frombuffer(value, np.float32),
                           np.frombuffer(ref[key], np.float32),
                           atol=1e-6), key
    fresh = asyncio.run(PipelineOrchestrator(
        workspace, Embedder(HashEmbedder(dimensions=128)), project_name="ws",
        settings=settings, device="cpu").run())
    nodes, edges = _graph_by_name(fresh.graph_builder.store)
    assert mine[0] == nodes
    for k in edges:
        extra = set(mine[1][k]) - set(edges[k])
        missing = set(edges[k]) - set(mine[1][k])
        assert not extra, (k, sorted(extra))
        if k != "CALLS":
            assert not missing, (k, sorted(missing))
    # what the watch loses, in both packages: the CALLS edges from files
    # it did not re-parse into the file it did (`rebuild_file` resolves
    # the changed file's own calls only)
    missing = set(edges["CALLS"]) - set(mine[1]["CALLS"])
    assert missing == {
        ("app.services.user_service.UserService.create_user",
         "app.utils.validators.validate_email_format")}
    assert len(mine[1]["DEFINES_METHOD"]) > len(edges["DEFINES_METHOD"])
    assert rows == _code_rows(fresh.indexer.code, port_bits)
