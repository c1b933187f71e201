"""The port's entry points run on the card unless the caller asks for the
CPU: built with no `device` on a machine without CUDA, each one raises
rather than landing quietly on the CPU; the graph store's device methods
do the same on a store made with no `device`. The sharded graph and deep
rank are ported: their tests keep the names they had while the port
refused them, and now check that they serve, on meshes of logical shards
on the CPU. So is the metadata stage: the orchestrator no longer refuses
default settings (`test_metadata_stage_raises_not_ported` keeps its name
and now checks that)."""

import asyncio

import pytest
import torch

from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.errors import (EmbeddingError, GraphError,
                                          VectorStoreError)
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.pipeline.orchestrator import (PipelineOrchestrator,
                                                     run_indexing)
from lattice_tpu_torch.models.unixcoder import UniXcoderConfig, UniXcoderModel
from lattice_tpu_torch.providers import unixcoder_provider as up
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

TINY = UniXcoderConfig(vocab_size=512, hidden_size=128, num_layers=1,
                       num_heads=2, intermediate_size=256,
                       max_position_embeddings=130)


def _no_metadata() -> Settings:
    settings = Settings()
    settings.metadata.enabled = False
    return settings


ENTRY_POINTS = {
    "ChunkStore": (lambda: ChunkStore(dim=8), VectorStoreError),
    "VectorIndexer": (lambda: VectorIndexer(Embedder(HashEmbedder(
        dimensions=8))), VectorStoreError),
    "UniXcoderModel": (lambda: UniXcoderModel(TINY), EmbeddingError),
    "_get_model": (lambda: up._get_model(None), EmbeddingError),
    "UniXcoderEmbedder": (lambda: up.UniXcoderEmbedder(), EmbeddingError),
    "UniXcoderEmbeddingProvider": (lambda: up.UniXcoderEmbeddingProvider(),
                                   EmbeddingError),
    "PipelineOrchestrator": (lambda: PipelineOrchestrator(
        ".", Embedder(HashEmbedder(dimensions=8)), settings=_no_metadata()),
        VectorStoreError),
    "run_indexing": (lambda: asyncio.run(run_indexing(
        ".", Embedder(HashEmbedder(dimensions=8)), settings=_no_metadata())),
        VectorStoreError),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make, error = ENTRY_POINTS[name]
    with pytest.raises(error, match="CUDA is not available"):
        make()


def test_cpu_is_asked_for_by_name():
    store = ChunkStore(dim=8, device="cpu")
    assert store.device.type == "cpu"
    model = UniXcoderModel(TINY, device="cpu")
    assert next(model.encoder.parameters()).device.type == "cpu"


def _graph(device: str = "cuda") -> GraphStore:
    store = GraphStore(device=device)
    a = store.add_node("m.a", EntityType.FUNCTION, "m.py")
    b = store.add_node("m.b", EntityType.FUNCTION, "m.py")
    store.add_edge(a, b, EdgeType.CALLS)
    store.finalize()
    return store


GRAPH_DEVICE_CALLS = {
    "k_hop": lambda g: g.k_hop([0], EdgeType.CALLS, 2, device=True),
    "k_hop_batch": lambda g: g.k_hop_batch([[0]] * 4, EdgeType.CALLS, 2,
                                           device=True),
    "device_edges": lambda g: g.device_edges(EdgeType.CALLS),
    "device_alive": lambda g: g.device_alive(),
    "device_degree": lambda g: g.device_degree(EdgeType.CALLS),
}


@pytest.mark.parametrize("name", sorted(GRAPH_DEVICE_CALLS))
def test_graph_device_methods_default_to_cuda(monkeypatch, name):
    """A graph store made with no `device` builds and walks its graph on
    the host; its device methods raise without CUDA, and run on the CPU
    when it is asked for by name (the store's or the call's)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # k_hop_batch keeps the reference's host walk below its edge threshold
    monkeypatch.setattr(GraphStore, "DEVICE_BFS_THRESHOLD", 0)
    store = _graph()
    assert store.k_hop([0], EdgeType.CALLS, 2) == {1: 1}
    with pytest.raises(GraphError, match="CUDA is not available"):
        GRAPH_DEVICE_CALLS[name](store)
    GRAPH_DEVICE_CALLS[name](_graph("cpu"))
    assert store.device_alive(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda g: g.to_sharded(EdgeType.CALLS),
], ids=["to_sharded"])
def test_graph_device_methods_raise_not_ported(monkeypatch, call):
    """`to_sharded` serves: on a CPU store its default mesh is one shard,
    a view cached per edge type until `finalize`, walking as the host
    does."""
    store = _graph("cpu")
    view = call(store)
    assert len(view.mesh.row_devices) == 1 and call(store) is view
    assert view.k_hop([0], 2) == {1: 1}
    assert store.k_hop([0], EdgeType.CALLS, 2) == {1: 1}
    assert store.k_hop([0], EdgeType.CALLS, 2, device=True) == {1: 1}
    store.finalize()
    assert call(store) is not view


def test_graph_sharded_flag_raises_only_with_several_cards(monkeypatch):
    """LATTICE_SHARDED=1 walks through the sharded view only with a mesh
    of more than one shard: two cards (the default mesh; counted, not
    built) or the mesh `default_mesh` sets, here two logical shards on the
    CPU, where the walk equals the host walk."""
    from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
    store = _graph()
    monkeypatch.setenv("LATTICE_SHARDED", "1")
    assert store.k_hop([0], EdgeType.CALLS, 2) == {1: 1}
    assert not store._want_sharded()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert store._want_sharded()
    with default_mesh(make_mesh(2, device="cpu")):
        assert store.k_hop([0], EdgeType.CALLS, 2) == {1: 1}
        assert store.k_hop([1], EdgeType.CALLS, 2, reverse=True) == {0: 1}
    assert len(store._sharded_graphs[EdgeType.CALLS].src) == 2


def test_metadata_stage_raises_not_ported():
    """The metadata stage is ported: default settings (metadata on, no
    generator given) construct, and a given generator is kept."""
    orch = PipelineOrchestrator(".", Embedder(HashEmbedder(dimensions=8)),
                                settings=Settings(), device="cpu")
    assert orch.ctx.settings.metadata.enabled
    assert orch.ctx.metadata_generator is None
    assert orch.ctx.indexer.code.device.type == "cpu"
    generator = object()
    orch = PipelineOrchestrator(".", Embedder(HashEmbedder(dimensions=8)),
                                settings=Settings(), device="cpu",
                                metadata_generator=generator)
    assert orch.ctx.metadata_generator is generator


def test_build_golden_engine_defaults_to_cuda(monkeypatch, tmp_path):
    from lattice_tpu_torch.query.golden_eval import build_golden_engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VectorStoreError, match="CUDA is not available"):
        build_golden_engine(work_dir=str(tmp_path))


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A QueryEngine over a two-file repository indexed on the CPU."""
    from lattice_tpu_torch.query.engine import QueryEngine
    repo = tmp_path_factory.mktemp("two")
    (repo / "base.py").write_text(
        "class Queue:\n    def drain(self):\n        return []\n")
    (repo / "jobs.py").write_text(
        "from base import Queue\n\n\nclass Jobs(Queue):\n"
        "    def run(self):\n        return self.drain()\n")
    ctx = asyncio.run(PipelineOrchestrator(
        repo, Embedder(HashEmbedder(dimensions=32)), settings=_no_metadata(),
        device="cpu").run())
    assert ctx.errors == []
    return QueryEngine(ctx.graph_builder.store, ctx.indexer)


def test_engine_serves_on_its_stores_device(engine):
    assert engine.indexer.code.device.type == "cpu"
    result = engine.deep_search("who calls drain?")
    assert result.results and "deep_fuse_ms" in result.phase_times_ms
    assert [r.query for r in engine.deep_search_batch(
        ["who calls drain?", "what does Jobs extend?"])] == [
        "who calls drain?", "what does Jobs extend?"]


def test_device_deep_branch_serves_on_the_stores_device(monkeypatch, engine):
    """Forced onto the device branch, the engine answers on its CPU
    stores: the rank columns live there, the caller is found through the
    reach, and the batch answers as the sequential calls do."""
    monkeypatch.setattr(engine, "DEEP_DEVICE_THRESHOLD", 1)
    result = engine.deep_search("who calls drain?")
    names = [r.qualified_name for r in result.results]
    assert any(n.endswith("Jobs.run") for n in names), names
    cols = engine.indexer.code.device_rank_columns(engine.graph_store)
    assert cols.degree.device.type == cols.quality.device.type == "cpu"
    texts = ["who calls drain?", "what does Jobs extend?"]
    batch = engine.deep_search_batch(texts)
    assert [[r.qualified_name for r in b.results] for b in batch] == [
        [r.qualified_name for r in engine.deep_search(t).results]
        for t in texts]


def test_sharded_deep_branch_raises_not_ported(monkeypatch, engine):
    """The sharded deep branch serves: with the stores' one mesh set to
    three logical shards on the CPU, `deep_search` and
    `deep_search_batch` rank through the store's sharded view as the
    unsharded device branch ranks, and the graph phase walks the sharded
    graph; outside the block the branch is off."""
    from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
    monkeypatch.setattr(engine, "DEEP_DEVICE_THRESHOLD", 1)
    texts = ["who calls drain?", "what does Jobs extend?"]
    want = [engine.deep_search(t) for t in texts]
    want_sync = engine.search_sync(texts[0])
    store, graph = engine.indexer.code, engine.graph_store
    mesh = make_mesh(3, device="cpu")
    monkeypatch.setenv("LATTICE_SHARDED", "1")
    assert not engine._sharded_deep_enabled()
    with default_mesh(mesh):
        assert engine._sharded_deep_enabled()
        got = [engine.deep_search(t) for t in texts]
        assert store._sharded_rank is not None
        assert store._sharded_rank[3].mesh == mesh
        batch = engine.deep_search_batch(texts)
        sync = engine.search_sync(texts[0])
        walked = set(graph._sharded_graphs)
    assert not engine._sharded_deep_enabled()
    for w, g, b in zip(want, got, batch):
        assert [(r.qualified_name, r.source) for r in g.results] == [
            (r.qualified_name, r.source) for r in w.results]
        assert [r.qualified_name for r in b.results] == [
            r.qualified_name for r in w.results]
        for x, y in zip(g.results, w.results):
            assert abs(x.score - y.score) <= 1e-5
    assert EdgeType.CALLS in walked
    assert [r.qualified_name for r in sync.results] == [
        r.qualified_name for r in want_sync.results]


def test_device_failures_are_not_degraded_answers(monkeypatch, engine):
    """A kernel that fails in the vector phase raises; a host failure
    degrades to the other side's results, as in the reference."""
    from lattice_tpu_torch.core.errors import KernelError

    def fail(exc):
        def search_code(*args, **kwargs):
            raise exc
        return search_code

    monkeypatch.setattr(engine.vector_searcher, "search_code",
                        fail(KernelError("launch failed")))
    with pytest.raises(KernelError, match="launch failed"):
        engine.search_sync("who calls drain?")
    monkeypatch.setattr(engine.vector_searcher, "search_code",
                        fail(ValueError("host bug")))
    result = engine.search_sync("who calls drain?")
    assert result.results
    assert all(r.source.value == "graph" for r in result.results)
