"""The persisted index, between the two packages and within the port.

A copy of the golden fixture goes through both packages' orchestrators
(hash embedder at dim 128, `index_dtype` float32, metadata off; the
port's on `device="cpu"`) and each package saves its index. The
manifests are equal (dtype "float32", never "torch.float32"), and so are
the saved arrays, strings and payloads (the port stores the rows without
compression). Then each package loads the
other's index: the port the JAX package's, the JAX package the port's.
Both engines, served through "flat", give every golden case the same top
10 (names equal and in order, scores within 1e-5).

Within the port: `save_chunks`' one gather is bit-equal to reading the
rows one by one on a bf16 store with holes, and a reload gives the same
bf16 bits; the IVF partition and a hollow verdict survive a round trip
(as `test_pipeline_e2e.py` holds the JAX package), and a partition saved
by the JAX package restores in the port; a dims mismatch is refused and a
fingerprint mismatch warns; a loaded graph's device edges, liveness and
degrees equal those of the graph it was saved from; an IVF restore that
fails with a kernel error or a CUDA out-of-memory raises, any other
failure is logged; and the default device raises without CUDA.
"""

import asyncio
import functools
import json
import logging
import shutil
import zipfile

import numpy as np
import pytest
import torch

from lattice_tpu.config.settings import Settings as JaxSettings
from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
from lattice_tpu.pipeline.orchestrator import (
    PipelineOrchestrator as JaxOrchestrator)
from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
from lattice_tpu.query import golden_eval as jge
from lattice_tpu.query.engine import QueryEngine as JaxEngine
from lattice_tpu.storage import persistence as jp
from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.errors import (KernelError, StorageError,
                                          VectorStoreError)
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.providers.hash_provider import HashEmbedder
from lattice_tpu_torch.query.engine import QueryEngine
from lattice_tpu_torch.storage import persistence as pp

DIM = 128
K = 10
SCORE_TOL = 1e-5
CASES = jge.load_cases()
PROJECT = "golden_eval"


def _settings(cls):
    settings = cls()
    settings.device.index_dtype = "float32"
    settings.metadata.enabled = False
    return settings


def _save(mod, ctx, data_dir) -> None:
    mod.save_index(data_dir, ctx.graph_builder.store, ctx.indexer,
                   project=PROJECT, provider="hash",
                   file_hashes={f.relative_path: f.content_hash
                                for f in ctx.files})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(JAX run, port run, JAX-saved dir, port-saved dir)."""
    root = tmp_path_factory.mktemp("persist")
    repo = root / "golden"
    shutil.copytree(jge.FIXTURE_PATH, repo)
    jctx = asyncio.run(JaxOrchestrator(
        repo, JaxEmbedder(JaxHash(dimensions=DIM)), project_name=PROJECT,
        settings=_settings(JaxSettings)).run())
    pctx = asyncio.run(PipelineOrchestrator(
        repo, Embedder(HashEmbedder(dimensions=DIM)), project_name=PROJECT,
        settings=_settings(Settings), device="cpu").run())
    assert jctx.errors == [] and pctx.errors == []
    _save(jp, jctx, root / "jax")
    _save(pp, pctx, root / "port")
    return jctx, pctx, root / "jax", root / "port"


def test_manifests_equal(saved):
    _, _, jdir, pdir = saved
    jm, pm = jp.read_manifest(jdir), pp.read_manifest(pdir)
    assert pm == jm
    assert pm["dtype"] == "float32" and pm["dims"] == DIM
    assert pm["weights_fingerprint"] == "HashEmbedder-d128"
    assert len(pm["file_hashes"]) == 68


@pytest.mark.parametrize("name", ["graph", "code_chunks", "summaries"])
def test_saved_arrays_equal(saved, name):
    _, _, jdir, pdir = saved
    a, b = np.load(jdir / f"{name}.npz"), np.load(pdir / f"{name}.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key
    for suffix in ("_strings.json", "_payloads.json"):
        path = jdir / f"{name}{suffix}"
        if path.is_file():
            assert json.loads((pdir / f"{name}{suffix}").read_text()) == \
                json.loads(path.read_text())
    assert not (pdir / f"{name}_ivf.npz").exists()
    # the port stores the rows without compression (the JAX package's
    # np.load reads both)
    with zipfile.ZipFile(pdir / f"{name}.npz") as z:
        methods = {i.compress_type for i in z.infolist()}
    assert methods == ({zipfile.ZIP_DEFLATED} if name == "graph"
                       else {zipfile.ZIP_STORED})


def _flat(engine):
    for store in (engine.indexer.code, engine.indexer.summaries):
        store.search = functools.partial(store.search, method="flat")
    return engine


def _run(engine, case) -> list:
    if case["path"] == "deep":
        return engine.deep_search(case["query"], limit=K).results
    return engine.search_sync(case["query"], limit=K).results


@pytest.fixture(scope="module")
def crossed(saved):
    """Each package's engine over the other package's saved index, and
    what each gives on every golden case."""
    _, _, jdir, pdir = saved
    graph, indexer, pman = pp.load_index(
        jdir, Embedder(HashEmbedder(dimensions=DIM)), device="cpu")
    port = _flat(QueryEngine(graph, indexer))
    jgraph, jindexer, jman = jp.load_index(
        pdir, JaxEmbedder(JaxHash(dimensions=DIM)))
    jax = _flat(JaxEngine(jgraph, jindexer))
    assert pman == jman
    return port, jax, [(_run(port, c), _run(jax, c)) for c in CASES]


def test_each_package_loads_the_others_index(crossed):
    port, jax, _ = crossed
    assert port.indexer.code.device.type == "cpu"
    assert port.indexer.code.dtype == torch.float32
    assert len(port.indexer.code) == len(jax.indexer.code) > 600
    assert len(port.indexer.summaries) == len(jax.indexer.summaries) > 300
    assert port.graph_store.stats == jax.graph_store.stats
    assert port.indexer.code._payloads[:len(port.indexer.code)] == \
        jax.indexer.code._payloads[:len(jax.indexer.code)]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_loaded_engines_answer_alike(crossed, i):
    p, j = crossed[2][i]
    where = CASES[i]["query"]
    assert len(p) == len(j) > 0, where
    assert [r.qualified_name for r in p] == [r.qualified_name for r in j], \
        where
    for x, y in zip(p, j):
        assert abs(x.score - y.score) <= SCORE_TOL, (where, x.score, y.score)


def _holey_store(dtype="bfloat16", n=300, dim=48, seed=0) -> ChunkStore:
    rng = np.random.default_rng(seed)
    store = ChunkStore(dim=dim, dtype=dtype, initial_capacity=64,
                       device="cpu")
    store.add(rng.normal(size=(n, dim)).astype(np.float32),
              [{"file_path": f"f{i % 17}.py", "content_hash": f"h{i}",
                "name": f"fn{i}"} for i in range(n)])
    store.remove(list(range(0, n, 7)))
    store.delete_file("f3.py")
    return store


def test_save_chunks_gather_is_bit_equal_to_the_row_loop(tmp_path):
    store = _holey_store()
    assert store._free  # holes
    pp.save_chunks(store, tmp_path, "code_chunks")
    live = [i for i, p in enumerate(store._payloads) if p is not None]
    want = np.stack([store.get_vector(r) for r in live])
    got = np.load(tmp_path / "code_chunks.npz")["embeddings"]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert json.loads((tmp_path / "code_chunks_payloads.json").read_text()) \
        == [store._payloads[r] for r in live]
    # the reload renormalizes the saved bf16 values: the same bits
    again = pp.load_chunks(tmp_path, "code_chunks", store.dim, "bfloat16",
                           device="cpu")
    assert len(again) == len(live)
    assert torch.equal(again._emb[:len(live)].view(torch.int16),
                       store._emb[live].view(torch.int16))
    assert again._payloads[:len(live)] == [store._payloads[r] for r in live]


def test_bf16_manifest_dtype_names_the_jax_dtype(saved, tmp_path):
    _, pctx, _, _ = saved
    indexer = pctx.indexer
    code, summaries = indexer.code, indexer.summaries
    try:
        indexer.code = _holey_store(dim=DIM)
        indexer.summaries = _holey_store(dim=DIM, seed=1)
        pp.save_index(tmp_path, pctx.graph_builder.store, indexer,
                      project=PROJECT, provider="hash", file_hashes={})
    finally:
        indexer.code, indexer.summaries = code, summaries
    assert pp.read_manifest(tmp_path)["dtype"] == "bfloat16"
    # and the JAX package loads it as a bf16 store
    _, jindexer, _ = jp.load_index(tmp_path, JaxEmbedder(JaxHash(
        dimensions=DIM)))
    assert str(jindexer.code.dtype) == "bfloat16"


def _clustered(n=200, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, 4, size=n)] + 0.05 * rng.normal(size=(n, d))
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def test_ivf_partition_roundtrip(tmp_path):
    """Mirror of `test_pipeline_e2e.py::test_ivf_partition_roundtrip`,
    with holes: the id table is remapped to the compacted rows."""
    emb = _clustered()
    s = ChunkStore(dim=32, dtype="float32", device="cpu")
    s.add(emb, [{"file_path": f"f{i}.py", "content_hash": "h"}
                for i in range(200)])
    s.build_ivf(n_clusters=4)
    s.delete_file("f5.py")
    assert s._ivf.measured_recall is not None and not s._ivf_dirty
    pp.save_chunks(s, tmp_path, "code_chunks")
    s2 = pp.load_chunks(tmp_path, "code_chunks", 32, "float32", device="cpu")
    assert s2._ivf is not None and not s2._ivf_dirty
    assert s2._ivf.measured_recall == s._ivf.measured_recall
    assert s2._ivf.measured_nprobe == s._ivf.measured_nprobe
    assert torch.equal(s2._ivf.centroids, s._ivf.centroids)
    live = [i for i, p in enumerate(s._payloads) if p is not None]
    q = emb[:3] + 0.001
    got = s2.search_ivf(q, k=3, nprobe=4)
    want = s.search_ivf(q, k=3, nprobe=4)
    assert [[live[r] for r, _, _ in h] for h in got] == \
        [[r for r, _, _ in h] for h in want]


def test_hollow_ivf_verdict_roundtrip(tmp_path):
    """Mirror of `test_pipeline_e2e.py::test_hollow_ivf_verdict_roundtrip`."""
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(100, 16))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    s = ChunkStore(dim=16, dtype="float32", device="cpu")
    s.add(emb, [{"file_path": "a.py", "content_hash": "h"}] * 100)
    s.build_ivf(n_clusters=4)
    s._ivf.measured_recall = 0.2       # the refusal verdict
    s._ivf.release_buckets()
    pp.save_chunks(s, tmp_path, "code_chunks")
    s2 = pp.load_chunks(tmp_path, "code_chunks", 16, "float32", device="cpu")
    assert s2._ivf is not None and s2._ivf.hollow
    assert s2._ivf.measured_recall == 0.2
    assert not s2._ivf_dirty           # verdict stands, no rebuild


def test_jax_saved_ivf_partition_restores_in_the_port(tmp_path):
    from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
    emb = _clustered(seed=2)
    js = JaxStore(dim=32, dtype="float32")
    js.add(emb, [{"file_path": f"f{i}.py", "content_hash": "h"}
                 for i in range(200)])
    js.build_ivf(n_clusters=4)
    jp.save_chunks(js, tmp_path, "code_chunks")
    s = pp.load_chunks(tmp_path, "code_chunks", 32, "float32", device="cpu")
    assert s._ivf is not None and not s._ivf_dirty and not s._ivf.hollow
    assert s._ivf.measured_recall == js._ivf.measured_recall
    q = emb[:4] + 0.001
    got = s.search_ivf(q, k=3, nprobe=4)
    want = js.search_ivf(q, k=3, nprobe=4)
    assert [[r for r, _, _ in h] for h in got] == \
        [[r for r, _, _ in h] for h in want]


@pytest.mark.parametrize("exc", [KernelError("launch failed"),
                                 torch.cuda.OutOfMemoryError("no memory")])
def test_ivf_restore_device_errors_raise(tmp_path, monkeypatch, exc):
    from lattice_tpu_torch.ops.ivf import IVFIndex
    s = ChunkStore(dim=32, dtype="float32", device="cpu")
    s.add(_clustered(), [{"file_path": "a.py"}] * 200)
    s.build_ivf(n_clusters=4)
    pp.save_chunks(s, tmp_path, "code_chunks")

    def fail(*args, **kwargs):
        raise exc
    monkeypatch.setattr(IVFIndex, "restore", fail)
    with pytest.raises(type(exc)):
        pp.load_chunks(tmp_path, "code_chunks", 32, "float32", device="cpu")


def test_ivf_restore_host_failure_is_logged(tmp_path, monkeypatch, caplog):
    from lattice_tpu_torch.ops.ivf import IVFIndex
    s = ChunkStore(dim=32, dtype="float32", device="cpu")
    s.add(_clustered(), [{"file_path": "a.py"}] * 200)
    s.build_ivf(n_clusters=4)
    pp.save_chunks(s, tmp_path, "code_chunks")

    def fail(*args, **kwargs):
        raise ValueError("corrupt table")
    monkeypatch.setattr(IVFIndex, "restore", fail)
    with caplog.at_level(logging.ERROR,
                         logger="lattice_tpu_torch.storage.persistence"):
        s2 = pp.load_chunks(tmp_path, "code_chunks", 32, "float32",
                            device="cpu")
    assert "IVF restore failed" in caplog.text
    assert s2._ivf is None and s2._ivf_dirty and len(s2) == 200


def test_dims_mismatch_refused(saved):
    with pytest.raises(StorageError, match="dims"):
        pp.load_index(saved[3], Embedder(HashEmbedder(dimensions=64)),
                      device="cpu")


def test_fingerprint_mismatch_warns(saved, caplog):
    pdir = saved[3]
    with caplog.at_level(logging.WARNING,
                         logger="lattice_tpu_torch.storage.persistence"):
        pp.load_index(pdir, Embedder(HashEmbedder(dimensions=DIM)),
                      device="cpu")
    assert "encoder" not in caplog.text

    class OtherWeights(HashEmbedder):
        fingerprint = "unixcoder-pretrained+ft-deadbeef"
    with caplog.at_level(logging.WARNING,
                         logger="lattice_tpu_torch.storage.persistence"):
        pp.load_index(pdir, Embedder(OtherWeights(dimensions=DIM)),
                      device="cpu")
    assert "encoder" in caplog.text


def test_missing_index_is_refused(tmp_path):
    with pytest.raises(StorageError, match="no index found"):
        pp.load_index(tmp_path, Embedder(HashEmbedder(dimensions=DIM)),
                      device="cpu")


def test_default_device_raises_without_cuda(saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VectorStoreError, match="CUDA is not available"):
        pp.load_index(saved[3], Embedder(HashEmbedder(dimensions=DIM)))


@pytest.mark.parametrize("edge_type", list(EdgeType))
def test_loaded_graph_device_tensors_equal_the_indexed_graph(saved,
                                                             edge_type):
    """After a load the device edges, liveness and degrees start empty and
    are built on first use; they equal those of the graph it was saved
    from."""
    _, pctx, _, pdir = saved
    fresh = pctx.graph_builder.store
    loaded = pp.load_graph(pdir, device="cpu")
    assert loaded._device_edges == {}
    assert loaded.generation == 1
    for reverse in (False, True):
        for a, b in zip(loaded.device_edges(edge_type, reverse=reverse,
                                            device="cpu"),
                        fresh.device_edges(edge_type, reverse=reverse,
                                           device="cpu")):
            assert torch.equal(a, b)
    assert torch.equal(loaded.device_alive(device="cpu"),
                       fresh.device_alive(device="cpu"))
    assert torch.equal(loaded.device_degree(edge_type, device="cpu"),
                       fresh.device_degree(edge_type, device="cpu"))
