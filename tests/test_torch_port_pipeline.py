"""The index side of the main path, through both packages, on the golden
fixture.

One copy of `tests/fixtures/golden_project` goes through the JAX
`PipelineOrchestrator` and the port's (`device="cpu"`), each with its
default `Settings()` and the metadata stage off, and the hash embedder at
dim 256, as `build_golden_engine` indexes it. Both must give the same
graph (nodes, and the edges of every `EdgeType`), the same code and
summary payloads in row order, bit-equal bf16 vectors and valid masks,
the same `VectorIndexer.stats`, and the same rows in the same order for
the 104 golden query texts through `search_code` (scores within 1e-5).
Then the incremental path: a second run over the same indexer skips
every file, and after one file is edited only that file is re-indexed,
in both packages alike, with the int8 shadows kept up to date in place
(the forced "quantized" plan gives the same rows before and after).
"""

import asyncio
import shutil

import numpy as np
import pytest
import torch

from lattice_tpu.config.settings import Settings as JaxSettings
from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
from lattice_tpu.embeddings.indexer import VectorSearcher as JaxSearcher
from lattice_tpu.pipeline.orchestrator import (
    PipelineOrchestrator as JaxOrchestrator)
from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
from lattice_tpu.query.golden_eval import FIXTURE_PATH, load_cases
from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorSearcher
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

DIM = 256
EDITED = "app/services/user_service.py"


def _index_jax(repo, indexer=None):
    settings = JaxSettings()
    settings.metadata.enabled = False
    orch = JaxOrchestrator(repo, JaxEmbedder(JaxHash(dimensions=DIM)),
                           project_name="golden_eval", settings=settings,
                           indexer=indexer)
    return asyncio.run(orch.run())


def _index_port(repo, indexer=None):
    settings = Settings()
    settings.metadata.enabled = False
    orch = PipelineOrchestrator(repo, Embedder(HashEmbedder(dimensions=DIM)),
                                project_name="golden_eval", settings=settings,
                                indexer=indexer, device="cpu")
    return asyncio.run(orch.run())


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    repo = tmp_path_factory.mktemp("golden") / "golden"
    shutil.copytree(FIXTURE_PATH, repo)
    jctx, pctx = _index_jax(repo), _index_port(repo)
    assert jctx.errors == [] and pctx.errors == []
    return repo, jctx, pctx


def _graph(store):
    nodes = [(r.qualified_name, r.name, r.entity_type.value, r.file_path,
              r.start_line, r.end_line, bool(store._alive[i]))
             for i, r in enumerate(store.node(i)
                                   for i in range(store.n_nodes()))]
    edges = {}
    for et in store._edges:
        src, dst = store.edges(et)
        edges[et.value] = list(zip(np.asarray(src).tolist(),
                                   np.asarray(dst).tolist()))
    return nodes, edges


def _bf16_bits(jax_emb, port_emb):
    a = np.asarray(jax_emb)
    b = port_emb.cpu()
    assert a.dtype.name == "bfloat16" and b.dtype == torch.bfloat16
    return a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16)


def test_same_graph(indexed):
    _, jctx, pctx = indexed
    js, ps = jctx.graph_builder.store, pctx.graph_builder.store
    jn, je = _graph(js)
    pn, pe = _graph(ps)
    assert len(pn) == 698 and pn == jn
    assert set(pe) == {e.value for e in EdgeType} and pe == je
    assert ps.stats == js.stats
    assert pctx.graph_builder.stats == jctx.graph_builder.stats


@pytest.mark.parametrize("store", ["code", "summaries"])
def test_same_payloads_and_bf16_vectors(indexed, store):
    _, jctx, pctx = indexed
    js, ps = getattr(jctx.indexer, store), getattr(pctx.indexer, store)
    assert len(ps) == len(js) > 0
    assert ps._payloads == js._payloads
    a, b = _bf16_bits(js._emb, ps._emb)
    assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(js._valid_host),
                          ps.device_arrays[1].cpu().numpy())
    assert ps.stats == js.stats


def test_same_indexer_stats_and_progress(indexed):
    _, jctx, pctx = indexed
    assert pctx.indexer.stats == jctx.indexer.stats
    assert pctx.tracker.stats == jctx.tracker.stats
    assert [p.file_info.relative_path for p in pctx.parsed] == \
        [p.file_info.relative_path for p in jctx.parsed]
    assert [p.file_info.relative_path for p in pctx.changed] == \
        [p.file_info.relative_path for p in jctx.changed]


def test_golden_queries_same_rows(indexed):
    _, jctx, pctx = indexed
    cases = load_cases()
    assert len(cases) == 104
    jsr, psr = JaxSearcher(jctx.indexer), VectorSearcher(pctx.indexer)
    limit = min(2 * 10, pctx.settings.query.max_vector_results)
    for case in cases:
        a = jsr.search_code(case["query"], limit=limit)
        b = psr.search_code(case["query"], limit=limit)
        assert len(b) == limit
        assert [r.row for r in a] == [r.row for r in b], case["query"]
        assert [r.graph_node_id for r in a] == [r.graph_node_id for r in b]
        np.testing.assert_allclose([r.score for r in a],
                                   [r.score for r in b], atol=1e-5)
        sa = jsr.search_summaries(case["query"], limit=10)
        sb = psr.search_summaries(case["query"], limit=10)
        assert [r.row for r in sa] == [r.row for r in sb], case["query"]


def test_incremental_runs_match(indexed):
    repo, jctx, pctx = indexed
    n_files = pctx.indexer.stats["files_indexed"]
    j2, p2 = _index_jax(repo, jctx.indexer), _index_port(repo, pctx.indexer)
    assert p2.indexer.stats["files_skipped"] == n_files
    assert p2.indexer.stats["files_indexed"] == n_files
    assert p2.changed == [] and j2.changed == []
    # the int8 shadows exist before the edit, so delete_file + add must
    # keep them up to date in place
    q = np.stack([JaxHash(dimensions=DIM).embed(c["query"])
                  for c in load_cases()[:16]]).astype(np.float32)
    _same_quantized(jctx.indexer.code, pctx.indexer.code, q)
    path = repo / EDITED
    path.write_text(path.read_text() + "\n\ndef added_after_index(x):\n"
                    "    return x + 1\n")
    j3, p3 = _index_jax(repo, jctx.indexer), _index_port(repo, pctx.indexer)
    assert [p.file_info.relative_path for p in p3.changed] == [EDITED]
    assert [p.file_info.relative_path for p in j3.changed] == [EDITED]
    assert p3.indexer.stats == j3.indexer.stats
    assert p3.indexer.stats["files_indexed"] == n_files + 1
    assert p3.indexer.stats["files_skipped"] == 2 * n_files - 1
    js, ps = jctx.indexer.code, pctx.indexer.code
    assert ps._payloads == js._payloads
    a, b = _bf16_bits(js._emb, ps._emb)
    assert np.array_equal(a, b)
    assert any(p and p["name"].endswith(".added_after_index")
               for p in ps._payloads)
    assert pctx.indexer.summaries._payloads == jctx.indexer.summaries._payloads
    assert _graph(p3.graph_builder.store) == _graph(j3.graph_builder.store)
    assert pctx.indexer.code._quant is not None
    assert not pctx.indexer.code._quant_dirty     # updated in place
    _same_quantized(jctx.indexer.code, pctx.indexer.code, q)


def _same_quantized(js, ps, q):
    a = js.search(q, 10, method="quantized")
    b = ps.search(q, 10, method="quantized")
    assert [[r for r, _, _ in h] for h in a] == [[r for r, _, _ in h]
                                                for h in b]
    for ha, hb in zip(a, b):
        np.testing.assert_allclose([x for _, x, _ in ha],
                                   [x for _, x, _ in hb], atol=1e-5)
