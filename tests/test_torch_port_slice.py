"""The port's slice as a whole against the JAX package on the golden corpus.

The JAX golden engine (`build_golden_engine`, hash embedder at dim 256)
indexes the golden fixture; its code store moves into a port
`VectorIndexer` through `from_numpy_state`. All 104 golden query texts then
go through both `VectorSearcher`s with the engine's own limit
(`2 * limit`, capped by `max_vector_results`): rows must come back equal
and in the same order, scores within 1e-5. Once through `search_code`
(plan "flat" on the CPU) and once through the forced "quantized" plan on
both stores with the same hash-embedded query vectors.
"""

import numpy as np
import pytest

from lattice_tpu.embeddings.indexer import VectorSearcher as JaxSearcher
from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
from lattice_tpu.query.golden_eval import build_golden_engine, load_cases
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer, VectorSearcher
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

DIM = 256


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    engine, _ctx = build_golden_engine(
        dim=DIM, work_dir=str(tmp_path_factory.mktemp("golden")))
    js = engine.indexer.code
    indexer = VectorIndexer(Embedder(HashEmbedder(dimensions=DIM)),
                            dtype=str(js.dtype), device="cpu")
    indexer.code = ChunkStore.from_numpy_state(
        np.asarray(js._emb), js._valid_host, js._payloads,
        dtype=str(js.dtype), device="cpu")
    limit = min(2 * 10, engine.settings.max_vector_results)
    return (JaxSearcher(engine.indexer), VectorSearcher(indexer),
            load_cases(), limit)


def _same(a, b):
    assert [r.row for r in a] == [r.row for r in b]
    assert [r.graph_node_id for r in a] == [r.graph_node_id for r in b]
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b],
                               atol=1e-5)


def test_golden_store_carried_over(golden):
    jsr, psr, cases, _ = golden
    assert len(cases) == 104
    assert psr.indexer.code.stats["points"] == jsr.indexer.code.stats["points"]
    assert psr.indexer.code.stats["dtype"] == "bfloat16"


def test_search_code_and_lexical_match_jax(golden):
    jsr, psr, cases, limit = golden
    for case in cases:
        a = jsr.search_code(case["query"], limit=limit)
        b = psr.search_code(case["query"], limit=limit)
        assert len(b) == limit
        _same(a, b)
        _same(jsr.search_lexical(case["query"], limit=limit),
              psr.search_lexical(case["query"], limit=limit))


def test_quantized_plan_matches_jax(golden):
    jsr, psr, cases, limit = golden
    js, ps = jsr.indexer.code, psr.indexer.code
    emb_j, emb_p = JaxHash(dimensions=DIM), HashEmbedder(dimensions=DIM)
    q = np.asarray([emb_j.embed(c["query"]) for c in cases], np.float32)
    np.testing.assert_array_equal(
        q, np.asarray([emb_p.embed(c["query"]) for c in cases], np.float32))
    a = js.search(q, limit, method="quantized")
    b = ps.search(q, limit, method="quantized")
    assert [[r for r, _, _ in h] for h in a] == [[r for r, _, _ in h] for h in b]
    for ha, hb in zip(a, b):
        np.testing.assert_allclose([s for _, s, _ in ha], [s for _, s, _ in hb],
                                   atol=1e-5)
