"""The serving frontend over the store's sharded plan: the port against
the JAX package.

Mirror of `tests/test_serving_sharded.py`. The frontend only calls
`store.search_device(..., method=...)`, so pointing it at a store whose
mesh has more than one shard serves the sharded plan with no frontend
change. The JAX store shards over the 8 virtual CPU devices
(`tests/conftest.py`); the port's over four logical shards on the CPU
(`default_mesh(make_mesh(4, device="cpu"))`, the stores' one mesh). Both
take the same rows and queries: coalesced batches serve through the sharded view and
equal the flat plan's winners (the store's sharded route answers at the
flat scan's precision, scores within 1e-6 of the JAX frontend's), filters
ride the sharded mask, a mutation between batches reaches the next one
through the view's O(delta) update, and the HTTP layer mints a
`method="sharded"` router config from a request body.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.serving import BatchingFrontend as JaxFrontend
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
from lattice_tpu_torch.serving import BatchingFrontend

N, D = 96, 32


def _vecs(n, seed):
    rng = np.random.default_rng(seed)
    return topk_ops.l2_normalize(
        rng.standard_normal((n, D)).astype(np.float32))


def _payloads():
    return [{"file_path": f"f{i % 4}.py", "content_hash": "h",
             "name": f"fn{i}"} for i in range(N)]


@pytest.fixture()
def store():
    st = ChunkStore(dim=D, dtype="float32", initial_capacity=128,
                    device="cpu")
    st.add(_vecs(N, seed=7), _payloads())
    with default_mesh(make_mesh(4, device="cpu")):
        yield st


@pytest.fixture()
def jax_store():
    st = JaxStore(dim=D, dtype="float32", initial_capacity=128)
    st.add(_vecs(N, seed=7), _payloads())
    return st


class TestFrontendSharded:
    def test_coalesced_batch_serves_sharded_and_matches_flat(self, store,
                                                             jax_store):
        qs = _vecs(8, seed=8)
        with BatchingFrontend(store, max_batch=16, max_wait_ms=250,
                              method="sharded") as fe:
            futs = [fe.submit(q, k=6) for q in qs]
            results = [f.result(timeout=60) for f in futs]
        assert fe.stats.batches == 1 and fe.stats.queries == 8
        assert store._sharded is not None
        with JaxFrontend(jax_store, max_batch=16, max_wait_ms=250,
                         method="sharded") as jfe:
            jres = [f.result(timeout=60)
                    for f in [jfe.submit(q, k=6) for q in qs]]
        flat = store.search(qs, k=6, method="flat")
        for qi, (scores, ids) in enumerate(results):
            assert ids.tolist() == [r for r, _, _ in flat[qi]]
            np.testing.assert_allclose(
                scores, [s for _, s, _ in flat[qi]], atol=1e-6)
            np.testing.assert_array_equal(ids, jres[qi][1])
            np.testing.assert_allclose(scores, jres[qi][0], atol=1e-6)

    def test_filters_ride_sharded_frontend(self, store, jax_store):
        q = _vecs(1, seed=9)[0]
        f = {"file_path": "f1.py"}
        with BatchingFrontend(store, max_wait_ms=50, filters=f,
                              method="sharded") as fe:
            scores, ids = fe.submit(q, k=8).result(timeout=60)
        live = [int(i) for i in ids.tolist() if i >= 0]
        assert live and all(store.payload(r)["file_path"] == "f1.py"
                            for r in live)
        flat = store.search(q[None, :], k=8, filters=f, method="flat")
        assert [r for r, _, _ in flat[0]] == live
        with JaxFrontend(jax_store, max_wait_ms=50, filters=f,
                         method="sharded") as jfe:
            _, jids = jfe.submit(q, k=8).result(timeout=60)
        np.testing.assert_array_equal(ids, jids)

    def test_mutation_mid_serve_reaches_next_batch(self, store):
        with BatchingFrontend(store, max_wait_ms=20,
                              method="sharded") as fe:
            fe.submit(_vecs(1, seed=10)[0], k=4).result(timeout=60)
            view = store._sharded
            new = _vecs(1, seed=11)
            rows = store.add(new, [{"file_path": "new.py",
                                    "content_hash": "h2",
                                    "name": "brand_new"}])
            _, ids = fe.submit(new[0], k=1).result(timeout=60)
            assert int(ids[0]) == rows[0]
            assert store._sharded is view and not store._sharded_dirty

    def test_threaded_submitters_sharded(self, store):
        qs = _vecs(16, seed=12)
        flat = store.search(qs, k=5, method="flat")
        errors: list[Exception] = []
        results: dict[int, np.ndarray] = {}
        with BatchingFrontend(store, max_batch=16, max_wait_ms=150,
                              method="sharded") as fe:
            def client(i):
                try:
                    _, ids = fe.submit(qs[i], k=5).result(timeout=60)
                    results[i] = ids
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        assert not errors and len(results) == 16
        for i, ids in results.items():
            assert ids.tolist() == [r for r, _, _ in flat[i]]


class TestHTTPSharded:
    def test_request_body_method_sharded(self, store):
        from lattice_tpu_torch.serving.http import ServingHTTPServer

        def fake_embed(text: str) -> np.ndarray:
            return _vecs(1, seed=abs(hash(text)) % 2**31)[0]

        with ServingHTTPServer(store, fake_embed, max_wait_ms=20) as srv:
            host, port = srv.address
            q = _vecs(1, seed=13)[0]
            body = {"vector": [float(x) for x in q], "k": 6,
                    "method": "sharded"}
            req = urllib.request.Request(
                f"http://{host}:{port}/v1/search_vector",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                hits = json.loads(r.read())["hits"]
            with urllib.request.urlopen(
                    f"http://{host}:{port}/v1/stats", timeout=60) as r:
                stats = json.loads(r.read())
        flat = store.search(q[None, :], k=6, method="flat")
        assert [h["row"] for h in hits] == [r for r, _, _ in flat[0]]
        assert store._sharded is not None
        cfg_keys = [k for k in stats["configs"] if "sharded" in k]
        assert cfg_keys, f"no sharded router config in {stats['configs']}"
        assert stats["configs"][cfg_keys[0]]["queries"] >= 1
