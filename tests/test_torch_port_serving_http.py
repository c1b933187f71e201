"""The port's HTTP serving surface: routes, coalescing across request
threads, error codes, lifecycle, the batch and deep-search endpoints.

Mirror of `tests/test_serving_http.py` against
`lattice_tpu_torch.serving.http` on a real ThreadingHTTPServer on
localhost, with CPU stores and the hash embedder. Then the port against
the JAX package: both `ServingHTTPServer.handle(method, path, body)` take
the same requests against stores (and engines) built from the same rows,
and give the same status, the same rows and names, scores within 1e-6;
the golden eval's line carries the reference's HTTP deep-batch keys.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.serving.http import ServingHTTPServer as JaxServer
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.providers.hash_provider import HashEmbedder
from lattice_tpu_torch.serving.http import ServingHTTPServer

D = 64
TRACER_SERIES = ("lattice_span_", "lattice_trace_")
TEXTS = [f"def handler_{i}(request): return process_{i}(request)"
         for i in range(40)]


@pytest.fixture(scope="module")
def server():
    embedder = HashEmbedder(dimensions=D)
    vecs = np.asarray([embedder.embed(t) for t in TEXTS], dtype=np.float32)
    vecs = topk_ops.l2_normalize(vecs)
    store = ChunkStore(dim=D, device="cpu")
    store.add(vecs, [{"file_path": f"f{i}.py", "name": f"handler_{i}"}
                     for i in range(len(TEXTS))])
    with ServingHTTPServer(store, embedder.embed,
                           max_wait_ms=30) as srv:
        yield srv


def _url(server, path):
    host, port = server.address
    return f"http://{host}:{port}{path}"


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(server, path, body):
    req = urllib.request.Request(
        _url(server, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestRoutes:
    def test_healthz(self, server):
        status, body = _get(server, "/healthz")
        assert status == 200 and body["ok"] and body["corpus"] == 40

    def test_text_search_finds_itself(self, server):
        status, body = _post(server, "/v1/search",
                             {"query": TEXTS[7], "k": 3})
        assert status == 200
        hits = body["hits"]
        assert len(hits) == 3
        assert hits[0]["payload"]["name"] == "handler_7"
        assert hits[0]["score"] > hits[-1]["score"] - 1e-6

    def test_vector_search(self, server):
        emb = HashEmbedder(dimensions=D)
        v = np.asarray(emb.embed(TEXTS[3]), dtype=np.float32)
        v /= np.linalg.norm(v)
        status, body = _post(server, "/v1/search_vector",
                             {"vector": v.tolist(), "k": 2})
        assert status == 200
        assert body["hits"][0]["payload"]["name"] == "handler_3"

    def test_stats_reflect_traffic(self, server):
        # its own traffic: the module's server is shared, in any order
        _post(server, "/v1/search", {"query": TEXTS[0], "k": 1})
        status, body = _get(server, "/v1/stats")
        assert status == 200
        assert body["queries"] >= 1 and body["batches"] >= 1
        assert body["corpus"] == 40

    def test_concurrent_requests_coalesce(self, server):
        before = server.frontend.stats.batches
        results = [None] * 12
        emb = HashEmbedder(dimensions=D)

        def hit(i):
            results[i] = _post(server, "/v1/search",
                               {"query": TEXTS[i], "k": 1})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r[0] == 200 for r in results)
        for i, (_, body) in enumerate(results):
            assert body["hits"][0]["payload"]["name"] == f"handler_{i}"
        # 12 concurrent requests must not take 12 device calls
        assert server.frontend.stats.batches - before < 12


class TestErrors:
    def test_unknown_route_404(self, server):
        status, body = _post(server, "/v1/nope", {})
        assert status == 404

    def test_bad_json_400(self, server):
        req = urllib.request.Request(
            _url(server, "/v1/search"), data=b"{not json",
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 400

    def test_missing_query_400(self, server):
        status, _ = _post(server, "/v1/search", {"k": 3})
        assert status == 400

    def test_wrong_dim_400(self, server):
        status, body = _post(server, "/v1/search_vector",
                             {"vector": [1.0] * (D + 5)})
        assert status == 400 and "vector must be" in body["error"]

    def test_bad_k_400(self, server):
        status, _ = _post(server, "/v1/search",
                          {"query": "x", "k": 0})
        assert status == 400

    def test_query_without_engine_501(self, server):
        status, body = _post(server, "/v1/query", {"query": "who?"})
        assert status == 501


class TestFullEnginePath:
    def test_query_endpoint_with_engine(self, tmp_path):
        # index the tiny corpus through the real pipeline pieces
        from lattice_tpu_torch.embeddings.embedder import Embedder
        from lattice_tpu_torch.embeddings.indexer import VectorIndexer
        from lattice_tpu_torch.index.graph_store import GraphStore
        from lattice_tpu_torch.providers.base import ProviderConfig
        from lattice_tpu_torch.providers.hash_provider import (
            HashEmbeddingProvider,
        )
        from lattice_tpu_torch.query.engine import QueryEngine

        embedder = Embedder(HashEmbeddingProvider(
            ProviderConfig(name="hash", dimensions=D)))
        indexer = VectorIndexer(embedder, device="cpu")
        graph = GraphStore(device="cpu")
        graph.finalize()
        for i, t in enumerate(TEXTS[:8]):
            v = np.asarray(embedder.embed(t), dtype=np.float32)
            v /= np.linalg.norm(v)
            indexer.code.add(v[None, :], [{
                "file_path": f"f{i}.py", "name": f"handler_{i}",
                "qualified_name": f"mod.handler_{i}", "node_type": "function",
                "start_line": 1, "end_line": 2, "content": t,
            }])
        engine = QueryEngine(graph, indexer)
        with ServingHTTPServer(indexer.code, embedder.embed,
                               engine=engine, max_wait_ms=10) as srv:
            status, body = _post(srv, "/v1/query",
                                 {"query": "what does handler_3 do?"})
        assert status == 200
        assert "results" in body and "answer" in body
        assert isinstance(body["phase_times_ms"], dict)


class TestRoutedOptions:
    """filters/method/deadline_ms ride the request body and route through
    the per-configuration FrontendRouter (`serving/router.py`)."""

    def test_filtered_search_routes_and_filters(self, server):
        emb = HashEmbedder(dimensions=D)
        v = np.asarray(emb.embed(TEXTS[3]), dtype=np.float32)
        v /= np.linalg.norm(v)
        configs_before = len(server.router)
        status, body = _post(server, "/v1/search_vector",
                             {"vector": v.tolist(), "k": 5,
                              "filters": {"file_path": "f5.py"},
                              "method": "flat"})
        assert status == 200
        assert [h["payload"]["file_path"] for h in body["hits"]] == ["f5.py"]
        assert len(server.router) > configs_before  # a new config frontend

    def test_bad_filters_400(self, server):
        status, body = _post(server, "/v1/search_vector",
                             {"vector": [0.1] * D, "filters": ["nope"]})
        assert status == 400 and "filters" in body["error"]

    def test_bad_method_400(self, server):
        status, _ = _post(server, "/v1/search_vector",
                          {"vector": [0.1] * D, "method": ""})
        assert status == 400

    def test_bad_deadline_400(self, server):
        status, body = _post(server, "/v1/search_vector",
                             {"vector": [0.1] * D, "deadline_ms": -5})
        assert status == 400 and "deadline_ms" in body["error"]

    def test_generous_deadline_200(self, server):
        status, body = _post(server, "/v1/search_vector",
                             {"vector": [0.1] * D, "k": 2,
                              "deadline_ms": 60000})
        assert status == 200 and len(body["hits"]) == 2

    def test_stats_carry_histogram_and_configs(self, server):
        _post(server, "/v1/search", {"query": TEXTS[0], "k": 1})
        status, body = _get(server, "/v1/stats")
        assert status == 200
        assert sum(body["latency_hist_ms"].values()) == body["queries"]
        assert "_aggregate" in body["configs"]
        assert body["configs"]["_aggregate"]["queries"] >= body["queries"]
        assert body["deadline_expired"] == 0


class TestMetrics:
    def test_prometheus_exposition(self, server):
        # drive some traffic first
        _post(server, "/v1/search", {"query": TEXTS[1], "k": 2})
        host, port = server.address
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert "# TYPE lattice_queries_total counter" in text
        assert "# TYPE lattice_request_latency_ms histogram" in text
        assert 'le="+Inf"' in text
        assert "lattice_corpus_rows 40" in text
        # cumulative buckets: +Inf count equals the histogram _count
        import re
        inf = re.findall(
            r'lattice_request_latency_ms_bucket\{config="(.*?)",'
            r'le="\+Inf"\} (\d+)', text)
        counts = dict(re.findall(
            r'lattice_request_latency_ms_count\{config="(.*?)"\} (\d+)',
            text))
        assert inf and all(counts[cfg] == n for cfg, n in inf)
        # label values escape the config-key JSON's quotes
        assert 'config="{\\"f\\": null' in text

    def test_bucket_cumulativity_monotone(self, server):
        host, port = server.address
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
        import re
        per_cfg = {}
        for cfg, le, n in re.findall(
                r'lattice_request_latency_ms_bucket\{config="(.*?)",'
                r'le="([^"]+)"\} (\d+)', text):
            per_cfg.setdefault(cfg, []).append(int(n))
        for counts in per_cfg.values():
            assert counts == sorted(counts)  # cumulative => monotone


class TestWarmupFlag:
    def test_healthz_cold_by_default(self, server):
        status, body = _get(server, "/healthz")
        assert status == 200 and body["warm"] is False

    def test_server_warmup_precompiles_and_reports_warm(self):
        import time
        rng = np.random.default_rng(5)
        vecs = topk_ops.l2_normalize(
            rng.standard_normal((16, D)).astype(np.float32))
        store = ChunkStore(dim=D, device="cpu")
        store.add(vecs, [{"file_path": f"w{i}.py"} for i in range(16)])
        with ServingHTTPServer(store, max_batch=4, max_wait_ms=5,
                               warmup=True) as srv:
            # warmup runs on a background thread: the socket serves from
            # the start and readiness probes observe the transition
            deadline = time.monotonic() + 120
            body = None
            while time.monotonic() < deadline:
                status, body = _get(srv, "/healthz")
                assert status == 200
                if body["warm"]:
                    break
                time.sleep(0.05)
            assert body is not None and body["warm"] is True
            # warmup traffic must not pollute the served-query counters
            _, stats = _get(srv, "/v1/stats")
            assert stats["queries"] == 0


class TestBatchEndpoints:
    """/v1/search_batch + /v1/search_vector_batch: many queries in one
    HTTP round trip, coalescing through the same router as singles."""

    def test_text_batch_matches_singles(self, server):
        texts = [TEXTS[3], TEXTS[11], TEXTS[29]]
        status, body = _post(server, "/v1/search_batch",
                             {"queries": texts, "k": 3})
        assert status == 200
        results = body["results"]
        assert len(results) == 3
        for t, item in zip(texts, results):
            assert "hits" in item and len(item["hits"]) == 3
            _, single = _post(server, "/v1/search", {"query": t, "k": 3})
            assert [h["row"] for h in item["hits"]] == \
                [h["row"] for h in single["hits"]]

    def test_vector_batch_matches_store_search(self, server):
        rng = np.random.default_rng(17)
        vecs = topk_ops.l2_normalize(
            rng.standard_normal((5, D)).astype(np.float32))
        status, body = _post(
            server, "/v1/search_vector_batch",
            {"vectors": [[float(x) for x in v] for v in vecs], "k": 4})
        assert status == 200
        flat = server.store.search(vecs, k=4)
        for qi, item in enumerate(body["results"]):
            assert [h["row"] for h in item["hits"]] == \
                [r for r, _, _ in flat[qi]]

    def test_batch_coalesces_into_few_device_batches(self, server):
        before = server.frontend.stats.batches
        rng = np.random.default_rng(18)
        vecs = topk_ops.l2_normalize(
            rng.standard_normal((12, D)).astype(np.float32))
        status, body = _post(
            server, "/v1/search_vector_batch",
            {"vectors": [[float(x) for x in v] for v in vecs], "k": 2})
        assert status == 200 and len(body["results"]) == 12
        # 12 queries submitted back-to-back coalesce (max_wait 30 ms)
        assert server.frontend.stats.batches - before <= 3

    def test_batch_validation_errors(self, server):
        cases = [
            ("/v1/search_batch", {"queries": []}),
            ("/v1/search_batch", {"queries": ["ok", ""]}),
            ("/v1/search_batch", {"queries": "not a list"}),
            ("/v1/search_vector_batch", {"vectors": [[0.1], [0.2, 0.3]]}),
            ("/v1/search_vector_batch", {"vectors": []}),
            ("/v1/search_vector_batch",
             {"vectors": [[0.0] * D], "method": "nope"}),
        ]
        for path, body in cases:
            status, resp = _post(server, path, body)
            assert status == 400, (path, body, resp)
        status, _ = _post(server, "/v1/search_batch",
                          {"queries": ["x"] * 1025})
        assert status == 400

    def test_batch_body_above_1mb_is_accepted(self, server):
        """The single-request 1 MB body cap would 413 every documented-
        size batch (1024 x 768-d vectors in JSON is ~8 MB); the batch
        endpoints get their own cap."""
        rng = np.random.default_rng(23)
        # float64 reprs (~20 chars each) push 1024 x 64 dims past 1 MB
        vecs = rng.standard_normal((1024, D))
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        body = {"vectors": [v.tolist() for v in vecs], "k": 1}
        assert len(json.dumps(body).encode()) > 1 << 20
        status, resp = _post(server, "/v1/search_vector_batch", body)
        assert status == 200 and len(resp["results"]) == 1024

    def test_single_endpoint_keeps_1mb_cap(self, server):
        big = {"vector": [0.0] * D, "pad": "x" * ((1 << 20) + 1)}
        try:
            status, resp = _post(server, "/v1/search_vector", big)
        except urllib.error.URLError:
            # the server responds 413 and drops the connection without
            # reading the oversized body — the client can hit a broken
            # pipe mid-send before it ever sees the status line
            return
        assert status == 413

    def test_warmup_on_empty_store_reports_warm(self):
        """'Nothing to warm' IS warm: readiness probes gate on the flag,
        and a valid-but-empty index must not wedge a deploy NotReady
        """
        import time
        with ServingHTTPServer(ChunkStore(dim=D, device="cpu"),
                               warmup=True) as srv:
            deadline = time.monotonic() + 60
            body = None
            while time.monotonic() < deadline:
                _, body = _get(srv, "/healthz")
                if body["warm"]:
                    break
                time.sleep(0.02)
            assert body is not None and body["warm"] is True

    def test_embed_batch_fn_preferred(self):
        rng = np.random.default_rng(19)
        vecs = topk_ops.l2_normalize(
            rng.standard_normal((8, D)).astype(np.float32))
        store = ChunkStore(dim=D, device="cpu")
        store.add(vecs, [{"file_path": f"b{i}.py"} for i in range(8)])
        calls = {"single": 0, "batch": 0}

        def embed(t):
            calls["single"] += 1
            return vecs[0]

        def embed_batch(ts):
            calls["batch"] += 1
            return np.stack([vecs[hash(t) % 8] for t in ts])

        with ServingHTTPServer(store, embed, embed_batch_fn=embed_batch,
                               max_wait_ms=5) as srv:
            status, body = _post(srv, "/v1/search_batch",
                                 {"queries": ["a", "b", "c"], "k": 2})
        assert status == 200 and len(body["results"]) == 3
        assert calls["batch"] == 1 and calls["single"] == 0


class TestDeepSearchEndpoints:
    """/v1/deep_search + /v1/deep_search_batch: the corpus-wide hybrid
    rank over HTTP; the batch form is one batched engine call."""

    @pytest.fixture(scope="class")
    def engine_server(self):
        from lattice_tpu_torch.embeddings.embedder import Embedder
        from lattice_tpu_torch.embeddings.indexer import VectorIndexer
        from lattice_tpu_torch.index.graph_store import GraphStore
        from lattice_tpu_torch.providers.base import ProviderConfig
        from lattice_tpu_torch.providers.hash_provider import (
            HashEmbeddingProvider,
        )
        from lattice_tpu_torch.query.engine import QueryEngine

        embedder = Embedder(HashEmbeddingProvider(
            ProviderConfig(name="hash", dimensions=D)))
        indexer = VectorIndexer(embedder, device="cpu")
        graph = GraphStore(device="cpu")
        graph.finalize()
        for i, t in enumerate(TEXTS[:12]):
            v = np.asarray(embedder.embed(t), dtype=np.float32)
            v /= np.linalg.norm(v)
            indexer.code.add(v[None, :], [{
                "file_path": f"f{i}.py", "name": f"mod.handler_{i}",
                "qualified_name": f"mod.handler_{i}",
                "node_type": "function",
                "start_line": 1, "end_line": 2, "content": t,
            }])
        engine = QueryEngine(graph, indexer)
        with ServingHTTPServer(indexer.code, embedder.embed,
                               engine=engine, max_wait_ms=10) as srv:
            yield srv, engine

    def test_single_deep_search(self, engine_server):
        srv, _ = engine_server
        status, body = _post(srv, "/v1/deep_search",
                             {"query": "handler_5 request processing",
                              "limit": 5})
        assert status == 200
        assert body["results"] and "phase_times_ms" in body
        assert len(body["results"]) <= 5

    def test_batch_matches_sequential(self, engine_server):
        """The batched path must return exactly what sequential deep
        searches return — batching is a transport optimization, not a
        ranking change."""
        srv, engine = engine_server
        queries = [f"handler_{i} request processing" for i in (1, 4, 9)]
        status, body = _post(srv, "/v1/deep_search_batch",
                             {"queries": queries, "limit": 5})
        assert status == 200
        got = [[h["name"] for h in item["results"]]
               for item in body["results"]]
        expected = [[r.qualified_name
                     for r in engine.deep_search(q, 5).results]
                    for q in queries]
        assert got == expected

    def test_batch_validation(self, engine_server):
        srv, _ = engine_server
        for bad in ({"queries": []}, {"queries": ["ok", ""]},
                    {"queries": "not a list"},
                    {"queries": ["x"], "limit": 0},
                    {"queries": ["x"] * 1025}):
            status, _body = _post(srv, "/v1/deep_search_batch", bad)
            assert status == 400, bad

    def test_no_engine_501(self, server):
        for path in ("/v1/deep_search", "/v1/deep_search_batch"):
            status, _body = _post(server, path,
                                  {"query": "x", "queries": ["x"]})
            assert status == 501


# ---- the port against the JAX package --------------------------------------


def _pair_servers(n_rows=40, **kw):
    """Both packages' servers, started (`shutdown` waits for the serve
    loop), over stores of the same rows and the same hash embedder; the
    tests call `handle` directly."""
    from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
    jemb, pemb = JaxHash(dimensions=D), HashEmbedder(dimensions=D)
    vecs = topk_ops.l2_normalize(np.asarray(
        [pemb.embed(t) for t in TEXTS[:n_rows]], dtype=np.float32))
    pl = [{"file_path": f"f{i}.py", "name": f"handler_{i}",
           "language": "go" if i % 2 else "python"} for i in range(n_rows)]
    js, ps = JaxStore(dim=D), ChunkStore(dim=D, device="cpu")
    assert js.add(vecs, pl) == ps.add(vecs, pl)
    return (JaxServer(js, jemb.embed, max_wait_ms=5, **kw).start(),
            ServingHTTPServer(ps, pemb.embed, max_wait_ms=5, **kw).start())


def _same_response(got, want):
    """Same status and keys; hits: the same rows and payloads, scores
    within 1e-6; errors: both present."""
    (gs, gb), (ws, wb) = got, want
    assert gs == ws, (gb, wb)
    assert set(gb) == set(wb)
    if "hits" in wb:
        assert [(h["row"], h["payload"]) for h in gb["hits"]] == \
            [(h["row"], h["payload"]) for h in wb["hits"]]
        np.testing.assert_allclose([h["score"] for h in gb["hits"]],
                                   [h["score"] for h in wb["hits"]],
                                   atol=1e-6)
    if "results" in wb and isinstance(wb["results"], list):
        assert len(gb["results"]) == len(wb["results"])
        for g, w in zip(gb["results"], wb["results"]):
            _same_response((200, g), (200, w))


REQUESTS = [
    ("POST", "/v1/search", {"query": TEXTS[7], "k": 3}),
    ("POST", "/v1/search", {"query": TEXTS[2], "k": 5,
                            "filters": {"language": "go"}}),
    ("POST", "/v1/search", {"query": TEXTS[9], "k": 4, "method": "flat"}),
    ("POST", "/v1/search", {"query": TEXTS[9], "k": 4,
                            "method": "quantized"}),
    ("POST", "/v1/search", {"query": TEXTS[11], "k": 6, "method": "pq"}),
    ("POST", "/v1/search", {"query": TEXTS[3], "k": 2, "method": "int4"}),
    ("POST", "/v1/search", {"query": TEXTS[1], "k": 50}),
    ("POST", "/v1/search_batch", {"queries": TEXTS[:5], "k": 3}),
    ("POST", "/v1/search_batch", {"queries": TEXTS[5:9], "k": 2,
                                  "filters": {"file_path": "f6.py"}}),
    ("POST", "/v1/search_vector_batch", "vectors"),
    ("POST", "/v1/search_vector", "vector"),
    ("POST", "/v1/search", {"k": 3}),
    ("POST", "/v1/search", {"query": "x", "k": 0}),
    ("POST", "/v1/search", {"query": "x", "method": "nope"}),
    ("POST", "/v1/search_vector", {"vector": [1.0] * (D + 1)}),
    ("POST", "/v1/search_vector", {"vector": [0.1] * D,
                                   "deadline_ms": -1}),
    ("POST", "/v1/query", {"query": "who?"}),
    ("POST", "/v1/deep_search", {"query": "x"}),
    ("POST", "/v1/nope", {}),
    ("GET", "/healthz", {}),
]


@pytest.mark.parametrize("method, path, body", REQUESTS,
                         ids=[f"{i}-{r[1]}" for i, r in
                              enumerate(REQUESTS)])
def test_handle_equals_jax(method, path, body):
    jsrv, psrv = _pair_servers()
    try:
        rng = np.random.default_rng(41)
        if body == "vectors":
            body = {"vectors": topk_ops.l2_normalize(rng.standard_normal(
                (6, D)).astype(np.float32)).tolist(), "k": 4}
        elif body == "vector":
            body = {"vector": rng.standard_normal(D).tolist(), "k": 7,
                    "filters": {"language": "python"}}
        _same_response(psrv.handle(method, path, body),
                       jsrv.handle(method, path, body))
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_stats_and_metrics_equal_jax_after_the_same_traffic():
    """The same requests, then `/v1/stats`: the same counters (but the
    latencies), configuration keys and corpus; `/metrics` the same metric
    names and label sets."""
    import re
    jsrv, psrv = _pair_servers()
    try:
        for srv in (jsrv, psrv):
            for method, path, body in REQUESTS[:9]:
                srv.handle(method, path, body)
        (js, jb), (ps, pb) = (jsrv.handle("GET", "/v1/stats", {}),
                              psrv.handle("GET", "/v1/stats", {}))
        assert js == ps == 200
        for key in ("queries", "batches", "errors", "deadline_expired",
                    "rejected_overload", "corpus"):
            assert pb[key] == jb[key], key
        assert set(pb["configs"]) == set(jb["configs"])
        assert pb["configs"]["_aggregate"]["queries"] == \
            jb["configs"]["_aggregate"]["queries"]

        def series(text):
            return sorted({m.group(1) for m in re.finditer(
                r"^([a-z_]+(?:\{config=\"[^\n]*?\"\})?)", text, re.M)})
        # the port's tracer series (`lattice_span_*`, `lattice_trace_*`)
        # have no counterpart in the JAX package
        assert [name for name in series(psrv.metrics_text())
                if not name.startswith(TRACER_SERIES)] == \
            series(jsrv.metrics_text())
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_engine_endpoints_equal_jax():
    """`/v1/query`, `/v1/deep_search` and `/v1/deep_search_batch` over
    both packages' golden engines: the same status and names, scores
    within 1e-6, the same answer text."""
    from lattice_tpu.query import golden_eval as jge
    from lattice_tpu_torch.query import golden_eval as pge
    jeng, _ = jge.build_golden_engine()
    peng, _ = pge.build_golden_engine(device="cpu")
    cases = [c["query"] for c in pge.load_cases()][:40:5]
    jsrv = JaxServer(jeng.indexer.code, jeng.vector_searcher.embedder.embed,
                     engine=jeng, max_wait_ms=2).start()
    psrv = ServingHTTPServer(peng.indexer.code,
                             peng.vector_searcher.embedder.embed,
                             engine=peng, max_wait_ms=2).start()
    try:
        for path, body in [("/v1/deep_search_batch",
                            {"queries": cases, "limit": 10})] + [
                (p, {"query": q, "limit": 8}) for q in cases[:4]
                for p in ("/v1/query", "/v1/deep_search")]:
            (gs, gb), (ws, wb) = (psrv.handle("POST", path, body),
                                  jsrv.handle("POST", path, body))
            assert gs == ws == 200
            items = (list(zip(gb["results"], wb["results"]))
                     if path.endswith("_batch") else [(gb, wb)])
            for g, w in items:
                assert [r["name"] for r in g["results"]] == \
                    [r["name"] for r in w["results"]], path
                np.testing.assert_allclose(
                    [r["score"] for r in g["results"]],
                    [r["score"] for r in w["results"]], atol=1e-6)
            assert gb.get("answer") == wb.get("answer")
    finally:
        jsrv.shutdown()
        psrv.shutdown()


def test_golden_eval_line_has_the_http_deep_batch_keys(capsys):
    """`python -m lattice_tpu_torch.query.golden_eval --device cpu`: the
    line carries the reference's `http_deep_batch_ms_per_q` and
    `http_deep_batch_n` (the golden set's deep questions, up to 16),
    and no error key."""
    from lattice_tpu_torch.query import golden_eval as pge
    pge.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n_deep = sum(c["path"] == "deep" for c in pge.load_cases())
    assert line["http_deep_batch_n"] == min(16, n_deep) == 12
    assert line["http_deep_batch_ms_per_q"] > 0
    assert "http_deep_batch_error" not in line
    assert line["mrr"] == pytest.approx(0.9148, abs=1e-4)


def test_golden_eval_http_surface_reraises_device_errors(monkeypatch):
    """A kernel error on the HTTP deep-batch surface raises out of the
    eval; any other failure becomes the line's `http_deep_batch_error`."""
    from lattice_tpu_torch.core.errors import KernelError
    from lattice_tpu_torch.query import golden_eval as pge

    def fail(exc):
        def http_deep_batch(engine, cases):
            raise exc
        return http_deep_batch
    monkeypatch.setattr(pge, "http_deep_batch", fail(KernelError("launch")))
    with pytest.raises(KernelError):
        pge.main(["--device", "cpu"])


def test_the_tracer_is_exported_with_lattice_trace_on():
    """A CPU server in a process started with `LATTICE_TRACE=1`: after
    forced "quantized" searches, `/v1/stats` carries the tracer's spans
    and counters and `/metrics` its span totals, self totals, counts and
    counters, one series a span."""
    code = """
import json, re, sys
import numpy as np
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.serving.http import ServingHTTPServer
from lattice_tpu_torch.utils.tracing import get_tracer
rng = np.random.default_rng(0)
store = ChunkStore(dim=64, device="cpu")
store.add(rng.standard_normal((300, 64)).astype(np.float32),
          [{"file_path": f"f{i}.py"} for i in range(300)])
get_tracer().count("probe.count", 7)
with ServingHTTPServer(store, None, max_wait_ms=1) as srv:
    for i in range(3):
        status, _ = srv.handle("POST", "/v1/search_vector", {
            "vector": rng.standard_normal(64).tolist(), "k": 4,
            "method": "quantized"})
        assert status == 200, status
    _, stats = srv.handle("GET", "/v1/stats", {})
    text = srv.metrics_text()
print(json.dumps({"stats": stats["spans"], "metrics": [
    line for line in text.splitlines()
    if line.startswith(("lattice_span_", "lattice_trace_"))]}))
"""
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = {**os.environ, "LATTICE_TRACE": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    spans = got["stats"]["spans"]
    for name in ("search.device", "search.plan", "search.quantize",
                 "search.first_stage", "search.rescore"):
        assert spans[name]["count"] == 3, name
        assert set(spans[name]) == {"count", "total_ms", "self_ms",
                                    "max_ms"}
    assert got["stats"]["counters"] == {"probe.count": 7}
    lines = got["metrics"]
    assert 'lattice_trace_count_total{counter="probe.count"} 7' in lines
    assert 'lattice_span_calls_total{span="search.plan"} 3' in lines
    for metric in ("lattice_span_seconds_total",
                   "lattice_span_self_seconds_total"):
        (line,) = [ln for ln in lines
                   if ln.startswith(f'{metric}{{span="search.device"}}')]
        assert float(line.split()[-1]) >= 0
    seconds = {ln.split('"')[1]: float(ln.split()[-1]) for ln in lines
               if ln.startswith("lattice_span_seconds_total")}
    assert seconds["search.device"] == pytest.approx(
        spans["search.device"]["total_ms"] / 1e3)
