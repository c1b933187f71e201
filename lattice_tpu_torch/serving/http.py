"""HTTP serving surface: concurrent search over the live index (torch
port).

Port of `lattice_tpu/serving/http.py`: a stdlib `ThreadingHTTPServer`
(one thread per in-flight request) whose search endpoints all submit to a
shared `FrontendRouter`, so concurrency across HTTP clients becomes batch
size on the card. The store is the port's `ChunkStore`; its
`search_device` runs the plan table's kernels.

Endpoints (JSON in / JSON out):
- ``GET  /healthz``           -> {"ok": true, "corpus": N, "warm": bool}
  (``warm`` flips true once background startup warmup has run the
  default config's pad buckets — readiness probes gate on it; the socket
  serves from the start)
- ``GET  /v1/stats``          -> frontend + store counters, lifetime
  latency histogram, per-configuration rollups
- ``GET  /metrics``           -> the same counters in Prometheus text
  exposition format (the log2 latency histogram maps directly onto a
  Prometheus histogram's cumulative ``le`` buckets)
- ``POST /v1/search``         {"query": str, "k"?: int, "filters"?: obj,
  "method"?: str, "deadline_ms"?: num}  (embeds, then coalesced vector
  search; results carry payloads)
- ``POST /v1/search_vector``  {"vector": [f32...], same options}
- ``POST /v1/search_batch``   {"queries": [str...], same options} — many
  queries in one HTTP round trip; each submits through the same router,
  so the batch coalesces with everyone else's traffic, and per-item
  failures (deadline/overload) report per item
- ``POST /v1/search_vector_batch`` {"vectors": [[f32...]...], same}

Requests naming ``filters``/``method`` route through a `FrontendRouter`
to a per-configuration frontend (each batch must share its filter mask
and plan); ``deadline_ms`` bounds queue wait (exceeded -> 504); a
saturated queue sheds load with 429.
- ``POST /v1/query``          {"query": str, "limit"?: int} — the full
  engine path (plan -> graph ∥ vector -> rank -> answer); synthesis is
  host/LLM work and is served per-request, not batched.
- ``POST /v1/deep_search``       {"query": str, "limit"?: int} — the
  corpus-wide hybrid rank (graph evidence + cosine fused)
- ``POST /v1/deep_search_batch`` {"queries": [str...], "limit"?: int} —
  many deep queries in one batched engine call

Zero dependencies beyond the stdlib; built for tests and co-located
sidecar serving, not as a hardened internet-facing server (no TLS/auth —
put it behind a real ingress for that).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lattice_tpu_torch.index import chunk_store
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.serving.frontend import (
    DeadlineExceeded,
    FrontendStats,
    Overloaded,
)
from lattice_tpu_torch.serving.router import FrontendRouter
from lattice_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20  # 1 MB: a 4096-dim f32 vector in JSON is ~100 KB
# the batch endpoints carry up to MAX_BATCH_ITEMS vectors — 1024 x 768
# floats in JSON is ~8 MB, so the single-request cap would 413 every
# documented-size batch before validation ever saw it
MAX_BATCH_BODY_BYTES = 32 << 20


class _ThreadingHTTPServer(ThreadingHTTPServer):
    """The stdlib server with a listen backlog sized for many concurrent
    clients. The stdlib's is 5: past it the kernel drops new connections'
    SYNs and the clients retry after 1, 3, 7 ... s (64 concurrent clients
    on an H100 host: 5.5 QPS with a frontend p50 of 26 ms)."""

    request_queue_size = 1024


def _tracer_lines(snapshot: dict, esc) -> list[str]:
    """The process tracer's span totals, self totals and counts, and its
    counters (`Tracer.snapshot()`), in Prometheus text: the always-on
    spans, and the hot spans and counters recorded while tracing was on
    (`LATTICE_TRACE=1`)."""
    spans = snapshot["spans"]
    series = [
        ("lattice_span_seconds_total", "Seconds inside each traced span",
         "span", {k: v["total_ms"] / 1e3 for k, v in spans.items()}),
        ("lattice_span_self_seconds_total", "Seconds inside each traced "
         "span less its child spans", "span",
         {k: v["self_ms"] / 1e3 for k, v in spans.items()}),
        ("lattice_span_calls_total", "Times each traced span closed",
         "span", {k: v["count"] for k, v in spans.items()}),
        ("lattice_trace_count_total", "The tracer's counters", "counter",
         snapshot["counters"]),
    ]
    out = []
    for name, help_, label, values in series:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} counter")
        for key, value in values.items():
            out.append(f'{name}{{{label}="{esc(key)}"}} {value}')
    return out


class ServingHTTPServer:
    """Owns the socket, the request threads, and the shared frontend.

    Parameters
    ----------
    store:
        `ChunkStore` serving the vector path.
    embed_fn:
        ``text -> np.ndarray[dim]`` for ``/v1/search`` (e.g.
        ``Embedder.embed``). Optional — without it only the vector
        endpoint works.
    engine:
        Optional `QueryEngine` for ``/v1/query`` (full answer path).
    port:
        0 picks a free port; read it back from ``.address``.
    """

    def __init__(self, store, embed_fn=None, *, engine=None,
                 embed_batch_fn=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 default_k: int = 10, max_queue: int | None = None,
                 max_configs: int = 8, warmup: bool = False):
        self.store = store
        self.embed_fn = embed_fn
        # texts -> [n, dim]; /v1/search_batch prefers it (the encoder
        # embeds a batch in one device call); falls back to embed_fn
        # per item when absent
        self.embed_batch_fn = embed_batch_fn
        self.engine = engine
        self.default_k = int(default_k)
        # warmup=True also warms every ROUTER-MINTED config off the
        # request path: a first request on a new (filters, method) config
        # queues behind its async warmup with the deadline extended
        # instead of paying the one-time costs inside its deadline
        self.router = FrontendRouter(store, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     max_queue=max_queue,
                                     max_configs=max_configs,
                                     warm_on_mint=warmup,
                                     warm_k=default_k)
        # eagerly create the default-configuration frontend so the
        # common no-filter path never pays first-request setup
        fe = self.router.frontend()
        self._httpd = _ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.app = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        # warm=True means the DEFAULT config's pad buckets at default_k
        # have run once (the kernels built, any IVF or PQ build paid).
        # Warming runs on a background thread so the socket serves
        # immediately and readiness probes observe the cold->warm
        # transition instead of connection-refused for the whole warm
        # window.
        self.warm = False
        self._warm_thread: threading.Thread | None = None
        if warmup:
            # the router's warm_on_mint already kicked warmup_async for
            # the default config minted above; this thread just observes
            # its completion for the readiness flag (warming twice would
            # run the same shapes concurrently for nothing)
            def _warm() -> None:
                try:
                    fe.join_warmup()
                    # "nothing to warm" (empty store / no dim) IS warm:
                    # readiness probes gate on this flag, and a valid-
                    # but-empty index must not wedge a deploy NotReady.
                    # A warmup that RAISED is not warm: the buckets are
                    # still cold and the flag exists to say exactly that.
                    self.warm = not fe.warmup_failed
                    if fe.warmup_failed:
                        logger.error("startup warmup failed; serving cold")
                except Exception:  # noqa: BLE001 — serve cold, don't die
                    logger.exception("startup warmup failed; serving cold")
            self._warm_thread = threading.Thread(
                target=_warm, daemon=True, name="lattice-serving-warmup")
            self._warm_thread.start()

    # ---- lifecycle -------------------------------------------------------

    @property
    def frontend(self):
        """The default-configuration frontend (resolved through the
        router every time: the LRU can evict and re-mint it)."""
        return self.router.frontend()

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "ServingHTTPServer":
        """Serve on a background thread; returns self for chaining."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="lattice-serving-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.router.close()
        # closing the router closed the frontend, which stops warmup at
        # its next bucket boundary; an in-flight search can outlive the
        # join (daemon thread — it only pins the store until it returns)
        if self._warm_thread is not None:
            self._warm_thread.join(timeout=5)
        # break the server<->handler cycle and drop the corpus refs: a
        # lingering server object must not pin the store's device memory
        # past the owner's del (as frontend.close() guards)
        self._httpd.app = None  # type: ignore[attr-defined]
        self.store = None
        self.engine = None
        # embed closures pin the encoder's params; drop them too
        self.embed_fn = None
        self.embed_batch_fn = None

    def __enter__(self) -> "ServingHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ---- endpoint logic (handler threads call these) ---------------------

    def handle(self, method: str, path: str, body: dict) -> tuple[int, dict]:
        if method == "GET" and path == "/healthz":
            return 200, {"ok": True, "corpus": len(self.store),
                         "warm": self.warm}
        if method == "GET" and path == "/v1/stats":
            # read-only: peek never mints a frontend (a monitoring
            # scrape must not evict live configs or hit Overloaded);
            # the default config can only be absent after LRU eviction,
            # in which case its retained stats ride in "configs"
            fe = self.router.peek()
            st = fe.stats if fe is not None else FrontendStats()
            p50 = st.latency_percentile(50)
            p95 = st.latency_percentile(95)
            life_p99 = st.lifetime_percentile(99)
            if life_p99 == float("inf"):
                # >1% of lifetime queries overflowed the top bucket;
                # bare Infinity is not valid JSON — report the overflow
                # bucket itself ("+inf" count in latency_hist_ms tells
                # the rest of the story)
                life_p99 = None
            return 200, {
                "queries": st.queries, "batches": st.batches,
                "mean_batch": round(st.mean_batch, 2),
                "padded_rows": st.padded_rows, "errors": st.errors,
                "deadline_expired": st.deadline_expired,
                "rejected_overload": st.rejected_overload,
                "cold_compiles": st.cold_compiles,
                "latency_p50_ms": round(p50, 2) if p50 is not None else None,
                "latency_p95_ms": round(p95, 2) if p95 is not None else None,
                "latency_hist_ms": st.histogram(),
                "lifetime_p99_ms": life_p99,
                "configs": self.router.stats(),
                "corpus": len(self.store),
                "spans": get_tracer().snapshot(),
            }
        if method == "POST" and path == "/v1/search":
            if self.embed_fn is None:
                return 501, {"error": "no embedder configured"}
            text = body.get("query")
            if not isinstance(text, str) or not text.strip():
                return 400, {"error": "missing 'query' string"}
            vec = np.asarray(self.embed_fn(text), dtype=np.float32)
            return self._vector_search(vec, body)
        if method == "POST" and path == "/v1/search_vector":
            raw = body.get("vector")
            if not isinstance(raw, list) or not raw:
                return 400, {"error": "missing 'vector' list"}
            return self._vector_search(
                np.asarray(raw, dtype=np.float32), body)
        if method == "POST" and path == "/v1/search_batch":
            if self.embed_fn is None:
                return 501, {"error": "no embedder configured"}
            texts = body.get("queries")
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) and t.strip()
                               for t in texts)):
                return 400, {"error": "missing 'queries': list of "
                                      "non-empty strings"}
            if len(texts) > self.MAX_BATCH_ITEMS:
                return 400, {"error": "queries must carry 1.."
                                      f"{self.MAX_BATCH_ITEMS} items"}
            if self.embed_batch_fn is not None:
                vecs = np.asarray(self.embed_batch_fn(texts),
                                  dtype=np.float32)
            else:
                vecs = np.asarray([self.embed_fn(t) for t in texts],
                                  dtype=np.float32)
            return self._vector_search_batch(vecs, body)
        if method == "POST" and path == "/v1/search_vector_batch":
            raw = body.get("vectors")
            if not isinstance(raw, list) or not raw:
                return 400, {"error": "missing 'vectors' list of lists"}
            try:
                vecs = np.asarray(raw, dtype=np.float32)
            except (ValueError, TypeError):
                return 400, {"error": "vectors must be a rectangular "
                                      "list of float lists"}
            return self._vector_search_batch(vecs, body)
        if method == "POST" and path == "/v1/deep_search":
            if self.engine is None:
                return 501, {"error": "no engine configured"}
            text = body.get("query")
            if not isinstance(text, str) or not text.strip():
                return 400, {"error": "missing 'query' string"}
            err = self._validate_limit(body)
            if err is not None:
                return err
            res = self.engine.deep_search(text, body.get("limit"))
            return 200, {"results": self._ranked(res.results),
                         "phase_times_ms": res.phase_times_ms}
        if method == "POST" and path == "/v1/deep_search_batch":
            # many deep (hybrid graph+vector) queries in ONE HTTP round
            # trip -> one batched engine call (`deep_search_batch`). The
            # engine chunks at DEEP_BATCH_CHUNK internally, so Q is
            # bounded only by MAX_BATCH_ITEMS here.
            if self.engine is None:
                return 501, {"error": "no engine configured"}
            texts = body.get("queries")
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) and t.strip()
                               for t in texts)):
                return 400, {"error": "missing 'queries': list of "
                                      "non-empty strings"}
            if len(texts) > self.MAX_BATCH_ITEMS:
                return 400, {"error": "queries must carry 1.."
                                      f"{self.MAX_BATCH_ITEMS} items"}
            err = self._validate_limit(body)
            if err is not None:
                return err
            out = self.engine.deep_search_batch(texts, body.get("limit"))
            return 200, {"results": [
                {"results": self._ranked(r.results),
                 "phase_times_ms": r.phase_times_ms} for r in out]}
        if method == "POST" and path == "/v1/query":
            if self.engine is None:
                return 501, {"error": "no engine configured"}
            text = body.get("query")
            if not isinstance(text, str) or not text.strip():
                return 400, {"error": "missing 'query' string"}
            limit = body.get("limit")
            if limit is not None and (
                    isinstance(limit, bool) or not isinstance(limit, int)
                    or not 1 <= limit <= 1000):
                return 400, {"error": "limit must be an int in [1, 1000]"}
            res = self.engine.query_sync(text, limit)
            return 200, {
                "answer": res.answer,
                "results": self._ranked(res.results),
                "phase_times_ms": res.phase_times_ms,
            }
        return 404, {"error": f"no route {method} {path}"}

    def metrics_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) over the router's
        per-configuration counters. The lifetime log2 histogram IS a
        Prometheus histogram: cumulative counts per `le` bound plus
        `_count`/`_sum`. Retired (LRU-evicted) configs keep reporting —
        counters must never move backwards between scrapes."""
        from lattice_tpu_torch.serving.frontend import HIST_BOUNDS_MS

        def esc(s: str) -> str:
            return (s.replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        items = self.router.iter_stats()
        out: list[str] = []
        counters = [
            ("lattice_queries_total", "Queries served", "queries"),
            ("lattice_batches_total", "Device batches dispatched",
             "batches"),
            ("lattice_padded_rows_total", "Pad rows wasted on bucket "
             "rounding", "padded_rows"),
            ("lattice_errors_total", "Batches whose dispatch failed",
             "errors"),
            ("lattice_deadline_expired_total",
             "Requests expired before dispatch", "deadline_expired"),
            ("lattice_rejected_overload_total",
             "Requests shed at max_queue depth", "rejected_overload"),
            ("lattice_cold_compiles_total",
             "Dispatches that hit a pad bucket warmup never ran",
             "cold_compiles"),
        ]
        for name, help_, attr in counters:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} counter")
            for key, st, _retired in items:
                out.append(f'{name}{{config="{esc(key)}"}} '
                           f'{getattr(st, attr)}')
        out.append("# HELP lattice_request_latency_ms Submit-to-result "
                   "latency")
        out.append("# TYPE lattice_request_latency_ms histogram")
        for key, st, _retired in items:
            label = f'config="{esc(key)}"'
            cum = 0
            for i, bound in enumerate(HIST_BOUNDS_MS):
                cum += st.latency_hist[i]
                out.append(f'lattice_request_latency_ms_bucket{{{label},'
                           f'le="{bound:g}"}} {cum}')
            cum += st.latency_hist[-1]
            out.append(f'lattice_request_latency_ms_bucket{{{label},'
                       f'le="+Inf"}} {cum}')
            out.append(f'lattice_request_latency_ms_count{{{label}}} {cum}')
            out.append(f'lattice_request_latency_ms_sum{{{label}}} '
                       f'{st.latency_sum_ms:.3f}')
        out.append("# HELP lattice_corpus_rows Live rows in the store")
        out.append("# TYPE lattice_corpus_rows gauge")
        out.append(f"lattice_corpus_rows {len(self.store)}")
        out.append("# HELP lattice_live_configs Frontends currently live")
        out.append("# TYPE lattice_live_configs gauge")
        out.append(f"lattice_live_configs {len(self.router)}")
        out.extend(_tracer_lines(get_tracer().snapshot(), esc))
        return "\n".join(out) + "\n"

    @staticmethod
    def _validate_limit(body: dict):
        limit = body.get("limit")
        if limit is not None and (
                isinstance(limit, bool) or not isinstance(limit, int)
                or not 1 <= limit <= 1000):
            return 400, {"error": "limit must be an int in [1, 1000]"}
        return None

    @staticmethod
    def _ranked(results) -> list[dict]:
        return [{
            "name": r.qualified_name, "kind": r.entity_type,
            "file_path": r.file_path, "line": r.start_line,
            "score": round(r.score, 4),
        } for r in results]

    def _search_opts(self, body: dict):
        """Validate the shared search options out of a request body.
        Returns (error_response | None, (k, filters, method, deadline_ms,
        timeout_s))."""
        k = body.get("k", self.default_k)
        if isinstance(k, bool) or not isinstance(k, int) \
                or k < 1 or k > 1000:
            return (400, {"error": "k must be an int in [1, 1000]"}), None
        filters = body.get("filters")
        if filters is not None and not isinstance(filters, dict):
            return (400, {"error": "filters must be a JSON object"}), None
        srch_method = body.get("method", "auto")
        if not isinstance(srch_method, str) \
                or srch_method not in chunk_store.SEARCH_METHODS:
            # validate BEFORE routing: an unknown method would otherwise
            # mint a dead-on-arrival frontend config (worker thread +
            # LRU slot) whose every dispatch 500s
            return (400, {"error": "method must be one of "
                                   f"{list(chunk_store.SEARCH_METHODS)}"}), \
                None
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None and (
                isinstance(deadline_ms, bool)
                or not isinstance(deadline_ms, (int, float))
                or not 0 < deadline_ms <= 600_000):
            return (400, {"error": "deadline_ms must be in "
                                   "(0, 600000]"}), None
        # the result wait must outlast any accepted deadline: deadline_ms
        # bounds QUEUE time, after which the request still rides a device
        # call — give that call the usual 300 s on top
        timeout_s = 300.0 if deadline_ms is None \
            else deadline_ms / 1000.0 + 300.0
        return None, (k, filters, srch_method, deadline_ms, timeout_s)

    def _vector_search(self, vec: np.ndarray,
                       body: dict) -> tuple[int, dict]:
        err, opts = self._search_opts(body)
        if err is not None:
            return err
        k, filters, srch_method, deadline_ms, timeout_s = opts
        if vec.ndim != 1 or vec.shape[0] != self.store.dim:
            return 400, {"error": f"vector must be [{self.store.dim}]"}
        try:
            fut = self.router.submit(vec, k, filters=filters,
                                     method=srch_method,
                                     deadline_ms=deadline_ms)
            scores, ids = fut.result(timeout=timeout_s)
        except DeadlineExceeded as exc:
            return 504, {"error": f"deadline exceeded: {exc}"}
        except FuturesTimeout:
            return 504, {"error": f"no result within {timeout_s:.0f}s"}
        except Overloaded as exc:
            return 429, {"error": f"overloaded: {exc}"}
        except Exception as exc:  # noqa: BLE001 — surface as a 500
            logger.exception("search failed")
            return 500, {"error": repr(exc)[:200]}
        return 200, {"hits": self._hits(scores, ids)}

    def _hits(self, scores: np.ndarray, ids: np.ndarray) -> list[dict]:
        hits = []
        for s, r in zip(scores.tolist(), ids.tolist()):
            if r < 0 or s <= topk_ops.NEG_INF / 2:
                # k > live rows pads ids with -1; a filter matching
                # fewer than k rows pads SCORES with the kernel's -1e30
                # sentinel on arbitrary rows — strip both, same contract
                # as the host search paths (chunk_store.py:700)
                continue
            payload = self.store.payload(int(r)) or {}
            hits.append({"row": int(r), "score": round(float(s), 4),
                         "payload": payload})
        return hits

    # one HTTP round trip can carry this many queries; each still rides
    # the router's max_queue backpressure individually
    MAX_BATCH_ITEMS = 1024

    def _vector_search_batch(self, vecs: np.ndarray,
                             body: dict) -> tuple[int, dict]:
        """Many queries in one HTTP request. Each query submits through
        the SAME router/frontend as single requests, so a batch coalesces
        into padded device executions with everyone else's traffic (and a
        lone batch IS the batch). Per-item failures (deadline, overload)
        report per item; one bad item never voids its neighbours."""
        err, opts = self._search_opts(body)
        if err is not None:
            return err
        k, filters, srch_method, deadline_ms, timeout_s = opts
        if vecs.ndim != 2 or vecs.shape[1] != self.store.dim:
            return 400, {"error": f"vectors must be [n, {self.store.dim}]"}
        if not 1 <= vecs.shape[0] <= self.MAX_BATCH_ITEMS:
            return 400, {"error": "vectors must carry 1.."
                                  f"{self.MAX_BATCH_ITEMS} rows"}
        futs = [self.router.submit(v, k, filters=filters,
                                   method=srch_method,
                                   deadline_ms=deadline_ms)
                for v in vecs]
        # one absolute deadline for the WHOLE batch: the items share
        # device batches, so waiting a fresh timeout_s per item would
        # let a wedged device call pin this handler thread for up to
        # n * timeout_s (85 h at 1024 items) instead of the single-
        # request bound
        wait_until = time.monotonic() + timeout_s
        results: list[dict] = []
        for fut in futs:
            try:
                scores, ids = fut.result(
                    timeout=max(0.0, wait_until - time.monotonic()))
                results.append({"hits": self._hits(scores, ids)})
            except DeadlineExceeded as exc:
                results.append({"error": f"deadline exceeded: {exc}",
                                "status": 504})
            except FuturesTimeout:
                results.append({"error": f"no result within "
                                         f"{timeout_s:.0f}s",
                                "status": 504})
            except Overloaded as exc:
                results.append({"error": f"overloaded: {exc}",
                                "status": 429})
            except Exception as exc:  # noqa: BLE001 — per-item 500
                logger.exception("batch item failed")
                results.append({"error": repr(exc)[:200], "status": 500})
        return 200, {"results": results}


class _Handler(BaseHTTPRequestHandler):
    # one instance per request, on the request's own thread
    protocol_version = "HTTP/1.1"
    # a response goes out as two writes (headers, then body); with Nagle's
    # algorithm on, the body waits for the client's delayed ACK of the
    # headers, ~40 ms a request on Linux (TCP_NODELAY)
    disable_nagle_algorithm = True

    def _app(self) -> ServingHTTPServer:
        return self.server.app  # type: ignore[attr-defined]

    def _respond(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_text(self, status: int, text: str,
                      content_type: str) -> None:
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        app = self._app()
        if app is None or app.store is None:  # shutdown mid-flight
            self.close_connection = True
            self._respond(503, {"error": "server is shutting down"})
            return
        try:
            if self.path == "/metrics":
                self._respond_text(
                    200, app.metrics_text(),
                    "text/plain; version=0.0.4; charset=utf-8")
                return
            status, payload = app.handle("GET", self.path, {})
        except Exception as exc:  # noqa: BLE001
            logger.exception("GET %s failed", self.path)
            status, payload = 500, {"error": repr(exc)[:200]}
        self._respond(status, payload)

    def do_POST(self) -> None:  # noqa: N802
        app = self._app()
        if app is None or app.store is None:  # shutdown mid-flight
            self.close_connection = True
            self._respond(503, {"error": "server is shutting down"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            cap = (MAX_BATCH_BODY_BYTES if self.path.endswith("_batch")
                   else MAX_BODY_BYTES)
            if length > cap:
                # the unread body would desync this keep-alive stream;
                # drop the connection after responding
                self.close_connection = True
                self._respond(413, {"error": "body too large"})
                return
            raw = self.rfile.read(length) if length else b"{}"
            try:
                body = json.loads(raw or b"{}")
            except json.JSONDecodeError:
                self._respond(400, {"error": "invalid JSON body"})
                return
            if not isinstance(body, dict):
                self._respond(400, {"error": "body must be a JSON object"})
                return
            status, payload = app.handle("POST", self.path, body)
        except Exception as exc:  # noqa: BLE001
            logger.exception("POST %s failed", self.path)
            status, payload = 500, {"error": repr(exc)[:200]}
        self._respond(status, payload)

    def log_message(self, fmt: str, *args) -> None:  # quiet by default
        logger.debug("http: " + fmt, *args)
