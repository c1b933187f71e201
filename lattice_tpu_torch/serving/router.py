"""Route queries to per-configuration batching frontends (torch port).

Port of `lattice_tpu/serving/router.py`. A `BatchingFrontend` coalesces
queries into one device call, so every query in a batch must share the
call's (filters, method) configuration: the filter mask and the plan are
fixed for the call. This router owns one frontend per distinct
configuration, created lazily on first use, and fans `submit()` out by a
canonical configuration key. Queries for the SAME configuration still
coalesce across all callers; queries for different configurations ride
different batches, on their frontends' own worker threads, so searches
of several configurations run concurrently on one store (`full_f32`
guards the process-wide TF32 flag across those threads).

The number of distinct configurations is capped (`max_configs`): each
frontend owns a worker thread, so a client cycling filter values must
not mint unbounded threads. Over the cap, `submit()` fails with
`Overloaded` unless an idle frontend can be evicted (closed + replaced).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import Future

import numpy as np

from lattice_tpu_torch.serving.frontend import (
    BatchingFrontend,
    FrontendStats,
    Overloaded,
)

logger = logging.getLogger(__name__)


def config_key(filters: dict | None, method: str) -> str:
    """Canonical string key for a (filters, method) configuration.

    Filters are JSON objects of scalars/lists (the store's payload
    filter language); sort_keys makes semantically-equal dicts equal
    keys, and an empty dict keys as None (the store treats them
    identically — `chunk_store.filter_mask` returns None for both, so
    they must coalesce into one frontend). Non-serializable values
    raise TypeError at the submit boundary, where the caller can map it
    to a 400.
    """
    return json.dumps({"m": method, "f": filters or None}, sort_keys=True)


class FrontendRouter:
    """Lazily-created `BatchingFrontend` per (filters, method) config.

    Parameters mirror `BatchingFrontend`; they apply to every frontend
    the router creates. `max_configs` bounds how many distinct
    configurations may be live at once; least-recently-used idle
    frontends are evicted (closed) to make room, and if every frontend
    is busy the submit fails with `Overloaded`.
    """

    def __init__(self, store, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0,
                 max_queue: int | None = None,
                 max_configs: int = 8,
                 warm_on_mint: bool = False,
                 warm_k: int = 10):
        if max_configs < 1:
            raise ValueError("max_configs must be >= 1")
        self.store = store
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = max_queue
        self.max_configs = int(max_configs)
        # a freshly-minted config's pad buckets pay their one-time costs
        # at request time unless someone warms them. warm_on_mint kicks
        # BatchingFrontend.warmup_async for every new frontend; requests
        # that arrive meanwhile queue with their deadline extended by the
        # warm window instead of 504ing against it.
        self.warm_on_mint = bool(warm_on_mint)
        self.warm_k = int(warm_k)
        self._frontends: dict[str, BatchingFrontend] = {}
        self._last_used: dict[str, float] = {}
        # evicted configs keep their FrontendStats here; re-minting the
        # same config hands the object back to the new frontend, so the
        # lifetime histogram/counters really are lifetime (never reset
        # by LRU churn) and stats aggregates stay monotonic
        self._retired_stats: dict[str, FrontendStats] = {}
        # warmed-bucket sets ride along: the built kernels and the
        # store's views outlive the frontend object, so a re-minted
        # config's first dispatches are NOT cold compiles and must not
        # count as such (cold_compiles_total would climb a bucket set per
        # LRU re-mint cycle)
        self._retired_warmed: dict[str, set] = {}
        self._lock = threading.Lock()
        self._closed = False

    # ---- client side ----------------------------------------------------

    def submit(self, vec: np.ndarray, k: int = 10, *,
               filters: dict | None = None, method: str = "auto",
               deadline_ms: float | None = None) -> Future:
        """Enqueue one query on the frontend matching (filters, method)."""
        fut: Future = Future()
        for _ in range(2):
            try:
                fe = self.frontend(filters=filters, method=method)
            except Exception as exc:  # noqa: BLE001 — keep the Future contract
                fut.set_exception(exc)
                return fut
            fut = fe.submit(vec, k, deadline_ms=deadline_ms)
            # an eviction can close this frontend between our lookup and
            # the enqueue; its key is already gone from the table, so one
            # retry mints a fresh frontend for the same configuration
            if not (fut.done() and isinstance(fut.exception(), RuntimeError)
                    and "closed" in str(fut.exception())):
                return fut
        return fut

    def search(self, vec: np.ndarray, k: int = 10, **kw):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(vec, k, **kw).result()

    def frontend(self, *, filters: dict | None = None,
                 method: str = "auto") -> BatchingFrontend:
        """The live frontend for this configuration (created on first
        use). Raises `Overloaded` when max_configs frontends are live
        and none is idle enough to evict."""
        key = config_key(filters, method)
        filters = filters or None  # {} and None are the same config
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            fe = self._frontends.get(key)
            if fe is not None:
                self._last_used[key] = time.monotonic()
                return fe
            if len(self._frontends) >= self.max_configs:
                self._evict_idle_locked()
            if len(self._frontends) >= self.max_configs:
                raise Overloaded(
                    f"{len(self._frontends)} configurations live "
                    f"(max_configs={self.max_configs}) and none idle")
            fe = BatchingFrontend(
                self.store, max_batch=self.max_batch,
                max_wait_ms=self.max_wait_ms, max_queue=self.max_queue,
                filters=filters, method=method,
                stats=self._retired_stats.pop(key, None),
                warmed_buckets=self._retired_warmed.pop(key, None))
            self._frontends[key] = fe
            self._last_used[key] = time.monotonic()
            if self.warm_on_mint:
                fe.warmup_async(k=self.warm_k)
            return fe

    def peek(self, *, filters: dict | None = None,
             method: str = "auto") -> BatchingFrontend | None:
        """The live frontend for this configuration, or None — never
        creates one. Read paths (stats endpoints) use this so a scrape
        cannot mint workers, evict live configs, or hit Overloaded."""
        with self._lock:
            return self._frontends.get(config_key(filters, method))

    def _evict_idle_locked(self) -> None:
        """Retire the least-recently-used idle frontend. Caller holds
        `_lock`; the CLOSE runs on its own thread because close() drains
        queued work and joins the worker — with a device call in flight
        that join can take as long as the call, and holding the router lock through it
        would freeze every configuration's submits. The frontend leaves
        the table immediately; its stats object is retained so the
        config's lifetime counters survive re-minting."""
        for key in sorted(self._frontends, key=lambda k: self._last_used[k]):
            fe = self._frontends[key]
            if fe.idle:
                del self._frontends[key]
                del self._last_used[key]
                self._retired_stats[key] = fe.stats
                self._retired_warmed[key] = fe._warmed_buckets
                # bound the tombstone table: a client cycling filter
                # values must not grow host memory without limit (the
                # oldest-evicted configs' counters are the ones dropped)
                while len(self._retired_stats) > 8 * self.max_configs:
                    gone = next(iter(self._retired_stats))
                    self._retired_stats.pop(gone)
                    self._retired_warmed.pop(gone, None)
                threading.Thread(
                    target=fe.close, daemon=True,
                    name="lattice-frontend-evict").start()
                logger.info("evicted idle frontend %s", key)
                return

    # ---- introspection ---------------------------------------------------

    def iter_stats(self) -> list[tuple[str, FrontendStats, bool]]:
        """(config_key, stats, retired) for every live and retired
        configuration — the raw feed for stats()/metrics exporters."""
        with self._lock:
            items = [(key, fe.stats, False)
                     for key, fe in self._frontends.items()]
            items += [(key, st, True)
                      for key, st in self._retired_stats.items()]
        return items

    def stats(self) -> dict[str, dict]:
        """Per-configuration counters keyed by config_key, plus an
        '_aggregate' rollup the stats endpoint can report directly.
        Evicted configs report from their retained stats (flagged
        "retired"), so the rollup never moves backwards across LRU
        churn."""
        items = self.iter_stats()
        out: dict[str, dict] = {}
        agg = {"queries": 0, "batches": 0, "errors": 0,
               "deadline_expired": 0, "rejected_overload": 0,
               "cold_compiles": 0}
        for key, st, retired in items:
            out[key] = {
                "queries": st.queries, "batches": st.batches,
                "mean_batch": round(st.mean_batch, 2),
                "errors": st.errors,
                "deadline_expired": st.deadline_expired,
                "rejected_overload": st.rejected_overload,
                "cold_compiles": st.cold_compiles,
                "latency_p50_ms": st.latency_percentile(50),
                "latency_p95_ms": st.latency_percentile(95),
                "latency_hist_ms": st.histogram(),
            }
            if retired:
                out[key]["retired"] = True
            for k in agg:
                agg[k] += out[key][k]
        out["_aggregate"] = agg
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._frontends)

    # ---- lifecycle -------------------------------------------------------

    def close(self, timeout: float | None = 5.0) -> None:
        """Close every frontend (draining queued work) and drop the
        store reference. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            frontends = list(self._frontends.values())
            self._frontends.clear()
            self._last_used.clear()
        for fe in frontends:
            try:
                fe.close(timeout=timeout)
            except Exception:  # noqa: BLE001 — close the rest regardless
                logger.exception("frontend close failed")
        # same device-memory discipline as BatchingFrontend.close
        self.store = None

    def __enter__(self) -> "FrontendRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
