"""The port's FrontendRouter and frontend hardening: per-request
deadlines, queue backpressure, lifetime latency histograms,
per-configuration routing and eviction, warm-on-mint.

Mirror of `tests/test_serving_router.py` against
`lattice_tpu_torch.serving` on a CPU store, then the port against the JAX
package: both routers over stores of the same rows, fed the same queries
under several configurations at once (concurrent submitters, each config
on its own frontend thread), give the same ids and scores within 1e-6,
the same configuration keys and the same aggregate counts.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.serving import FrontendRouter as JaxRouter
from lattice_tpu.serving.router import config_key as jax_config_key
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.serving import (
    BatchingFrontend,
    DeadlineExceeded,
    FrontendRouter,
    Overloaded,
)
from lattice_tpu_torch.serving.router import config_key

N, D = 256, 32


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(7)
    emb = topk_ops.l2_normalize(
        rng.standard_normal((N, D)).astype(np.float32))
    st = ChunkStore(dim=D, device="cpu")
    st.add(emb, [{"file_path": f"f{i}.py",
                  "language": "python" if i % 2 else "go"}
                 for i in range(N)])
    return st


def _q(seed=3):
    rng = np.random.default_rng(seed)
    return topk_ops.l2_normalize(
        rng.standard_normal((1, D)).astype(np.float32))[0]


class _GatedStore:
    """Wraps a store so every search blocks until the gate opens —
    deterministic control over when the worker's dispatch completes."""

    def __init__(self, inner, gate: threading.Event):
        self._inner = inner
        self._gate = gate
        self.dim = inner.dim

    def search_device(self, q, k, **kw):
        assert self._gate.wait(timeout=30), "gate never opened"
        return self._inner.search_device(q, k, **kw)


class TestDeadlines:
    def test_expired_in_queue_fails_fast(self, store):
        gate = threading.Event()
        gated = _GatedStore(store, gate)
        fe = BatchingFrontend(gated, max_batch=1, max_wait_ms=0)
        try:
            # first item occupies the worker inside the blocked dispatch
            f_block = fe.submit(_q(1), k=3)
            time.sleep(0.05)
            # second item waits in the queue with a 1 ms budget
            f_late = fe.submit(_q(2), k=3, deadline_ms=1.0)
            time.sleep(0.05)  # let the deadline rot while the gate holds
            gate.set()
            with pytest.raises(DeadlineExceeded):
                f_late.result(timeout=30)
            f_block.result(timeout=30)  # the blocker still succeeds
            assert fe.stats.deadline_expired == 1
        finally:
            gate.set()
            fe.close()

    def test_generous_deadline_succeeds(self, store):
        with BatchingFrontend(store, max_wait_ms=0) as fe:
            scores, ids = fe.submit(_q(), k=5,
                                    deadline_ms=60_000).result(timeout=30)
            assert ids.shape == (5,)
        assert fe.stats.deadline_expired == 0

    def test_nonpositive_deadline_rejected(self, store):
        with BatchingFrontend(store, max_wait_ms=0) as fe:
            with pytest.raises(ValueError):
                fe.submit(_q(), k=5, deadline_ms=0).result(timeout=5)


class TestBackpressure:
    def test_overflow_submit_rejected(self, store):
        gate = threading.Event()
        fe = BatchingFrontend(_GatedStore(store, gate),
                              max_batch=1, max_wait_ms=0, max_queue=2)
        try:
            f0 = fe.submit(_q(0), k=3)       # dispatched, blocks on gate
            time.sleep(0.05)                 # worker takes f0 off queue
            f1 = fe.submit(_q(1), k=3)       # queued (pending 1)
            f2 = fe.submit(_q(2), k=3)       # queued (pending 2 = max)
            f3 = fe.submit(_q(3), k=3)       # over: shed
            with pytest.raises(Overloaded):
                f3.result(timeout=5)
            assert fe.stats.rejected_overload == 1
            gate.set()
            for f in (f0, f1, f2):
                f.result(timeout=30)         # queued work still completes
            # the counter drains back to zero -> new submits accepted
            fe.submit(_q(4), k=3).result(timeout=30)
        finally:
            gate.set()
            fe.close()

    def test_bad_max_queue_rejected(self, store):
        with pytest.raises(ValueError):
            BatchingFrontend(store, max_queue=0)


class TestHistogram:
    def test_lifetime_histogram_counts_all_queries(self, store):
        with BatchingFrontend(store, max_wait_ms=0) as fe:
            for i in range(8):
                fe.submit(_q(i), k=3).result(timeout=30)
        hist = fe.stats.histogram()
        assert sum(hist.values()) == 8
        assert fe.stats.lifetime_percentile(50) is not None
        # deque window agrees on the total
        assert len(fe.stats.latencies_ms) == 8

    def test_histogram_bucketing_is_log2(self):
        from lattice_tpu_torch.serving.frontend import FrontendStats
        st = FrontendStats()
        st.observe_latency(0.1)    # <= 0.25 bucket
        st.observe_latency(3.0)    # <= 4 bucket
        st.observe_latency(1e9)    # overflow
        h = st.histogram()
        assert h["0.25"] == 1 and h["4"] == 1 and h["+inf"] == 1
        assert st.lifetime_percentile(1) == 0.25
        assert st.lifetime_percentile(99) == float("inf")


class TestRouter:
    def test_same_config_reuses_frontend(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            a = r.frontend(filters={"language": "python"}, method="flat")
            b = r.frontend(filters={"language": "python"}, method="flat")
            assert a is b
            assert len(r) == 1

    def test_distinct_configs_get_distinct_frontends(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            a = r.frontend(filters=None, method="flat")
            b = r.frontend(filters={"language": "go"}, method="flat")
            assert a is not b
            assert len(r) == 2

    def test_config_key_canonicalizes_dict_order(self):
        assert config_key({"a": 1, "b": 2}, "flat") == \
            config_key({"b": 2, "a": 1}, "flat")
        assert config_key({"a": 1}, "flat") != config_key({"a": 1}, "int8")

    def test_filtered_route_respects_filters(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            _, ids = r.search(_q(), k=10,
                              filters={"language": "go"}, method="flat")
            langs = {store.payload(int(i))["language"]
                     for i in ids if i >= 0}
            assert langs == {"go"}

    def test_unfiltered_route_matches_direct_frontend(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            s_r, i_r = r.search(_q(), k=5, method="flat")
        with BatchingFrontend(store, max_wait_ms=0, method="flat") as fe:
            s_f, i_f = fe.search(_q(), k=5)
        np.testing.assert_array_equal(i_r, i_f)
        np.testing.assert_allclose(s_r, s_f)

    def test_eviction_over_max_configs(self, store):
        with FrontendRouter(store, max_wait_ms=0, max_configs=2) as r:
            r.search(_q(), k=3, filters={"language": "python"},
                     method="flat")
            r.search(_q(), k=3, filters={"language": "go"}, method="flat")
            assert len(r) == 2
            # a third config evicts the least-recently-used idle one
            r.search(_q(), k=3, method="flat")
            assert len(r) == 2

    def test_no_evictable_frontend_raises_overloaded(self, store):
        gate = threading.Event()
        gated = _GatedStore(store, gate)
        r = FrontendRouter(gated, max_wait_ms=0, max_configs=1,
                           max_batch=1)
        try:
            f0 = r.submit(_q(0), k=3, method="flat")
            time.sleep(0.05)               # dispatched, blocked on gate
            f1 = r.submit(_q(1), k=3, method="flat")  # queued: pending=1
            # a second config now finds the only slot busy (pending > 0)
            with pytest.raises(Overloaded):
                r.frontend(method="int8")
            gate.set()
            f0.result(timeout=30)
            f1.result(timeout=30)
        finally:
            gate.set()
            r.close()

    def test_stats_aggregate(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            r.search(_q(1), k=3, method="flat")
            r.search(_q(2), k=3, filters={"language": "go"},
                     method="flat")
            st = r.stats()
        assert st["_aggregate"]["queries"] == 2
        per_cfg = [v for k, v in st.items() if k != "_aggregate"]
        assert sum(v["queries"] for v in per_cfg) == 2
        assert all(isinstance(v["latency_hist_ms"], dict)
                   for v in per_cfg)

    def test_close_rejects_and_releases_store(self, store):
        r = FrontendRouter(store, max_wait_ms=0)
        r.search(_q(), k=3, method="flat")
        r.close()
        assert r.store is None
        with pytest.raises(RuntimeError):
            r.frontend()
        # submit surfaces the closed error through the future
        with pytest.raises(RuntimeError):
            r.submit(_q(), k=3).result(timeout=5)


class TestReviewRegressions:
    """Pinned fixes from this round's serving review pass."""

    def test_empty_filters_key_equals_none(self):
        # the store treats {} and None identically (filter_mask -> None);
        # they must coalesce into ONE frontend, not split batches
        assert config_key({}, "flat") == config_key(None, "flat")

    def test_peek_never_creates(self, store):
        with FrontendRouter(store, max_wait_ms=0) as r:
            assert r.peek(method="int4") is None
            assert len(r) == 0
            fe = r.frontend(method="flat")
            assert r.peek(method="flat") is fe

    def test_busy_frontend_is_not_evictable(self, store):
        # _pending drops to 0 the moment a batch enters dispatch; a
        # frontend blocked inside a device call must NOT be evicted
        # (closing it would stall on the in-flight call)
        gate = threading.Event()
        r = FrontendRouter(_GatedStore(store, gate), max_wait_ms=0,
                           max_configs=1, max_batch=1)
        try:
            f0 = r.submit(_q(0), k=3, method="flat")
            time.sleep(0.05)  # worker now blocked in dispatch, pending=0
            with pytest.raises(Overloaded):
                r.frontend(method="int8")
            gate.set()
            f0.result(timeout=30)
        finally:
            gate.set()
            r.close()

    def test_eviction_preserves_lifetime_stats(self, store):
        with FrontendRouter(store, max_wait_ms=0, max_configs=1) as r:
            r.search(_q(1), k=3, method="flat")
            r.search(_q(2), k=3, method="flat")
            key = config_key(None, "flat")
            assert r.stats()[key]["queries"] == 2
            # mint a second config: evicts the first, retains its stats
            r.search(_q(3), k=3, filters={"language": "go"},
                     method="flat")
            st = r.stats()
            assert st[key]["queries"] == 2 and st[key].get("retired")
            assert st["_aggregate"]["queries"] == 3  # never goes backwards
            # re-minting the config resumes the SAME lifetime counters
            r.search(_q(4), k=3, method="flat")
            assert r.stats()[config_key(None, "flat")]["queries"] == 3


class _SlowCompileStore:
    """Fake slow first call: the FIRST search at each distinct batch
    shape sleeps `compile_s` (a one-time cost), later calls at that shape
    are fast."""

    def __init__(self, inner, compile_s: float = 0.25):
        self._inner = inner
        self._compile_s = compile_s
        self.dim = inner.dim
        self.compiled_shapes: set[tuple[int, int]] = set()
        self.compile_events: list[tuple[int, int]] = []
        self._lock = threading.Lock()

    def search_device(self, q, k, **kw):
        shape = (int(q.shape[0]), int(k))
        with self._lock:
            cold = shape not in self.compiled_shapes
            if cold:
                self.compiled_shapes.add(shape)
                self.compile_events.append(shape)
        if cold:
            time.sleep(self._compile_s)
        return self._inner.search_device(q, k, **kw)


class TestWarmOnMint:
    """Router-minted configs warm off the request path; requests never
    pay the one-time cost inside their deadline window."""

    def test_mint_kicks_async_warmup(self, store):
        slow = _SlowCompileStore(store, compile_s=0.05)
        with FrontendRouter(slow, max_batch=4, max_wait_ms=5,
                            warm_on_mint=True, warm_k=3) as router:
            fe = router.frontend(method="flat")
            assert fe.join_warmup(timeout=30)
            # every pad bucket precompiled by the warm thread
            assert {s[0] for s in slow.compiled_shapes} == {1, 2, 4}

    def test_request_on_cold_config_survives_tight_deadline(self, store):
        """A request whose deadline is far shorter than the compile
        queues with its deadline suspended while the mint-time warmup
        runs, then succeeds — the pre-fix behavior 504ed it."""
        slow = _SlowCompileStore(store, compile_s=0.4)
        with FrontendRouter(slow, max_batch=4, max_wait_ms=5,
                            warm_on_mint=True, warm_k=3) as router:
            # submit IMMEDIATELY after mint: warmup is still compiling
            fut = router.submit(_q(11), k=3, method="flat",
                                deadline_ms=50)
            scores, ids = fut.result(timeout=30)
            assert len(ids) == 3

    def test_cold_compiles_counted_without_warmup(self, store):
        with FrontendRouter(store, max_batch=4, max_wait_ms=5) as router:
            router.submit(_q(12), k=3, method="flat").result(timeout=30)
            fe = router.peek(method="flat")
            assert fe is not None and fe.stats.cold_compiles == 1
            # same bucket again: the jit key is live, not a new compile
            router.submit(_q(13), k=3, method="flat").result(timeout=30)
            assert fe.stats.cold_compiles == 1
            assert router.stats()["_aggregate"]["cold_compiles"] == 1

    def test_warmed_config_reports_zero_cold_compiles(self, store):
        with FrontendRouter(store, max_batch=4, max_wait_ms=5,
                            warm_on_mint=True, warm_k=3) as router:
            fe = router.frontend(method="flat")
            assert fe.join_warmup(timeout=30)
            router.submit(_q(14), k=3, method="flat").result(timeout=30)
            assert fe.stats.cold_compiles == 0

    def test_deadline_enforced_again_after_warm(self, store):
        """The suspension is scoped to the warm window: once warming is
        done, an expired request still fails fast."""
        gate = threading.Event()
        gated = _GatedStore(store, gate)
        fe = BatchingFrontend(gated, max_batch=4, max_wait_ms=0,
                              method="flat")
        try:
            assert not fe.warming
            blocker = fe.submit(_q(15), k=3)          # occupies the worker
            time.sleep(0.05)
            doomed = fe.submit(_q(16), k=3, deadline_ms=1)
            time.sleep(0.05)                          # let it expire
            gate.set()
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=30)
            blocker.result(timeout=30)
        finally:
            gate.set()
            fe.close()


class TestReviewFixesR5:
    """Warm credit, a failed warmup, cold compiles after a re-mint."""

    def test_warm_credit_extends_but_does_not_waive(self, store):
        fe = BatchingFrontend(store, max_batch=4, max_wait_ms=0,
                              method="flat")
        try:
            now = time.monotonic()
            # no warm window ever: zero credit
            assert fe._warm_credit(now - 5, now) == 0.0
            # a warm window fully inside the wait: full credit
            fe._warm_start, fe._warm_end = now - 4, now - 1
            assert fe._warm_credit(now - 5, now) == pytest.approx(3.0)
            # request arrived mid-warm: only the overlap counts
            assert fe._warm_credit(now - 2, now) == pytest.approx(1.0)
            # request arrived after the warm ended: zero credit
            assert fe._warm_credit(now - 0.5, now) == 0.0
        finally:
            fe.close()

    def test_deadline_survives_warm_then_expires_past_credit(self, store):
        """A request that waited out the warm window is not expired the
        moment warming flips false (the pre-fix behavior); one that is
        late beyond the credited window still is."""
        slow = _SlowCompileStore(store, compile_s=0.3)
        with FrontendRouter(slow, max_batch=4, max_wait_ms=5,
                            warm_on_mint=True, warm_k=3) as router:
            fe = router.frontend(method="flat")
            fut = router.submit(_q(31), k=3, method="flat",
                                deadline_ms=40)
            fe.join_warmup(timeout=30)
            scores, ids = fut.result(timeout=30)  # survived via credit
            assert len(ids) == 3

    def test_failed_warmup_sets_flag(self, store):
        class Boom:
            dim = store.dim

            def __len__(self):
                return 8

            def search_device(self, q, k, **kw):
                raise RuntimeError("compile exploded")

        fe = BatchingFrontend(Boom(), max_batch=4, method="flat")
        try:
            fe.warmup_async(k=3)
            assert fe.join_warmup(timeout=30)
            assert fe.warmup_failed is True
        finally:
            fe.close()

    def test_cold_compiles_not_recounted_after_remint(self, store):
        """The warmed buckets survive LRU eviction; a re-minted config's
        first dispatches must not count as cold compiles."""
        with FrontendRouter(store, max_batch=4, max_wait_ms=5,
                            max_configs=1) as router:
            router.submit(_q(33), k=3, method="flat").result(timeout=30)
            fe = router.peek(method="flat")
            assert fe.stats.cold_compiles == 1
            # force eviction by minting a different config
            router.submit(_q(34), k=3, method="flat",
                          filters={"file_path": "f1.py"}).result(timeout=30)
            deadline = time.monotonic() + 10
            while router.peek(method="flat") is not None \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            # re-mint the original config; same bucket
            router.submit(_q(35), k=3, method="flat").result(timeout=30)
            fe2 = router.peek(method="flat")
            assert fe2 is not None and fe2.stats.cold_compiles == 1


# ---- the port against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def jax_store():
    rng = np.random.default_rng(7)
    emb = topk_ops.l2_normalize(
        rng.standard_normal((N, D)).astype(np.float32))
    st = JaxStore(dim=D)
    st.add(emb, [{"file_path": f"f{i}.py",
                  "language": "python" if i % 2 else "go"}
                 for i in range(N)])
    return st


CONFIGS = [(None, "auto"), ({"language": "go"}, "flat"),
           (None, "quantized"), ({"language": ["go", "python"]}, "pq"),
           ({"file_path": "f3.py"}, "flat")]


@pytest.mark.parametrize("filters, method", CONFIGS)
def test_config_key_equals_jax(filters, method):
    assert config_key(filters, method) == jax_config_key(filters, method)


def test_concurrent_configs_equal_jax(store, jax_store):
    """Four submitter threads each send the same 10 queries under every
    configuration, through both routers: every answer equals the JAX
    router's (ids equal, scores within 1e-6); each configuration has its
    own frontend; the aggregate counts agree."""
    queries = [_q(40 + i) for i in range(10)]
    answers = {}
    for name, cls, st in (("jax", JaxRouter, jax_store),
                          ("port", FrontendRouter, store)):
        got = {}
        with cls(st, max_wait_ms=20, max_batch=16) as r:
            def work(t, r=r, got=got):
                for ci, (filters, method) in enumerate(CONFIGS):
                    futs = [r.submit(q, k=4, filters=filters,
                                     method=method) for q in queries]
                    got[t, ci] = [f.result(timeout=60) for f in futs]
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            stats = r.stats()
            assert len(r) == len(CONFIGS)
        answers[name] = (got, stats)
    (jgot, jst), (pgot, pst) = answers["jax"], answers["port"]
    assert set(jgot) == set(pgot) and len(pgot) == 4 * len(CONFIGS)
    for key in pgot:
        for (js, ji), (ps, pi) in zip(jgot[key], pgot[key]):
            np.testing.assert_array_equal(pi, np.asarray(ji))
            np.testing.assert_allclose(ps, np.asarray(js), atol=1e-6)
    assert set(pst) == set(jst)
    for k in ("queries", "errors", "deadline_expired", "rejected_overload"):
        assert pst["_aggregate"][k] == jst["_aggregate"][k]
    assert pst["_aggregate"]["queries"] == 4 * 10 * len(CONFIGS)
