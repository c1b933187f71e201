"""The port's BatchingFrontend: coalescing, padding buckets, error
fan-out, close(), warmup; and the same traffic through both packages.

Mirror of `tests/test_serving.py` against `lattice_tpu_torch.serving` on a
CPU store (`device="cpu"`, plain kernel versions), then the port against
the JAX package: frontends over stores built from the same rows, fed the
same queries, give the same ids, scores within 1e-6, and the same batch
and pad counts; a query's result does not depend on its batch partners;
the frontend hands the store a torch tensor and reads back with `.cpu()`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.serving import BatchingFrontend as JaxFrontend
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.serving import BatchingFrontend

N, D = 512, 64


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(0)
    emb = topk_ops.l2_normalize(
        rng.standard_normal((N, D)).astype(np.float32))
    st = ChunkStore(dim=D, device="cpu")
    st.add(emb, [{"file_path": f"f{i}.py"} for i in range(N)])
    return st


def _rows(store):
    """The store's (rows as f32 numpy, validity) for the oracle."""
    emb, valid = store.device_arrays
    return emb.to(torch.float32).numpy(), valid.numpy()


def _queries(n, seed=1):
    rng = np.random.default_rng(seed)
    return topk_ops.l2_normalize(
        rng.standard_normal((n, D)).astype(np.float32))


class TestCoalescing:
    def test_concurrent_submits_coalesce_and_match_oracle(self, store):
        qs = _queries(16)
        with BatchingFrontend(store, max_batch=64, max_wait_ms=250,
                              method="flat") as fe:
            futs = [fe.submit(q, k=5) for q in qs]
            results = [f.result(timeout=30) for f in futs]
        assert fe.stats.queries == 16
        # all 16 arrived within the 250 ms window -> one device call
        assert fe.stats.batches == 1
        assert fe.stats.mean_batch == 16.0
        emb, valid = _rows(store)
        o_scores, o_ids = topk_ops.topk_oracle(qs, emb, valid, 5)
        for i, (scores, ids) in enumerate(results):
            assert set(ids.tolist()) == set(np.asarray(o_ids)[i].tolist())
            np.testing.assert_allclose(np.sort(scores),
                                       np.sort(np.asarray(o_scores)[i]),
                                       atol=2e-2)  # bf16 storage

    def test_full_batch_dispatches_immediately(self, store):
        qs = _queries(16, seed=2)
        with BatchingFrontend(store, max_batch=8, max_wait_ms=10_000,
                              method="flat") as fe:
            futs = [fe.submit(q, k=3) for q in qs]
            t0 = time.monotonic()
            for f in futs:
                f.result(timeout=30)
            # a 10 s max_wait must NOT gate a full batch
            assert time.monotonic() - t0 < 8.0
        assert fe.stats.batches == 2
        assert list(fe.stats.batch_sizes) == [8, 8]

    def test_mixed_k_per_query(self, store):
        qs = _queries(3, seed=3)
        with BatchingFrontend(store, max_wait_ms=100,
                              method="flat") as fe:
            f1 = fe.submit(qs[0], k=2)
            f2 = fe.submit(qs[1], k=7)
            f3 = fe.submit(qs[2], k=4)
            for f, k in ((f1, 2), (f2, 7), (f3, 4)):
                scores, ids = f.result(timeout=30)
                assert scores.shape == (k,) and ids.shape == (k,)

    def test_pad_bucket_is_power_of_two(self, store):
        with BatchingFrontend(store, max_batch=64, max_wait_ms=100,
                              method="flat") as fe:
            futs = [fe.submit(q, k=3) for q in _queries(5, seed=4)]
            for f in futs:
                f.result(timeout=30)
        assert fe.stats.batches == 1
        assert fe.stats.padded_rows == 3  # 5 -> bucket 8

    def test_threaded_submitters(self, store):
        qs = _queries(24, seed=5)
        results = [None] * 24
        with BatchingFrontend(store, max_batch=32, max_wait_ms=150,
                              method="flat") as fe:
            def worker(i):
                results[i] = fe.search(qs[i], k=4)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert fe.stats.queries == 24
        assert fe.stats.batches <= 3  # coalesced, not 24 single calls
        emb, valid = _rows(store)
        _, o_ids = topk_ops.topk_oracle(qs, emb, valid, 4)
        for i in range(24):
            assert set(results[i][1].tolist()) == set(
                np.asarray(o_ids)[i].tolist())


class TestLifecycleAndErrors:
    def test_dim_mismatch_fails_only_that_future(self, store):
        with BatchingFrontend(store, max_wait_ms=50, method="flat") as fe:
            bad = fe.submit(np.ones(D + 1, np.float32), k=3)
            good = fe.submit(_queries(1, seed=6)[0], k=3)
            with pytest.raises(ValueError, match="dim mismatch"):
                bad.result(timeout=5)
            scores, ids = good.result(timeout=30)
            assert ids.shape == (3,)

    def test_bad_k_rejected(self, store):
        with BatchingFrontend(store, max_wait_ms=10) as fe:
            with pytest.raises(ValueError, match="k must be"):
                fe.submit(_queries(1)[0], k=0).result(timeout=5)

    def test_device_error_fans_out_to_all_futures(self):
        class Boom:
            dim = D

            def search_device(self, *a, **k):
                raise RuntimeError("device fell over")

        with BatchingFrontend(Boom(), max_wait_ms=100) as fe:
            futs = [fe.submit(q, k=3) for q in _queries(4, seed=7)]
            for f in futs:
                with pytest.raises(RuntimeError, match="fell over"):
                    f.result(timeout=10)
        assert fe.stats.errors == 1

    def test_close_drains_pending_then_rejects(self, store):
        fe = BatchingFrontend(store, max_wait_ms=5_000, method="flat")
        futs = [fe.submit(q, k=3) for q in _queries(4, seed=8)]
        fe.close()  # must not wait out the 5 s window
        for f in futs:
            scores, ids = f.result(timeout=10)
            assert ids.shape == (3,)
        with pytest.raises(RuntimeError, match="closed"):
            fe.submit(_queries(1)[0], k=3).result(timeout=5)
        fe.close()  # idempotent

    def test_latency_percentiles_populate(self, store):
        with BatchingFrontend(store, max_wait_ms=20, method="flat") as fe:
            assert fe.stats.latency_percentile(50) is None
            for q in _queries(6, seed=13):
                fe.search(q, k=3)
        p50, p95 = (fe.stats.latency_percentile(50),
                    fe.stats.latency_percentile(95))
        assert p50 is not None and p95 is not None and p95 >= p50 > 0
        assert len(fe.stats.latencies_ms) == 6

    def test_cancelled_future_does_not_kill_worker(self, store):
        """A future cancelled before dispatch must be skipped, not crash
        the worker with InvalidStateError (which would hang every later
        submit)."""
        with BatchingFrontend(store, max_wait_ms=150, method="flat") as fe:
            f1 = fe.submit(_queries(1, seed=10)[0], k=3)
            f1.cancel()  # races the worker's claim; either is fine
            f2 = fe.submit(_queries(1, seed=11)[0], k=3)
            scores, ids = f2.result(timeout=30)
            assert ids.shape == (3,)
        assert f1.cancelled() or f1.done()

    def test_k_beyond_capacity_pads_to_contract(self, store):
        """search_device clamps k to capacity; the frontend must keep
        its documented length-k, -1-padded contract."""
        big_k = store._cap + 7
        with BatchingFrontend(store, max_wait_ms=20, method="flat") as fe:
            scores, ids = fe.search(_queries(1, seed=12)[0], k=big_k)
        assert ids.shape == (big_k,) and scores.shape == (big_k,)
        assert (ids[-7:] == -1).all()

    def test_stress_submit_racing_close_never_hangs(self, store):
        """Submitters racing close(): every future must terminate — with
        a result or a frontend-closed error — never hang (the pre-fix
        race stranded futures enqueued behind the stop sentinel)."""
        fe = BatchingFrontend(store, max_wait_ms=5, method="flat")
        qs = _queries(8, seed=14)
        futs: list = []
        stop = threading.Event()

        def submitter():
            i = 0
            while not stop.is_set():
                futs.append(fe.submit(qs[i % 8], k=2))
                i += 1

        threads = [threading.Thread(target=submitter) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        fe.close()
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert futs
        served = 0
        for f in futs:
            try:
                scores, ids = f.result(timeout=10)
                assert ids.shape == (2,)
                served += 1
            except RuntimeError as exc:
                assert "closed" in str(exc)
        assert served > 0  # traffic before close was actually served

    def test_close_releases_store_reference(self, store):
        """A closed frontend must not pin the corpus's device memory."""
        fe = BatchingFrontend(store, max_wait_ms=10, method="flat")
        fe.search(_queries(1, seed=9)[0], k=3)
        fe.close()
        assert fe.store is None


class TestWarmup:
    """warmup() runs every pad bucket once before traffic."""

    def test_warms_each_power_of_two_bucket_once(self, store,
                                                 monkeypatch):
        shapes: list[tuple[int, int]] = []
        orig = store.search_device

        def spy(q, k, **kw):
            shapes.append((int(q.shape[0]), int(k)))
            return orig(q, k, **kw)

        monkeypatch.setattr(store, "search_device", spy)
        with BatchingFrontend(store, max_batch=8, method="flat") as fe:
            n = fe.warmup(k=4)
        assert n == 4
        assert shapes == [(1, 4), (2, 4), (4, 4), (8, 4)]

    def test_custom_buckets_dedup_and_sort(self, store, monkeypatch):
        shapes: list[int] = []
        orig = store.search_device

        def spy(q, k, **kw):
            shapes.append(int(q.shape[0]))
            return orig(q, k, **kw)

        monkeypatch.setattr(store, "search_device", spy)
        with BatchingFrontend(store, max_batch=64, method="flat") as fe:
            n = fe.warmup(k=3, buckets=[16, 4, 16, 1])
        assert n == 3 and shapes == [1, 4, 16]

    def test_invalid_buckets_are_filtered(self, store, monkeypatch):
        """Caller-supplied buckets outside 1..max_batch never reach the
        store: 0/negatives would build a (0, dim) batch and oversized
        ones warm shapes dispatch can never produce."""
        shapes: list[int] = []
        orig = store.search_device

        def spy(q, k, **kw):
            shapes.append(int(q.shape[0]))
            return orig(q, k, **kw)

        monkeypatch.setattr(store, "search_device", spy)
        with BatchingFrontend(store, max_batch=8, method="flat") as fe:
            n = fe.warmup(k=3, buckets=[0, -4, 2, 8, 10**9])
        assert n == 2 and shapes == [2, 8]

    def test_warmup_then_search_matches_oracle(self, store):
        qs = _queries(4, seed=21)
        with BatchingFrontend(store, max_batch=8, max_wait_ms=100,
                              method="flat") as fe:
            fe.warmup(k=5)
            futs = [fe.submit(q, k=5) for q in qs]
            results = [f.result(timeout=30) for f in futs]
        emb, valid = _rows(store)
        _, o_ids = topk_ops.topk_oracle(qs, emb, valid, 5)
        for i, (_, ids) in enumerate(results):
            assert set(ids.tolist()) == set(np.asarray(o_ids)[i].tolist())

    def test_warmup_on_closed_frontend_raises(self, store):
        fe = BatchingFrontend(store, method="flat")
        fe.close()
        with pytest.raises(RuntimeError, match="closed"):
            fe.warmup()

    def test_warmup_empty_store_is_noop(self):
        st = ChunkStore(dim=16, device="cpu")
        with BatchingFrontend(st, method="flat") as fe:
            assert fe.warmup() == 0

    def test_warmup_buckets_match_dispatch_policy(self, store,
                                                  monkeypatch):
        """The warmed shapes are DERIVED from _bucket(), so the two
        copies of the padding policy cannot desync — here with a
        non-power-of-two max_batch where the cap truncates the ladder."""
        shapes: list[int] = []
        orig = store.search_device

        def spy(q, k, **kw):
            shapes.append(int(q.shape[0]))
            return orig(q, k, **kw)

        monkeypatch.setattr(store, "search_device", spy)
        with BatchingFrontend(store, max_batch=12, method="flat") as fe:
            fe.warmup(k=3)
        expected = sorted({BatchingFrontend._bucket(n, 12)
                           for n in range(1, 13)})
        assert shapes == expected == [1, 2, 4, 8, 12]


# ---- the port against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def jax_store():
    rng = np.random.default_rng(0)
    emb = topk_ops.l2_normalize(
        rng.standard_normal((N, D)).astype(np.float32))
    st = JaxStore(dim=D)
    st.add(emb, [{"file_path": f"f{i}.py"} for i in range(N)])
    return st


@pytest.mark.parametrize("method", ["flat", "quantized", "pq", "int4",
                                    "auto"])
def test_same_traffic_same_answers(store, jax_store, method):
    """Both frontends over stores of the same rows take the same 13
    queries at mixed k in one window: one batch each, padded to 16, the
    same ids and scores within 1e-6. (The JAX store's "pallas" and
    "refined" run Pallas kernels, which its CPU backend refuses outside
    interpret mode.)"""
    qs = _queries(13, seed=31)
    ks = [1 + i % 7 for i in range(13)]
    out = {}
    for name, cls, st in (("jax", JaxFrontend, jax_store),
                          ("port", BatchingFrontend, store)):
        with cls(st, max_batch=64, max_wait_ms=300, method=method) as fe:
            futs = [fe.submit(q, k=k) for q, k in zip(qs, ks)]
            out[name] = ([f.result(timeout=60) for f in futs],
                         fe.stats.batches, fe.stats.padded_rows)
    (jr, jb, jp), (pr, pb, pp) = out["jax"], out["port"]
    assert (pb, pp) == (jb, jp) == (1, 3)
    for (js, ji), (ps, pi), k in zip(jr, pr, ks):
        assert ps.dtype == np.float32 and pi.shape == (k,)
        np.testing.assert_array_equal(pi, np.asarray(ji))
        np.testing.assert_allclose(ps, np.asarray(js), atol=1e-6)


def test_result_independent_of_batch_partners(store):
    """One query alone and inside a batch of 31 others: the same ids and
    bit-equal scores."""
    qs = _queries(32, seed=32)
    with BatchingFrontend(store, max_batch=64, max_wait_ms=0,
                          method="quantized") as fe:
        alone = fe.search(qs[5], k=6)
    with BatchingFrontend(store, max_batch=64, max_wait_ms=300,
                          method="quantized") as fe:
        futs = [fe.submit(q, k=6) for q in qs]
        together = futs[5].result(timeout=60)
        for f in futs:
            f.result(timeout=60)
    assert fe.stats.batches == 1
    np.testing.assert_array_equal(alone[1], together[1])
    np.testing.assert_array_equal(alone[0], together[0])


def test_store_gets_a_tensor_and_results_are_read_back(store, monkeypatch):
    """The port's store takes torch queries (the pad bucket's rows, pad
    rows repeating the first query) and its tensors come back as numpy."""
    seen = []
    orig = store.search_device

    def spy(q, k, **kw):
        seen.append(q)
        return orig(q, k, **kw)

    monkeypatch.setattr(store, "search_device", spy)
    qs = _queries(3, seed=33)
    with BatchingFrontend(store, max_batch=8, max_wait_ms=200,
                          method="flat") as fe:
        futs = [fe.submit(q, k=2) for q in qs]
        res = [f.result(timeout=30) for f in futs]
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert seen[0].shape == (4, D) and seen[0].dtype == torch.float32
    assert torch.equal(seen[0][3], seen[0][0])
    assert all(isinstance(s, np.ndarray) and isinstance(i, np.ndarray)
               for s, i in res)

