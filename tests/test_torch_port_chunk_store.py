"""Port ChunkStore against the JAX ChunkStore, fed the same rows.

Mirrors the core cases of `tests/test_chunk_store.py`: both stores take
the same seeded numpy rows and payloads, by `add` or, for the port, by
`from_numpy_state` from the JAX store, and every observable (row ids,
hits, payloads, filters, lexical candidates, stats) must agree. Scores
agree within 1e-5 (f32 products in two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.core.errors import VectorStoreError as JaxVectorStoreError
from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.core.errors import KernelError, VectorStoreError
from lattice_tpu_torch.index import chunk_store as port_cs
from lattice_tpu_torch.index.chunk_store import (INDEXED_FIELDS,
                                                 SEARCH_METHODS, ChunkStore)
from lattice_tpu_torch.ops import _build, quant
from lattice_tpu_torch.ops import scan_topk as scan_ops

LANGS = ("python", "rust", "go")
KINDS = ("function", "class", "method")


def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _payloads(n, start=0):
    return [{"file_path": f"src/f{i % 7}.py", "entity_type": KINDS[i % 3],
             "language": LANGS[i % 3], "content_hash": f"h{i % 7}",
             "project_name": "proj" if i % 5 else "other",
             "graph_node_id": f"mod.f{i % 7}.Entity{i}",
             "name": f"{'Delivery' if i % 4 else 'Webhook'}Queue{i}.drain_items",
             "content": f"def e{i}(): pass"}
            for i in range(start, start + n)]


def _hits(res):
    return [[(r, p) for r, _, p in q] for q in res]


def _assert_same_hits(a, b, atol=1e-5):
    assert _hits(a) == _hits(b)
    for qa, qb in zip(a, b):
        np.testing.assert_allclose([s for _, s, _ in qa], [s for _, s, _ in qb],
                                   atol=atol)


def _pair(n=120, d=32, dtype="float32", cap=16, seed=0):
    js = JaxStore(dim=d, dtype=dtype, initial_capacity=cap)
    ps = ChunkStore(dim=d, dtype=dtype, initial_capacity=cap, device="cpu")
    vecs = _vecs(n, d, seed)
    pl = _payloads(n)
    assert js.add(vecs, pl) == ps.add(vecs, pl)
    return js, ps, vecs


def _from_state(js):
    return ChunkStore.from_numpy_state(np.asarray(js._emb), js._valid_host,
                                       js._payloads, dtype=str(js.dtype),
                                       device="cpu")


@pytest.fixture(params=["add", "from_numpy_state"])
def pair(request):
    js, ps, vecs = _pair()
    js.remove([3, 10, 11, 50])
    if request.param == "add":
        assert ps.remove([3, 10, 11, 50]) == 4
    else:
        ps = _from_state(js)
    return js, ps, vecs


class TestMutation:
    def test_add_remove_and_tombstone_reuse(self):
        js, ps, vecs = _pair()
        for s in (js, ps):
            assert s.remove([5, 6, 7]) == 3
            assert s.remove([5]) == 0
        new = _vecs(4, 32, seed=3)
        rows_j = js.add(new, _payloads(4, start=500))
        rows_p = ps.add(new, _payloads(4, start=500))
        assert rows_j == rows_p and set(rows_p) <= {5, 6, 7, 120}
        assert len(ps) == len(js) == 121
        assert ps.capacity == js.capacity
        assert ps._free == js._free and ps._next == js._next
        np.testing.assert_array_equal(ps._valid.numpy(), js._valid_host)
        np.testing.assert_array_equal(ps._valid_host, js._valid_host)
        for r in rows_p:
            np.testing.assert_allclose(ps.get_vector(r), js.get_vector(r),
                                       atol=1e-7)

    def test_growth_doubles_from_minimum_eight(self):
        js = JaxStore(dim=8, dtype="float32", initial_capacity=3)
        ps = ChunkStore(dim=8, dtype="float32", initial_capacity=3,
                        device="cpu")
        assert ps.capacity == js.capacity == 8
        for s in (js, ps):
            s.add(_vecs(20, 8), [{"file_path": "a", "content_hash": "h"}] * 20)
        assert ps.capacity == js.capacity == 32

    def test_compact_mapping_and_search(self):
        js, ps, vecs = _pair()
        drop = list(range(0, 120, 3))
        js.remove(drop)
        ps.remove(drop)
        assert ps.maybe_compact() is None          # below min capacity
        mj, mp = js.compact(), ps.compact()
        assert mj == mp
        assert ps.capacity == js.capacity and ps._next == js._next
        q = vecs[[1, 4, 77]]
        _assert_same_hits(js.search(q, k=6), ps.search(q, k=6))
        assert ps.add(vecs[:2], _payloads(2)) == js.add(vecs[:2], _payloads(2))

    def test_maybe_compact_threshold(self):
        js, ps, _ = _pair(n=64, cap=8)
        for s in (js, ps):
            s.COMPACT_MIN_CAPACITY = 8
            s.remove(list(range(0, 64, 2)))
            assert s.maybe_compact() is None       # 50% exactly
            s.remove([1, 3, 5])
        assert ps.maybe_compact() == js.maybe_compact()
        assert ps.maybe_compact() is None

    def test_delete_file_and_clear(self, pair):
        js, ps, vecs = pair
        assert ps.delete_file("src/f2.py") == js.delete_file("src/f2.py") > 0
        assert len(ps) == len(js)
        _assert_same_hits(js.search(vecs[:4], k=10), ps.search(vecs[:4], k=10))
        for s in (js, ps):
            s.clear()
        assert len(ps) == 0 and ps.search(vecs[:1], k=3) == [[]]
        assert ps.stats == js.stats

    def test_errors(self):
        ps = ChunkStore(dim=8, dtype="float32", device="cpu")
        with pytest.raises(VectorStoreError):
            ps.add(_vecs(1, 16), [{}])
        with pytest.raises(VectorStoreError):
            ps.add(_vecs(2, 8), [{}])
        with pytest.raises(VectorStoreError):
            ChunkStore(dim=0, device="cpu")
        assert ps.add(np.zeros((0, 8), np.float32), []) == []
        with pytest.raises(VectorStoreError):
            ps.search_device(torch.zeros(1, 8), 3)
        js = JaxStore(dim=8, dtype="float32")
        js.add(_vecs(2, 8), [{}, {}])
        ps.add(_vecs(2, 8), [{}, {}])
        for s, err in ((js, JaxVectorStoreError), (ps, VectorStoreError)):
            with pytest.raises(err):
                s.search(_vecs(1, 8), k=3, filters={"nope": "x"})
            with pytest.raises(err):
                s.search(_vecs(1, 8), k=3, method="bogus")


class TestPayloads:
    @pytest.mark.parametrize("field", INDEXED_FIELDS)
    def test_filter_on_every_indexed_field(self, pair, field):
        js, ps, vecs = pair
        value = js._payloads[14][field]
        flt = {field: value}
        np.testing.assert_array_equal(ps.filter_mask(flt).numpy(),
                                      np.asarray(js.filter_mask(flt)))
        _assert_same_hits(js.search(vecs[:3], k=8, filters=flt),
                          ps.search(vecs[:3], k=8, filters=flt))
        assert ps.scroll(flt, limit=50) == js.scroll(flt, limit=50)

    def test_filter_list_is_or_and_fields_and(self, pair):
        js, ps, vecs = pair
        flt = {"file_path": ["src/f1.py", "src/f2.py"], "language": "rust"}
        assert ps._filter_rows(flt) == js._filter_rows(flt)
        _assert_same_hits(js.search(vecs[:2], k=20, filters=flt),
                          ps.search(vecs[:2], k=20, filters=flt))
        assert ps.filter_mask(None) is None

    def test_scroll_payload_and_file_needs_update(self, pair):
        js, ps, _ = pair
        assert ps.scroll() == js.scroll()
        assert ps.payload(7) == js.payload(7) and ps.payload(3) is None
        for path, h in (("src/f1.py", "h1"), ("src/f1.py", "x"),
                        ("src/none.py", "h")):
            assert ps.file_needs_update(path, h) == js.file_needs_update(path, h)

    def test_lexical_candidates(self, pair):
        js, ps, _ = pair
        for toks, flt in (({"delivery", "queu"}, None),
                          ({"webhook", "drain"}, {"language": "go"}),
                          ({"deliveryqueue"}, None), ({"absent"}, None)):
            assert ps.lexical_candidates(toks, limit=9, filters=flt) == \
                js.lexical_candidates(toks, limit=9, filters=flt)
        # incremental upkeep after the index is built
        new = _payloads(3, start=900)
        new[0]["name"] = "Unsubscribe.handle"
        for s in (js, ps):
            s.add(_vecs(3, 32, seed=9), new)
            s.remove([20, 21])
        # a store made from numpy state has no freelist (as one made by
        # `from_device_arrays`), so compare hits by payload, not row id
        for toks, lim in (({"unsubscrib", "handl"}, 32), ({"queu"}, 50)):
            assert [(ps.payload(r)["graph_node_id"], sc) for r, sc in
                    ps.lexical_candidates(toks, limit=lim)] == \
                [(js.payload(r)["graph_node_id"], sc) for r, sc in
                 js.lexical_candidates(toks, limit=lim)]

    def test_stats_and_device_arrays(self, pair):
        js, ps, _ = pair
        want = dict(js.stats)
        if not ps._free:  # made from numpy state: no freelist
            want["free_rows"] = 0
        assert ps.stats == want
        emb, valid = ps.device_arrays
        assert emb.shape == (ps.capacity, 32) and valid.dtype == torch.bool
        np.testing.assert_array_equal(valid.numpy(),
                                      np.asarray(js.device_arrays[1]))


class TestSearch:
    @pytest.mark.parametrize("method", ["flat", "quantized", "pallas"])
    def test_methods_match_jax(self, pair, method):
        js, ps, vecs = pair
        q = np.concatenate([vecs[[0, 9, 33]], _vecs(3, 32, seed=5)])
        # the JAX store runs "pallas" only on a TPU; its exact CPU plan is
        # "flat", which the port's exact scan must reproduce
        j_method = "flat" if method == "pallas" else method
        _assert_same_hits(js.search(q, k=7, method=j_method),
                          ps.search(q, k=7, method=method))
        s, i = ps.search_device(torch.from_numpy(q), 7, method=method)
        assert s.shape == (6, 7) and i.dtype == torch.int32
        js_s, js_i = js.search_device(jnp.asarray(q), 7, method=j_method)
        np.testing.assert_array_equal(i.numpy(), np.asarray(js_i))
        np.testing.assert_allclose(s.numpy(), np.asarray(js_s), atol=1e-5)

    def test_bf16_store_search(self):
        js, ps, vecs = _pair(n=200, d=64, dtype="bfloat16", seed=2)
        for method in ("flat", "quantized"):
            _assert_same_hits(js.search(vecs[:5], k=10, method=method),
                              ps.search(vecs[:5], k=10, method=method))
        row, score, _ = ps.search(vecs[:1], k=1)[0][0]
        assert row == 0 and score == pytest.approx(1.0, abs=2e-2)

    def test_two_quantization_histories(self):
        """Full shadow build quantizes the stored bf16 rows; a delta into
        the live shadow quantizes the f32 input. Both stores end with the
        same shadow, bit for bit, and the same quantized hits."""
        js, ps, vecs = _pair(n=100, d=64, dtype="bfloat16", cap=256, seed=4)
        q = _vecs(4, 64, seed=8)
        _assert_same_hits(js.search(q, k=5, method="quantized"),
                          ps.search(q, k=5, method="quantized"))
        new = _vecs(10, 64, seed=6)
        js.add(new, _payloads(10, start=300))
        ps.add(new, _payloads(10, start=300))
        assert not ps._quant_dirty and not js._quant_dirty
        np.testing.assert_array_equal(ps._quant.values.numpy(),
                                      np.asarray(js._quant.values))
        np.testing.assert_array_equal(ps._quant.scales.numpy(),
                                      np.asarray(js._quant.scales))
        # the delta rows hold their f32 quantization, not the bf16 one
        v32, _ = jax_quant.quantize_rows_device(
            jnp.asarray(new / np.linalg.norm(new, axis=1, keepdims=True)))
        np.testing.assert_array_equal(ps._quant.values[100:110].numpy(),
                                      np.asarray(v32))
        q2 = np.concatenate([new[:3], q])
        _assert_same_hits(js.search(q2, k=5, method="quantized"),
                          ps.search(q2, k=5, method="quantized"))
        # growth past the shadow marks it dirty in both
        more = _vecs(200, 64, seed=7)
        js.add(more, _payloads(200, start=400))
        ps.add(more, _payloads(200, start=400))
        assert ps._quant_dirty and js._quant_dirty

    def test_pipelined_matches_search_device(self, pair):
        _, ps, vecs = pair
        q = torch.from_numpy(vecs[:10])
        a = ps.search_device(q, 5, method="quantized")
        b = ps.search_device_pipelined(q, 5, chunk=4, method="quantized")
        assert torch.equal(a[1], b[1]) and torch.allclose(a[0], b[0])

    def test_pipelined_plans_once_at_chunk(self, pair, monkeypatch):
        """A plan that depends on the batch ("ivf" at <= 256, "quantized"
        above) is made once, at `chunk`, and serves every slice, the
        600 - 512 = 88-query tail included, as the JAX store's padding to
        whole chunks did."""
        _, ps, _ = pair
        calls = []

        def plan(self, batch, k_eff, filters, method):
            calls.append((batch, method))
            if method != "auto":
                return method
            return "ivf" if batch <= 256 else "quantized"

        monkeypatch.setattr(ChunkStore, "_plan_search", plan)
        q = torch.from_numpy(_vecs(600, 32, seed=11))
        s, i = ps.search_device_pipelined(q, 5, chunk=512)
        assert calls == [(512, "auto"), (512, "quantized"), (88, "quantized")]
        want_s, want_i = ps.search_device(q, 5, method="quantized")
        assert torch.equal(i, want_i) and torch.equal(s, want_s)

    def test_pipelined_matches_jax(self, pair):
        """Ten queries in chunks of 4 (a short tail) through both stores'
        `search_device_pipelined`, each planned by its own table."""
        js, ps, vecs = pair
        q = np.concatenate([vecs[[1, 4, 60]], _vecs(7, 32, seed=12)])
        s, i = ps.search_device_pipelined(torch.from_numpy(q), 6, chunk=4)
        j_s, j_i = js.search_device_pipelined(jnp.asarray(q), 6, chunk=4)
        np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)

    def test_filtered_search_device(self, pair):
        js, ps, vecs = pair
        flt = {"entity_type": "class"}
        for method in ("flat", "quantized", "pallas"):
            s, i = ps.search_device(torch.from_numpy(vecs[:3]), 6,
                                    filters=flt, method=method)
            allowed = ps._filter_rows(flt)
            assert all(int(r) in allowed for r in i.flatten())


class TestPlanTable:
    @pytest.fixture
    def cuda_store(self, monkeypatch):
        _, ps, _ = _pair(n=40)
        monkeypatch.setattr(ChunkStore, "_device_is_cuda", lambda self: True)
        monkeypatch.setattr(ChunkStore, "_device_memory_bytes",
                            lambda self: 80 * 1024 ** 3)
        for flag in ("LATTICE_INT8", "LATTICE_INT4", "LATTICE_PQ",
                     "LATTICE_SHARDED"):
            monkeypatch.delenv(flag, raising=False)
        return ps

    def test_cpu_auto_is_flat(self, pair):
        _, ps, _ = pair
        assert ps._plan_search(1, 10, None, "auto") == "flat"

    def test_cuda_default_is_quantized(self, cuda_store):
        assert cuda_store._plan_search(256, 10, None, "auto") == "quantized"
        assert cuda_store._plan_search(1, 64, None, "auto") == "quantized"

    def test_int8_optout_serves_pallas(self, cuda_store, monkeypatch):
        monkeypatch.setenv("LATTICE_INT8", "0")
        assert cuda_store._plan_search(256, 10, None, "auto") == "pallas"

    def test_shadow_that_does_not_fit_serves_pallas(self, cuda_store,
                                                    monkeypatch):
        monkeypatch.setattr(ChunkStore, "_device_memory_bytes",
                            lambda self: 1000)
        assert cuda_store._plan_search(256, 10, None, "auto") == "pallas"
        monkeypatch.setenv("LATTICE_INT8", "1")
        assert cuda_store._plan_search(256, 10, None, "auto") == "quantized"

    def test_k_above_64_is_flat(self, cuda_store, monkeypatch):
        assert cuda_store._plan_search(256, 65, None, "auto") == "flat"
        monkeypatch.setenv("LATTICE_INT8", "1")
        assert cuda_store._plan_search(256, 65, None, "auto") == "flat"

    @pytest.mark.parametrize("flag", ["LATTICE_INT4", "LATTICE_PQ",
                                      "LATTICE_SHARDED"])
    def test_unported_modes_raise(self, cuda_store, monkeypatch, flag):
        """Every capacity and scale mode is ported and plans its method:
        LATTICE_SHARDED with more than one CUDA device (the default mesh)
        plans "sharded" up to SHARDED_MAX_K and falls through past it (one
        device: test_sharded_flag_on_one_device_falls_through);
        LATTICE_INT4 plans "int4" (tests/test_torch_port_int4.py), and
        LATTICE_PQ builds the PQ view, whose rescored recall on these rows
        clears the bar, and plans "pq" (tests/test_torch_port_pq.py)."""
        monkeypatch.setenv(flag, "1")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        if flag == "LATTICE_INT4":
            assert cuda_store._plan_search(256, 10, None, "auto") == "int4"
            return
        if flag == "LATTICE_PQ":
            assert cuda_store._plan_search(256, 10, None, "auto") == "pq"
            assert cuda_store._pq.measured_recall >= port_cs.IVF_MIN_RECALL
            return
        assert cuda_store._mesh_shards() == 2
        k_max = port_cs.SHARDED_MAX_K
        assert cuda_store._plan_search(256, 10, None, "auto") == "sharded"
        assert cuda_store._plan_search(1, k_max, None, "auto") == "sharded"
        assert cuda_store._plan_search(1, k_max + 1, None,
                                       "auto") == "quantized"

    @pytest.mark.parametrize("k, want", [
        (10, "pq"), (65, "pq"), (scan_ops.MAX_K1_LONG, "pq"),
        (scan_ops.MAX_K1_LONG + 1, "flat"), (600, "flat")])
    def test_pq_flag_within_kernel_b_lists(self, cuda_store, monkeypatch,
                                           k, want):
        """On a CUDA store LATTICE_PQ=1 plans "pq" only while its first
        stage's max(k, 32) candidates fit kernel B's lists; a longer k
        (the HTTP surface takes k <= 1000) falls through to "flat" rather
        than hand the kernel a k it refuses. On the CPU any k plans "pq",
        as in the JAX store."""
        monkeypatch.setenv("LATTICE_PQ", "1")
        assert cuda_store._plan_search(256, k, None, "auto") == want
        monkeypatch.setattr(ChunkStore, "_device_is_cuda",
                            lambda self: False)
        assert cuda_store._plan_search(256, k, None, "auto") == "pq"

    @pytest.mark.parametrize("batch, k", [(1, 10), (256, 10), (1, 64),
                                          (256, 65)])
    def test_sharded_flag_on_one_device_falls_through(self, cuda_store,
                                                      monkeypatch, batch, k):
        """As the JAX store plans "sharded" only with more than one device,
        the flag on one card (the default mesh) plans exactly what the
        table plans without it, and a forced "sharded" serves the exact
        flat scan, as the JAX store does on one device."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        want = cuda_store._plan_search(batch, k, None, "auto")
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        assert cuda_store._plan_search(batch, k, None, "auto") == want
        assert cuda_store._resolve_plan(batch, k, None, "sharded") == "sharded"
        assert not cuda_store._serves_sharded("sharded")
        q = torch.from_numpy(_vecs(2, 32, seed=batch + k))
        fs, fi = cuda_store.search_device(q, k, method="flat")
        ss, si = cuda_store.search_device(q, k, method="sharded")
        assert torch.equal(si, fi) and torch.equal(ss, fs)
        assert cuda_store._sharded is None and cuda_store._shardedq is None

    def test_sharded_flag_plans_as_the_jax_store(self, pair, monkeypatch):
        """One input through both stores with the flag set: the JAX store
        plans "sharded" on the tests' 8 host devices, and falls through
        when `jax.devices` gives one; the port plans the same method with
        one device (or none: the CPU store's default mesh is one shard),
        and "sharded" with a mesh of four logical shards on the CPU, where
        it answers as the JAX store does on its eight."""
        import jax
        from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
        js, ps, vecs = pair
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        assert js._plan_search(4, 5, None, "auto") == "sharded"
        want = js.search(vecs[:4], k=5)
        with default_mesh(make_mesh(4, device="cpu")):
            assert ps._plan_search(4, 5, None, "auto") == "sharded"
            _assert_same_hits(want, ps.search(vecs[:4], k=5))
        assert ps._sharded is not None
        one = jax.devices()[:1]
        monkeypatch.setattr(jax, "devices", lambda *a, **kw: one)
        j_plan = js._plan_search(4, 5, None, "auto")
        assert j_plan != "sharded"
        for count in (0, 1):
            monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
            assert ps._plan_search(4, 5, None, "auto") == j_plan
        got = ps.search(vecs[:4], k=5)
        _assert_same_hits(js.search(vecs[:4], k=5), got)

    @pytest.mark.parametrize("method", ["refined", "pq", "int4", "sharded"])
    def test_unported_forced_methods_raise(self, pair, method):
        """Every forced method is ported and serves the exact flat answer
        here: "refined", "int4" and "pq" (rescored widened lists), and
        "sharded", on the CPU store's one shard (the flat scan, as the JAX
        store on one device) and on four logical shards."""
        from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
        _, ps, vecs = pair
        assert method in SEARCH_METHODS
        want = ps.search(vecs[:1], k=3, method="flat")
        got = ps.search(vecs[:1], k=3, method=method)
        assert [r for r, _, _ in got[0]] == [r for r, _, _ in want[0]]
        if method == "sharded":
            with default_mesh(make_mesh(4, device="cpu")):
                got = ps.search(vecs[:1], k=3, method=method)
            assert ps._sharded is not None
            assert [r for r, _, _ in got[0]] == [r for r, _, _ in want[0]]

    def test_forced_kernel_plan_past_list_bound_serves_flat(self):
        """Only the auto plan serves "flat" past k=64. A forced kernel plan
        is served as asked: the plain versions take any k on the CPU, and
        the kernels refuse a list longer than MAX_K1 rather than serve
        another plan."""
        _, ps, vecs = _pair(n=300)
        assert port_cs.KERNEL_MAX_K == 64
        q = torch.from_numpy(vecs[:2])
        fs, fi = ps.search_device(q, 129, method="flat")
        for method in ("quantized", "pallas", "refined", "int4"):
            assert ps._resolve_plan(1, 129, None, method) == method
            s, i = ps.search_device(q, 129, method=method)
            assert s.shape == i.shape == (2, 129)
            assert bool((s[:, :-1] >= s[:, 1:]).all())
        # the f32 first stage is exact at storage precision
        assert torch.equal(i, fi) and torch.allclose(s, fs, atol=1e-5)
        emb, valid = ps.device_arrays
        with pytest.raises(KernelError, match="128"):
            scan_ops.scan_blocks(q, emb, valid, scan_ops.MAX_K1 + 1)
        qv, qs = quant.quantize_rows_device(q)
        ev, es = quant.quantize_rows_device(emb)
        with pytest.raises(KernelError, match="128"):
            scan_ops.scan_blocks_int8(qv, qs, ev, es, valid,
                                      scan_ops.MAX_K1 + 1)
        ep, eps = quant.quantize_rows_int4_device(emb)
        with pytest.raises(KernelError, match="512"):
            scan_ops.scan_blocks_int4(qv, qs, ep, eps, valid,
                                      scan_ops.MAX_K1_LONG + 1)

    def test_first_stage_widths(self):
        for k, n, int8_k1 in ((1, 1000, 4), (4, 1000, 16), (10, 1000, 16),
                              (64, 1000, 64), (10, 12, 12)):
            assert scan_ops.int8_first_stage_width(k, n) == int8_k1
            # the int8 view's scan runs at the bf16 plan's width
            assert (scan_ops.first_stage_width(int8_k1, n)
                    == scan_ops.first_stage_width(k, n))

    def test_unported_surfaces_raise(self, pair):
        """Every surface is ported: the sharded views build over the CPU
        store's rows on a mesh (the hybrid view with the rank columns of a
        graph), and `build_pq` builds the view over the live rows."""
        from lattice_tpu_torch.index.graph_store import GraphStore
        from lattice_tpu_torch.parallel.mesh import make_mesh
        _, ps, vecs = pair
        mesh = make_mesh(4, device="cpu")
        view = ps.to_sharded(mesh)
        assert view.capacity >= ps.capacity and view.mesh == mesh
        q = vecs[:2]
        s, i = view.search(q, 5)
        want = ps.search(q, k=5, method="flat")
        assert [list(r) for r in i] == [[r for r, _, _ in h] for h in want]
        qview = ps.to_sharded_quantized(mesh, bits=4)
        assert qview.bits == 4 and qview.values.shape == (qview.capacity, 16)
        graph = GraphStore(device="cpu")
        hybrid = ps.sharded_hybrid(graph, mesh)
        assert hybrid.bits == 16 and hybrid.mesh == mesh
        assert ps.sharded_hybrid(graph, mesh) is hybrid
        pq = ps.build_pq()
        assert pq is ps._pq and not ps._pq_dirty
        assert pq.codes.shape == (ps.capacity, pq.m)
        assert pq.measured_recall is not None

    def test_cpu_store_launches_no_kernel(self, pair):
        _, ps, vecs = pair
        _build.reset_launch_counts()
        for method in ("quantized", "pallas", "flat", "int4", "refined"):
            ps.search_device(torch.from_numpy(vecs[:2]), 5, method=method)
        assert set(_build.launch_counts().values()) == {0}
