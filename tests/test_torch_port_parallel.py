"""The port's `parallel/` against the JAX package's, on a 4-shard mesh.

The JAX objects are built on `make_mesh(4)` over the 8 virtual CPU devices
that `tests/conftest.py` makes; the port's on `make_mesh(4,
device="cpu")`, four logical shards on the CPU. Both take the same numpy
inputs from one seed, at small sizes (n <= 8192, d <= 256). Mirrors
`tests/test_models_parallel.py`'s `TestShardedIndex`, `TestShardedQuantized
Index`, `TestTreeMergeLadder`, `TestEncoderBatchDP`, `TestShardedGraphBFS`,
`TestMultiSliceIndex`, `TestShardedQuantizedUpgrades` (whose Pallas-forced
cases compare the plain per-shard versions) and `TestShardedHybridRank`,
and the sharded cases of `tests/test_chunk_store.py`.

Tolerances:
- bf16 and f32 sharded search: ids equal to the JAX view's at every rank,
  except where the two scores at that rank tie within 1e-6 (so do the
  scores, 1e-6);
- the quantized views: ids equal at every rank except between candidates
  whose scores differ by less than one quantization step (TIE_Q: 1e-5 of
  f32 rounding; both packages quantize the same rows bit for bit);
- the sharded deep rank: ids equal to the port's own single-device
  `hybrid_rank_device_packed_batch` except ties within 1e-5, scores
  within 1e-5; and to the JAX sharded rank by the same rule;
- `ShardedGraph`: distances equal to `bfs_oracle` and to the JAX view,
  `k_hop` equal to the host walk, exactly;
- the encoder's batch split over shards: pooled rows within 2e-5 of the
  unsplit forward (f32), within 2e-4 of the JAX sharded forward.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu.models.unixcoder import UniXcoderModel as JaxModel
from lattice_tpu.parallel import mesh as jax_mesh
from lattice_tpu.parallel import sharded_graph as jax_graph
from lattice_tpu.parallel import sharded_index as jax_index
from lattice_tpu.parallel import sharded_rank as jax_rank
from lattice_tpu_torch.core.errors import ConfigurationError
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.models import unixcoder as um
from lattice_tpu_torch.ops import _build, ranking
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.graph_kernels import bfs_oracle
from lattice_tpu_torch.parallel import mesh as mesh_ops
from lattice_tpu_torch.parallel.mesh import (default_mesh, make_mesh,
                                             make_multislice_mesh)
from lattice_tpu_torch.parallel.sharded_graph import ShardedGraph
from lattice_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                      ShardedQuantizedIndex,
                                                      tree_merge_topk)
from lattice_tpu_torch.parallel.sharded_rank import ShardedHybridRank

TIE = 1e-6
TIE_Q = 1e-5
TIE_RANK = 1e-5


def mesh4():
    return make_mesh(4, device="cpu")


def jmesh4():
    return jax_mesh.make_mesh(4)


@pytest.fixture()
def on_mesh4():
    """The stores' one mesh (`default_mesh`) set to four logical shards on
    the CPU for the test."""
    with default_mesh(mesh4()):
        yield


def _normed(rng, n, d):
    return topk_ops.l2_normalize(rng.normal(size=(n, d)))


def _agree(got, want, tie):
    """Scores within `tie` at every rank; where the ids at a rank differ,
    the two candidates tie within it."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, atol=tie, rtol=0)
    for q in range(gi.shape[0]):
        for j in np.flatnonzero(gi[q] != wi[q]):
            assert abs(float(gs[q, j]) - float(ws[q, j])) <= tie, (q, j)


def _overlap(a, b, k):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / k
                          for x, y in zip(a, b)]))


class TestMesh:
    def test_make_mesh_deals_shards_over_the_pool(self):
        m = make_mesh(4, device="cpu")
        assert m.shape == {"data": 4, "model": 1} and m.size == 4
        assert m.row_devices == (torch.device("cpu"),) * 4
        assert make_mesh(device="cpu").size == 1
        tp = make_mesh(8, model_parallel=2, device="cpu")
        assert tp.shape == {"data": 4, "model": 2}
        assert len(tp.row_devices) == 4
        assert make_mesh(6, model_parallel=4, device="cpu").shape == {
            "data": 6, "model": 1}
        ms = make_multislice_mesh(2, 8, device="cpu")
        assert ms.shape == {"dcn": 2, "data": 4} and ms.multislice
        assert [list(s) for s in ms.slices] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        with pytest.raises(ValueError):
            make_multislice_mesh(3, 8, device="cpu")
        # the same factoring as the JAX package's meshes
        assert dict(jax_mesh.make_mesh(8, model_parallel=2).shape) == \
            tp.shape
        assert dict(jax_mesh.make_multislice_mesh(2, 8).shape) == ms.shape

    def test_cuda_mesh_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ConfigurationError, match="CUDA is not available"):
            make_mesh(4)

    def test_placement_helpers(self):
        m = mesh4()
        x = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 3)
        parts = mesh_ops.row_sharded(m, x)
        assert [p.shape for p in parts] == [(3, 3)] * 4
        assert torch.equal(torch.cat(parts)[:10], x)
        assert not bool(torch.cat(parts)[10:].any())
        assert all(p.data_ptr() != x.data_ptr() for p in parts)
        rep = mesh_ops.replicated(m, x)
        assert len(rep) == 4 and all(r is rep[0] for r in rep)

    def test_param_sharding_rules_match_jax(self):
        """The Megatron rules on the port's [out, in] weights name the same
        split as the JAX rules on flax's [in, out] kernels."""
        cfg = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                   intermediate_size=32, max_position_embeddings=20)
        jm = JaxModel(JaxConfig(**cfg, dtype="float32"), seed=0)
        flat = {}
        for path, value in jax.tree_util.tree_flatten_with_path(
                jm.params)[0]:
            flat["/".join(str(getattr(p, "key", p)) for p in path)] = (
                path, value)
        port = um.params_from_jax({k: np.asarray(v)
                                   for k, (_, v) in flat.items()})
        rules = {}
        for k, (path, value) in flat.items():
            spec = tuple(jax_mesh.param_sharding_rules(path, value))
            rules[k] = spec[::-1] if np.ndim(value) == 2 else spec
        names = sorted(port)
        assert len(names) == len(rules)
        got = Counter(mesh_ops.param_sharding_rules(n, port[n])
                      for n in names)
        assert Counter(rules.values()) == got
        assert got[("model", None)] == 4 and got[(None, "model")] == 2
        placed = mesh_ops.shard_params(
            port, make_mesh(4, model_parallel=2, device="cpu"))
        w = "layers.0.intermediate.weight"
        assert [p.shape for p in placed[w]] == [(16, 16)] * 2
        assert torch.equal(torch.cat(placed[w]), port[w])

    def test_model_axis_raises_where_a_forward_uses_it(self):
        """A model axis runs the tensor-parallel forward
        (`tests/test_torch_port_tensor_parallel.py` holds it to JAX's);
        where it does not split the heads, the forward would use it, so
        `use_mesh` and the trainer raise, and the model keeps its mesh."""
        from lattice_tpu_torch.models.train import ContrastiveTrainer
        tp = make_mesh(4, model_parallel=2, device="cpu")
        model = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), device="cpu")
        want = model.encode(np.full((3, 8), 7), np.ones((3, 8), np.int64))
        model.use_mesh(tp)
        assert model.mesh is tp and model.data_shards == 2
        got = model.encode(np.full((3, 8), 7), np.ones((3, 8), np.int64))
        np.testing.assert_allclose(got, want, atol=2e-2)
        with pytest.raises(ConfigurationError, match="does not split"):
            model.use_mesh(make_mesh(4, model_parallel=4, device="cpu"))
        assert model.mesh is tp
        with pytest.raises(ConfigurationError, match="does not split"):
            ContrastiveTrainer(um.UniXcoderConfig(**SMALL),
                               mesh=make_mesh(4, model_parallel=4,
                                              device="cpu"))
        trainer = ContrastiveTrainer(um.UniXcoderConfig(**SMALL),
                                     mesh=mesh4())
        assert trainer.mp == 1 and trainer.device == torch.device("cpu")


class TestShardedIndex:
    def test_matches_single_chip_oracle(self):
        rng = np.random.default_rng(0)
        emb = _normed(rng, 500, 32)
        valid = np.ones(500, dtype=bool)
        valid[123] = False
        queries = _normed(rng, 4, 32)
        index = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        got = index.search(queries, k=7)
        want = jax_index.ShardedIndex(emb, valid, mesh=jmesh4(),
                                      dtype="float32").search(queries, k=7)
        _agree(got, want, TIE)
        o_scores, o_idx = topk_ops.topk_oracle(queries, emb, valid, 7)
        np.testing.assert_allclose(got[0], o_scores, atol=1e-5)
        assert 123 not in got[1]
        assert index.rows_per_shard == 125 and index.capacity == 500

    def test_mask_ands_per_shard(self):
        rng = np.random.default_rng(2)
        emb = _normed(rng, 500, 32)
        valid = np.ones(500, dtype=bool)
        mask = np.zeros(500, dtype=bool)
        allowed = rng.choice(500, size=40, replace=False)
        mask[allowed] = True
        queries = _normed(rng, 3, 32)
        index = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        jindex = jax_index.ShardedIndex(emb, valid, mesh=jmesh4(),
                                        dtype="float32")
        got = index.search(queries, k=7, mask=mask)
        _agree(got, jindex.search(queries, k=7, mask=mask), TIE)
        assert set(got[1].ravel().tolist()) <= set(allowed.tolist())
        s2, _ = index.search(queries, k=7)
        assert s2[0][0] >= got[0][0][0] - 1e-6

    def test_row_padding_not_returned(self):
        rng = np.random.default_rng(1)
        emb = _normed(rng, 13, 16)                 # 13 % 4 != 0
        valid = np.ones(13, dtype=bool)
        index = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        scores, idx = index.search(emb[:2], k=13)
        assert idx.max() < 13 and index.capacity == 16
        _agree((scores, idx), jax_index.ShardedIndex(
            emb, valid, mesh=jmesh4(), dtype="float32").search(emb[:2], 13),
            TIE)

    def test_incremental_update_rows(self):
        rng = np.random.default_rng(3)
        emb = _normed(rng, 64, 16)
        valid = np.ones(64, dtype=bool)
        index = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        jindex = jax_index.ShardedIndex(emb, valid, mesh=jmesh4(),
                                        dtype="float32")
        fresh = _normed(rng, 2, 16)
        assert index.update_rows(fresh, np.array([5, 40]))
        assert jindex.update_rows(fresh, np.array([5, 40]))
        _, idx = index.search(fresh, k=1)
        assert idx[0, 0] == 5 and idx[1, 0] == 40
        index.invalidate_rows(np.array([5, 999]))
        jindex.invalidate_rows(np.array([5, 999]))
        _agree(index.search(fresh, k=3), jindex.search(fresh, k=3), TIE)
        assert not index.update_rows(fresh[:1], np.array([64]))  # past cap

    def test_store_mutations_keep_sharded_view_o_delta(self, monkeypatch):
        """Mutations of the store write the delta rows into its view: the
        view object survives, the rows copied to the shards are the delta
        (counted at the copy into the shards), and the sharded search sees
        the mutation."""
        rng = np.random.default_rng(4)
        n, d = 256, 32
        emb = _normed(rng, n, d)
        store = ChunkStore(dim=d, dtype="float32", initial_capacity=512,
                           device="cpu")
        store.add(emb, [{"file_path": "a.py"}] * n)
        store._sharded = store.to_sharded(mesh=mesh4())
        store._sharded_dirty = False
        view = store._sharded
        written = []
        orig = torch.Tensor.__setitem__

        def counting(self, key, value):
            if any(self is e for e in view.embeddings):
                written.append(value.numel() * value.element_size())
            return orig(self, key, value)

        monkeypatch.setattr(torch.Tensor, "__setitem__", counting)
        fresh = _normed(rng, 4, d)
        rows = store.add(fresh, [{"file_path": "b.py"}] * 4)
        store.remove(rows[:1])
        monkeypatch.setattr(torch.Tensor, "__setitem__", orig)
        assert store._sharded is view and not store._sharded_dirty
        assert 0 < sum(written) <= 4 * d * 4, written
        scores, idx = view.search(fresh, k=1)
        assert idx[1, 0] == rows[1] and idx[0, 0] != rows[0]


class TestShardedQuantizedIndex:
    def test_recall_vs_oracle_and_memory(self):
        rng = np.random.default_rng(7)
        emb = _normed(rng, 600, 32)
        valid = np.ones(600, dtype=bool)
        valid[[9, 500]] = False
        queries = _normed(rng, 4, 32)
        index = ShardedQuantizedIndex(emb, valid, mesh=mesh4())
        got = index.search(queries, k=10)
        want = jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jmesh4()).search(queries, k=10)
        _agree(got, want, TIE_Q)
        o_scores, o_idx = topk_ops.topk_oracle(queries, emb, valid, 10)
        assert _overlap(got[1], o_idx, 10) >= 0.9
        np.testing.assert_allclose(got[0], o_scores, atol=5e-2)
        assert 9 not in got[1] and 500 not in got[1]
        assert index.memory_bytes() < 0.6 * (index.capacity * 32 * 2)
        jmem = jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jmesh4()).memory_bytes()
        assert index.memory_bytes() == jmem

    def test_search_device_matches_host_wrapper(self):
        rng = np.random.default_rng(23)
        emb = _normed(rng, 512, 32)
        valid = np.ones(512, dtype=bool)
        queries = _normed(rng, 8, 32)
        index = ShardedQuantizedIndex(emb, valid, mesh=mesh4())
        s_host, i_host = index.search(queries, k=5)
        s_dev, i_dev = index.search_device(torch.from_numpy(queries), k=5)
        np.testing.assert_array_equal(i_host, i_dev.numpy())
        np.testing.assert_array_equal(s_host, s_dev.numpy())
        mask = np.zeros(512, dtype=bool)
        mask[:100] = True
        got = index.search(queries, k=5, mask=mask)
        assert (got[1] < 100).all()
        _agree(got, jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jmesh4()).search(queries, k=5, mask=mask), TIE_Q)

    def test_int4_rescore_default_recovers_recall(self):
        rng = np.random.default_rng(11)
        n, d, k = 4096, 96, 10
        emb = _normed(rng, n, d)
        valid = np.ones(n, dtype=bool)
        queries = topk_ops.l2_normalize(
            emb[rng.integers(0, n, size=16)]
            + 0.25 * rng.normal(size=(16, d)))
        index = ShardedQuantizedIndex(emb, valid, mesh=mesh4(), bits=4)
        got = index.search(queries, k=k)
        _agree(got, jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jmesh4(), bits=4).search(queries, k=k), TIE_Q)
        _, o_idx = topk_ops.topk_oracle(queries, emb, valid, k)
        assert _overlap(got[1], o_idx, k) >= 0.85
        # the winners' scores are the f32 dots of the dequantized rows
        from lattice_tpu_torch.ops.quant import unpack_int4_oracle
        deq = (unpack_int4_oracle(index.values.numpy()).astype(np.float32)
               * index.scales.numpy()[:, None])
        want = np.einsum("bd,bkd->bk", queries.astype(np.float32),
                         deq[got[1]])
        np.testing.assert_allclose(got[0], want, atol=2e-3)

    def test_int4_full_precision_rescore_beats_capacity_tier(self):
        rng = np.random.default_rng(3)
        n, d, k, nclus = 8192, 256, 10, 16
        centers = _normed(rng, nclus, d)
        emb = topk_ops.l2_normalize(
            centers[rng.integers(0, nclus, n)] + 0.06 * rng.normal(size=(n, d)))
        valid = np.ones(n, bool)
        queries = topk_ops.l2_normalize(
            centers[rng.integers(0, nclus, 16)]
            + 0.06 * rng.normal(size=(16, d)))
        _, o_idx = topk_ops.topk_oracle(queries, emb, valid, k)
        capacity = ShardedQuantizedIndex(emb, valid, mesh=mesh4(), bits=4)
        speed = ShardedQuantizedIndex(emb, valid, mesh=mesh4(), bits=4,
                                      keep_full_precision=True)
        got_cap, got_spd = capacity.search(queries, k), speed.search(queries, k)
        jspeed = jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jmesh4(), bits=4, keep_full_precision=True)
        _agree(got_spd, jspeed.search(queries, k), TIE_Q)
        r_cap, r_spd = _overlap(got_cap[1], o_idx, k), _overlap(
            got_spd[1], o_idx, k)
        assert r_spd >= 0.95 and r_spd > r_cap + 0.05, (r_cap, r_spd)
        assert speed.memory_bytes() > 4 * capacity.memory_bytes()
        assert speed.memory_bytes() == jspeed.memory_bytes()
        fresh = _normed(rng, 2, d)
        assert speed.update_rows(fresh, np.array([5, 9]))
        assert speed.search(fresh[:1], k=1)[1][0, 0] == 5

    def test_int4_rescore_pallas_interpret_matches_xla(self):
        """The JAX case forces the Pallas first stage (interpret mode); the
        port's per-shard first stage on the CPU is kernel D's plain
        version, held here to the JAX view's XLA first stage and to JAX's
        rescored winners."""
        rng = np.random.default_rng(5)
        n, d, k = 8192, 64, 8
        emb = _normed(rng, n, d)
        valid = np.ones(n, dtype=bool)
        queries = _normed(rng, 4, d)
        index = ShardedQuantizedIndex(emb, valid, mesh=mesh4(), bits=4)
        jindex = jax_index.ShardedQuantizedIndex(emb, valid, mesh=jmesh4(),
                                                 bits=4)
        _agree(index.search(queries, k, rescore=False),
               jindex.search(queries, k, rescore=False), TIE_Q)
        _agree(index.search(queries, k), jindex.search(queries, k), TIE_Q)


class TestTreeMergeLadder:
    def test_ladder_root_matches_global_topk(self):
        rng = np.random.default_rng(0)
        k, d, per = 5, 16, 64
        emb = _normed(rng, 8 * per, d)
        q = _normed(rng, 2, d)
        scores, ids = [], []
        for s in range(8):
            sl, il = topk_ops.flat_topk(
                torch.from_numpy(q), torch.from_numpy(emb[s * per:(s + 1) * per]),
                torch.ones(per, dtype=torch.bool), k)
            scores.append(sl)
            ids.append(il + s * per)
        out = tree_merge_topk(scores, ids, k)
        root_s, root_i = out[0]
        o_s, o_i = topk_ops.topk_oracle(q, emb, np.ones(len(emb), bool), k)
        np.testing.assert_allclose(root_s.numpy(), o_s, atol=1e-5)
        np.testing.assert_array_equal(root_i.numpy(), o_i)
        # the JAX ladder over the same shard lists leaves the same root
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def local(s, i):
            return jax_index.tree_merge_topk(s[0], i[0], k,
                                             axis_name="data")

        fn = shard_map(local, mesh=jax_mesh.make_mesh(8),
                       in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_vma=False)
        js, ji = jax.jit(fn)(jnp.asarray(torch.stack(scores).numpy()),
                             jnp.asarray(torch.stack(ids).numpy()))
        np.testing.assert_allclose(root_s.numpy(), np.asarray(js)[:2],
                                   atol=1e-6)
        np.testing.assert_array_equal(root_i.numpy(), np.asarray(ji)[:2])


SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=66)


def _jax_and_port_models(seed=7):
    jm = JaxModel(JaxConfig(**SMALL, dtype="float32"), seed=seed)
    pm = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, dtype="float32"),
                           seed=seed, device="cpu")
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jm.params)[0]}
    pm.encoder.load_state_dict(um.params_from_jax(flat))
    return jm, pm


class TestEncoderBatchDP:
    def test_sharded_encode_matches_single_device(self, monkeypatch):
        """Batch 5 pads to the 4 shards' multiple; each shard's forward
        runs paired attention (its plain version here)."""
        from lattice_tpu_torch.ops import attention
        rng = np.random.default_rng(3)
        ids = rng.integers(5, 500, size=(5, 40))
        mask = np.ones((5, 40), dtype=np.int64)
        mask[2, 17:] = 0
        jm, pm = _jax_and_port_models()
        want = pm.encode(ids, mask)
        calls = []
        real = attention.paired_attention

        def counted(*a, **kw):
            calls.append(a[0].shape[0])
            return real(*a, **kw)

        monkeypatch.setattr(um, "paired_attention", counted)
        pm.use_mesh(mesh4())
        assert pm.data_shards == 4
        got = pm.encode(ids, mask)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert calls == [2] * (4 * SMALL["num_layers"])
        jm.use_mesh(jmesh4())
        np.testing.assert_allclose(got, jm.encode(ids, mask), atol=2e-4)
        # device-resident inputs at a bucket length take the same split
        bucket = pm.bucket_length(40)
        ids_p = np.pad(ids, ((0, 0), (0, bucket - 40)),
                       constant_values=pm.config.pad_token_id)
        mask_p = np.pad(mask, ((0, 0), (0, bucket - 40)))
        out = pm.encode_device(torch.from_numpy(ids_p),
                               torch.from_numpy(mask_p))
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
        # rows of two length buckets: each bucket's group of 3 rows is
        # padded to the 4 data rows and split, one row a shard
        wide = um.UniXcoderModel(um.UniXcoderConfig(
            **{**SMALL, "max_position_embeddings": 130}, dtype="float32"),
            seed=7, device="cpu")
        ids = rng.integers(5, 500, size=(6, 100))
        mask = np.ones((6, 100), dtype=np.int64)
        mask[[1, 3, 4], 50:] = 0
        whole = wide._forward(
            torch.from_numpy(np.pad(ids, ((0, 0), (0, 28)))),
            torch.from_numpy(np.pad(mask, ((0, 0), (0, 28))))).numpy()
        wide.use_mesh(mesh4())
        calls.clear()
        np.testing.assert_allclose(wide.encode(ids, mask), whole, atol=2e-5)
        assert calls == [1] * (2 * 4 * SMALL["num_layers"])

    def test_provider_autoshards_on_multidevice(self, monkeypatch):
        """With more than one device of the model's kind (here the mesh
        `default_mesh` sets, four CPU shards, stands for four cards) the
        provider splits its
        batches; on one device (the CPU's own mesh) it changes nothing."""
        from lattice_tpu_torch.providers import unixcoder_provider as up
        tiny = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), seed=1,
                                 device="cpu")
        monkeypatch.setattr(up, "_get_model", lambda *a, **kw: tiny)
        emb = up.UniXcoderEmbedder(batch_size=4, device="cpu")
        assert emb.model.mesh is None and emb.batch_size == 4
        want = np.asarray(emb.embed_batch(["def f(): pass", "class A: ..."]))
        with default_mesh(mesh4()):
            emb = up.UniXcoderEmbedder(batch_size=4, device="cpu")
        assert emb.model.data_shards == 4
        assert emb.batch_size == 4 * emb.model.data_shards
        vecs = np.asarray(emb.embed_batch(["def f(): pass", "class A: ..."]))
        np.testing.assert_allclose(vecs, want, atol=2e-2)

    def test_opt_out_env(self, monkeypatch):
        from lattice_tpu_torch.providers import unixcoder_provider as up
        monkeypatch.setenv("LATTICE_EMBED_DP", "0")
        tiny = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), seed=1,
                                 device="cpu")
        monkeypatch.setattr(up, "_get_model", lambda *a, **kw: tiny)
        with default_mesh(mesh4()):
            emb = up.UniXcoderEmbedder(batch_size=4, device="cpu")
        assert emb.model.data_shards == 1 and emb.batch_size == 4


class TestShardedGraphBFS:
    def _random_graph(self, n=200, e=900, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.integers(1, n, size=e).astype(np.int32),
                rng.integers(1, n, size=e).astype(np.int32))

    def test_matches_oracle(self):
        n = 200
        src, dst = self._random_graph(n)
        seeds = np.zeros(n, dtype=bool)
        seeds[[1, 7]] = True
        got = ShardedGraph(src, dst, n, mesh=mesh4()).bfs_distances(seeds, 4)
        np.testing.assert_array_equal(got, bfs_oracle(src, dst, seeds, n, 4))
        np.testing.assert_array_equal(got, jax_graph.ShardedGraph(
            src, dst, n, mesh=jmesh4()).bfs_distances(seeds, 4))

    def test_reverse_matches_oracle(self):
        n = 120
        src, dst = self._random_graph(n, e=500, seed=3)
        seeds = np.zeros(n, dtype=bool)
        seeds[5] = True
        got = ShardedGraph(src, dst, n, mesh=mesh4()).bfs_distances(
            seeds, 3, reverse=True)
        np.testing.assert_array_equal(got, bfs_oracle(dst, src, seeds, n, 3))
        np.testing.assert_array_equal(got, jax_graph.ShardedGraph(
            src, dst, n, mesh=jmesh4()).bfs_distances(seeds, 3, reverse=True))

    def test_k_hop_contract(self):
        src = np.array([1, 2, 3], np.int32)
        dst = np.array([2, 3, 4], np.int32)
        g = ShardedGraph(src, dst, 5, mesh=mesh4())
        assert g.k_hop([1], 2) == {2: 1, 3: 2}
        assert g.k_hop([3], 2, reverse=True) == {2: 1, 1: 2}
        assert g.k_hop([], 2) == {}

    @pytest.mark.parametrize("hops", [1, 2, 3])
    def test_graph_store_routes_sharded(self, monkeypatch, hops):
        """LATTICE_SHARDED=1 with the store's mesh of four shards walks the
        sharded view, equal to the host walk forward and reverse, as the
        JAX store's equals its own."""
        store = GraphStore(device="cpu")
        rng = np.random.default_rng(hops)
        ids = [store.add_node(f"m.f{i}", EntityType.FUNCTION, "m.py", i, i)
               for i in range(60)]
        for a, b in rng.integers(0, 60, size=(150, 2)):
            store.add_edge(ids[a], ids[b], EdgeType.CALLS)
        store.finalize()
        seeds = [ids[0], ids[7]]
        want = [store.k_hop(seeds, EdgeType.CALLS, hops, reverse=r)
                for r in (False, True)]
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        with default_mesh(mesh4()):
            got = [store.k_hop(seeds, EdgeType.CALLS, hops, reverse=r)
                   for r in (False, True)]
            assert got == want
            assert store.to_sharded(EdgeType.CALLS).mesh == mesh4()
            assert store.k_hop_batch([seeds], EdgeType.CALLS, hops,
                                     limit=0) == [want[0]]


class TestMultiSliceIndex:
    def test_hierarchical_merge_matches_oracle(self):
        rng = np.random.default_rng(5)
        emb = _normed(rng, 500, 32)
        valid = np.ones(500, dtype=bool)
        valid[77] = False
        queries = _normed(rng, 4, 32)
        mesh = make_multislice_mesh(2, 4, device="cpu")
        index = ShardedIndex(emb, valid, mesh=mesh, dtype="float32")
        assert index.multislice
        got = index.search(queries, k=7)
        want = jax_index.ShardedIndex(
            emb, valid, mesh=jax_mesh.make_multislice_mesh(2, 8),
            dtype="float32").search(queries, k=7)
        _agree(got, want, TIE)
        flat = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        for a, b in zip(got, flat.search(queries, k=7)):
            np.testing.assert_array_equal(a, b)
        assert 77 not in got[1]

    def test_mask_and_incremental_updates(self):
        rng = np.random.default_rng(6)
        emb = _normed(rng, 128, 16)
        valid = np.ones(128, dtype=bool)
        index = ShardedIndex(emb, valid, dtype="float32",
                             mesh=make_multislice_mesh(4, 8, device="cpu"))
        mask = np.zeros(128, bool)
        mask[10:30] = True
        _, idx = index.search(emb[:2], k=3, mask=mask)
        assert ((idx >= 10) & (idx < 30)).all()
        fresh = _normed(rng, 1, 16)
        assert index.update_rows(fresh, np.array([99]))
        assert index.search(fresh, k=1)[1][0, 0] == 99


def _store(n=128, d=32, seed=9, cap=None):
    emb = _normed(np.random.default_rng(seed), n, d)
    pl = [{"file_path": f"f{i % 4}.py", "content_hash": "h",
           "name": f"fn{i}"} for i in range(n)]
    js = JaxStore(dim=d, dtype="float32", initial_capacity=cap or n)
    ps = ChunkStore(dim=d, dtype="float32", initial_capacity=cap or n,
                    device="cpu")
    assert js.add(emb, pl) == ps.add(emb, pl)
    return js, ps, emb


def _rows(hits):
    return [[r for r, _, _ in h] for h in hits]


def _same_hits(got, want, tie):
    """Hit lists held as `_agree` holds (scores, ids) lists."""
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _agree(([[s for _, s, _ in g]], [[r for r, _, _ in g]]),
               ([[s for _, s, _ in w]], [[r for r, _, _ in w]]), tie)


class TestShardedQuantizedUpgrades:
    def test_mask_and_multislice(self):
        rng = np.random.default_rng(7)
        emb = _normed(rng, 256, 32)
        valid = np.ones(256, bool)
        idx = ShardedQuantizedIndex(
            emb, valid, mesh=make_multislice_mesh(2, 4, device="cpu"))
        assert idx.multislice
        mask = np.zeros(256, bool)
        mask[40:80] = True
        got = idx.search(emb[:3], k=5, mask=mask)
        assert ((got[1] >= 40) & (got[1] < 80)).all()
        _agree(got, jax_index.ShardedQuantizedIndex(
            emb, valid, mesh=jax_mesh.make_multislice_mesh(2, 8)).search(
                emb[:3], k=5, mask=mask), TIE_Q)

    def test_incremental_updates(self):
        rng = np.random.default_rng(8)
        emb = _normed(rng, 64, 16)
        idx = ShardedQuantizedIndex(emb, np.ones(64, bool), mesh=mesh4())
        fresh = _normed(rng, 1, 16)
        assert idx.update_rows(fresh, np.array([17]))
        assert idx.search(fresh, k=1)[1][0, 0] == 17
        idx.invalidate_rows(np.array([17]))
        assert idx.search(fresh, k=1)[1][0, 0] != 17
        assert not idx.update_rows(fresh, np.array([64]))

    @pytest.mark.usefixtures("on_mesh4")
    def test_memory_pressure_dispatch(self, monkeypatch):
        js, ps, emb = _store(cap=1024)     # headroom: no growth
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        monkeypatch.setenv("LATTICE_SHARDED_INT8", "1")
        hits = ps.search(emb[:2], k=3)
        _same_hits(hits, js.search(emb[:2], k=3), TIE_Q)
        assert hits[0][0][0] == 0
        assert ps._shardedq is not None and ps._sharded is None
        view = ps._shardedq
        ps.add(emb[:2], [{"file_path": "b.py"}] * 2)
        assert ps._shardedq is view and not ps._shardedq_dirty
        monkeypatch.setenv("LATTICE_SHARDED_INT8", "0")
        assert ps.search(emb[:2], k=3)[0][0][0] == 0
        assert ps._sharded is not None
        monkeypatch.delenv("LATTICE_SHARDED_INT8")
        assert ps._sharded_quant_bits() == 16
        monkeypatch.setenv("LATTICE_SHARDED_BITS", "4")
        assert ps.search(emb[:2], k=3)[0][0][0] == 0
        assert ps._shardedq is not None and ps._shardedq.bits == 4

    @pytest.mark.usefixtures("on_mesh4")
    def test_store_sharded_quantized_rescores_exact(self, monkeypatch):
        js, ps, emb = _store(n=256, seed=14)
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        monkeypatch.setenv("LATTICE_SHARDED_BITS", "4")
        q = emb[:4] + 0.001
        hits = ps.search(q, k=5)
        _same_hits(hits, js.search(q, k=5), TIE_Q)
        for r, s, _ in hits[0]:
            assert abs(s - float(emb[r] @ (q[0] / np.linalg.norm(q[0])))) \
                < 1e-4

    @pytest.mark.usefixtures("on_mesh4")
    def test_sharded_quant_bits_tiers(self, monkeypatch):
        """The tier follows the most loaded device's memory: the JAX
        store's ladder at the same bytes, logical shards on one device
        adding up. (The JAX store divides by a TPU's HBM constant; the port
        reads each mesh device's memory.)"""
        from lattice_tpu.index import chunk_store as jcs
        js, ps, _ = _store()
        bf16 = ps.capacity * ps.dim * 2
        n_dev = len(jax.devices())
        for factor, bits in ((4, 16), (1.5, 8), (0.5, 4)):
            monkeypatch.setattr(mesh_ops, "device_memory_bytes",
                                lambda d, f=factor: bf16 * f)
            assert ps._sharded_quant_bits() == bits     # 4 shards, 1 device
            monkeypatch.setattr(jcs, "CHIP_HBM_GB",
                                bf16 / n_dev * factor / 1024 ** 3)
            assert js._sharded_quant_bits() == bits
        # four shards over two devices: each holds half the rows
        two = make_mesh(4, device=[torch.device("cpu"), torch.device("meta")])
        assert mesh_ops.shards_per_device(two) == {
            torch.device("cpu"): 2, torch.device("meta"): 2}
        monkeypatch.setattr(mesh_ops, "device_memory_bytes",
                            lambda d: bf16 * 0.75)
        assert ps._sharded_quant_bits(two) == 8
        assert ps._sharded_quant_bits() == 4

    def test_pallas_per_shard_path(self):
        """The JAX case forces the Pallas bf16 scan per shard; the port's
        per-shard scan on the CPU is kernel A's plain version (`fused_topk`),
        held to the JAX view's XLA scan."""
        rng = np.random.default_rng(12)
        emb = _normed(rng, 4096, 32)
        valid = np.ones(4096, bool)
        idx = ShardedIndex(emb, valid, mesh=mesh4(), dtype="float32")
        q = emb[:3] + 0.001
        got = idx.search(q, k=5)
        _agree(got, jax_index.ShardedIndex(
            emb, valid, mesh=jmesh4(), dtype="float32").search(q, k=5), TIE)
        _, o_idx = topk_ops.topk_oracle(q, emb, valid, 5)
        assert _overlap(got[1], o_idx, 5) == 1.0

    def test_pallas_per_shard_quantized(self):
        rng = np.random.default_rng(13)
        emb = _normed(rng, 4096, 32)
        idx = ShardedQuantizedIndex(emb, np.ones(4096, bool), mesh=mesh4(),
                                    bits=4)
        q = emb[:2] + 0.001
        got = idx.search(q, k=5)
        _agree(got, jax_index.ShardedQuantizedIndex(
            emb, np.ones(4096, bool), mesh=jmesh4(), bits=4).search(q, k=5),
            TIE_Q)
        _, o_idx = topk_ops.topk_oracle(q, emb, np.ones(4096, bool), 5)
        assert _overlap(got[1], o_idx, 5) >= 0.6

    def test_sharded_int4_view(self):
        rng = np.random.default_rng(11)
        emb = _normed(rng, 96, 32)
        idx = ShardedQuantizedIndex(emb, np.ones(96, bool), mesh=mesh4(),
                                    bits=4)
        assert idx.bits == 4 and idx.values.shape[1] == 16
        got = idx.search(emb[:4], k=5)
        _agree(got, jax_index.ShardedQuantizedIndex(
            emb, np.ones(96, bool), mesh=jmesh4(), bits=4).search(emb[:4], 5),
            TIE_Q)
        fresh = _normed(rng, 1, 32)
        assert idx.update_rows(fresh, np.array([33]))
        assert idx.search(fresh, k=1)[1][0, 0] == 33


def _rank_fixture(n=1000, d=32, q=3, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < 0.95
    degree = rng.integers(0, 80, n).astype(np.int32)
    quality = rng.random(n).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    packed = np.stack([
        ranking.pack_reach(rng.choice(n, 200, replace=False).astype(np.int64),
                           rng.integers(0, 6, 200), rng.integers(0, 4, 200),
                           512) for _ in range(q)])
    match = np.full((q, 64), -1, np.int32)
    for i in range(q):
        match[i, :10] = rng.choice(n, 10, replace=False)
    rel = np.stack([np.asarray([1.0, 0.9, 0.7, 0.0], np.float32)
                    * (1 - 0.1 * i) for i in range(q)])
    w = np.stack([ranking.pack_weights(ranking.FuseWeights())] * q)
    return emb, valid, degree, quality, queries, packed, match, rel, w


def _single_device(emb, valid, degree, quality, queries, packed, match, rel,
                   w, k):
    t = torch.from_numpy
    s, i = ranking.hybrid_rank_device_packed_batch(
        t(queries), t(emb), t(valid), t(packed), t(rel), t(match), t(degree),
        t(quality), t(w), k)
    return s.numpy(), i.numpy()


class TestShardedHybridRank:
    def test_matches_single_chip_kernel(self):
        fx = _rank_fixture()
        emb, valid, degree, quality, queries, packed, match, rel, w = fx
        sh = ShardedHybridRank(emb, valid, degree, quality, mesh=mesh4(),
                               dtype="float32")
        got = sh.rank(queries, packed, rel, match, w, k=10)
        assert got[0].shape == (3, 10) and got[1].shape == (3, 10)
        _agree(got, _single_device(*fx, k=10), TIE_RANK)
        _agree(got, jax_rank.ShardedHybridRank(
            emb, valid, degree, quality, mesh=jmesh4(),
            dtype="float32").rank(queries, packed, rel, match, w, k=10),
            TIE_RANK)

    def test_multislice_merge_matches(self):
        fx = _rank_fixture(seed=1)
        emb, valid, degree, quality, queries, packed, match, rel, w = fx
        sh = ShardedHybridRank(emb, valid, degree, quality, dtype="float32",
                               mesh=make_multislice_mesh(2, 4, device="cpu"))
        _agree(sh.rank(queries, packed, rel, match, w, k=8),
               _single_device(*fx, k=8), TIE_RANK)

    def test_shared_intent_tables_broadcast(self):
        fx = _rank_fixture(seed=2)
        emb, valid, degree, quality, queries, packed, match, rel, w = fx
        sh = ShardedHybridRank(emb, valid, degree, quality, mesh=mesh4(),
                               dtype="float32")
        s_flat, i_flat = sh.rank(queries, packed, rel[0], match, w[0], k=6)
        s_stack, i_stack = sh.rank(queries, packed,
                                   np.stack([rel[0]] * 3), match,
                                   np.stack([w[0]] * 3), k=6)
        np.testing.assert_array_equal(s_flat, s_stack)
        np.testing.assert_array_equal(i_flat, i_stack)

    @pytest.mark.parametrize("bits", [8, 4])
    def test_quantized_tiers_track_bf16_ordering(self, bits):
        """The quantized tiers against the JAX tiers (the same host
        quantization, the same integer products): equal but for ties; and
        the JAX test's overlap with the full-precision view."""
        fx = _rank_fixture(seed=3)
        emb, valid, degree, quality, queries, packed, match, rel, w = fx
        full = ShardedHybridRank(emb, valid, degree, quality, mesh=mesh4(),
                                 dtype="float32")
        want_i = full.rank(queries, packed, rel, match, w, k=10)[1]
        qv = ShardedHybridRank(emb, valid, degree, quality, mesh=mesh4(),
                               dtype="float32", bits=bits)
        got = qv.rank(queries, packed, rel, match, w, k=10)
        jqv = jax_rank.ShardedHybridRank(emb, valid, degree, quality,
                                         mesh=jmesh4(), dtype="float32",
                                         bits=bits)
        _agree(got, jqv.rank(queries, packed, rel, match, w, k=10), TIE_Q)
        assert _overlap(got[1], want_i, 10) >= (0.9 if bits == 8 else 0.7)
        if bits == 8:
            np.testing.assert_array_equal(got[1][:, 0], want_i[:, 0])

    def test_store_view_follows_memory_pressure_bits(self, monkeypatch):
        rng = np.random.default_rng(0)
        store = ChunkStore(dim=16, dtype="float32", initial_capacity=64,
                           device="cpu")
        vecs = rng.normal(size=(32, 16)).astype(np.float32)
        store.add(vecs, [{"file_path": f"f{i}.py", "content_hash": "h",
                          "content": "x" * 100} for i in range(32)])
        graph = GraphStore(device="cpu")
        monkeypatch.setenv("LATTICE_SHARDED_BITS", "8")
        v8 = store.sharded_hybrid(graph, mesh=mesh4())
        assert v8.bits == 8 and v8.scales is not None
        assert store.sharded_hybrid(graph, mesh=mesh4()) is v8
        monkeypatch.setenv("LATTICE_SHARDED_BITS", "16")
        v16 = store.sharded_hybrid(graph, mesh=mesh4())
        assert v16.bits == 16 and v16 is not v8
        store.add(vecs[:1], [{"file_path": "g.py"}])
        assert store._sharded_rank is None
        assert store.sharded_hybrid(graph, mesh=mesh4()) is not v16

    def test_pad_slots_never_leak_ids(self):
        rng = np.random.default_rng(7)
        n, d = 10, 16                     # 4 shards -> 2 pad rows
        emb = rng.normal(size=(n, d)).astype(np.float32)
        view = ShardedHybridRank(emb, np.ones(n, bool), np.zeros(n, np.int32),
                                 np.ones(n, np.float32), mesh=mesh4(),
                                 dtype="float32")
        assert view.capacity == 12
        packed = np.full((1, 512), -1, np.int32)
        match = np.full((1, 64), -1, np.int32)
        rel = np.asarray([1.0, 0.9, 0.7, 0.0], np.float32)
        s, i = view.rank(rng.normal(size=(1, d)), packed, rel, match,
                         ranking.pack_weights(ranking.FuseWeights()), k=12)
        assert i.max() < n, i
        finite = s[0] > -1e29
        assert finite.sum() == n
        assert set(i[0][finite].tolist()) == set(range(n))


@pytest.mark.usefixtures("on_mesh4")
class TestStoreShardedViews:
    """The sharded cases of `tests/test_chunk_store.py` (TestShardedView,
    TestShardedDispatch): the JAX store on its 8 devices, the port's on
    four logical shards."""

    def test_to_sharded_matches_flat(self):
        js, ps, _ = _store(n=50, seed=31, cap=64)
        q = _normed(np.random.default_rng(32), 2, 32)
        got = ps.to_sharded().search(q, k=6)
        assert [sorted(r) for r in got[1].tolist()] == [
            sorted(r) for r in _rows(ps.search(q, k=6, method="flat"))]
        _agree(got, js.to_sharded(mesh=jmesh4()).search(q, k=6), TIE)

    def test_sharded_matches_flat(self):
        js, ps, _ = _store(n=50, seed=41, cap=64)
        q = _normed(np.random.default_rng(42), 3, 32)
        got = ps.search(q, k=6, method="sharded")
        assert ps._sharded is not None
        _same_hits(got, js.search(q, k=6, method="sharded"), TIE)
        _same_hits(got, ps.search(q, k=6, method="flat"), 1e-5)
        s, i = ps.search_device(torch.from_numpy(q), 6, method="sharded")
        js_s, js_i = js.search_device(jnp.asarray(q), 6, method="sharded")
        _agree((s, i), (np.asarray(js_s), np.asarray(js_i)), TIE)

    def test_mutation_invalidates_sharded_view(self):
        js, ps, _ = _store(n=50, seed=41, cap=64)
        ps.search(_normed(np.random.default_rng(43), 1, 32), k=4,
                  method="sharded")
        view = ps._sharded
        new = _normed(np.random.default_rng(44), 1, 32)
        rows = ps.add(new, [{"file_path": "new.py", "content_hash": "h2",
                             "name": "brand_new"}])
        assert ps._sharded is view and not ps._sharded_dirty
        assert ps.search(new, k=1, method="sharded")[0][0][0] == rows[0]
        # past the view's capacity the view is rebuilt
        more = ps.add(_normed(np.random.default_rng(45), 20, 32),
                      [{"file_path": "more.py"}] * 20)
        assert max(more) >= view.capacity and ps._sharded_dirty
        assert ps.search(new, k=1, method="sharded")[0][0][0] == rows[0]
        assert ps._sharded is not view

    @pytest.mark.parametrize("bits", ["16", "8", "4"])
    def test_filters_ride_sharded_path(self, monkeypatch, bits):
        monkeypatch.setenv("LATTICE_SHARDED_BITS", bits)
        js, ps, _ = _store(n=50, seed=41, cap=64)
        q = _normed(np.random.default_rng(45), 1, 32)
        f = {"file_path": "f1.py"}
        hits = ps.search(q, k=10, filters=f, method="sharded")
        assert (ps._sharded if bits == "16" else ps._shardedq) is not None
        assert hits[0] and all(p["file_path"] == "f1.py"
                               for _, _, p in hits[0])
        assert _rows(hits) == _rows(ps.search(q, k=10, filters=f,
                                              method="flat"))
        _same_hits(hits, js.search(q, k=10, filters=f, method="sharded"),
                   TIE_Q)

    def test_to_sharded_quantized(self):
        js, ps, _ = _store(n=50, seed=41, cap=64)
        view = ps.to_sharded_quantized()
        q = _normed(np.random.default_rng(47), 2, 32)
        got = view.search(q, k=5)
        flat = ps.search(q, k=5, method="flat")
        assert _overlap(got[1], np.asarray(_rows(flat)), 5) >= 0.8
        assert view.memory_bytes() < 0.6 * (view.capacity * 32 * 2)
        _agree(got, js.to_sharded_quantized(mesh=jmesh4()).search(q, k=5),
               TIE_Q)

    def test_env_knob(self, monkeypatch):
        js, ps, _ = _store(n=50, seed=41, cap=64)
        q = _normed(np.random.default_rng(46), 1, 32)
        monkeypatch.setenv("LATTICE_SHARDED", "1")
        assert ps._plan_search(1, 5, None, "auto") == "sharded"
        _same_hits(ps.search(q, k=5), js.search(q, k=5), TIE)
        assert ps._sharded is not None
        _build.reset_launch_counts()
        ps.search_device(torch.from_numpy(q), 5)
        assert set(_build.launch_counts().values()) == {0}
