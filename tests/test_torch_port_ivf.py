"""Port IVF (`lattice_tpu_torch/ops/ivf.py`, the store's IVF plan) against
the JAX package, on the CPU.

The same seeded numpy inputs go through `lattice_tpu.ops.ivf` and its
port. The JAX probe kernel runs in Pallas interpret mode, as
`tests/test_pallas_ivf.py` runs it; the port's CPU tensors take the plain
version of `ivf_probe`. Tolerances: k-means centroids within 1e-5 (f32
sums in another order); search scores within 1e-5, ids identical on f32
buckets, and on bf16 buckets identical except swaps of two scores closer
than 1e-5. A partition is carried from JAX to the port with
`IVFIndex.restore`, so that both packages search one layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.ops import ivf as jax_ivf
from lattice_tpu_torch.index import chunk_store as port_cs
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import _build, ivf
from lattice_tpu_torch.ops import topk as topk_ops

TOL = 1e-5


def clustered_data(n, d, n_clusters, seed=0, spread=0.25):
    """`tests/test_pallas_ivf.py`'s generator: unit centers + noise,
    normalized f32."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    data = centers[assign] + spread * rng.normal(size=(n, d))
    return topk_ops.l2_normalize(data), assign


def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), dtype=dtype)


def _np(x):
    """f32 numpy view of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x).astype(np.float32) \
        if np.issubdtype(np.asarray(x).dtype, np.floating) or \
        np.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


def assert_same_topk(s, i, js, ji, exact_ids):
    """Port (s, i) against JAX (js, ji): scores within TOL; ids identical,
    or (bf16) differing only where the two scores at that rank are a
    near-tie of the reference's own list."""
    s, i, js, ji = map(np.asarray, (s, i, js, ji))
    assert s.shape == js.shape and i.shape == ji.shape
    np.testing.assert_allclose(s, js, atol=TOL, rtol=0)
    if exact_ids:
        np.testing.assert_array_equal(i, ji)
        return
    for qi in range(len(i)):
        for r in np.flatnonzero(i[qi] != ji[qi]):
            near = np.abs(js[qi] - js[qi, r]) < TOL
            assert i[qi, r] in ji[qi][near], (qi, r)


# ---- k-means -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kmeans_fit_matches_jax(dtype):
    data, true_assign = clustered_data(600, 32, 4, spread=0.05)
    valid = np.ones(600, bool)
    valid[[3, 50, 401]] = False
    init = np.arange(4, dtype=np.int32) * 150
    jc, ja = jax_ivf.kmeans_fit(_j(data, dtype), jnp.asarray(valid),
                                jnp.asarray(init), 4, iters=15)
    pc, pa = ivf.kmeans_fit(_t(data, dtype), torch.from_numpy(valid), init, 4,
                            iters=15)
    assert pa.dtype == torch.int32 and pc.dtype == torch.float32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(pc.numpy(), axis=1), 1.0,
                               atol=TOL)
    # the clusters are recovered (labels permuted)
    purity = sum(np.bincount(true_assign[pa.numpy() == c]).max()
                 for c in range(4) if (pa.numpy() == c).any())
    assert purity / len(data) > 0.95


def test_kmeans_empty_cluster_reseeds_like_jax():
    """A first centroid inside a cluster whose rows are all invalid leaves
    that centroid with no live weight: the first empty cluster reseeds to
    the worst-served live row, in both packages."""
    data, assign = clustered_data(500, 24, 5, spread=0.05, seed=4)
    valid = assign != 4
    init = np.array([int(np.flatnonzero(assign == 4)[0]), 0, 1, 2, 3],
                    np.int32)
    jc, ja = jax_ivf.kmeans_fit(_j(data), jnp.asarray(valid),
                                jnp.asarray(init), 5, iters=6)
    pc, pa = ivf.kmeans_fit(_t(data), torch.from_numpy(valid), init, 5,
                            iters=6)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=TOL)
    # the reseed moved the dead cluster's centroid onto live data
    first = ivf.farthest_first_init(_t(data), torch.from_numpy(valid),
                                    int(init[0]), 5)
    assert not torch.allclose(first[0], pc[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_farthest_first_init_matches_jax(dtype):
    data, _ = clustered_data(400, 32, 6, spread=0.05, seed=2)
    valid = np.ones(400, bool)
    valid[::37] = False
    jc = jax_ivf.farthest_first_init(_j(data, dtype), jnp.asarray(valid),
                                     jnp.int32(5), 6)
    pc = ivf.farthest_first_init(_t(data, dtype), torch.from_numpy(valid), 5, 6)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_topc_matches_jax(dtype):
    data, _ = clustered_data(300, 32, 6, spread=0.05, seed=3)
    cent = topk_ops.l2_normalize(_vecs(6, 32, seed=9))
    js, ji = jax_ivf.assign_topc(_j(data, dtype), jnp.asarray(cent), 6)
    ps, pi = ivf.assign_topc(_t(data, dtype), torch.from_numpy(cent), 6)
    assert pi.dtype == torch.int32 and ps.shape == (300, 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=TOL)


# ---- the capped layout ---------------------------------------------------------


def _skewed(n=4000, d=32, seed=0):
    """One dominant mode (60% of rows) + small satellites
    (`test_pallas_ivf.py` TestCappedLayout)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    probs = np.array([0.6] + [0.4 / 7] * 7)
    assign = rng.choice(8, size=n, p=probs)
    return topk_ops.l2_normalize(
        centers[assign] + 0.2 * rng.normal(size=(n, d)))


@pytest.mark.parametrize("max_load", [None, 2.0])
def test_capped_layout_is_the_jax_layout(max_load):
    data = _skewed()
    valid = np.ones(len(data), bool)
    valid[::97] = False
    c = 32
    init = np.random.default_rng(0).choice(np.flatnonzero(valid), c,
                                           replace=False).astype(np.int32)
    cent, _ = jax_ivf.kmeans_fit(_j(data), jnp.asarray(valid),
                                 jnp.asarray(init), c, iters=5)
    sims, ids = jax_ivf.assign_topc(_j(data), cent, c)
    sims, ids = np.asarray(sims), np.asarray(ids)
    want = jax_ivf._capped_layout(sims, ids, valid, c, max_load)
    got = ivf._capped_layout(sims.copy(), ids.copy(), valid.copy(), c,
                             max_load)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    live = got[got >= 0]
    assert sorted(live.tolist()) == np.flatnonzero(valid).tolist()
    if max_load is not None:   # the cap bounds the skew
        assert got.shape[1] < jax_ivf._capped_layout(
            sims, ids, valid, c, None).shape[1]


# ---- search through a partition carried across -------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def carried(request):
    """A JAX-built partition over 3000 x 64 rows (16 clusters, two invalid
    rows, four removed), restored into the port over the same rows."""
    dtype = request.param
    data, _ = clustered_data(3000, 64, 24, spread=0.3)
    valid = np.ones(3000, bool)
    valid[[7, 2000]] = False
    j = jax_ivf.IVFIndex.build(data, valid, n_clusters=16, dtype=dtype)
    rows = topk_ops.l2_normalize(data)      # the rows the build bucketed
    p = ivf.IVFIndex.restore(np.asarray(j.centroids), np.asarray(j.bucket_ids),
                             _t(rows), None, None, dtype=dtype)
    for idx in (j, p):
        idx.remove([11, 12, 500, 2999])
    valid[[11, 12, 500, 2999]] = False
    return dtype, j, p, rows, valid


def test_restore_carries_the_partition(carried):
    dtype, j, p, _, _ = carried
    assert p.bucket_data.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(p.bucket_ids.numpy(), np.asarray(j.bucket_ids))
    np.testing.assert_array_equal(_np(p.bucket_data), _np(j.bucket_data))
    np.testing.assert_array_equal(p.centroids.numpy(), np.asarray(j.centroids))
    assert (p.n_clusters, p.bucket_size) == (j.n_clusters, j.bucket_size)


@pytest.mark.parametrize("nprobe", [1, 6, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_search_matches_jax_batch_and_fused(carried, nprobe, masked):
    dtype, j, p, _, _ = carried
    q = topk_ops.l2_normalize(_vecs(6, 64, seed=5 + nprobe))
    mask = np.random.default_rng(nprobe).random(3000) < 0.5 if masked \
        else None
    s, i = p.search(q, k=10, nprobe=nprobe, mask=mask)
    assert s.dtype == np.float32 and i.dtype == np.int32
    exact = dtype == "float32"
    js, ji = j.search(q, k=10, nprobe=nprobe,
                      mask=None if mask is None else jnp.asarray(mask))
    assert_same_topk(s, i, js, ji, exact)
    ids = j.bucket_ids if mask is None else jax_ivf._mask_bucket_ids(
        j.bucket_ids, jnp.asarray(mask))
    fs, fi = jax_ivf.ivf_search_fused(jnp.asarray(q), j.centroids,
                                      j.bucket_data, ids, nprobe=nprobe, k=10,
                                      interpret=True)
    assert_same_topk(s, i, fs, fi, exact)
    assert (i >= 0).all()
    if mask is not None:
        assert mask[i].all()


def test_padding_when_probed_buckets_hold_fewer_than_k(carried):
    """A filter leaves ~3% of the rows: the one probed bucket holds fewer
    live rows than k, and the tail is (NEG_INF, -1) in both packages."""
    dtype, j, p, _, _ = carried
    q = topk_ops.l2_normalize(_vecs(3, 64, seed=31))
    mask = np.random.default_rng(4).random(3000) < 0.03
    s, i = p.search(q, k=50, nprobe=1, mask=mask)
    js, ji = j.search(q, k=50, nprobe=1, mask=jnp.asarray(mask))
    assert_same_topk(s, i, js, ji, dtype == "float32")
    pad = s <= topk_ops.NEG_INF / 2
    assert pad.any() and (i[pad] == -1).all() and (i[~pad] >= 0).all()
    assert (s[pad] == topk_ops.NEG_INF).all()


@pytest.mark.parametrize("max_batch", [1, 3, 32])
def test_batching_invariant(carried, max_batch):
    _, j, p, _, _ = carried
    q = topk_ops.l2_normalize(_vecs(11, 64, seed=9))
    s_ref, i_ref = p.search(q, k=10, nprobe=8)
    s, i = p.search(q, k=10, nprobe=8, max_batch=max_batch)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, atol=TOL)
    js, ji = j.search(q, k=10, nprobe=8, max_batch=max_batch)
    np.testing.assert_array_equal(ji, np.asarray(j.search(q, 10, 8)[1]))
    assert_same_topk(s, i, js, ji, False)


def test_full_probe_is_the_exact_scan(carried):
    dtype, _, p, rows, valid = carried
    q = topk_ops.l2_normalize(_vecs(4, 64, seed=12))
    s, i = p.search(q, k=10, nprobe=16)
    # the exact scan at storage precision: query and rows in the bucket
    # dtype, f64 products
    cast = lambda x: _t(x, dtype).float().numpy()  # noqa: E731
    o_s, o_i = topk_ops.topk_oracle(cast(q), cast(rows), valid, 10)
    np.testing.assert_array_equal(i, o_i)
    np.testing.assert_allclose(s, o_s, atol=1e-5)


def test_search_device_and_fused_wrapper(carried):
    _, _, p, _, _ = carried
    q = topk_ops.l2_normalize(_vecs(5, 64, seed=13))
    s, i = p.search_device(torch.from_numpy(q), 7, nprobe=6)
    hs, hi = p.search(q, 7, nprobe=6)
    np.testing.assert_array_equal(i.numpy(), hi)
    np.testing.assert_allclose(s.numpy(), hs, atol=TOL)
    # on CPU tensors the fused wrapper is its plain version
    fs, fi = ivf.ivf_search_fused(torch.from_numpy(q), p.centroids,
                                  p.bucket_data, p.bucket_ids, 6, 7)
    bs, bi = ivf.ivf_search_batch(torch.from_numpy(q), p.centroids,
                                  p.bucket_data, p.bucket_ids, 7, 6)
    assert torch.equal(fi, bi) and torch.equal(fs, bs)
    # k past the probed slots: k_eff = nprobe * S, as in the JAX package
    s_all, _ = p.search(q[:1], k=10 ** 6, nprobe=1)
    assert s_all.shape == (1, p.bucket_size)


def test_probe_table_ties_go_to_the_lower_bucket():
    cent = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    probe = ivf.probe_table(torch.tensor([[1.0, 0.0], [0.0, 1.0]]), cent, 3)
    assert probe.tolist() == [[0, 2, 1], [1, 3, 0]]


def test_measure_recall_matches_jax(carried):
    dtype, j, p, rows, valid = carried
    want = j.measure_recall(_j(rows, dtype), jnp.asarray(valid), nprobe=4)
    got = p.measure_recall(_t(rows, dtype), torch.from_numpy(valid), nprobe=4)
    assert got == want and p.measured_nprobe == 4
    assert 0.5 < got < 1.0


# ---- insert / remove ----------------------------------------------------------


def _assert_same_index(p, j):
    np.testing.assert_array_equal(p.bucket_ids.numpy(), np.asarray(j.bucket_ids))
    np.testing.assert_array_equal(_np(p.bucket_data), _np(j.bucket_data))
    np.testing.assert_array_equal(p._row_bucket, j._row_bucket)
    np.testing.assert_array_equal(p._row_pos, j._row_pos)
    np.testing.assert_array_equal(p._fill, j._fill)
    assert p._holes == j._holes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insert_remove_sequence_matches_jax(dtype):
    data, _ = clustered_data(800, 32, 8, spread=0.1, seed=6)
    valid = np.ones(800, bool)
    j = jax_ivf.IVFIndex.build(data, valid, n_clusters=8, dtype=dtype)
    rows = topk_ops.l2_normalize(data)
    p = ivf.IVFIndex.restore(np.asarray(j.centroids), np.asarray(j.bucket_ids),
                             _t(rows), None, None, dtype=dtype)
    new, _ = clustered_data(12, 32, 8, spread=0.1, seed=6 + 1)
    steps = [("remove", [3, 4, 5, 100, 799, 5000]),
             ("insert", (new[:4], [3, 4, 800, 801])),
             ("remove", [800, 20]),
             ("insert", (new[4:], [20, 5, 100, 802, 803, 804, 805, 900]))]
    for op, arg in steps:
        if op == "remove":
            j.remove(arg)
            p.remove(arg)
        else:
            vecs, ids = arg
            j.insert(jnp.asarray(vecs), ids)
            p.insert(torch.from_numpy(vecs), ids)
        _assert_same_index(p, j)
    q = topk_ops.l2_normalize(new[:5])
    s, i = p.search(q, 3, nprobe=8)
    assert_same_topk(s, i, *j.search(q, 3, nprobe=8), False)
    assert 799 not in i and i[0, 0] == 3     # row 3 now holds new[0]


def test_insert_widens_every_bucket_by_8_when_all_are_full():
    data, _ = clustered_data(64, 16, 4, spread=0.1, seed=8)
    valid = np.ones(64, bool)
    j = jax_ivf.IVFIndex.build(data, valid, n_clusters=4, dtype="float32")
    p = ivf.IVFIndex.restore(np.asarray(j.centroids), np.asarray(j.bucket_ids),
                             _t(topk_ops.l2_normalize(data)), None, None,
                             dtype="float32")
    free = p.n_clusters * p.bucket_size - int(p._fill.sum())
    new, _ = clustered_data(free + 3, 16, 4, spread=0.1, seed=9)
    ids = list(range(64, 64 + free + 3))
    j.insert(jnp.asarray(new), ids)
    p.insert(torch.from_numpy(new), ids)
    assert p.bucket_size == j.bucket_size
    assert p.bucket_size % 8 == 0 and p.bucket_size * p.n_clusters >= 64 + free
    _assert_same_index(p, j)
    s, i = p.search(new[-1:], 1, nprobe=4)
    assert i[0, 0] == ids[-1]


def test_release_buckets_and_hollow_restore():
    data, _ = clustered_data(200, 16, 4, spread=0.1)
    valid = np.ones(200, bool)
    j = jax_ivf.IVFIndex.build(data, valid, n_clusters=4, dtype="float32")
    p = ivf.IVFIndex.restore(np.asarray(j.centroids), np.asarray(j.bucket_ids),
                             _t(topk_ops.l2_normalize(data)), 0.4, 8,
                             dtype="float32")
    assert p.memory_bytes() > p.centroids.numel() * 4
    for idx in (j, p):
        idx.release_buckets()
        assert idx.hollow and idx.bucket_data is None
    assert p.memory_bytes() == j.memory_bytes() == 4 * 16 * 4
    assert (p.measured_recall, p.measured_nprobe) == (0.4, 8)
    for call in (lambda: p.insert(torch.zeros(1, 16), [3]),
                 lambda: p.remove([3])):
        with pytest.raises(RuntimeError, match="hollow"):
            call()
    h = ivf.IVFIndex.restore(np.asarray(j.centroids), np.zeros((0, 0), np.int32),
                             _t(data), 0.2, 8, hollow=True)
    jh = jax_ivf.IVFIndex.restore(np.asarray(j.centroids),
                                  np.zeros((0, 0), np.int32), jnp.asarray(data),
                                  0.2, 8, hollow=True)
    assert h.hollow and jh.hollow and h.measured_recall == jh.measured_recall
    assert h.memory_bytes() == jh.memory_bytes()


# ---- builds ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_from_device_matches_jax(dtype):
    data, _ = clustered_data(800, 32, 8, spread=0.1)
    valid = np.ones(800, bool)
    valid[5] = False
    jb = jax_ivf.IVFIndex.build_from_device(_j(data, dtype), valid,
                                            n_clusters=8, dtype=dtype, iters=8)
    pb = ivf.IVFIndex.build_from_device(_t(data, dtype), valid, n_clusters=8,
                                        dtype=dtype, iters=8)
    np.testing.assert_array_equal(pb.bucket_ids.numpy(),
                                  np.asarray(jb.bucket_ids))
    np.testing.assert_array_equal(_np(pb.bucket_data), _np(jb.bucket_data))
    np.testing.assert_allclose(pb.centroids.numpy(), np.asarray(jb.centroids),
                               atol=TOL)
    assert pb.build_seconds > 0 and pb.bucket_data.dtype == getattr(torch, dtype)
    # the host-array entry is the device build over host-normalized rows
    hb = ivf.IVFIndex.build(data, valid, n_clusters=8, dtype=dtype, iters=8)
    np.testing.assert_array_equal(hb.bucket_ids.numpy(), pb.bucket_ids.numpy())
    q = topk_ops.l2_normalize(_vecs(4, 32, seed=3))
    o_s, o_i = topk_ops.topk_oracle(_np(_t(q, dtype)), _np(_t(data, dtype)),
                                    valid, 10)
    s, i = pb.search(q, k=10, nprobe=8)
    np.testing.assert_array_equal(i, o_i)
    np.testing.assert_allclose(s, o_s, atol=1e-5)


def test_build_caps_skew_and_keeps_recall():
    data = _skewed()
    valid = np.ones(len(data), bool)
    uncapped = ivf.IVFIndex.build(data, valid, n_clusters=32, max_load=None)
    capped = ivf.IVFIndex.build(data, valid, n_clusters=32, max_load=2.0)
    w0 = uncapped.n_clusters * uncapped.bucket_size / valid.sum()
    w1 = capped.n_clusters * capped.bucket_size / valid.sum()
    assert w0 > 2.0 and w1 <= 2.4 and w1 < w0
    ids = capped.bucket_ids.numpy()
    assert set(ids[ids >= 0].tolist()) == set(range(len(data)))
    r = capped.measure_recall(_t(topk_ops.l2_normalize(data), "bfloat16"),
                              torch.from_numpy(valid), nprobe=8)
    assert r >= 0.9, r


# ---- the store ----------------------------------------------------------------


def _clustered_store(n, d, n_clusters=8, seed=0, spread=0.15,
                     cls=ChunkStore, payload=lambda i: {"file_path": f"f{i % 4}.py",
                                                        "entity_type": "function"}):
    x, _ = clustered_data(n, d, n_clusters, seed=seed, spread=spread)
    s = cls(dim=d, dtype="float32", initial_capacity=n)
    s.add(x, [payload(i) for i in range(n)])
    return s, x


def _hits(res):
    return [[(r, p) for r, _, p in q] for q in res]


def _assert_same_hits(a, b):
    assert _hits(a) == _hits(b)
    for qa, qb in zip(a, b):
        np.testing.assert_allclose([s for _, s, _ in qa],
                                   [s for _, s, _ in qb], atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_search_ivf_matches_jax_store(dtype):
    """One partition in both packages: the JAX store builds it, the port
    store takes the JAX store's state (`from_numpy_state`) and the
    partition (`adopt_ivf(restore(...))`). Every query gives the same
    rows in the same order, with and without a filter, through
    `search_ivf`, `search(method="ivf")` and `search_device`."""
    n, d = 1500, 32
    x, _ = clustered_data(n, d, 12, spread=0.2, seed=5)
    payloads = [{"file_path": f"f{i % 5}.py", "language": ("py", "go")[i % 2]}
                for i in range(n)]
    js = JaxStore(dim=d, dtype=dtype, initial_capacity=n)
    js.add(x, payloads)
    js.remove([2, 3, 700])
    jivf = js.build_ivf(n_clusters=12)
    ps = ChunkStore.from_numpy_state(np.asarray(js._emb).astype(np.float32),
                                     js._valid_host, js._payloads,
                                     dtype=dtype, device="cpu")
    ps.adopt_ivf(ivf.IVFIndex.restore(
        np.asarray(jivf.centroids), np.asarray(jivf.bucket_ids),
        ps.device_arrays[0], jivf.measured_recall, jivf.measured_nprobe,
        dtype=dtype))
    q = np.concatenate([x[[0, 9, 333, 1400]], _vecs(4, d, seed=2)])
    for flt in (None, {"language": "go"}, {"file_path": ["f1.py", "f3.py"]}):
        for nprobe in (2, 8):
            got = ps.search_ivf(q, k=8, nprobe=nprobe, filters=flt)
            want = js.search_ivf(q, k=8, nprobe=nprobe, filters=flt)
            if dtype == "float32":
                _assert_same_hits(got, want)
            else:
                for g, w in zip(got, want):
                    gs = np.array([s for _, s, _ in g])
                    ws = np.array([s for _, s, _ in w])
                    np.testing.assert_allclose(gs, ws, atol=TOL)
                    for (gr, _, _), (wr, wsc, _) in zip(g, w):
                        assert gr == wr or np.isclose(
                            ws, wsc, atol=TOL).sum() > 1
        _assert_same_hits(ps.search(q, k=8, filters=flt, method="ivf"),
                          ps.search_ivf(q, k=8, nprobe=port_cs.IVF_AUTO_NPROBE,
                                        filters=flt))
        s, i = ps.search_device(torch.from_numpy(q), 8, filters=flt,
                                method="ivf")
        assert [[r for r, _, _ in h] for h in ps.search(q, 8, filters=flt,
                                                        method="ivf")] == \
            [[r for r in row if r >= 0] for row in i.tolist()]
    assert not ps._ivf_dirty and ps._ivf.measured_recall == jivf.measured_recall


def test_store_ivf_matches_flat_at_full_probe():
    s = ChunkStore(dim=32, dtype="float32", initial_capacity=64)
    vecs = _vecs(40, 32, seed=11)
    s.add(vecs, [{"file_path": f"f{i}.py", "content_hash": "h"}
                 for i in range(40)])
    built = s.build_ivf(n_clusters=6)
    assert built is s._ivf and built.measured_recall is not None
    q = _vecs(2, 32, seed=12)
    flat = s.search(q, k=5)
    ann = s.search_ivf(q, k=5, nprobe=6)
    assert _hits(ann) == _hits(flat)


def test_store_ivf_fresh_on_small_mutation():
    s = ChunkStore(dim=16, dtype="float32", initial_capacity=32)
    s.add(_vecs(20, 16, seed=13),
          [{"file_path": "a.py", "content_hash": "h"}] * 20)
    s.search_ivf(_vecs(1, 16), k=3)
    assert not s._ivf_dirty
    new = _vecs(1, 16, seed=14)
    row = s.add(new, [{"file_path": "b.py", "content_hash": "h"}])[0]
    assert not s._ivf_dirty
    hits = s.search_ivf(new, k=1, nprobe=s._ivf.n_clusters)
    assert hits[0][0][0] == row


def test_store_hollow_ivf_survives_mutations():
    s = ChunkStore(dim=16, dtype="float32", initial_capacity=64)
    s.add(_vecs(30, 16, seed=27),
          [{"file_path": "a.py", "content_hash": "h"}] * 30)
    s.build_ivf(n_clusters=4)
    s._ivf.release_buckets()
    s._ivf_dirty = False
    s._ivf_mutations = 0
    s.add(_vecs(2, 16, seed=28),
          [{"file_path": "b.py", "content_hash": "h"}] * 2)
    s.remove([0])
    assert not s._ivf_dirty            # small delta: the verdict stands
    s.add(_vecs(20, 16, seed=29),
          [{"file_path": "c.py", "content_hash": "h"}] * 20)
    assert s._ivf_dirty                # > 20% churn: re-measure
    # a forced IVF search rebuilds a hollow or stale partition
    assert s.search_ivf(_vecs(1, 16), k=2)[0]
    assert not s._ivf.hollow and not s._ivf_dirty


class TestIncremental:
    """`tests/test_chunk_store.py` TestIncrementalIVF: O(delta) upkeep of
    the partition, no rebuild per mutation."""

    def _store(self, n=128, d=16):
        s, _ = _clustered_store(n, d, n_clusters=8, seed=1)
        s.build_ivf(n_clusters=4)
        return s

    def test_empty_add_is_a_noop(self):
        s = self._store()
        before = s._size
        assert s.add(np.zeros((0, 16), dtype=np.float32), []) == []
        assert s._size == before and not s._ivf_dirty

    def test_add_is_findable_without_rebuild(self):
        s = self._store()
        ivf_obj = s._ivf
        new, _ = clustered_data(3, 16, 8, seed=9, spread=0.15)
        rows = s.add(new, [{"file_path": "new.py"}] * 3)
        assert not s._ivf_dirty and s._ivf is ivf_obj
        got = s.search_ivf(new, k=1, nprobe=4)
        assert [h[0][0] for h in got] == rows

    def test_remove_disappears_without_rebuild(self):
        s = self._store()
        vec = s.get_vector(7)
        s.remove([7])
        assert not s._ivf_dirty
        got = s.search_ivf(vec[None, :], k=5, nprobe=4)
        assert all(r != 7 for r, _, _ in got[0])
        # the freed row is reused by the next add and found again
        row = s.add(vec[None, :], [{"file_path": "back.py"}])[0]
        assert row == 7 and not s._ivf_dirty
        assert s.search_ivf(vec[None, :], k=1, nprobe=4)[0][0][0] == 7

    def test_churn_past_20_percent_marks_dirty(self):
        s = self._store()
        s.remove(list(range(20)))
        assert not s._ivf_dirty
        s.remove(list(range(20, 30)))
        assert s._ivf_dirty

    def test_failed_update_marks_dirty_and_rebuilds(self, monkeypatch):
        s = self._store()

        def boom(*a, **k):
            raise ValueError("bookkeeping")
        monkeypatch.setattr(s._ivf, "insert", boom)
        s.add(_vecs(1, 16, seed=4), [{"file_path": "x.py"}])
        assert s._ivf_dirty
        s.search_ivf(_vecs(1, 16), k=2)
        assert not s._ivf_dirty

    def test_compact_and_clear_drop_the_partition(self):
        s = self._store()
        s.remove(list(range(0, 128, 2)))
        s.compact()
        assert s._ivf is None and s._ivf_dirty
        s.build_ivf(n_clusters=4)
        s.clear()
        assert s._ivf is None and s._ivf_mutations == 0


class TestFilters:
    """`tests/test_chunk_store.py` TestIVFFilters."""

    def test_filtered_matches_flat(self):
        s, _ = _clustered_store(256, 32, seed=3,
                                payload=lambda i: {"file_path": f"f{i % 2}.py"})
        s.build_ivf(n_clusters=8)
        q = _vecs(3, 32, seed=7)
        flt = {"file_path": "f1.py"}
        got = s.search_ivf(q, k=5, nprobe=8, filters=flt)  # all buckets
        want = s.search(q, k=5, filters=flt, method="flat")
        for qi in range(3):
            assert [r for r, _, _ in got[qi]] == [r for r, _, _ in want[qi]]
            assert all(p["file_path"] == "f1.py" for _, _, p in got[qi])

    def test_filter_excludes_everything(self):
        s, _ = _clustered_store(64, 16, payload=lambda i: {"file_path": "a.py"})
        s.build_ivf(n_clusters=4)
        got = s.search_ivf(_vecs(1, 16), k=5, nprobe=4,
                           filters={"file_path": "missing.py"})
        assert got[0] == []
        s_, i_ = s.search_device(torch.from_numpy(_vecs(1, 16)), 5,
                                 filters={"file_path": "missing.py"},
                                 method="ivf")
        assert (i_ == -1).all() and (s_ == topk_ops.NEG_INF).all()


class TestPlanTable:
    """`tests/test_chunk_store.py` TestDispatchDecisionTable, IVF rows, on
    a store that reports a CUDA device (its tensors stay on the CPU, so
    the IVF build and search run their plain versions)."""

    @pytest.fixture
    def cuda(self, monkeypatch):
        monkeypatch.setattr(ChunkStore, "_device_is_cuda", lambda self: True)
        monkeypatch.setattr(ChunkStore, "_device_memory_bytes",
                            lambda self: 80 * 1024 ** 3)
        for flag in ("LATTICE_INT8", "LATTICE_INT4", "LATTICE_PQ",
                     "LATTICE_SHARDED"):
            monkeypatch.delenv(flag, raising=False)
        monkeypatch.setattr(port_cs, "IVF_AUTO_MIN_ROWS", 128)
        monkeypatch.setattr(port_cs, "IVF_SMALL_BATCH", 32)
        monkeypatch.setattr(port_cs, "IVF_FLAT_CROSSOVER_ROWS", 2_000_000)
        return monkeypatch

    @staticmethod
    def _never_build(s, monkeypatch):
        called = {"n": 0}
        monkeypatch.setattr(s, "build_ivf", lambda *a, **k: called.__setitem__(
            "n", called["n"] + 1))
        return called

    def test_forced_ivf_passes_through(self):
        s, _ = _clustered_store(64, 32)
        assert s._plan_search(4, 10, None, "ivf") == "ivf"
        assert s._resolve_plan(4, 10, None, "ivf") == "ivf"

    def test_large_clustered_corpus_serves_ivf(self, cuda):
        s, _ = _clustered_store(256, 32)
        assert s._ivf is None
        assert s._plan_search(4, 10, None, "auto") == "ivf"   # first call builds
        assert s._ivf.measured_recall >= port_cs.IVF_MIN_RECALL
        built = s._ivf
        assert s._plan_search(1, 10, None, "auto") == "ivf"   # no rebuild
        assert s._ivf is built

    def test_small_corpus_skips_ivf(self, cuda):
        s, _ = _clustered_store(100, 32)
        called = self._never_build(s, cuda)
        assert s._plan_search(4, 10, None, "auto") == "quantized"
        assert called["n"] == 0

    def test_isotropic_corpus_never_auto_ivf(self, cuda):
        s = ChunkStore(dim=64, dtype="float32", initial_capacity=512)
        s.add(_vecs(512, 64), [{"file_path": "a.py"}] * 512)
        cuda.setattr(port_cs, "IVF_AUTO_NPROBE", 1)
        assert s._plan_search(4, 10, None, "auto") == "quantized"
        # the refusal is remembered, the buckets are released
        assert s._ivf.hollow and not s._ivf_dirty
        assert s._ivf.measured_recall < port_cs.IVF_MIN_RECALL
        called = self._never_build(s, cuda)
        assert s._plan_search(4, 10, None, "auto") == "quantized"
        assert called["n"] == 0

    def test_large_batch_prefers_quantized(self, cuda):
        s, _ = _clustered_store(256, 32)
        assert s._plan_search(32, 10, None, "auto") == "ivf"
        assert s._plan_search(33, 10, None, "auto") == "quantized"
        cuda.setattr(port_cs, "IVF_FLAT_CROSSOVER_ROWS", 200)
        assert s._plan_search(256, 10, None, "auto") == "ivf"
        cuda.setattr(port_cs, "IVF_SMALL_BATCH", 0)
        cuda.setattr(port_cs, "IVF_FLAT_CROSSOVER_ROWS", 2_000_000)
        assert s._plan_search(1, 10, None, "auto") == "quantized"

    def test_ivf_refused_when_build_wont_fit(self, cuda):
        s, _ = _clustered_store(256, 32)
        called = self._never_build(s, cuda)
        # rows + shadow fit (5 bytes a value), rows + buckets + slack not
        cuda.setattr(ChunkStore, "_device_memory_bytes",
                     lambda self: self._cap * self.dim * 10)
        assert s._plan_search(4, 10, None, "auto") == "quantized"
        assert called["n"] == 0

    def test_selective_filter_falls_to_the_flat_tier(self, cuda):
        s, _ = _clustered_store(256, 32)
        called = self._never_build(s, cuda)
        # 64 of 256 rows is 25%, but under the 50 * k = 500 floor
        assert s._plan_search(4, 10, {"file_path": "f1.py"},
                              "auto") == "quantized"
        assert called["n"] == 0

    def test_broad_filter_is_served_by_ivf(self, cuda):
        s, _ = _clustered_store(2048, 32)
        assert s._filter_selectivity_ok({"entity_type": "function"}, 10)
        assert s._plan_search(4, 10, {"file_path": "f1.py"}, "auto") == "ivf"

    def test_forced_modes_preempt_ivf(self, cuda):
        s, _ = _clustered_store(256, 32)
        called = self._never_build(s, cuda)
        for flag in ("LATTICE_INT4", "LATTICE_PQ", "LATTICE_SHARDED"):
            cuda.setenv(flag, "1")
            with pytest.raises(NotImplementedError):
                s._plan_search(256, 10, None, "auto")
            cuda.delenv(flag)
        assert called["n"] == 0

    def test_int8_env_does_not_preempt_ivf_and_k_above_64_is_flat(self, cuda):
        s, _ = _clustered_store(256, 32)
        cuda.setenv("LATTICE_INT8", "1")
        assert s._plan_search(4, 10, None, "auto") == "ivf"
        assert s._plan_search(64, 10, None, "auto") == "quantized"
        assert s._plan_search(4, 65, None, "auto") == "flat"

    def test_auto_search_serves_through_ivf(self, cuda):
        s, x = _clustered_store(256, 32)
        q = x[[1, 2, 3]]
        got = s.search(q, k=5)
        assert s._ivf is not None and not s._ivf_dirty
        _assert_same_hits(got, s.search_ivf(q, k=5,
                                            nprobe=port_cs.IVF_AUTO_NPROBE))
        sd, idx = s.search_device(torch.from_numpy(q), 5)
        assert idx.tolist() == [[r for r, _, _ in h] for h in got]


def test_cpu_store_launches_no_kernel():
    s, x = _clustered_store(256, 32)
    _build.reset_launch_counts()
    s.build_ivf(n_clusters=8)
    s.search_ivf(x[:3], k=5)
    s.search_device(torch.from_numpy(x[:3]), 5, method="ivf")
    assert "ivf_probe" in _build.launch_counts()
    assert set(_build.launch_counts().values()) == {0}
