"""The port's PQ capacity tier against the JAX package's.

Mirror of `tests/test_pq.py` (codebook training, the ADC scan against the
float64 oracle, recall, O(delta) mutation, the store's "pq" plan and the
`LATTICE_PQ=1` gate) against `lattice_tpu_torch.ops.pq` on the CPU, where
kernel B's plain versions select. Then both packages on the same seeded
numpy inputs:
- `PQIndex.build` draws the same sample and seeds, so the codebooks and
  codes come out equal (codebooks within 1e-5);
- `train_pq` on a sample with separated codewords gives codebooks within
  1e-5, and `pq_encode_block` the same codes given JAX's codebooks, except
  near-ties within 1e-6;
- `pq_topk` and `PQIndex.search` on a JAX-built index carried across
  (`PQIndex.from_numpy`) give ids equal except between candidates whose
  scores lie within 1e-5, and scores within 1e-4;
- the stores' "pq" plan and `LATTICE_PQ=1` give the JAX store's plan,
  hits and measured recall.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.ops import pq as jax_pq
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import pq as pq_ops
from lattice_tpu_torch.ops import topk as topk_ops

ID_TIE = 1e-5     # two candidates this close may swap
SCORE_TOL = 1e-4  # ADC scores of bf16 products summed in two frameworks


def _clustered(n, d, n_clusters, spread=0.3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return topk_ops.l2_normalize(x)


def _build_cpu(x, valid, **kw):
    return pq_ops.PQIndex.build(x, valid, device="cpu", **kw)


def _codes_np(idx):
    return idx.codes.cpu().numpy()


def _cb_np(idx):
    return idx.codebooks.cpu().numpy()


# ---- mirror of tests/test_pq.py -------------------------------------------


def test_choose_m():
    assert pq_ops.choose_m(768) == 192
    assert pq_ops.choose_m(768, target_dsub=2) == 384
    assert pq_ops.choose_m(64) == 16
    assert pq_ops.choose_m(768, target_dsub=8) == 96
    assert pq_ops.choose_m(7) == 1


def test_train_reduces_distortion():
    rng = np.random.default_rng(1)
    x = topk_ops.l2_normalize(rng.normal(size=(2048, 32)).astype(np.float32))
    m, ksub = 8, 32
    init = torch.from_numpy(rng.permutation(2048)[:ksub].astype(np.int64))
    xt = torch.from_numpy(x)
    cb0 = pq_ops.train_pq(xt, init, m, ksub, iters=0)
    cb8 = pq_ops.train_pq(xt, init, m, ksub, iters=8)

    def distortion(cb):
        codes = pq_ops.pq_encode_block(xt, cb).numpy()
        xhat = pq_ops.pq_decode_oracle(codes, cb.numpy())
        return float(np.mean((x - xhat) ** 2))

    assert distortion(cb8) < 0.75 * distortion(cb0)


def test_encode_decode_roundtrip_exact_on_codebook_points():
    m, ksub, dsub = 4, 8, 4
    rng = np.random.default_rng(2)
    cb = torch.from_numpy(rng.normal(size=(m, ksub, dsub)).astype(np.float32))
    codes_true = rng.integers(0, ksub, size=(64, m))
    x = pq_ops.pq_decode_oracle(codes_true, cb.numpy()).astype(np.float32)
    codes = pq_ops.pq_encode_block(torch.from_numpy(x), cb)
    assert codes.dtype == torch.uint8 and codes.shape == (64, m)
    xhat = pq_ops.pq_decode_oracle(codes.numpy(), cb.numpy())
    np.testing.assert_allclose(xhat, x, atol=1e-5)
    dev = pq_ops.pq_decode(codes, cb).numpy()
    np.testing.assert_allclose(dev, xhat, atol=1e-5)


def test_pq_topk_matches_oracle():
    n, d, m, ksub, k = 500, 32, 8, 16, 7   # n not a block multiple
    x = _clustered(n, d, 8, seed=3)
    idx = _build_cpu(x, np.ones(n, bool), m=m, ksub=ksub)
    q = _clustered(9, d, 8, seed=4)
    valid = np.ones(n, bool)
    valid[::5] = False
    s, i = pq_ops.pq_topk(torch.from_numpy(q), idx.codes, idx.codebooks,
                          torch.from_numpy(valid), k, block=128)
    _, oi = pq_ops.pq_topk_oracle(q, _codes_np(idx), _cb_np(idx), valid, k)
    for row in range(len(q)):
        got, want = set(i[row].tolist()), set(oi[row].tolist())
        assert len(got & want) >= k - 1, (got, want)
    assert bool((s[:, :-1] >= s[:, 1:]).all())


def test_pq_topk_k_wider_than_corpus():
    x = _clustered(12, 16, 2, seed=5)
    idx = _build_cpu(x, np.ones(12, bool), m=4, ksub=8)
    s, i = idx.search(x[:2], k=20)
    assert s.shape == (2, 20)
    assert (i[:, 12:] == -1).all()
    assert (s[:, 12:] < topk_ops.NEG_INF / 2).all()


def test_recall_on_clustered_corpus():
    n, d = 8192, 64
    x = _clustered(n, d, 32, spread=0.25, seed=6)
    idx = _build_cpu(x, np.ones(n, bool))
    r_adc = idx.measure_recall(x, np.ones(n, bool), n_sample=64)
    assert r_adc >= 0.6, r_adc
    r = idx.measure_recall(x, np.ones(n, bool), n_sample=64, rescore=True)
    assert r >= 0.95, r
    assert idx.memory_bytes() < x.nbytes / 8


def test_filters_fold_into_mask():
    n, d = 1024, 32
    x = _clustered(n, d, 8, seed=7)
    idx = _build_cpu(x, np.ones(n, bool), m=8)
    mask = np.zeros(n, bool)
    mask[100:200] = True
    _, ids = idx.search(x[:4], k=5, mask=mask)
    assert ((ids >= 100) & (ids < 200)).all()


def test_incremental_insert_remove():
    n, d = 512, 32
    x = _clustered(n, d, 8, seed=8)
    idx = _build_cpu(x[:256], np.ones(256, bool), m=8)
    idx.insert(torch.from_numpy(x[256:]), list(range(256, 512)))
    assert idx.codes.shape[0] == 512 and idx.n_rows == 512
    _, ids = idx.search(x[300:301], k=1)
    assert ids[0, 0] == 300
    idx.remove([300])
    _, ids = idx.search(x[300:301], k=1)
    assert ids[0, 0] != 300


def test_chunk_store_pq_method():
    n, d = 600, 32
    x = _clustered(n, d, 8, seed=9)
    store = ChunkStore(dim=d, dtype="float32", device="cpu")
    store.add(x, [{"file_path": f"f{i % 3}.py"} for i in range(n)])
    hits = store.search(x[:3], k=5, method="pq")
    assert len(hits) == 3 and hits[0][0][0] == 0
    hits = store.search(x[:1], k=5, method="pq",
                        filters={"file_path": "f1.py"})
    assert hits[0] and all(p["file_path"] == "f1.py" for _, _, p in hits[0])
    assert not store._pq_dirty
    store.add(x[:4], [{"file_path": "new.py"}] * 4)
    assert not store._pq_dirty
    rows = sorted(store._inverted["file_path"]["new.py"])
    assert len(rows) == 4
    _, sids = store._pq.search(x[:1], k=5)
    assert rows[0] in sids[0].tolist()


def test_auto_dispatch_env_gate(monkeypatch):
    n, d = 400, 32
    x = _clustered(n, d, 8, seed=10)
    store = ChunkStore(dim=d, dtype="float32", device="cpu")
    store.add(x, [{"file_path": "a.py"}] * n)
    monkeypatch.setenv("LATTICE_PQ", "1")
    assert store._plan_search(4, 10, None, "auto") == "pq"
    assert store._pq.measured_recall >= 0.9
    monkeypatch.delenv("LATTICE_PQ")
    assert store._plan_search(4, 10, None, "auto") == "flat"


def test_auto_dispatch_rejects_low_recall_pq(monkeypatch):
    rng = np.random.default_rng(11)
    x = topk_ops.l2_normalize(rng.normal(size=(512, 64)).astype(np.float32))
    store = ChunkStore(dim=64, dtype="float32", device="cpu")
    store.add(x, [{"file_path": "a.py"}] * 512)
    monkeypatch.setenv("LATTICE_PQ", "1")
    store.build_pq(m=2)
    assert store._pq.measured_recall < 0.9
    assert store._plan_search(4, 10, None, "auto") != "pq"


# ---- the port against the JAX package --------------------------------------


def _same_ids_but_ties(ids_a, ids_b, scores, tol=ID_TIE):
    """Ids equal slot by slot, except where the two candidates' scores (in
    `scores`, one row's [k] scores of the reference) lie within `tol` of
    the slot's score: a near-tie may swap."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    for row in range(ids_a.shape[0]):
        for j in np.flatnonzero(ids_a[row] != ids_b[row]):
            near = np.abs(scores[row] - scores[row, j]) <= tol
            assert near.sum() > 1, (row, j, ids_a[row], ids_b[row])
            assert set(ids_a[row][near]) == set(ids_b[row][near])


@pytest.mark.parametrize("n, m, ksub, k, block", [
    (500, 8, 16, 7, 128), (1000, 16, 64, 10, 4096), (12, 4, 8, 20, 4096),
    (777, 8, 32, 33, 100)])
def test_build_equals_jax(n, m, ksub, k, block):
    """The same rows through both builds: the same sample and seeds, so
    codebooks within 1e-5 and equal codes; then both packages' `pq_topk`
    on JAX's index carried across agree."""
    d = 32
    x = _clustered(n, d, 8, seed=n)
    valid = np.ones(n, bool)
    valid[::7] = False
    jidx = jax_pq.PQIndex.build(x, valid, m=m, ksub=ksub)
    pidx = _build_cpu(x, valid, m=m, ksub=ksub)
    np.testing.assert_allclose(_cb_np(pidx), np.asarray(jidx.codebooks),
                               atol=1e-5)
    assert np.array_equal(_codes_np(pidx), np.asarray(jidx.codes))
    assert np.array_equal(pidx.valid.numpy(), np.asarray(jidx.valid))
    assert pidx.memory_bytes() == jidx.memory_bytes()
    carried = pq_ops.PQIndex.from_numpy(
        np.asarray(jidx.codebooks), np.asarray(jidx.codes),
        np.asarray(jidx.valid), jidx.n_rows, device="cpu")
    q = _clustered(9, d, 8, seed=n + 1)
    js, ji = jax_pq.pq_topk(jnp.asarray(q), jidx.codes, jidx.codebooks,
                            jidx.valid, k, block=block)
    ps, pi = pq_ops.pq_topk(torch.from_numpy(q), carried.codes,
                            carried.codebooks, carried.valid, k, block=block)
    js, ji = np.asarray(js), np.asarray(ji)
    assert ps.shape == pi.shape == (9, k)
    np.testing.assert_allclose(ps.numpy(), js, atol=SCORE_TOL)
    _same_ids_but_ties(pi.numpy(), ji, js)
    # padding: -1 ids exactly where JAX pads
    assert np.array_equal(pi.numpy() < 0, ji < 0)


def test_train_pq_equals_jax_on_separated_codewords():
    """A sample drawn around well separated codewords, each centroid
    seeded by a point of its own codeword in every subspace: Lloyd's
    assignments have no near-ties, so both packages' codebooks agree
    within 1e-5."""
    rng = np.random.default_rng(21)
    m, ksub, dsub = 6, 16, 4
    words = rng.normal(size=(m, ksub, dsub)).astype(np.float32) * 4.0
    codes = rng.integers(0, ksub, size=(3000, m))
    codes[:ksub] = np.arange(ksub)[:, None]
    x = (pq_ops.pq_decode_oracle(codes, words)
         + 0.05 * rng.normal(size=(3000, m * dsub))).astype(np.float32)
    init = rng.permutation(ksub)
    jcb = jax_pq.train_pq(jnp.asarray(x), jnp.asarray(init.astype(np.int32)),
                          m, ksub, iters=6, block=512)
    pcb = pq_ops.train_pq(torch.from_numpy(x), torch.from_numpy(init), m,
                          ksub, iters=6, block=512)
    np.testing.assert_allclose(pcb.numpy(), np.asarray(jcb), atol=1e-5)


def test_encode_equals_jax_except_near_ties():
    """`pq_encode_block` given JAX's codebooks: the same codes, except
    where two codewords' distances lie within 1e-6."""
    x = _clustered(2000, 64, 16, seed=22)
    jidx = jax_pq.PQIndex.build(x, np.ones(2000, bool), m=16, ksub=64)
    cb = np.array(jidx.codebooks)
    got = pq_ops.pq_encode_block(torch.from_numpy(x),
                                 torch.from_numpy(cb)).numpy()
    want = np.asarray(jax_pq.pq_encode_block(jnp.asarray(x), jidx.codebooks))
    xs = x.reshape(2000, 16, 4).astype(np.float64)
    dist = ((xs[:, :, None, :] - cb[None].astype(np.float64)) ** 2).sum(-1)
    for r, j in zip(*np.nonzero(got != want)):
        assert abs(dist[r, j, got[r, j]] - dist[r, j, want[r, j]]) <= 1e-6
    assert (got == want).mean() > 0.999


def test_search_and_recall_equal_jax_carried():
    """`PQIndex.search` (ADC only and with the host rescore) and
    `measure_recall` on a JAX-built index carried across."""
    n, d = 2048, 64
    x = _clustered(n, d, 16, spread=0.25, seed=23)
    jidx = jax_pq.PQIndex.build(x, np.ones(n, bool))
    pidx = pq_ops.PQIndex.from_numpy(
        np.asarray(jidx.codebooks), np.asarray(jidx.codes),
        np.asarray(jidx.valid), jidx.n_rows, device="cpu")
    q = x[:16] + 0.01
    mask = np.ones(n, bool)
    mask[::3] = False
    for kw in ({}, {"mask": mask}, {"rescore_rows": x}):
        js, ji = jidx.search(q, 10, **kw)
        ps, pi = pidx.search(q, 10, **kw)
        np.testing.assert_allclose(ps, js, atol=SCORE_TOL)
        _same_ids_but_ties(pi, ji, js)
    for rescore in (False, True):
        assert pidx.measure_recall(x, np.ones(n, bool), n_sample=32,
                                   rescore=rescore) == pytest.approx(
            jidx.measure_recall(x, np.ones(n, bool), n_sample=32,
                                rescore=rescore), abs=1.0 / 320)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_pq_plan_equals_jax_store(dtype, monkeypatch):
    """The same rows and payloads in both stores: forced "pq" (with and
    without a filter) gives the same hits; `LATTICE_PQ=1` plans "pq" in
    both with the same measured recall; a mutation keeps both views
    fresh and the answers equal; `clear` drops the view."""
    n, d = 700, 32
    x = _clustered(n, d, 8, seed=24)
    pl = [{"file_path": f"f{i % 5}.py", "language": "go" if i % 2 else "py"}
          for i in range(n)]
    js = JaxStore(dim=d, dtype=dtype)
    ps = ChunkStore(dim=d, dtype=dtype, device="cpu")
    assert js.add(x, pl) == ps.add(x, pl)
    monkeypatch.setenv("LATTICE_PQ", "1")
    assert js._plan_search(4, 10, None, "auto") == "pq"
    assert ps._plan_search(4, 10, None, "auto") == "pq"
    assert ps._pq.measured_recall == js._pq.measured_recall
    np.testing.assert_allclose(_cb_np(ps._pq), np.asarray(js._pq.codebooks),
                               atol=1e-5)

    def same(a, b):
        assert [[r for r, _, _ in h] for h in a] == \
            [[r for r, _, _ in h] for h in b]
        for ha, hb in zip(a, b):
            np.testing.assert_allclose([s for _, s, _ in ha],
                                       [s for _, s, _ in hb], atol=1e-5)

    q = x[:5] + 0.02
    same(js.search(q, 10), ps.search(q, 10))
    monkeypatch.delenv("LATTICE_PQ")
    for filters in (None, {"language": "go"}):
        same(js.search(q, 10, method="pq", filters=filters),
             ps.search(q, 10, method="pq", filters=filters))
    s, i = ps.search_device(torch.from_numpy(q), 10, method="pq")
    assert s.shape == i.shape == (5, 10)
    new = _clustered(6, d, 8, seed=25)
    assert js.add(new, pl[:6]) == ps.add(new, pl[:6])
    assert js.remove([3, 4]) == ps.remove([3, 4])
    assert not js._pq_dirty and not ps._pq_dirty
    assert ps._pq_mutations == js._pq_mutations == 8
    same(js.search(new, 5, method="pq"), ps.search(new, 5, method="pq"))
    ps.clear()
    assert ps._pq is None and ps._pq_dirty


def test_pq_upkeep_reraises_device_errors(monkeypatch):
    """The reference logs any failure of the PQ upkeep and rebuilds; the
    port does so too, except for a kernel error, a CUDA out-of-memory or a
    path not ported (`DEVICE_ERRORS`), which raise."""
    from lattice_tpu_torch.core.errors import KernelError
    x = _clustered(300, 32, 8, seed=26)
    store = ChunkStore(dim=32, dtype="float32", device="cpu")
    store.add(x, [{"file_path": "a.py"}] * 300)
    store.build_pq()

    def boom(exc):
        def insert(*a, **k):
            raise exc
        return insert
    monkeypatch.setattr(store._pq, "insert", boom(ValueError("host")))
    store.add(x[:1], [{"file_path": "b.py"}])
    assert store._pq_dirty
    store.build_pq()
    monkeypatch.setattr(store._pq, "insert", boom(KernelError("launch")))
    with pytest.raises(KernelError):
        store.add(x[:1], [{"file_path": "c.py"}])


def test_pq_past_churn_rebuilds():
    x = _clustered(400, 32, 8, seed=27)
    store = ChunkStore(dim=32, dtype="float32", device="cpu")
    store.add(x, [{"file_path": "a.py"}] * 400)
    store.build_pq()
    store.add(x[:79], [{"file_path": "b.py"}] * 79)
    assert not store._pq_dirty
    store.add(x[:30], [{"file_path": "c.py"}] * 30)
    assert store._pq_dirty
    store.search(x[:1], 3, method="pq")
    assert not store._pq_dirty and store._pq.codes.shape[0] >= 509


def test_cpu_pq_launches_no_kernel():
    x = _clustered(300, 32, 8, seed=28)
    store = ChunkStore(dim=32, dtype="bfloat16", device="cpu")
    store.add(x, [{"file_path": "a.py"}] * 300)
    _build.reset_launch_counts()
    store.search_device(torch.from_numpy(x[:4]), 5, method="pq")
    assert set(_build.launch_counts().values()) == {0}


def test_cuda_default_raises_without_cuda(monkeypatch):
    from lattice_tpu_torch.core.errors import VectorStoreError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _clustered(20, 16, 2, seed=29)
    with pytest.raises(VectorStoreError, match="CUDA"):
        pq_ops.PQIndex.build(x, np.ones(20, bool), m=4, ksub=8)
    with pytest.raises(VectorStoreError, match="CUDA"):
        pq_ops.PQIndex.from_numpy(np.zeros((4, 8, 4), np.float32),
                                  np.zeros((20, 4), np.uint8),
                                  np.ones(20, bool), 20, device="cuda")
