"""The port's corpus-scale deep path against the JAX package.

Same inputs, made from a seed with numpy, through both packages' ranking
entry points (`lattice_tpu/ops/ranking.py` jitted on the CPU, and the
port's torch ops with their plain selection): the cases of
`tests/test_ranking_fuse.py` (the oracle, the node -> row join, the
sparse reach, packed against unpacked, `pack_reach`'s round trip and
bounds, overflow truncation, the batch against each query), each run in
both. Scores within 1e-5; ids equal except between candidates whose
scores lie within 1e-6 of each other (JAX's `approx_max_k` on the CPU
orders exact ties its own way; the port ranks the lower row first).

Then `QueryEngine`'s device branch on the golden fixture, with
`DEEP_DEVICE_THRESHOLD = 1` in both packages (the fixture is far below
100,000 rows): each of the 104 golden texts through `deep_search` (top
10 under the same rule, sources and `graph_context` equal),
`deep_search_batch` against the sequential calls, whole and chunked
(`DEEP_BATCH_CHUNK = 2`), `LATTICE_REACH_BUDGET=1`, and the subject
demotion cases of `tests/test_golden_corpus.py:288-328`. Last, the
device branch scores the f32 query against the rows widened to f32,
never the query rounded to the rows' dtype.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import ranking as jrank
from lattice_tpu.query import golden_eval as jge
from lattice_tpu_torch.ops import ranking as prank
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.query import golden_eval as pge

TIE = 1e-6
SCORE_TOL = 1e-5
K = 10
CASES = jge.load_cases()
W = jrank.pack_weights(jrank.FuseWeights())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def _same_top(p_s, p_i, j_s, j_i):
    """Scores within SCORE_TOL slot by slot; where the ids differ, the
    JAX id scores within TIE of the port's slot in the port's own list
    (a near-tie ranked the other way)."""
    p_s, p_i = np.asarray(p_s), np.asarray(p_i)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    assert p_s.shape == j_s.shape and p_i.shape == j_i.shape
    np.testing.assert_allclose(p_s, j_s, rtol=0, atol=SCORE_TOL)
    where = {int(i): float(s) for s, i in zip(p_s.reshape(-1),
                                              p_i.reshape(-1))}
    for slot, (a, b) in enumerate(zip(p_i.reshape(-1), j_i.reshape(-1))):
        if a != b:
            other = where.get(int(b), float(j_s.reshape(-1)[slot]))
            assert abs(other - float(p_s.reshape(-1)[slot])) <= TIE, \
                (slot, a, b)


# ---- ranking entry points ---------------------------------------------------


def _fuse_inputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random(n) < 0.3, rng.integers(0, 5, n),
                     jrank.UNREACHED).astype(np.int32)
    relevance = rng.random(n).astype(np.float32)
    vec = np.where(rng.random(n) < 0.4, rng.random(n),
                   jrank.NEG_INF).astype(np.float32)
    match = (rng.random(n) < 0.1).astype(np.float32)
    degree = rng.integers(0, 100, n).astype(np.int32)
    quality = rng.random(n).astype(np.float32)
    return depth, relevance, vec, match, degree, quality


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_rank_matches_oracle_and_jax(seed):
    cols = _fuse_inputs(seed=seed)
    w = jrank.FuseWeights()
    js, ji = jrank.fused_rank(*(j(c) for c in cols), j(W), 20)
    ps, pi = prank.fused_rank(*(t(c) for c in cols), t(W), 20)
    o_s, o_i = prank.rank_oracle(*cols, prank.FuseWeights(
        *dataclasses.astuple(w)), 20)
    np.testing.assert_allclose(ps.numpy(), o_s, atol=1e-5)
    assert set(pi.tolist()) == set(o_i.tolist())
    _same_top(ps, pi, js, ji)


def test_hybrid_beats_single_side():
    depth = np.asarray([0, 0, jrank.UNREACHED], np.int32)
    rel = np.asarray([1.0, 1.0, 0.0], np.float32)
    vec = np.asarray([0.9, jrank.NEG_INF, 0.9], np.float32)
    zeros = np.zeros(3, np.float32)
    cols = (depth, rel, vec, zeros, np.zeros(3, np.int32),
            np.ones(3, np.float32))
    ps, pi = prank.fused_rank(*(t(c) for c in cols), t(W), 3)
    js, ji = jrank.fused_rank(*(j(c) for c in cols), j(W), 3)
    assert pi[0] == 0 == int(np.asarray(ji)[0])
    _same_top(ps, pi, js, ji)


def test_absent_nodes_excluded():
    depth = np.full(5, jrank.UNREACHED, np.int32)
    vec = np.full(5, jrank.NEG_INF, np.float32)
    z = np.zeros(5, np.float32)
    ps, pi = prank.fused_rank(t(depth), t(z), t(vec), t(z),
                              t(np.zeros(5, np.int32)), t(z), t(W), 5)
    assert bool((ps <= prank.NEG_INF / 2).all())
    assert pi.tolist() == list(range(5))   # the NEG_INF fillers, by row


@pytest.mark.parametrize("seed", [0, 3])
def test_row_join_matches_flat_fuse_and_jax(seed):
    """fused_rank_rows (node -> row gather) equals fused_rank on
    pre-gathered columns when rows map 1:1 to nodes, and JAX's."""
    rng = np.random.default_rng(seed)
    n = 96
    depth = np.full(n, jrank.UNREACHED, np.int32)
    depth[rng.choice(n, 20, replace=False)] = rng.integers(1, 4, 20)
    degree = rng.integers(0, 80, n).astype(np.int32)
    vec = np.where(rng.random(n) < 0.5, rng.random(n).astype(np.float32),
                   -1e30).astype(np.float32)
    match = (rng.random(n) < 0.2).astype(np.float32)
    quality = rng.random(n).astype(np.float32)
    rel_nodes = np.full(n, 0.7, np.float32)
    rel_flat = np.where(depth < jrank.UNREACHED, 0.7, 0.0).astype(np.float32)
    s1, i1 = prank.fused_rank(t(depth), t(rel_flat), t(vec), t(match),
                              t(degree), t(quality), t(W), 10)
    args = (depth, degree, np.arange(n, dtype=np.int32), rel_nodes, vec,
            match, quality, W)
    s2, i2 = prank.fused_rank_rows(*(t(a) for a in args), 10)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    js, ji = jrank.fused_rank_rows(*(j(a) for a in args), 10)
    _same_top(s2, i2, js, ji)


def test_rows_without_nodes_rank_on_vector_side():
    n_nodes, n_rows = 16, 8
    args = (np.zeros(n_nodes, np.int32), np.zeros(n_nodes, np.int32),
            np.full(n_rows, -1, np.int32), np.full(n_nodes, 0.7, np.float32),
            np.linspace(0.9, 0.2, n_rows).astype(np.float32),
            np.zeros(n_rows, np.float32), np.ones(n_rows, np.float32), W)
    ps, pi = prank.fused_rank_rows(*(t(a) for a in args), 4)
    js, ji = jrank.fused_rank_rows(*(j(a) for a in args), 4)
    assert int(pi[0]) == 0
    _same_top(ps, pi, js, ji)


def _hybrid_inputs(seed=4, n=256, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[[5, 99]] = False
    q = rng.normal(size=(d,)).astype(np.float32) * 3.0   # unnormalized
    reach = np.full(32, -1, np.int32)
    reach[:4] = [7, 11, 40, 99]   # 99 is invalid: vector side masked
    depths = np.zeros(32, np.int32)
    depths[:4] = [0, 1, 2, 1]
    rel = np.zeros(32, np.float32)
    rel[:4] = 0.7
    degree = rng.integers(0, 60, n).astype(np.int32)
    match = np.zeros(n, np.float32)
    match[rng.choice(n, 6, replace=False)] = 1.0
    quality = rng.random(n).astype(np.float32)
    return q, emb, valid, reach, depths, rel, degree, match, quality


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_rank_device_matches_composition_and_jax(dtype):
    """The hybrid rank (normalize + cosine + scatter + fuse + select)
    equals the op-by-op composition in the port, and JAX's on the same
    rows (bf16 rows widened exactly on both sides)."""
    q, emb, valid, reach, depths, rel, degree, match, quality = \
        _hybrid_inputs()
    rows_p = t(emb).to(getattr(torch, dtype))
    rows_j = j(emb).astype(getattr(jnp, dtype))
    s1, r1 = prank.hybrid_rank_device(
        t(q), rows_p, t(valid), t(reach), t(depths), t(rel), t(degree),
        t(match), t(quality), t(W), 8)
    qn = q / np.linalg.norm(q)
    e64 = rows_p.to(torch.float64).numpy()
    vec = np.where(valid, e64 @ qn, -1e30).astype(np.float32)
    s2, r2 = prank.fused_rank_rows_sparse(
        t(reach), t(depths), t(rel), t(degree), t(vec), t(match),
        t(quality), t(W), 8)
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-5)
    js, ji = jrank.hybrid_rank_device(
        j(q), rows_j, j(valid), j(reach), j(depths), j(rel), j(degree),
        j(match), j(quality), j(W), 8)
    _same_top(s1, r1, js, ji)
    js2, ji2 = jrank.fused_rank_rows_sparse(
        j(reach), j(depths), j(rel), j(degree), j(vec), j(match),
        j(quality), j(W), 8)
    _same_top(s2, r2, js2, ji2)


def test_sparse_reach_keeps_least_depth_and_largest_relevance():
    """A row reached twice (two nodes on one row, or two directions)
    keeps its least depth and its largest relevance; pads change
    nothing. Both packages agree on every row's fused score."""
    n = 12
    reach = np.asarray([3, 3, 7, -1, -1, 0], np.int32)
    depths = np.asarray([4, 1, 2, 0, 0, 3], np.int32)
    rel = np.asarray([0.9, 0.2, 0.5, 1.0, 1.0, 0.3], np.float32)
    vec = np.linspace(0.1, 0.6, n).astype(np.float32)
    z = np.zeros(n, np.float32)
    deg = np.arange(n, dtype=np.int32)
    args = (reach, depths, rel, deg, vec, z, z, W)
    ps, pi = prank.fused_rank_rows_sparse(*(t(a) for a in args), n)
    js, ji = jrank.fused_rank_rows_sparse(*(j(a) for a in args), n)
    _same_top(ps, pi, js, ji)
    depth = np.full(n, jrank.UNREACHED, np.int32)
    depth[[3, 7, 0]] = [1, 2, 3]
    relc = np.zeros(n, np.float32)
    relc[[3, 7, 0]] = [0.9, 0.5, 0.3]
    fs, fi = prank.fused_rank(t(depth), t(relc), t(vec), t(z), t(deg), t(z),
                              t(W), n)
    np.testing.assert_array_equal(fs.numpy(), ps.numpy())
    np.testing.assert_array_equal(fi.numpy(), pi.numpy())


def _packed_setup(seed=9, n=300, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[[5, 120]] = False
    q = rng.normal(size=(d,)).astype(np.float32) * 2.0
    degree = rng.integers(0, 60, n).astype(np.int32)
    quality = np.ones(n, np.float32)
    return rng, n, emb, valid, q, degree, quality


@pytest.mark.parametrize("seed", [9, 10])
def test_packed_matches_unpacked_and_jax(seed):
    rng, n, emb, valid, q, degree, quality = _packed_setup(seed)
    rel_table = np.asarray([1.0, 0.9, 0.7, 0.0], np.float32)
    rows = rng.choice(n, size=20, replace=False).astype(np.int32)
    depths = rng.integers(0, 6, 20).astype(np.int32)
    cls = rng.integers(0, 3, 20).astype(np.uint8)
    match_rows = np.asarray([3, 17, -1, -1], np.int32)
    packed = prank.pack_reach(rows, depths, cls, 32)
    np.testing.assert_array_equal(packed,
                                  jrank.pack_reach(rows, depths, cls, 32))
    args = (q, emb, valid, packed, rel_table, match_rows, degree, quality, W)
    s1, r1 = prank.hybrid_rank_device_packed(*(t(a) for a in args), 10)
    reach = np.full(32, -1, np.int32)
    reach[:20] = rows
    dep = np.zeros(32, np.int32)
    dep[:20] = depths
    rel = np.zeros(32, np.float32)
    rel[:20] = rel_table[cls]
    match = np.zeros(n, np.float32)
    match[[3, 17]] = 1.0
    s2, r2 = prank.hybrid_rank_device(
        t(q), t(emb), t(valid), t(reach), t(dep), t(rel), t(degree),
        t(match), t(quality), t(W), 10)
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-5)
    js, ji = jrank.hybrid_rank_device_packed(*(j(a) for a in args), 10)
    _same_top(s1, r1, js, ji)


def test_pack_reach_roundtrip_and_bounds():
    rows = np.asarray([0, prank.REACH_ROW_MASK, 12345], np.int64)
    depths = np.asarray([0, 15, 99], np.int64)   # 99 clamps to 15
    cls = np.asarray([0, 3, 2], np.uint8)
    assert (prank.REACH_ROW_BITS, prank.REACH_ROW_MASK,
            prank.REACH_DEPTH_MAX) == (jrank.REACH_ROW_BITS,
                                       jrank.REACH_ROW_MASK,
                                       jrank.REACH_DEPTH_MAX)
    p = prank.pack_reach(rows, depths, cls, 8)
    np.testing.assert_array_equal(p, jrank.pack_reach(rows, depths, cls, 8))
    assert (p[3:] == -1).all()
    np.testing.assert_array_equal(p[:3] & prank.REACH_ROW_MASK, rows)
    np.testing.assert_array_equal((p[:3] >> prank.REACH_ROW_BITS) & 15,
                                  [0, 15, 15])
    np.testing.assert_array_equal((p[:3] >> 29) & 3, cls)
    # the torch unpack of the fuse reads the same fields
    pt = t(p)
    assert ((pt >> 29) & 3)[:3].tolist() == cls.tolist()
    with pytest.raises(ValueError, match="25-bit"):
        prank.pack_reach(np.asarray([1 << prank.REACH_ROW_BITS]),
                         np.zeros(1), np.zeros(1), 4)


def test_truncates_overflowing_reach():
    p = prank.pack_reach(np.arange(100), np.zeros(100), np.zeros(100), 16)
    assert len(p) == 16 and (p >= 0).all()
    np.testing.assert_array_equal(p, jrank.pack_reach(
        np.arange(100), np.zeros(100), np.zeros(100), 16))


@pytest.mark.parametrize("per_query", [False, True])
def test_batch_matches_per_query_and_jax(per_query):
    """The Q-query rank equals Q single packed calls (the same scatter,
    fuse and selection per row), with one [4] / [8] table or per-query
    [Q, 4] / [Q, 8] tables; and JAX's batch."""
    rng, n, emb, valid, q, degree, quality = _packed_setup(11)
    nq = 5
    queries = rng.normal(size=(nq, 32)).astype(np.float32)
    packed = np.stack([
        prank.pack_reach(rng.choice(n, size=12, replace=False),
                         rng.integers(0, 6, 12), rng.integers(0, 3, 12), 16)
        for _ in range(nq)])
    match = np.full((nq, 4), -1, np.int32)
    match[0, :2] = [3, 17]
    match[2, 0] = 40
    rel_table = np.asarray([1.0, 0.9, 0.7, 0.0], np.float32)
    w = W
    if per_query:
        rel_table = np.stack([rel_table * (1 - 0.1 * i) for i in range(nq)])
        w = np.stack([jrank.pack_weights(jrank.FuseWeights(
            graph_weight=0.3 + 0.1 * i, vector_weight=0.7 - 0.1 * i))
            for i in range(nq)])
    args = (queries, emb, valid, packed, rel_table, match, degree, quality, w)
    bs, bi = prank.hybrid_rank_device_packed_batch(*(t(a) for a in args), 7)
    assert bs.shape == bi.shape == (nq, 7)
    for qi in range(nq):
        s1, i1 = prank.hybrid_rank_device_packed(
            t(queries[qi]), t(emb), t(valid), t(packed[qi]),
            t(rel_table[qi] if per_query else rel_table), t(match[qi]),
            t(degree), t(quality), t(w[qi] if per_query else w), 7)
        np.testing.assert_array_equal(bi[qi].numpy(), i1.numpy())
        np.testing.assert_allclose(bs[qi].numpy(), s1.numpy(), atol=1e-5)
    js, ji = jrank.hybrid_rank_device_packed_batch(*(j(a) for a in args), 7)
    _same_top(bs, bi, js, ji)


def test_batch_fuses_in_blocks(monkeypatch):
    """The [Q, N] slab fused a query at a time equals it fused whole."""
    rng, n, emb, valid, q, degree, quality = _packed_setup(12)
    queries = rng.normal(size=(6, 32)).astype(np.float32)
    packed = np.stack([prank.pack_reach(
        rng.choice(n, size=9, replace=False), rng.integers(0, 6, 9),
        rng.integers(0, 3, 9), 12) for _ in range(6)])
    match = np.full((6, 2), -1, np.int32)
    match[1] = [4, 8]
    args = [t(a) for a in (queries, emb, valid, packed,
                           np.asarray([1.0, 0.9, 0.7, 0.0], np.float32),
                           match, degree, quality, W)]
    whole = prank.hybrid_rank_device_packed_batch(*args, 9)
    monkeypatch.setattr(prank, "FUSE_BLOCK", n)   # one query a block
    blocked = prank.hybrid_rank_device_packed_batch(*args, 9)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cosine_scores_the_f32_query_not_a_rounded_one():
    """The device branch's cosine keeps the query in f32 against bf16 rows
    widened to f32 (as `lax.dot_general(f32, bf16)` does), where
    `batched_matmul_scores` (the "flat" plan) rounds the query to bf16.
    On a crafted input the two differ by ~1e-3: rounded, the two rows tie
    and the lower row ranks first; in f32 the other row is ahead. The
    device branch agrees with float64 within 1e-7 and with JAX's
    `hybrid_rank_device`."""
    rows = np.zeros((2, 4), np.float32)
    rows[0, 0] = 1.0            # row 0 scores q[0]
    rows[1, 1] = 1.0            # row 1 scores q[1]
    # both components round to bf16 0.6015625
    q = np.asarray([0.6, 0.601, 0.0, 0.528014], np.float32)
    q /= np.linalg.norm(q)
    emb = t(rows).to(torch.bfloat16)
    valid = torch.ones(2, dtype=torch.bool)
    dev = prank.row_scores(t(q)[None], emb, valid)[0].numpy()
    flat = topk_ops.batched_matmul_scores(t(q)[None], emb)[0].numpy()
    np.testing.assert_allclose(dev, q[:2].astype(np.float64), rtol=0,
                               atol=1e-7)
    assert np.abs(flat - dev).max() > 1e-3
    assert dev[1] > dev[0] and flat[1] == flat[0]
    z = np.zeros(2, np.float32)
    args = (q, rows, np.ones(2, bool), np.full(1, -1, np.int32),
            np.zeros(1, np.int32), np.zeros(1, np.float32),
            np.zeros(2, np.int32), z, z, W)
    ps, pi = prank.hybrid_rank_device(
        *(t(a) if i != 1 else emb for i, a in enumerate(args)), 2)
    js, ji = jrank.hybrid_rank_device(
        *(j(a) if i != 1 else j(rows).astype(jnp.bfloat16)
          for i, a in enumerate(args)), 2)
    _same_top(ps, pi, js, ji)
    assert pi.tolist() == [1, 0] == np.asarray(ji).tolist()
    fs, fi = topk_ops.flat_topk(t(q)[None], emb, valid, 2)
    assert fi[0].tolist() == [0, 1]      # the "flat" plan ranks the tie


# ---- the engine's device branch on the golden fixture ----------------------


def _plain(obj):
    """A dataclass tree as dicts and lists, enums as their values, so
    objects of the two packages compare with `==`."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _same_results(p, jx, where):
    """Top 10: names equal except a near-tie (two candidates within TIE)
    ranked the other way, scores within SCORE_TOL, sources equal."""
    p, jx = p[:K], jx[:K]
    assert len(p) == len(jx), where
    p_score = {r.qualified_name: r.score for r in p}
    for slot, (a, b) in enumerate(zip(p, jx)):
        assert abs(a.score - b.score) <= SCORE_TOL, (where, slot)
        if a.qualified_name != b.qualified_name:
            other = p_score.get(b.qualified_name, b.score)
            assert abs(other - a.score) <= TIE, (where, slot)
        else:
            assert a.source.value == b.source.value, (where, slot)
            assert (a.file_path, a.start_line, a.end_line) == \
                (b.file_path, b.start_line, b.end_line), (where, slot)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, _ = jge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("jax")))
    peng, _ = pge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("port")), device="cpu")
    return jeng, peng


@pytest.fixture
def forced(engines, monkeypatch):
    """Both engines on their device branch."""
    for e in engines:
        monkeypatch.setattr(e, "DEEP_DEVICE_THRESHOLD", 1)
    return engines


@pytest.mark.parametrize("i", range(len(CASES)))
def test_device_branch_matches_jax(forced, i):
    jeng, peng = forced
    text = CASES[i]["query"]
    p = peng.deep_search(text, limit=K)
    jx = jeng.deep_search(text, limit=K)
    assert p.results, text
    _same_results(p.results, jx.results, text)
    assert _plain(p.graph_context) == _plain(jx.graph_context), text
    assert _plain(p.query_plan) == _plain(jx.query_plan), text


def test_deep_cases_first_hits_match_jax(forced):
    """The golden set's `deep` cases on the forced device branch: every
    first hit at JAX's rank."""
    jeng, peng = forced
    deep = [c for c in CASES if c["path"] == "deep"]
    assert len(deep) == 12
    for c in deep:
        expect = set(c["expect"])
        assert jge._rank_of_first_hit(
            peng.deep_search(c["query"], limit=K).results, expect, K) == \
            jge._rank_of_first_hit(
                jeng.deep_search(c["query"], limit=K).results, expect, K)


def _texts():
    return [c["query"] for c in CASES if c["path"] == "deep"] + [
        c["query"] for c in CASES if c["path"] == "search"][::9]


@pytest.mark.parametrize("chunk", [2, 128])
def test_batch_equals_sequential(forced, monkeypatch, chunk):
    """`deep_search_batch` through the batched rank (chunked at 2, or
    whole) equals the sequential `deep_search` per query, and JAX's
    batch."""
    jeng, peng = forced
    monkeypatch.setattr(peng, "DEEP_BATCH_CHUNK", chunk)
    texts = _texts()
    batch = peng.deep_search_batch(texts, limit=K)
    jbatch = jeng.deep_search_batch(texts, limit=K)
    assert [r.query for r in batch] == texts
    for text, b, jb in zip(texts, batch, jbatch):
        one = peng.deep_search(text, limit=K)
        _same_results(b.results, one.results, text)
        _same_results(b.results, jb.results, text)
        assert _plain(b.graph_context) == _plain(one.graph_context)
        assert "deep_fuse_ms" in b.phase_times_ms


def test_batch_walks_batched_equal_sequential(forced):
    """`_deep_evidence_batch` (two batched native walks) gives each plan
    the evidence `_deep_evidence` computes alone."""
    _, peng = forced
    plans = [peng.planner.plan_heuristic(x) for x in _texts()]
    for plan, ev in zip(plans, peng._deep_evidence_batch(plans)):
        one = peng._deep_evidence(plan)
        for key in ("f_ids", "f_d", "b_ids", "b_d", "r_rows", "r_depths",
                    "r_cls", "rel_table"):
            np.testing.assert_array_equal(ev[key], one[key])
        assert ev["seeds"] == one["seeds"]
        assert ev["match_rows"] == one["match_rows"]
        assert ev["reach_set"] == one["reach_set"]


def test_evidence_matches_jax(forced):
    """Seeds, walks, row expansion, relevance tables and match rows of
    every golden text equal JAX's."""
    jeng, peng = forced
    for c in CASES:
        pp = peng.planner.plan_heuristic(c["query"])
        jp = jeng.planner.plan_heuristic(c["query"])
        pe, je = peng._deep_evidence(pp), jeng._deep_evidence(jp)
        for key in ("f_ids", "f_d", "b_ids", "b_d", "r_rows", "r_depths",
                    "r_cls", "rel_table"):
            np.testing.assert_array_equal(pe[key], je[key])
        assert pe["seeds"] == je["seeds"]
        assert sorted(pe["match_rows"]) == sorted(je["match_rows"])
        assert pe["reach_set"] == je["reach_set"]
        pb, mb = peng._pack_deep_evidence([pe])
        jb, jm = jeng._pack_deep_evidence([je])
        r = len(pe["r_rows"])
        np.testing.assert_array_equal(pb[0, :r], jb[0, :r])
        assert (pb[0, r:] == -1).all() and (jb[0, r:] == -1).all()


def test_reach_budget_floor(forced, monkeypatch):
    """LATTICE_REACH_BUDGET=1 still bounds the walk and keeps graph
    evidence (`tests/test_golden_corpus.py::test_reach_budget_floor`), in
    both packages alike."""
    jeng, peng = forced
    monkeypatch.setenv("LATTICE_REACH_BUDGET", "1")
    assert peng._reach_budget() == 1
    result = peng.deep_search("who calls validate_email?")
    assert result.results
    names = " ".join(r.qualified_name for r in result.results)
    assert "validate_email" in names
    ev = peng._deep_evidence(peng.planner.plan_heuristic(
        "who calls validate_email?"))
    assert len(ev["f_ids"]) <= 1 and len(ev["b_ids"]) <= 1
    _same_results(result.results,
                  jeng.deep_search("who calls validate_email?").results,
                  "budget 1")


def test_device_route_keeps_subject_for_non_calls_intents(forced):
    """The CALLS-only walk cannot promote the answers of a methods intent,
    so the subject is not demoted there: it stays in the top 3."""
    jeng, peng = forced
    text = "what methods does DeliveryQueue have?"
    result = peng.deep_search(text)
    top = [r.qualified_name for r in result.results[:3]]
    assert any("DeliveryQueue" in qn for qn in top), top
    _same_results(result.results, jeng.deep_search(text).results, text)


def test_device_route_demotes_subject_for_usage_intent(forced):
    """Usage answers (callers) ride the CALLS reach, so the subject
    demotion stands: a caller outranks the subject."""
    jeng, peng = forced
    text = "who calls validate_email?"
    result = peng.deep_search(text)
    qns = [r.qualified_name for r in result.results]
    subject = next((i for i, qn in enumerate(qns)
                    if qn.endswith(".validate_email")), None)
    callers = [i for i, qn in enumerate(qns)
               if not qn.endswith(".validate_email")]
    assert subject is None or any(i < subject for i in callers), qns
    _same_results(result.results, jeng.deep_search(text).results, text)


def test_rank_columns_match_jax(engines):
    jeng, peng = engines
    pc = peng.indexer.code.device_rank_columns(peng.graph_store)
    jc = jeng.indexer.code.device_rank_columns(jeng.graph_store)
    for name in ("node_ids", "quality", "degree"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(pc.node_row_indptr, jc.node_row_indptr)
    np.testing.assert_array_equal(pc.node_row_indices, jc.node_row_indices)
    assert pc.generation == jc.generation
    assert peng.indexer.code.device_rank_columns(peng.graph_store) is pc
