"""The port's graph device paths against the JAX package and the oracle.

Seeded random graphs (numpy), small, on the CPU, through both packages'
`ops/graph_kernels` functions (JAX's jitted on the CPU) and the NumPy
`bfs_oracle`: padded edges, distances, degrees, path corridors and
closures exactly equal. `khop_select` is exact in the port (ties to the
lower id) and equals JAX's `exact=True` bit for bit; JAX's default
`approx_min_k` orders equal depths its own way, so against it the depths
are equal and the ids equal as a set below the last depth. Then the
`GraphStore` device methods against JAX's and the host walk: the padded
edge, liveness and degree tensors, `k_hop(device=True)` and
`k_hop_batch(device=True)` (with and without a limit, with tombstoned
nodes) equal to the host walk's (depth, id) prefix; the edge caches
reused, and dropped by `finalize`. Last, the selection's route by shape
through a recorded launch: kernel B's positional entry up to k = 512,
`stable_topk` past it, for `khop_select` and `ranking._select_topk`.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import merge_cases
from lattice_tpu.core.types import EdgeType as JEdge
from lattice_tpu.core.types import EntityType as JEntity
from lattice_tpu.index.graph_store import GraphStore as JGraph
from lattice_tpu.ops import graph_kernels as jgk
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import graph_kernels as pgk
from lattice_tpu_torch.ops import ranking as prank
from lattice_tpu_torch.ops import scan_topk as scan

UNREACHED = int(jgk.UNREACHED)


def _graph(seed: int, n: int = 200, e: int = 700):
    """A power-law edge list (hubs near node 0, as `bench.py` draws its
    CALLS graph), with duplicates and self-loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.minimum((n * rng.random(e) ** 3).astype(np.int32), n - 1)
    return src, dst, rng


def _padded(seed, n=200, e=700):
    src, dst, rng = _graph(seed, n, e)
    ps, pd = pgk.pad_edges(src, dst, geometric=True)
    return src, dst, ps, pd, rng


@pytest.mark.parametrize("e", [0, 1, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("geometric", [False, True])
def test_pad_edges_matches_jax(e, geometric):
    rng = np.random.default_rng(e)
    src = rng.integers(0, 50, e).astype(np.int32)
    dst = rng.integers(0, 50, e).astype(np.int32)
    for bucket in (64, 1024):
        p = pgk.pad_edges(src, dst, bucket, geometric)
        j = jgk.pad_edges(src, dst, bucket, geometric)
        for a, b in zip(p, j):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hops", [1, 3, 5])
def test_bfs_distances_match_jax_and_oracle(seed, hops):
    src, dst, ps, pd, rng = _padded(seed)
    n = 256
    seeds = np.zeros(n, bool)
    seeds[rng.choice(200, 1 + seed, replace=False)] = True
    got = pgk.bfs_distances(torch.from_numpy(ps), torch.from_numpy(pd),
                            torch.from_numpy(seeds), n, hops)
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = np.asarray(jgk.bfs_distances(jnp.asarray(ps), jnp.asarray(pd),
                                        jnp.asarray(seeds), n, hops))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  pgk.bfs_oracle(src, dst, seeds, n, hops))
    np.testing.assert_array_equal(
        pgk.bfs_oracle(src, dst, seeds, n, hops),
        jgk.bfs_oracle(src, dst, seeds, n, hops))


def test_padding_self_loops_reach_nothing():
    """(0, 0) pads add no reach, whether node 0 is a seed or not."""
    src = np.asarray([1, 2], np.int32)
    dst = np.asarray([2, 3], np.int32)
    ps, pd = pgk.pad_edges(src, dst, bucket=16)
    for seed in (0, 1):
        seeds = np.zeros(8, bool)
        seeds[seed] = True
        got = pgk.bfs_distances(torch.from_numpy(ps), torch.from_numpy(pd),
                                torch.from_numpy(seeds), 8, 4).numpy()
        np.testing.assert_array_equal(got, pgk.bfs_oracle(ps, pd, seeds, 8, 4))
    assert got.tolist()[:4] == [UNREACHED, 0, 1, 2]


@pytest.mark.parametrize("weighted", [False, True])
def test_degree_counts_match_jax(weighted):
    src, dst, _ = _graph(5)
    w = (np.random.default_rng(1).random(len(src)) * 3).astype(np.float32)
    pw = torch.from_numpy(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    got = pgk.degree_counts(torch.from_numpy(dst), 256, pw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgk.degree_counts(jnp.asarray(dst), 256, jw)))


@pytest.mark.parametrize("seed", range(3))
def test_nodes_on_paths_and_closure_match_jax(seed):
    src, dst, ps, pd, rng = _padded(seed)
    n = 256
    a = np.zeros(n, bool)
    b = np.zeros(n, bool)
    a[rng.integers(0, 200)] = True
    b[rng.choice(200, 3, replace=False)] = True
    got = pgk.nodes_on_paths(torch.from_numpy(ps), torch.from_numpy(pd),
                             torch.from_numpy(a), torch.from_numpy(b), n, 4)
    want = jgk.nodes_on_paths(jnp.asarray(ps), jnp.asarray(pd),
                              jnp.asarray(a), jnp.asarray(b), n, 4)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    up, down = pgk.bidirectional_closure(torch.from_numpy(ps),
                                         torch.from_numpy(pd),
                                         torch.from_numpy(b), n, 5)
    jup, jdown = jgk.bidirectional_closure(jnp.asarray(ps), jnp.asarray(pd),
                                           jnp.asarray(b), n, 5)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    np.testing.assert_array_equal(down.numpy(), np.asarray(jdown))
    np.testing.assert_array_equal(down.numpy(),
                                  pgk.bfs_oracle(dst, src, b, n, 5))


def _seed_sets(rng, q, s, n=200):
    seeds = np.full((q, s), -1, np.int32)
    for i in range(q):
        m = int(rng.integers(1, s + 1))
        seeds[i, :m] = rng.choice(n, m, replace=False)
    return seeds


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("q", [1, 7])
def test_bfs_distances_batch_matches_jax_and_oracle(seed, q, monkeypatch):
    src, dst, ps, pd, rng = _padded(seed)
    n = 256
    seeds = _seed_sets(rng, q, 4)
    # several edge slices per hop, as at 10M edges
    monkeypatch.setattr(pgk, "BATCH_STEP_PAIRS", 300 * q)
    got = pgk.bfs_distances_batch(torch.from_numpy(ps), torch.from_numpy(pd),
                                  torch.from_numpy(seeds), n, 4)
    assert got.shape == (q, n) and got.is_contiguous()
    want = jgk.bfs_distances_batch(jnp.asarray(ps), jnp.asarray(pd),
                                   jnp.asarray(seeds), n, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(q):
        mask = np.zeros(n, bool)
        mask[seeds[i][seeds[i] >= 0]] = True
        np.testing.assert_array_equal(got[i].numpy(),
                                      pgk.bfs_oracle(src, dst, mask, n, 4))


def _check_against_approx(pd_, pi, jd, ji):
    """JAX's approx selection: the same depths; below the last depth the
    same ids (as sets), at the last one any equal-depth ids."""
    pd_, pi, jd, ji = map(np.asarray, (pd_, pi, jd, ji))
    np.testing.assert_array_equal(pd_, jd)
    last = pd_.max(initial=0)
    assert set(pi[pd_ < last].tolist()) == set(ji[jd < last].tolist())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("limit", [1, 10, 50, 300])
def test_khop_select_exact_matches_jax(seed, limit):
    src, dst, ps, pd, rng = _padded(seed)
    n = 256
    seeds = np.zeros(n, bool)
    seeds[rng.choice(200, 2, replace=False)] = True
    dist = jgk.bfs_distances(jnp.asarray(ps), jnp.asarray(pd),
                             jnp.asarray(seeds), n, 5)
    alive = np.ones(n, bool)
    alive[rng.choice(n, 20, replace=False)] = False
    pd_, pi = pgk.khop_select(torch.from_numpy(np.array(dist)),
                              torch.from_numpy(alive), limit)
    assert pd_.dtype == pi.dtype == torch.int32
    jd, ji = jgk.khop_select(dist, jnp.asarray(alive), limit, exact=True)
    np.testing.assert_array_equal(pd_.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    jd2, ji2 = jgk.khop_select(dist, jnp.asarray(alive), limit)
    _check_against_approx(pd_, pi, jd2, ji2)
    # ties to the lower id: (depth, id) ascending
    pairs = list(zip(pd_.tolist(), pi.tolist()))
    assert pairs == sorted(pairs)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("limit", [5, 50])
def test_khop_bounded_and_batch_match_jax(seed, limit):
    src, dst, ps, pd, rng = _padded(seed)
    n = 256
    alive = np.ones(n, bool)
    alive[rng.choice(n, 10, replace=False)] = False
    seeds = _seed_sets(rng, 6, 3)
    bd, bi = pgk.khop_batch_bounded(
        torch.from_numpy(ps), torch.from_numpy(pd), torch.from_numpy(seeds),
        torch.from_numpy(alive), n, 4, limit)
    jd, ji = jgk.khop_batch_bounded(jnp.asarray(ps), jnp.asarray(pd),
                                    jnp.asarray(seeds), jnp.asarray(alive),
                                    n, 4, limit)
    assert bd.shape == (6, limit)
    for i in range(6):
        _check_against_approx(bd[i], bi[i], np.asarray(jd)[i],
                              np.asarray(ji)[i])
        sd, si = pgk.khop_bounded(
            torch.from_numpy(ps), torch.from_numpy(pd),
            torch.from_numpy(seeds[i]), torch.from_numpy(alive), n, 4, limit)
        np.testing.assert_array_equal(sd.numpy(), bd[i].numpy())
        np.testing.assert_array_equal(si.numpy(), bi[i].numpy())
        jsd, jsi = jgk.khop_bounded(jnp.asarray(ps), jnp.asarray(pd),
                                    jnp.asarray(seeds[i]), jnp.asarray(alive),
                                    n, 4, limit)
        _check_against_approx(sd, si, jsd, jsi)


# ---- GraphStore's device methods -----------------------------------------


def _stores(seed: int, n: int = 300, e: int = 1500):
    """The same graph in both packages' GraphStore: nodes in two files,
    power-law CALLS edges, an EXTENDS forest; one file tombstoned."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.minimum((n * rng.random(e) ** 3).astype(np.int64), n - 1)
    child = rng.choice(n, n // 10, replace=False)
    parent = np.minimum((n * rng.random(n // 10) ** 3).astype(np.int64),
                        n - 1)
    out = []
    for cls, etype, ent in ((GraphStore, EdgeType, EntityType),
                            (JGraph, JEdge, JEntity)):
        g = cls(device="cpu") if cls is GraphStore else cls()
        for f in range(2):
            g.add_nodes_bulk([f"m{f}.f{i}" for i in range(n // 2)],
                             ent.FUNCTION, f"m{f}.py")
        g.add_edges_bulk(src, dst, etype.CALLS)
        g.add_edges_bulk(child, parent, etype.EXTENDS)
        g.finalize()
        out.append(g)
    return out


def _host_prefix(g, seeds, hops, limit, reverse=False):
    """The host walk's (depth, id) prefix as an ordered list of pairs."""
    host = g.k_hop(seeds, EdgeType.CALLS, hops, reverse=reverse,
                   limit=limit)
    return sorted((d, v) for v, d in host.items())


def test_device_tensors_match_jax_and_are_cached():
    p, j = _stores(0)
    assert p._n_padded() == j._n_padded() == 1024
    for et in (EdgeType.CALLS, EdgeType.EXTENDS):
        for reverse in (False, True):
            ps, pd = p.device_edges(et, reverse=reverse)
            js, jd = j.device_edges(JEdge(et.value), reverse=reverse)
            assert ps.dtype == pd.dtype == torch.int32
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
            np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
            assert p.device_edges(et, reverse=reverse)[0] is ps
        np.testing.assert_array_equal(
            p.device_degree(et).numpy(),
            np.asarray(j.device_degree(JEdge(et.value))))
    np.testing.assert_array_equal(p.device_alive().numpy(),
                                  np.asarray(j.device_alive()))
    edges, alive = p.device_edges(EdgeType.CALLS), p.device_alive()
    assert p.device_alive() is alive
    p.remove_file_nodes("m1.py")
    p.finalize()
    assert p.device_edges(EdgeType.CALLS) is not edges
    assert p.device_alive() is not alive
    assert not p.device_alive()[150:300].any() and p.device_alive()[:150].all()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("limit", [None, 0, 1, 20, 50])
@pytest.mark.parametrize("reverse", [False, True])
def test_k_hop_device_equals_host_walk(seed, limit, reverse):
    p, j = _stores(seed)
    # tombstone a file: its nodes never surface, its edges are gone
    p.remove_file_nodes("m1.py")
    j.remove_file_nodes("m1.py")
    rng = np.random.default_rng(seed)
    for _ in range(3):
        seeds = rng.choice(150, 2, replace=False).tolist()
        got = p.k_hop(seeds, EdgeType.CALLS, 5, reverse=reverse,
                      device=True, limit=limit)
        pairs = [(d, v) for v, d in got.items()]
        if limit:   # the device path returns the prefix in order
            assert pairs == sorted(pairs)
        assert sorted(pairs) == _host_prefix(p, seeds, 5, limit, reverse)
        assert all(v < 150 for v in got)
        jgot = j.k_hop(seeds, JEdge.CALLS, 5, reverse=reverse, device=True,
                       limit=limit)
        assert sorted(jgot.values()) == sorted(got.values())
        if not limit:
            assert jgot == got


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("limit", [0, 10, 50])
def test_k_hop_batch_device_equals_host_walk(monkeypatch, seed, limit):
    p, j = _stores(seed)
    monkeypatch.setattr(GraphStore, "DEVICE_BFS_THRESHOLD", 0)
    monkeypatch.setattr(JGraph, "DEVICE_BFS_THRESHOLD", 0)
    rng = np.random.default_rng(10 + seed)
    sets = [rng.choice(300, int(rng.integers(1, 4)), replace=False).tolist()
            for _ in range(9)]
    got = p.k_hop_batch(sets, EdgeType.CALLS, 5, limit=limit, device=True)
    jgot = j.k_hop_batch(sets, JEdge.CALLS, 5, limit=limit, device=True)
    host = p.k_hop_batch(sets, EdgeType.CALLS, 5, limit=limit)
    assert len(got) == len(jgot) == len(host) == 9
    for s, a, b, h in zip(sets, got, jgot, host):
        assert sorted((d, v) for v, d in a.items()) == \
            sorted((d, v) for v, d in h.items()) == \
            _host_prefix(p, s, 5, limit)
        assert sorted(a.values()) == sorted(b.values())
        if limit <= 0:
            assert a == b


def test_k_hop_batch_below_threshold_stays_on_host():
    p, _ = _stores(0)
    assert p.n_edges(EdgeType.CALLS) < GraphStore.DEVICE_BFS_THRESHOLD
    _build.reset_launch_counts()
    out = p.k_hop_batch([[1], [2]], EdgeType.CALLS, 3, device=True)
    assert out == [p.k_hop([1], EdgeType.CALLS, 3, limit=50),
                   p.k_hop([2], EdgeType.CALLS, 3, limit=50)]
    assert p._device_edges == {}   # no device tensor was made


# ---- the selection's route, by shape --------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Kernel B's launches recorded, not made (no CUDA is touched): the
    wrappers take the CPU tensors as if they were on the card."""
    calls = []
    monkeypatch.setattr(scan, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(scan, "_sm_count", lambda device: 132)
    monkeypatch.setattr(scan, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(scan.MERGE_CANDIDATES, "launch",
                        lambda entry, *args: calls.append((entry, args)))
    _build.reset_launch_counts()
    yield calls
    assert set(_build.launch_counts().values()) == {0}


@pytest.mark.parametrize("q,n,k", [(1, 1000, 1), (1, 1 << 20, 10),
                                   (16, 1 << 20, 50), (128, 1 << 20, 512),
                                   (3, 500, 600)])
def test_select_topk_takes_kernel_b_up_to_512(recorded, q, n, k):
    fused = torch.zeros((q, n), dtype=torch.float32)
    s, i = prank._select_topk(fused, k)
    [(entry, args)] = recorded
    assert entry == "lt_merge_positions"
    assert args[:4] == (fused.data_ptr(), q, n, min(k, n))
    assert args[4] == scan.merge_splits(q, n, min(k, n), 132)
    assert s.shape == i.shape == (q, min(k, n))


@pytest.mark.parametrize("k", [513, 1 << 20])
def test_select_topk_past_512_is_stable_topk(recorded, k):
    fused = torch.from_numpy(np.random.default_rng(k).random(
        (2, 4096)).astype(np.float32))
    s, i = prank._select_topk(fused, k)
    assert recorded == []
    ws, wi = scan.stable_topk(fused, min(k, 4096))
    assert torch.equal(s, ws) and torch.equal(i, wi)


@pytest.mark.parametrize("limit,launched", [(50, True), (512, True),
                                            (0, False), (1024, False)])
def test_khop_select_route(recorded, limit, launched):
    """`k_hop_batch(device=True, limit<=0)` selects every padded node
    (1,024 here): past kernel B's 512, so `stable_topk`; bounded limits
    go through kernel B on the negated distances."""
    n = 1024
    dist = torch.full((4, n), UNREACHED, dtype=torch.int32)
    dist[:, :40] = 2
    alive = torch.ones(n, dtype=torch.bool)
    k = n if limit <= 0 else limit
    d, i = pgk.khop_select(dist, alive, k)
    assert bool(recorded) == launched
    if launched:
        [(entry, args)] = recorded
        assert entry == "lt_merge_positions" and args[1:4] == (4, n, k)
    else:
        assert d[:, :40].eq(2).all() and i[:, :40].equal(
            torch.arange(40, dtype=torch.int32).expand(4, -1))


def test_merge_positions_plain_is_merge_candidates_with_column_ids():
    """Kernel B's positional entry computes `merge_candidates` with the
    ids 0 ... m - 1; its plain version, `stable_topk`, equals that plain
    chain on the adversarial lists the card holds kernel B to."""
    for _name, s, _ids, k1 in merge_cases(0):
        cs = torch.from_numpy(s)
        ids = torch.arange(cs.shape[1], dtype=torch.int32).expand_as(
            cs).contiguous()
        a = scan.merge_positions(cs, k1)
        b = scan.merge_candidates_plain(cs, ids, k1)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
