"""Model-based differential test of the port's `GraphStore`: random
graph mutations against a pure-Python mirror.

Mirror of `tests/test_graph_store_model.py` (random add_node / add_edge /
remove_file_nodes / refinalize transitions, with k_hop, neighbors and
degree checked against the model at every step: the watch-mode churn,
where file rewrites delete and re-add whole node cohorts) against
`lattice_tpu_torch.index.graph_store.GraphStore(device="cpu")`. After
each mutation the device caches are checked too, since watch mode
re-indexes in place: `device_edges` (both directions) holds exactly the
surviving edges, then (0, 0) pads; `device_alive` the model's liveness;
`device_degree` the host degree vector, which counts at least the
model's edges; each rebuilt once per `finalize` generation. The device
walk (`k_hop(device=True)`) equals the model as the host walk does.
"""

from collections import deque

import numpy as np
import pytest
import torch

from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.graph_store import GraphStore


class Model:
    def __init__(self):
        self.alive: set[int] = set()
        self.file_of: dict[int, str] = {}
        self.edges: set[tuple[int, int]] = set()

    def k_hop(self, seeds, hops, reverse=False):
        adj: dict[int, list[int]] = {}
        for s, d in self.edges:
            if s in self.alive and d in self.alive:
                a, b = (d, s) if reverse else (s, d)
                adj.setdefault(a, []).append(b)
        dist = {s: 0 for s in seeds if s in self.alive}
        dq = deque(dist)
        while dq:
            u = dq.popleft()
            if dist[u] == hops:
                continue
            for v in adj.get(u, ()):
                if v not in dist:
                    dist[v] = dist[u] + 1
                    dq.append(v)
        return {v: d for v, d in dist.items() if d > 0}

    def neighbors(self, node, reverse=False):
        out = set()
        for s, d in self.edges:
            if s in self.alive and d in self.alive:
                if reverse and d == node:
                    out.add(s)
                elif not reverse and s == node:
                    out.add(d)
        return out


def check_device_caches(g: GraphStore, model: Model, generation: int):
    """The device tensors after a mutation and `finalize`: built anew for
    this generation, and equal to the host state and the model."""
    assert g.generation == generation
    n = g.n_nodes()
    for reverse in (False, True):
        hs, hd = (np.asarray(a) for a in g.edges(EdgeType.CALLS,
                                                 reverse=reverse))
        dsrc, ddst = g.device_edges(EdgeType.CALLS, reverse=reverse)
        assert dsrc.device.type == ddst.device.type == "cpu"
        assert dsrc.dtype == ddst.dtype == torch.int32
        assert len(dsrc) == len(ddst) >= len(hs)
        assert np.array_equal(dsrc[:len(hs)].numpy(), hs)
        assert np.array_equal(ddst[:len(hs)].numpy(), hd)
        assert not bool(dsrc[len(hs):].any() or ddst[len(hs):].any())
        pairs = set(zip(dsrc[:len(hs)].tolist(), ddst[:len(hs)].tolist()))
        assert pairs == ({(d, s) for s, d in model.edges} if reverse
                         else model.edges)
    alive = g.device_alive()
    assert alive.dtype == torch.bool and len(alive) >= n
    assert alive[:n].tolist() == [i in model.alive for i in range(n)]
    assert not bool(alive[n:].any())
    deg = g.device_degree(EdgeType.CALLS)
    assert np.array_equal(deg[:n].numpy(), g.degree_vector(EdgeType.CALLS))
    assert not bool(deg[n:].any())
    for v in model.alive:
        assert int(deg[v]) >= len(model.neighbors(v)) + len(
            model.neighbors(v, reverse=True)) - ((v, v) in model.edges)
    # cached within the generation
    assert g.device_edges(EdgeType.CALLS)[0] is \
        g.device_edges(EdgeType.CALLS)[0]
    assert g.device_alive() is alive


class TestGraphStoreModelBased:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_mutation_sequence_matches_model(self, seed):
        rng = np.random.default_rng(seed)
        g = GraphStore(device="cpu")
        model = Model()
        files = [f"f{j}.py" for j in range(3)]
        counter = [0]

        def check():
            if not model.alive:
                return
            seeds = list(rng.choice(sorted(model.alive),
                                    size=min(2, len(model.alive)),
                                    replace=False))
            seeds = [int(s) for s in seeds]
            hops = int(rng.integers(1, 4))
            rev = bool(rng.random() < 0.5)
            got = g.k_hop(seeds, EdgeType.CALLS, hops=hops, reverse=rev,
                          limit=0)
            want = model.k_hop(seeds, hops, reverse=rev)
            assert got == want, (seeds, hops, rev)
            assert g.k_hop(seeds, EdgeType.CALLS, hops=hops, reverse=rev,
                           device=True) == want, (seeds, hops, rev)
            (nbrs,) = g.neighbors([seeds[0]], EdgeType.CALLS,
                                  reverse=rev)
            assert set(int(x) for x in nbrs) == model.neighbors(
                seeds[0], reverse=rev)
            o, i = g.degree([seeds[0]], EdgeType.CALLS)[0]
            assert o >= len(model.neighbors(seeds[0]))
            assert i >= len(model.neighbors(seeds[0], reverse=True))

        for step in range(40):
            op = rng.random()
            if op < 0.5 or not model.alive:
                f = str(rng.choice(files))
                nid = g.add_node(f"m.fn{counter[0]}",
                                 EntityType.FUNCTION, f)
                counter[0] += 1
                model.alive.add(nid)
                model.file_of[nid] = f
                # wire 0-3 random edges touching the new node
                for _ in range(int(rng.integers(0, 4))):
                    other = int(rng.choice(sorted(model.alive)))
                    if rng.random() < 0.5:
                        g.add_edge(nid, other, EdgeType.CALLS)
                        model.edges.add((nid, other))
                    else:
                        g.add_edge(other, nid, EdgeType.CALLS)
                        model.edges.add((other, nid))
            else:
                f = str(rng.choice(files))
                g.remove_file_nodes(f)
                dead = {n for n, ff in model.file_of.items() if ff == f}
                model.alive -= dead
                for n in dead:
                    del model.file_of[n]
                # removed nodes' edges are gone PERMANENTLY — a freelist
                # id reuse must not resurrect them
                model.edges = {(s, d) for s, d in model.edges
                               if s not in dead and d not in dead}
            g.finalize()
            check_device_caches(g, model, generation=step + 1)
            check()
