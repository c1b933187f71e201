"""Edge-partitioned graph traversal over a mesh (torch port).

Port of `lattice_tpu/parallel/sharded_graph.py`: the multi-device tier of
the traversals the reference ran in Memgraph (`queries.py:2-50`
CALLS*1..k). The edge list of one relationship is row-sharded over the
mesh and the [N] frontier is replicated: for code graphs E >> N (every
call site is an edge), so the O(E) gather and scatter is what must shard,
while the frontier is small. One hop:

    local:    hits = count of reached sources per destination, on each
              shard's edges (`ops/graph_kernels._step`'s int32 scatter)
    exchange: the shards' [N] counts summed on the lead device (the
              reference's `psum`), `> 0` is the next frontier, sent back
              to each shard's device

`ops/graph_kernels.bfs_distances`, the single-device walk, is this
module's oracle in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_tpu_torch.ops import graph_kernels as gk
from lattice_tpu_torch.parallel.mesh import (DeviceMesh, make_mesh,
                                             row_sharded)

UNREACHED = gk.UNREACHED


class ShardedGraph:
    """Edge-partitioned multi-device view of one relationship's edge
    list."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 mesh: DeviceMesh | None = None):
        self.mesh = mesh or make_mesh()
        self.n_nodes = int(n_nodes)
        n_shards = len(self.mesh.row_devices)
        # pad with (0, 0) self-loops, idempotent under reachability, to a
        # shard multiple (row_sharded pads with them too)
        src, dst = gk.pad_edges(np.asarray(src, np.int32),
                                np.asarray(dst, np.int32),
                                bucket=max(n_shards, 8))
        self.src = row_sharded(self.mesh, torch.from_numpy(src))
        self.dst = row_sharded(self.mesh, torch.from_numpy(dst))

    def bfs_distances(self, seeds: np.ndarray, max_hops: int,
                      reverse: bool = False) -> np.ndarray:
        """[N] hop distances from the seed set (UNREACHED sentinel); the
        frontier is exchanged after every hop."""
        lead = self.mesh.lead
        reached = torch.from_numpy(np.asarray(seeds, dtype=bool)).to(lead)
        dist = torch.where(reached, 0, int(UNREACHED)).to(torch.int32)
        src, dst = ((self.dst, self.src) if reverse
                    else (self.src, self.dst))
        for hop in range(max_hops):
            on: dict[torch.device, torch.Tensor] = {}
            hits = [gk._step(on.setdefault(s.device, reached.to(s.device)),
                             s, d).to(torch.int32)
                    for s, d in zip(src, dst)]
            nxt = sum(h.to(lead, non_blocking=True) for h in hits) > 0
            dist = torch.where(nxt & ~reached, hop + 1, dist)
            reached = reached | nxt
        return dist.cpu().numpy()

    def k_hop(self, node_ids: list[int], max_hops: int,
              reverse: bool = False) -> dict[int, int]:
        """{node_id: depth} within `max_hops`, excluding seeds: the contract
        of `GraphStore.k_hop` (FIND_TRANSITIVE_* semantics)."""
        seeds = np.zeros(self.n_nodes, dtype=bool)
        if node_ids:
            seeds[np.asarray(node_ids, dtype=np.int64)] = True
        dist = self.bfs_distances(seeds, max_hops, reverse=reverse)
        hit = np.flatnonzero((dist > 0) & (dist < UNREACHED))
        return {int(i): int(dist[i]) for i in hit}
