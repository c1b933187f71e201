"""Graph statistics.

A copy of `lattice_tpu/graph/statistics.py`, its imports pointed at the port.

Parity target: reference `src/lattice/graph/statistics.py:18-67` — entity
counts via GET_STATS and per-project counts by path-prefix matching. The
counting Cypher becomes direct reads of the GraphStore's columnar tables.
"""

from __future__ import annotations

from collections import Counter

from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.index.graph_store import GraphStore


class GraphStatistics:
    def __init__(self, store: GraphStore):
        self.store = store

    def get_statistics(self) -> dict:
        """Reference: `statistics.py:18-32`."""
        return self.store.stats

    def get_project_statistics(self, path_prefix: str) -> dict:
        """Per-project counts by file-path prefix (reference `:34-67`)."""
        store = self.store
        node_ids = [
            nid for nid in range(store.n_nodes())
            if store._alive[nid]
            and store.node(nid).file_path.startswith(path_prefix)
        ]
        by_type = Counter(store.node(nid).entity_type.value for nid in node_ids)
        id_set = set(node_ids)
        edge_counts = {}
        for etype in EdgeType:
            src, dst = store.edges(etype)
            edge_counts[etype.value] = int(sum(
                1 for s, d in zip(src, dst)
                if int(s) in id_set or int(d) in id_set))
        return {
            "path_prefix": path_prefix,
            "nodes": len(node_ids),
            "by_type": dict(by_type),
            "edges": edge_counts,
            "files": len({store.node(nid).file_path for nid in node_ids}),
        }

    def degree_histogram(self, edge_type: EdgeType = EdgeType.CALLS,
                         buckets: tuple[int, ...] = (0, 1, 2, 5, 10, 25)
                         ) -> dict[str, int]:
        """TPU-native addition: degree distribution for centrality tuning."""
        store = self.store
        ids = [nid for nid in range(store.n_nodes()) if store._alive[nid]]
        degrees = store.degree(ids, edge_type)
        hist: Counter = Counter()
        for out_deg, in_deg in degrees:
            total = out_deg + in_deg
            label = None
            for i, b in enumerate(buckets):
                upper = buckets[i + 1] if i + 1 < len(buckets) else None
                if upper is None or b <= total < upper:
                    label = f"{b}+" if upper is None else f"{b}-{upper - 1}"
                    if total >= b and (upper is None or total < upper):
                        break
            hist[label or "0"] += 1
        return dict(hist)
