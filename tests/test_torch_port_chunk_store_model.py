"""Model-based differential test of the port's ChunkStore, on the CPU.

The port's mirror of `tests/test_chunk_store_model.py`: a random sequence
of add / remove / update / delete_file / compact steps on a
`ChunkStore(device="cpu")` must match a pure-NumPy model at every step,
through the freelist, compaction, the payload indexes and the validity
mask: after each step an exact search ("flat", or "refined": the widened
bf16 scan's plain version + exact rescore) equals brute-force cosine over
the model's live rows. Each step also checks the deep path's resident
rank columns: `device_rank_columns(graph)` equals the columns rebuilt
from scratch from the model's payloads and the graph (graph node id per
row, content quality, CALLS degree, the node -> rows CSR), is reused while
nothing changed, and is rebuilt after every mutation and after the graph
is re-finalized (new edges, a tombstoned file).
"""

import numpy as np
import pytest

from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.index.graph_store import GraphStore

DIM = 24
N_NODES = 24


def _norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


class Model:
    """Pure-Python mirror: row -> (vector, payload)."""

    def __init__(self):
        self.rows: dict[int, tuple[np.ndarray, dict]] = {}

    def search(self, q, k, filters=None):
        if not self.rows:
            return []
        ids = sorted(self.rows)
        mat = np.stack([self.rows[i][0] for i in ids])
        scores = _norm(np.atleast_2d(q))[0] @ mat.T
        if filters:
            keep = np.array([
                all(self.rows[i][1].get(f) == v for f, v in filters.items())
                for i in ids])
            scores = np.where(keep, scores, -np.inf)
        order = np.argsort(-scores, kind="stable")
        return [(ids[j], scores[j]) for j in order[:k]
                if scores[j] > -np.inf]

    def rank_columns(self, cap: int, graph: GraphStore):
        """The rank columns from scratch: (node_ids, quality, degree,
        indptr, indices)."""
        node_ids = np.full(cap, -1, np.int64)
        quality = np.zeros(cap, np.float32)
        for row, (_v, p) in self.rows.items():
            nid = graph.id_of(p.get("graph_node_id") or "")
            if nid is not None:
                node_ids[row] = nid
            n = len(p.get("content") or "")
            quality[row] = 1.0 if 80 <= n <= 4000 else (0.5 if n else 0.0)
        deg = graph.degree_vector(EdgeType.CALLS)
        degree = np.where(node_ids >= 0, deg[np.maximum(node_ids, 0)], 0)
        indptr = np.zeros(graph.n_nodes() + 1, np.int64)
        indices = []
        for nid in range(graph.n_nodes()):
            rows = [r for r in range(cap) if node_ids[r] == nid]
            indices += rows
            indptr[nid + 1] = indptr[nid] + len(rows)
        return node_ids, quality, degree, indptr, np.asarray(indices)


def _graph(rng) -> GraphStore:
    graph = GraphStore(device="cpu")
    _add_edges(graph, rng, 40)
    graph.finalize()
    return graph


def _add_edges(graph, rng, n):
    """(Re-)index the graph's files, reviving tombstoned nodes, and add n
    CALLS edges between live nodes."""
    for i in range(N_NODES):
        graph.add_node(f"pkg.n{i}", EntityType.FUNCTION, f"g{i % 3}.py")
    live = [i for i in range(graph.n_nodes()) if graph._alive[i]]
    for s, d in zip(rng.choice(live, n), rng.choice(live, n)):
        graph.add_edge(int(s), int(d), EdgeType.CALLS)


class TestChunkStoreModelBased:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_op_sequence_matches_model(self, seed):
        rng = np.random.default_rng(seed)
        store = ChunkStore(dim=DIM, dtype="float32", initial_capacity=16,
                           device="cpu")
        graph = _graph(rng)
        model = Model()
        files = [f"f{j}.py" for j in range(4)]
        langs = ["python", "javascript"]
        cols = {"last": None}

        def check(mutated: bool):
            q = rng.normal(size=DIM).astype(np.float32)
            filters = None
            if rng.random() < 0.4 and model.rows:
                filters = {"file_path": str(rng.choice(files))}
            method = "flat" if rng.random() < 0.5 else "refined"
            got = store.search(q, k=5, filters=filters, method=method)[0]
            want = model.search(q, k=5, filters=filters)
            assert [r for r, _, _ in got] == [r for r, _ in want], (
                f"step mismatch: got {[r for r, _, _ in got]} "
                f"want {[r for r, _ in want]}")
            for (_, gs, _), (_, ws) in zip(got, want):
                assert abs(gs - ws) < 1e-4
            rc = store.device_rank_columns(graph)
            if not mutated:
                assert rc is cols["last"]
            assert rc.generation == graph.generation
            node_ids, quality, degree, indptr, indices = \
                model.rank_columns(store.capacity, graph)
            np.testing.assert_array_equal(rc.node_ids.numpy(), node_ids)
            np.testing.assert_array_equal(rc.quality.numpy(), quality)
            np.testing.assert_array_equal(rc.degree.numpy(), degree)
            np.testing.assert_array_equal(rc.node_row_indptr, indptr)
            np.testing.assert_array_equal(rc.node_row_indices, indices)
            for nid in rng.choice(graph.n_nodes(), 3):
                (rows, depth) = rc.rows_for_nodes(np.asarray([nid]),
                                                  np.asarray([2]))
                assert sorted(rows.tolist()) == [
                    r for r in sorted(model.rows) if node_ids[r] == nid]
                assert (depth == 2).all()
            cols["last"] = rc

        check(True)
        for step in range(60):
            op = rng.random()
            if op < 0.4 or not model.rows:
                n = int(rng.integers(1, 4))
                vecs = rng.normal(size=(n, DIM)).astype(np.float32)
                pls = [{"file_path": str(rng.choice(files)),
                        "language": str(rng.choice(langs)),
                        "content_hash": f"h{step}-{i}",
                        "graph_node_id": f"pkg.n{rng.integers(0, 30)}",
                        "content": "x" * int(rng.integers(0, 200))}
                       for i in range(n)]
                ids = store.add(vecs, pls)
                for i, r in enumerate(ids):
                    model.rows[r] = (_norm(vecs[i:i + 1])[0], pls[i])
            elif op < 0.55:
                victims = list(rng.choice(sorted(model.rows),
                                          size=min(2, len(model.rows)),
                                          replace=False))
                store.remove(victims)
                for v in victims:
                    del model.rows[v]
            elif op < 0.7:
                f = str(rng.choice(files))
                store.delete_file(f)
                model.rows = {r: (v, p) for r, (v, p) in model.rows.items()
                              if p["file_path"] != f}
            elif op < 0.8 and model.rows:
                # update: re-embed an existing row via remove+add
                victim = int(rng.choice(sorted(model.rows)))
                old_payload = model.rows[victim][1]
                store.remove([victim])
                del model.rows[victim]
                vec = rng.normal(size=(1, DIM)).astype(np.float32)
                (rid,) = store.add(vec, [dict(old_payload,
                                              content_hash=f"u{step}")])
                model.rows[rid] = (
                    _norm(vec)[0],
                    dict(old_payload, content_hash=f"u{step}"))
            elif op < 0.88:
                remap = store.compact()
                model.rows = {remap.get(r, r): (v, p)
                              for r, (v, p) in model.rows.items()}
            elif op < 0.96:
                # the graph re-indexed: nodes back, new edges, a new
                # generation
                _add_edges(graph, rng, 5)
                graph.finalize()
            elif op < 0.98:
                # a graph file re-indexed: its nodes tombstoned
                graph.remove_file_nodes(f"g{rng.integers(0, 3)}.py")
                graph.finalize()
            else:
                check(False)   # nothing changed: the columns are reused
                continue
            check(True)
        assert len(store) == len(model.rows)
