"""In-process code knowledge graph: node table + per-edge-type COO/CSR.

Port of `lattice_tpu/index/graph_store.py`: the node table (qualified
name <-> dense id, entity-type code, file id, lines, names), the
per-`EdgeType` edge lists that `finalize()` turns into sorted COO + CSR
(host NumPy), the host traversals (the C++ bounded BFS of
`utils/native.py`, else the NumPy CSR walk over `ops/graph_kernels.
csr_expand`), paths, search helpers and stats. Incremental updates:
`remove_file_nodes` tombstones a file's nodes and drops their edges;
`finalize()` rebuilds the CSR arrays.

The device methods (`device_edges`, `device_alive`, `device_degree`,
`k_hop(device=True)` and `k_hop_batch`'s device branch, over the frontier
ops of `ops/graph_kernels.py`) run on the store's device, `"cuda"` by
default, or on the one the caller names. The store builds and walks its
graph on the host without touching that device; the first device method
resolves it, and `"cuda"` without CUDA raises there rather than landing
on the CPU. Device tensors are cached per `finalize` generation.
`to_sharded` splits an edge type's list over a mesh
(`parallel/sharded_graph.py`): every visible device of the store's kind,
or the mesh `parallel.mesh.default_mesh` sets for the process (such as
several logical shards on one card; the chunk store reads the same).
With `LATTICE_SHARDED=1` and a mesh of more than one shard, `k_hop` walks
through it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from lattice_tpu_torch.core.errors import GraphError
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.ops import graph_kernels as gk
from lattice_tpu_torch.ops.graph_kernels import csr_expand
from lattice_tpu_torch.parallel.mesh import (DeviceMesh, visible_mesh,
                                             visible_shards)
from lattice_tpu_torch.parallel.sharded_graph import ShardedGraph


def _device(device: str | torch.device) -> torch.device:
    """A graph device, exactly as asked: "cuda" on a machine without CUDA
    raises rather than landing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise GraphError(f"device {dev} requested but CUDA is not available")
    return dev


@dataclass(slots=True)
class NodeRecord:
    """Materialized node view returned by queries."""

    node_id: int
    qualified_name: str
    name: str
    entity_type: EntityType
    file_path: str
    start_line: int = 0
    end_line: int = 0


@dataclass
class _EdgeSet:
    src: list[int] = field(default_factory=list)
    dst: list[int] = field(default_factory=list)

    # finalized arrays
    coo_src: np.ndarray | None = None
    coo_dst: np.ndarray | None = None
    indptr: np.ndarray | None = None        # CSR over sorted src
    rev_src: np.ndarray | None = None       # reverse COO (sorted by dst-as-src)
    rev_dst: np.ndarray | None = None
    rev_indptr: np.ndarray | None = None


class GraphStore:
    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = device       # of the device methods; resolved there
        self._ids: dict[str, int] = {}
        self._qns: list[str] = []
        self._names: list[str] = []
        self._types: list[int] = []
        self._file_ids: list[int] = []
        self._start_lines: list[int] = []
        self._end_lines: list[int] = []
        self._alive: list[bool] = []
        self._files: dict[str, int] = {}          # file path -> file id
        self._file_paths: list[str] = []
        self._file_nodes: dict[int, list[int]] = {}  # file id -> node ids
        self._edges: dict[EdgeType, _EdgeSet] = {e: _EdgeSet() for e in EdgeType}
        self._finalized = False
        self.generation = 0   # bumped each finalize; callers key caches on it
        self.project: str | None = None
        self._sharded_graphs: dict[EdgeType, ShardedGraph] = {}

    # ---- construction --------------------------------------------------

    def n_nodes(self) -> int:
        return len(self._qns)

    def n_edges(self, edge_type: EdgeType | None = None) -> int:
        if edge_type is not None:
            return len(self._edges[edge_type].src)
        return sum(len(es.src) for es in self._edges.values())

    def file_id(self, file_path: str) -> int:
        fid = self._files.get(file_path)
        if fid is None:
            fid = len(self._file_paths)
            self._files[file_path] = fid
            self._file_paths.append(file_path)
        return fid

    def file_path_of(self, file_id: int) -> str:
        return self._file_paths[file_id] if 0 <= file_id < len(self._file_paths) else ""

    def add_node(self, qualified_name: str, entity_type: EntityType,
                 file_path: str = "", start_line: int = 0,
                 end_line: int = 0, name: str | None = None) -> int:
        """Idempotent by qualified name (Cypher MERGE semantics,
        `graph/queries.py:88-137`)."""
        nid = self._ids.get(qualified_name)
        if nid is not None:
            # refresh position info on re-index
            if file_path:
                self._file_ids[nid] = self.file_id(file_path)
            if start_line:
                self._start_lines[nid] = start_line
                self._end_lines[nid] = end_line
            self._alive[nid] = True
            return nid
        nid = len(self._qns)
        self._ids[qualified_name] = nid
        self._qns.append(qualified_name)
        self._names.append(name if name is not None
                           else qualified_name.rsplit(".", 1)[-1])
        self._types.append(entity_type.code)
        fid = self.file_id(file_path) if file_path else -1
        self._file_ids.append(fid)
        self._start_lines.append(start_line)
        self._end_lines.append(end_line)
        self._alive.append(True)
        if fid >= 0:
            self._file_nodes.setdefault(fid, []).append(nid)
        self._finalized = False
        return nid

    def add_edge(self, src_id: int, dst_id: int, edge_type: EdgeType) -> None:
        es = self._edges[edge_type]
        es.src.append(src_id)
        es.dst.append(dst_id)
        self._finalized = False

    # ---- bulk construction (restore / synthetic corpora) ---------------

    def add_nodes_bulk(self, qualified_names: list[str],
                       entity_type: EntityType, file_path: str = ""
                       ) -> np.ndarray:
        """Append many NEW nodes in one pass (no per-node MERGE probing).

        The columnar equivalent of the reference's UNWIND batch MERGE
        (`graph/queries.py:229-323`) for the restore/bulk-build case where
        names are known fresh; duplicate qualified names raise.
        """
        seen: set[str] = set()
        for qn in qualified_names:
            if qn in self._ids or qn in seen:
                raise GraphError(f"bulk add of duplicate node: {qn}")
            seen.add(qn)
        start = len(self._qns)
        n = len(qualified_names)
        ids = np.arange(start, start + n, dtype=np.int64)
        self._ids.update(zip(qualified_names, ids.tolist()))
        self._qns.extend(qualified_names)
        self._names.extend(qn.rsplit(".", 1)[-1] for qn in qualified_names)
        self._types.extend([entity_type.code] * n)
        fid = self.file_id(file_path) if file_path else -1
        self._file_ids.extend([fid] * n)
        self._start_lines.extend([0] * n)
        self._end_lines.extend([0] * n)
        self._alive.extend([True] * n)
        if fid >= 0:
            self._file_nodes.setdefault(fid, []).extend(ids.tolist())
        self._finalized = False
        return ids

    def add_edges_bulk(self, src: np.ndarray, dst: np.ndarray,
                       edge_type: EdgeType) -> None:
        """Append an edge array in one pass (UNWIND-batch analog)."""
        es = self._edges[edge_type]
        es.src.extend(np.asarray(src, dtype=np.int64).tolist())
        es.dst.extend(np.asarray(dst, dtype=np.int64).tolist())
        self._finalized = False

    def id_of(self, qualified_name: str) -> int | None:
        nid = self._ids.get(qualified_name)
        if nid is not None and self._alive[nid]:
            return nid
        return None

    def node(self, node_id: int) -> NodeRecord:
        if not (0 <= node_id < len(self._qns)):
            raise GraphError(f"node id out of range: {node_id}")
        fid = self._file_ids[node_id]
        return NodeRecord(
            node_id=node_id,
            qualified_name=self._qns[node_id],
            name=self._names[node_id],
            entity_type=EntityType.from_code(self._types[node_id]),
            file_path=self.file_path_of(fid) if fid >= 0 else "",
            start_line=self._start_lines[node_id],
            end_line=self._end_lines[node_id],
        )

    def remove_file_nodes(self, file_path: str) -> int:
        """Tombstone all nodes of a file + drop their edges (watch mode).

        Reference: `graph/builder.py:75-84` delete_file_entities +
        `:86-143` delete CALLS for changed file.
        """
        fid = self._files.get(file_path)
        if fid is None:
            return 0
        doomed = set(self._file_nodes.get(fid, ()))
        for nid in doomed:
            self._alive[nid] = False
            self._ids.pop(self._qns[nid], None)
        for es in self._edges.values():
            keep = [i for i, (s, d) in enumerate(zip(es.src, es.dst))
                    if s not in doomed and d not in doomed]
            es.src = [es.src[i] for i in keep]
            es.dst = [es.dst[i] for i in keep]
        self._file_nodes[fid] = []
        self._finalized = False
        return len(doomed)

    # ---- finalization --------------------------------------------------

    def finalize(self) -> None:
        """Build sorted COO + CSR for every edge type."""
        n = self.n_nodes()
        for es in self._edges.values():
            src = np.asarray(es.src, dtype=np.int32)
            dst = np.asarray(es.dst, dtype=np.int32)
            if len(src):
                order = np.argsort(src, kind="stable")
                es.coo_src, es.coo_dst = src[order], dst[order]
                rorder = np.argsort(dst, kind="stable")
                es.rev_src, es.rev_dst = dst[rorder], src[rorder]
            else:
                es.coo_src = es.coo_dst = src
                es.rev_src = es.rev_dst = src
            es.indptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(es.indptr, es.coo_src + 1, 1)
            np.cumsum(es.indptr, out=es.indptr)
            es.rev_indptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(es.rev_indptr, es.rev_src + 1, 1)
            np.cumsum(es.rev_indptr, out=es.rev_indptr)
        # device tensors (edges, liveness, degree) and the sharded views
        # rebuild on next use
        self._device_edges = {}
        self._sharded_graphs = {}
        self._alive_np = None
        self.generation += 1
        self._finalized = True

    def _ensure_final(self) -> None:
        if not self._finalized:
            self.finalize()

    def edges(self, edge_type: EdgeType, reverse: bool = False
              ) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays; reversed edges swap direction."""
        self._ensure_final()
        es = self._edges[edge_type]
        if reverse:
            return es.rev_src, es.rev_dst
        return es.coo_src, es.coo_dst

    # ---- host traversal (CSR oracle + small-graph fast path) -----------

    def neighbors(self, node_ids: list[int], edge_type: EdgeType,
                  reverse: bool = False) -> list[list[int]]:
        self._ensure_final()
        es = self._edges[edge_type]
        indptr = es.rev_indptr if reverse else es.indptr
        indices = es.rev_dst if reverse else es.coo_dst
        out = []
        for nid in node_ids:
            lo, hi = int(indptr[nid]), int(indptr[nid + 1])
            out.append([int(v) for v in indices[lo:hi] if self._alive[v]])
        return out

    # Edge count beyond which BATCHED traversals (and path corridors in
    # their batched form) dispatch to the device frontier kernel. Measured
    # on v5e at 1M nodes / 10M edges (R3 phase B): the dense device pass
    # is gather/scatter-bound at ~1.5 s for a SINGLE query (XLA lowers
    # scalar gathers to a serial loop), but amortizes to ~21 ms/query at
    # Q=128 ([N, Q] frontiers gather full lane rows). Single-query k_hop
    # therefore always runs the vectorized host CSR walk — O(edges
    # touched), which for code-graph queries (bounded hops, 50-result
    # caps) is milliseconds even at 10M edges.
    DEVICE_BFS_THRESHOLD = 50_000

    def _alive_arr(self) -> np.ndarray:
        arr = getattr(self, "_alive_np", None)
        if arr is None or len(arr) != len(self._alive):
            arr = self._alive_np = np.asarray(self._alive, dtype=bool)
        return arr

    def _bfs_scratch_for(self, n: int):
        """Per-store epoch-marked visited scratch for the C++ BFS."""
        from lattice_tpu_torch.utils import native
        scratch = getattr(self, "_bfs_scratch", None)
        if scratch is None or scratch.n != n:
            scratch = self._bfs_scratch = native.BFSScratch(n)
        return scratch

    def _csr_view(self, edge_type: EdgeType, reverse: bool
                  ) -> tuple[np.ndarray, np.ndarray, int]:
        """(indptr, indices, n_nodes) for the requested direction —
        shared by the single and batch native walks so their CSR/limit
        semantics cannot diverge (r4 review finding)."""
        es = self._edges[edge_type]
        indptr = es.rev_indptr if reverse else es.indptr
        indices = es.rev_dst if reverse else es.coo_dst
        return indptr, indices, self.n_nodes()

    def _host_bfs(self, seed_ids: list[int], edge_type: EdgeType,
                  hops: int, reverse: bool = False, limit: int = 0
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Bounded CSR frontier expansion on the host.

        Returns (reached_ids, depths) EXCLUDING the seeds, depth-major
        with ids ascending within a depth. Primary path is the C++ walk
        (`native/lattice_native.cpp lattice_bfs_khop`): serving
        traversals stop at `limit` results (the Cypher ORDER BY depth
        LIMIT n tail), so per-query cost is dominated by per-hop
        small-array overhead, which C++ removes — ~4 ms/query NumPy ->
        microseconds at 1M nodes / 10M edges. The NumPy fallback is three
        vectorized primitives per hop (repeat/arange gather + unique),
        O(edges touched); both beat a dense device pass for single
        traversals. `limit<=0` traverses all `hops`.
        """
        self._ensure_final()
        indptr, indices, n = self._csr_view(edge_type, reverse)
        seeds32 = np.asarray([s for s in seed_ids if 0 <= s < n],
                             dtype=np.int32)
        if seeds32.size == 0 or len(indices) == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int32))
        from lattice_tpu_torch.utils import native
        nat = native.bfs_khop(
            indptr, indices, self._alive_arr().view(np.uint8), seeds32,
            hops, limit if limit else 0, self._bfs_scratch_for(n),
            out_cap=(limit if limit and limit > 0 else n))
        if nat is not None:
            return nat[0].astype(np.int64, copy=False), nat[1]
        dist = np.full(n, -1, dtype=np.int32)
        seeds = seeds32.astype(np.int64)
        dist[seeds] = 0
        frontier = seeds
        out_ids: list[np.ndarray] = []
        out_depths: list[np.ndarray] = []
        for hop in range(1, hops + 1):
            (nbrs,) = csr_expand(indptr, indices, frontier)
            if nbrs.size == 0:
                break
            nbrs = nbrs[dist[nbrs] < 0]
            if nbrs.size == 0:
                break
            nbrs = np.unique(nbrs)
            dist[nbrs] = hop
            out_ids.append(nbrs)
            out_depths.append(np.full(nbrs.size, hop, np.int32))
            frontier = nbrs
        if not out_ids:
            return (np.empty(0, np.int64), np.empty(0, np.int32))
        ids = np.concatenate(out_ids)
        depths = np.concatenate(out_depths)
        keep = self._alive_arr()[ids]
        return ids[keep], depths[keep]

    def _host_bfs_batch(self, seed_sets: list[list[int]],
                        edge_type: EdgeType, hops: int,
                        reverse: bool = False, limit: int = 0,
                        force_batch: bool = False
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Q bounded walks with `_host_bfs` semantics, one result pair
        per seed set.

        On hosts with cores to spare the Q walks run as ONE native call
        (OpenMP across queries, `lattice_bfs_khop_batch`); on small
        hosts the per-query loop serves — the batch entry measured
        SLOWER in-process with the TPU runtime on a 1-core box (7.4k vs
        16.3k walks/s, r4) because OpenMP contends for the core.
        `force_batch` pins the native batch path for parity tests.
        """
        self._ensure_final()
        if seed_sets and (force_batch
                          or (len(seed_sets) >= 4
                              and (os.cpu_count() or 1) > 2)):
            indptr, indices, n = self._csr_view(edge_type, reverse)
            clean = [[s for s in ss if 0 <= s < n] for ss in seed_sets]
            # limit<=0 (unbounded) would need out_cap=n, i.e. two dense
            # (Q, n) buffers up front (~1 GB at Q=128 / n=1M) — the
            # sequential walk allocates one (n,) pair at a time instead.
            if len(indices) and limit > 0:
                from lattice_tpu_torch.utils import native
                res = native.bfs_khop_batch(
                    indptr, indices, self._alive_arr().view(np.uint8),
                    clean, hops, limit, out_cap=limit)
                if res is not None:
                    return [(ids.astype(np.int64, copy=False), depths)
                            for ids, depths in res]
        return [self._host_bfs(ss, edge_type, hops, reverse=reverse,
                               limit=limit) for ss in seed_sets]

    def _mesh_shards(self) -> int:
        """Row shards of the store's mesh (`visible_mesh`: every visible
        device of its kind, or the mesh `default_mesh` set, which the chunk
        store's sharded plan reads too), counted without building it."""
        return visible_shards(torch.device(self.device).type)

    def _want_sharded(self) -> bool:
        """The sharded traversal tier: LATTICE_SHARDED=1 with a mesh of more
        than one shard (the opt-in of `ChunkStore.search`'s sharded
        plan)."""
        return (os.environ.get("LATTICE_SHARDED") == "1"
                and self._mesh_shards() > 1)

    def to_sharded(self, edge_type: EdgeType, mesh: DeviceMesh | None = None
                   ) -> ShardedGraph:
        """The edge list of `edge_type` split over the mesh (`mesh`, else
        the store's), the frontier exchanged each hop
        (`parallel/sharded_graph.py`). Cached per edge type until
        `finalize` or another mesh."""
        self._ensure_final()
        mesh = mesh or visible_mesh(torch.device(self.device).type)
        view = self._sharded_graphs.get(edge_type)
        if (view is None or view.n_nodes != self.n_nodes()
                or view.mesh != mesh):
            src, dst = self.edges(edge_type)
            view = ShardedGraph(src, dst, self.n_nodes(), mesh=mesh)
            self._sharded_graphs[edge_type] = view
        return view

    def _graph_device(self, device=None) -> torch.device:
        return _device(self.device if device is None else device)

    def device_edges(self, edge_type: EdgeType, reverse: bool = False,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident padded (src, dst) int32 edge tensors of one edge
        type, on the store's device or `device`. Built once per `finalize`
        generation and cached, so traversals never pay an O(E) upload per
        call; edge counts pad to geometric buckets with (0, 0) self-loops
        (`gk.pad_edges`)."""
        self._ensure_final()
        dev = self._graph_device(device)
        cache = self._device_edges
        ent = cache.get((edge_type, reverse, dev))
        if ent is None:
            src, dst = self.edges(edge_type, reverse=reverse)
            psrc, pdst = gk.pad_edges(src, dst, geometric=True)
            ent = (torch.from_numpy(psrc).to(dev),
                   torch.from_numpy(pdst).to(dev))
            cache[(edge_type, reverse, dev)] = ent
        return ent

    def device_alive(self, device=None) -> torch.Tensor:
        """[n_padded] bool liveness mask on the device, cached per finalize
        generation (tombstoned nodes must not surface from device
        traversals)."""
        self._ensure_final()
        dev = self._graph_device(device)
        cache = self._device_edges
        alive = cache.get(("alive", dev))
        if alive is None:
            host = np.zeros(self._n_padded(), dtype=bool)
            host[:self.n_nodes()] = self._alive
            alive = cache[("alive", dev)] = torch.from_numpy(host).to(dev)
        return alive

    def _n_padded(self) -> int:
        return gk.geometric_bucket(self.n_nodes())

    def degree_vector(self, edge_type: EdgeType) -> np.ndarray:
        """[n_nodes] i32 total (in+out) degree — the centrality signal of
        `GET_ENTITY_CENTRALITY` (`queries.py:314-329`)."""
        self._ensure_final()
        es = self._edges[edge_type]
        return (np.diff(es.indptr) + np.diff(es.rev_indptr)).astype(np.int32)

    def device_degree(self, edge_type: EdgeType, device=None) -> torch.Tensor:
        """[n_padded] int32 degree_vector on the device, cached per finalize
        generation (a device column for the fused hybrid rank)."""
        self._ensure_final()
        dev = self._graph_device(device)
        cache = self._device_edges
        ent = cache.get(("degree", edge_type, dev))
        if ent is None:
            deg = np.zeros(self._n_padded(), dtype=np.int32)
            deg[:self.n_nodes()] = self.degree_vector(edge_type)
            ent = cache[("degree", edge_type, dev)] = \
                torch.from_numpy(deg).to(dev)
        return ent

    def k_hop(self, node_ids: list[int], edge_type: EdgeType, hops: int,
              reverse: bool = False, device: bool | None = None,
              limit: int | None = None) -> dict[int, int]:
        """{node_id: depth} for nodes within `hops`, excluding the seeds.

        Semantics of FIND_TRANSITIVE_CALLERS/CALLEES (`queries.py:2-50`)
        with depth ordering. Serves through the vectorized host CSR walk
        (the measured-best path at every scale for single traversals —
        see DEVICE_BFS_THRESHOLD's note); `device=True` explicitly opts
        into the dense scatter-max frontier kernel
        (`ops/graph_kernels.bfs_distances`), which only pays off batched
        over many queries or huge reaches. `limit` caps the result to the
        `limit` shallowest reached nodes (the Cypher `ORDER BY depth
        LIMIT n` tail; `models.py:5-8` caps at 50) — on the device path
        this also bounds the readback to O(limit) instead of O(N).
        """
        self._ensure_final()
        if self._want_sharded():
            out = self.to_sharded(edge_type).k_hop(node_ids, hops,
                                                   reverse=reverse)
        elif device:
            # explicit opt-in only: the dense device pass re-scans all E
            # edges per hop and only pays off BATCHED (k_hop_batch)
            return self._k_hop_device(node_ids, edge_type, hops, reverse,
                                      limit)
        else:
            ids, depths = self._host_bfs(node_ids, edge_type, hops,
                                         reverse=reverse,
                                         limit=limit or 0)
            # limit<=0 means UNBOUNDED, matching _host_bfs/k_hop_batch
            # (a 0 used to trim every result away here)
            if limit and limit > 0 and len(ids) > limit:
                # discovery order is depth order; trim with id tiebreak
                order = np.lexsort((ids, depths))[:limit]
                ids, depths = ids[order], depths[order]
            return {int(v): int(d) for v, d in zip(ids, depths)}
        if limit and limit > 0 and len(out) > limit:
            out = dict(sorted(out.items(), key=lambda t: (t[1], t[0]))[:limit])
        return out

    def _k_hop_device(self, node_ids: list[int], edge_type: EdgeType,
                      hops: int, reverse: bool, limit: int | None = None
                      ) -> dict[int, int]:
        n_pad = self._n_padded()
        psrc, pdst = self.device_edges(edge_type, reverse=reverse)
        alive = self.device_alive()
        # seeds scatter on the device: the upload is O(seeds), not O(N)
        ids = torch.as_tensor(np.asarray(node_ids, dtype=np.int32),
                              device=psrc.device)
        if limit and limit > 0:
            # one selection on the device and an O(limit) readback; exact,
            # so the `limit` shallowest (depth, id) pairs come back as they
            # are (the reference widened 4x for approx_min_k)
            d, idx = gk.khop_bounded(psrc, pdst, ids, alive, n_pad, hops,
                                     min(limit, n_pad))
            d, idx = d.cpu().numpy(), idx.cpu().numpy()
            keep = d < int(gk.UNREACHED)
            return {int(v): int(dd) for dd, v in zip(d[keep], idx[keep])}
        seeds = gk._seed_rows(ids[None, :], n_pad)[:, 0]
        dist = gk.bfs_distances(psrc, pdst, seeds, n_pad,
                                hops).cpu().numpy()[:self.n_nodes()]
        reached = np.flatnonzero((dist > 0) & (dist < gk.UNREACHED))
        return {int(v): int(dist[v]) for v in reached if self._alive[v]}

    def k_hop_batch(self, seed_sets: list[list[int]], edge_type: EdgeType,
                    hops: int, reverse: bool = False, limit: int = 50,
                    device: bool = False) -> list[dict[int, int]]:
        """Batched traversals: Q independent seed sets.

        Default: the vectorized host CSR walk per query — measured 4 ms
        p50 at 1M nodes / 10M edges (R3), so 128 queries cost ~0.5 s
        serial. `device=True` answers all Q in ONE device execution
        (`ops/graph_kernels.bfs_distances_batch`, O(Q*limit) readback) —
        that pass re-scans all E edges per hop (~21 ms/query at Q=128 on
        v5e), so it only wins when most queries reach a large fraction
        of the graph (closures from hub seeds), where the host walk's
        O(touched) approaches O(E) anyway. Reference semantics: one Bolt
        round-trip per traversal (`graph_reasoning/engine.py:86-122`).

        The device branch selects each query's `limit` shallowest nodes
        exactly (kernel B on the card); `limit<=0` is unbounded and asks
        for every padded node, past kernel B's 512, so that selection is
        `stable_topk` (`gk.khop_select`, by shape alone)."""
        self._ensure_final()
        if not seed_sets:
            return []
        if (not device
                or self.n_edges(edge_type) < self.DEVICE_BFS_THRESHOLD):
            if not self._want_sharded():
                indptr, indices, n = self._csr_view(edge_type, reverse)
                clean = [[s for s in ss if 0 <= s < n] for ss in seed_sets]
                # limit<=0 (unbounded) falls to the per-query loop: the
                # native batch entry needs dense (Q, out_cap) buffers.
                if len(indices) and limit > 0:
                    from lattice_tpu_torch.utils import native
                    res = native.bfs_khop_batch(
                        indptr, indices, self._alive_arr().view(np.uint8),
                        clean, hops, limit, out_cap=limit)
                    if res is not None:
                        return [{int(v): int(d)
                                 for v, d in zip(ids, depths)}
                                for ids, depths in res]
            return [self.k_hop(s, edge_type, hops, reverse=reverse,
                               limit=limit) for s in seed_sets]
        n_pad = self._n_padded()
        psrc, pdst = self.device_edges(edge_type, reverse=reverse)
        alive = self.device_alive()
        s_max = max(len(s) for s in seed_sets)
        seed_arr = np.full((len(seed_sets), s_max), -1, dtype=np.int32)
        for i, s in enumerate(seed_sets):
            seed_arr[i, :len(s)] = s
        cap = n_pad if limit <= 0 else min(limit, n_pad)
        d, idx = gk.khop_batch_bounded(
            psrc, pdst, torch.from_numpy(seed_arr).to(psrc.device), alive,
            n_pad, hops, cap)
        d, idx = d.cpu().numpy(), idx.cpu().numpy()
        out = []
        for i in range(len(seed_sets)):
            keep = d[i] < int(gk.UNREACHED)
            out.append({int(v): int(dd)
                        for dd, v in zip(d[i][keep], idx[i][keep])})
        return out

    def degree(self, node_ids: list[int], edge_type: EdgeType) -> list[tuple[int, int]]:
        """[(out_degree, in_degree)] — `GET_ENTITY_CENTRALITY` (`queries.py:314-329`)."""
        self._ensure_final()
        es = self._edges[edge_type]
        out = []
        for nid in node_ids:
            o = int(es.indptr[nid + 1] - es.indptr[nid])
            i = int(es.rev_indptr[nid + 1] - es.rev_indptr[nid])
            out.append((o, i))
        return out

    def _path_corridor(self, src_id: int, dst_id: int, edge_type: EdgeType,
                       max_len: int) -> set[int] | None:
        """Set of nodes lying on SOME src->dst path of length <= max_len
        (the dense-device analog is `ops/graph_kernels.nodes_on_paths`;
        the sparse host BFS is faster for single pairs — R3 phase B);
        None when the graph is below the device threshold (plain DFS is
        fine there). Bounds host path enumeration to the corridor instead
        of the whole frontier fan-out at 10M-edge scale."""
        if self.n_edges(edge_type) < self.DEVICE_BFS_THRESHOLD:
            return None
        f_ids, f_d = self._host_bfs([src_id], edge_type, max_len)
        fwd = dict(zip(f_ids.tolist(), f_d.tolist()))
        fwd[src_id] = 0
        b_ids, b_d = self._host_bfs([dst_id], edge_type, max_len,
                                    reverse=True)
        bwd = dict(zip(b_ids.tolist(), b_d.tolist()))
        bwd[dst_id] = 0
        return {v for v, df in fwd.items()
                if v in bwd and df + bwd[v] <= max_len}

    def shortest_path(self, src_id: int, dst_id: int, edge_type: EdgeType,
                      max_len: int = 10) -> list[int] | None:
        """One shortest path (FIND_CALL_CHAIN, `queries.py:52-67`).

        Large graphs first compute the device corridor; the host BFS then
        expands only corridor nodes (O(corridor) instead of O(frontier
        fan-out))."""
        self._ensure_final()
        corridor = self._path_corridor(src_id, dst_id, edge_type, max_len)
        if corridor is not None and (src_id not in corridor
                                     or dst_id not in corridor):
            return None
        prev: dict[int, int] = {src_id: -1}
        frontier = [src_id]
        for _ in range(max_len):
            nxt = []
            for u in frontier:
                for v in self.neighbors([u], edge_type)[0]:
                    if corridor is not None and v not in corridor:
                        continue
                    if v not in prev:
                        prev[v] = u
                        if v == dst_id:
                            path = [v]
                            while prev[path[-1]] != -1:
                                path.append(prev[path[-1]])
                            return list(reversed(path))
                        nxt.append(v)
            frontier = nxt
            if not frontier:
                break
        return None

    def all_paths(self, src_id: int, dst_id: int, edge_type: EdgeType,
                  max_len: int = 5, max_paths: int = 20) -> list[list[int]]:
        """Bounded path enumeration (FIND_ALL_PATHS, `queries.py:69-86`).

        Device kernels compute the on-path corridor for big graphs
        (`ops/graph_kernels.nodes_on_paths`); enumeration itself is
        host-side DFS restricted to the corridor (irregular output stays
        on the host, the pruning runs on the MXU-fed frontier kernels).
        """
        self._ensure_final()
        corridor = self._path_corridor(src_id, dst_id, edge_type, max_len)
        if corridor is not None and (src_id not in corridor
                                     or dst_id not in corridor):
            return []
        paths: list[list[int]] = []
        stack: list[tuple[int, list[int]]] = [(src_id, [src_id])]
        while stack and len(paths) < max_paths:
            u, path = stack.pop()
            if u == dst_id:
                paths.append(path)
                continue
            if len(path) > max_len:
                continue
            for v in self.neighbors([u], edge_type)[0]:
                if corridor is not None and v not in corridor:
                    continue
                if v not in path:  # simple paths
                    stack.append((v, path + [v]))
        return paths

    # ---- search helpers ------------------------------------------------

    def find_by_name(self, name: str) -> list[int]:
        """Exact simple-name or qualified-name match."""
        out = [i for i, (nm, alive) in enumerate(zip(self._names, self._alive))
               if alive and nm == name]
        nid = self.id_of(name)
        if nid is not None and nid not in out:
            out.append(nid)
        return out

    def find_fuzzy(self, text: str, limit: int = 10) -> list[tuple[int, float]]:
        """CASE-scored contains-match (FIND_ENTITY_FUZZY, `queries.py:281-312`)."""
        text_l = text.lower()
        scored: list[tuple[int, float]] = []
        for i, (nm, qn, alive) in enumerate(zip(self._names, self._qns, self._alive)):
            if not alive:
                continue
            nml, qnl = nm.lower(), qn.lower()
            if nml == text_l:
                score = 1.0
            elif qnl == text_l:
                score = 0.95
            elif nml.startswith(text_l):
                score = 0.8
            elif text_l in nml:
                score = 0.6
            elif text_l in qnl:
                score = 0.4
            else:
                continue
            scored.append((i, score))
        scored.sort(key=lambda t: (-t[1], self._qns[t[0]]))
        return scored[:limit]

    def nodes_in_file(self, file_path: str) -> list[int]:
        fid = self._files.get(file_path)
        if fid is None:
            return []
        return [nid for nid in self._file_nodes.get(fid, ()) if self._alive[nid]]

    def methods_of_class(self, class_id: int) -> list[int]:
        """FIND_CLASS_WITH_METHODS (`queries.py:130-160`)."""
        return self.neighbors([class_id], EdgeType.DEFINES_METHOD)[0]

    @property
    def stats(self) -> dict:
        """GET_STATS analog (`graph/queries.py:217-226`)."""
        from collections import Counter
        type_counts = Counter(
            EntityType.from_code(t).value
            for t, alive in zip(self._types, self._alive) if alive
        )
        return {
            "nodes": sum(self._alive),
            "files": len(self._file_paths),
            "edges": {e.value: self.n_edges(e) for e in EdgeType},
            "by_type": dict(type_counts),
        }
