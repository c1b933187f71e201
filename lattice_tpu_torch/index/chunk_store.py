"""Device-resident vector index with payload filtering (torch port).

Port of `lattice_tpu/index/chunk_store.py`. Rows are L2-normalized into a
`[capacity, d]` tensor (bf16 by default) on the store's device; deleted
rows go to a freelist and are masked out of search by the `[capacity]`
bool `valid` tensor, so deletion is O(1) and never reshapes the rows.
Payload fields keep host inverted indexes whose boolean row masks AND
into the validity mask of every plan.

Where JAX rebuilt arrays functionally (and needed a donated `jit` to
update the int8 shadow without a copy, `_fused_delta`), this store
updates its tensors in place with index assignment: `add`, `remove` and
`clear` write only the touched rows of `_emb`, `_valid` and the shadow.
A caller holding `device_arrays` therefore sees later mutations.

Search runs through the plan table (`_plan_search_impl`): on a CUDA
device the packed-int4 two-stage scan (`"int4"`, kernel D + B + exact
rescore, `ops/quant.Int4View`) when `LATTICE_INT4=1` asks for the
capacity tier; the IVF partition (`"ivf"`, the `ivf_probe` kernel + B
over the probed buckets, `ops/ivf.py`) for small batches on a large
clustered corpus whose self-measured recall clears `IVF_MIN_RECALL`;
otherwise the int8 two-stage scan (`"quantized"`, kernel C + B + exact
rescore) by default, the bf16 scan (`"pallas"`, kernel A + B + exact
rescore) when int8 is opted out or its shadow does not fit, and the plain
exact scan (`"flat"`) above k = 64 and on the CPU. A forced `"refined"`
is the widened bf16 scan with an exact rescore (`scan_topk.refined_topk`,
kernel A + B). `LATTICE_PQ=1` (the 8x-capacity mode) or a forced `"pq"`
serves the product-quantized view (`ops/pq.PQIndex`: a decode-and-score
of the uint8 codes, kernel B's two entries, then the exact rescore),
gated on its build-time self-measured recall like IVF. With
`LATTICE_SHARDED=1` and a mesh of more than one shard, the sharded plan
(`"sharded"`, `parallel/sharded_index.py`) serves from views whose rows
split over the mesh: the bf16 view (kernel A + B a shard, kernel B's
merge), or past the card memory's tiers the int8 or int4 view (kernel C
or D + B a shard, a rescore in each shard, the merge, then the exact
rescore against the store's rows). The store's mesh is every visible
device of its kind, or the one `parallel.mesh.default_mesh` sets for the
process (such as several logical shards on one card), which the graph
store and the engine's sharded deep branch read too.

`device_rank_columns(graph)` keeps the deep path's per-row columns (graph
node id, content quality, CALLS degree) on the store's device with a host
node -> rows CSR; every mutation and `_reset_views` marks them dirty, and
they rebuild on the next call or when `graph.generation` moves.

Every store lives on the device it is given, `"cuda"` by default; without
CUDA that default raises rather than landing on the CPU (the CPU is asked
for by name, as the tests do).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import threading
from typing import Any, Sequence

import numpy as np
import torch

from lattice_tpu_torch.core.errors import DEVICE_ERRORS, VectorStoreError
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.ops import scan_topk as scan_ops
from lattice_tpu_torch.ops import topk as topk_ops
from lattice_tpu_torch.ops.graph_kernels import csr_expand
from lattice_tpu_torch.parallel import mesh as mesh_ops
from lattice_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                      ShardedQuantizedIndex)
from lattice_tpu_torch.parallel.sharded_rank import ShardedHybridRank
from lattice_tpu_torch.utils.tracing import get_tracer

# every method string _plan_search_impl accepts; surfaces (HTTP, MCP)
# validate requests against this before minting per-config serving state
SEARCH_METHODS = ("auto", "flat", "pallas", "refined", "ivf", "pq",
                  "quantized", "int4", "sharded")

# Payload fields with inverted indexes (reference `embeddings/client.py:103-113`
# plus graph_node_id, the vector->graph join key used by the context builder).
INDEXED_FIELDS = ("file_path", "entity_type", "language", "content_hash",
                  "project_name", "graph_node_id")

# the plans served by the widened bf16 scan (kernel A + B + exact rescore)
_BF16_SCANS = {"pallas": scan_ops.binned_topk,
               "refined": scan_ops.refined_topk}


@dataclasses.dataclass(frozen=True)
class RankColumns:
    """Resident ranking columns (see `ChunkStore.device_rank_columns`)."""

    node_ids: torch.Tensor       # [cap] i32 graph node id per row (-1)
    quality: torch.Tensor        # [cap] f32 content-quality heuristic
    degree: torch.Tensor         # [cap] i32 CALLS degree centrality
    node_row_indptr: np.ndarray  # [n_nodes+1] host CSR: node -> rows
    node_row_indices: np.ndarray
    generation: int              # graph finalize generation it was built at

    def rows_for_nodes(self, node_ids: np.ndarray, *value_arrays
                       ) -> tuple[np.ndarray, ...]:
        """Vectorized node->rows expansion; each aligned per-node value
        array comes back repeated per row."""
        return csr_expand(self.node_row_indptr, self.node_row_indices,
                          node_ids, *value_arrays)


def _index_payload(inverted: dict, row: int, payload: dict) -> None:
    """Add one payload's indexed fields to an inverted-index dict (the
    single definition shared by add / from_device_arrays / compact)."""
    for f in INDEXED_FIELDS:
        v = payload.get(f)
        if v is not None:
            inverted[f].setdefault(v, set()).add(row)


# ---- lexical name tokens (retrieval-quality channel) -----------------------
# The golden eval exposed the gap: "drain the webhook delivery queue"
# missed DeliveryQueue.drain even though the query names the method —
# plain cosine over hash n-grams under-weights identifier matches, and
# the planner's entity extraction only fires on code-shaped tokens
# (CamelCase/snake_case), never plain words. These helpers split entity
# names into searchable word tokens for an IDF-weighted exact-token
# channel that complements the dense path (classic hybrid code search;
# the reference got a weak version implicitly via Qdrant payload match).

_CAMEL_SPLIT_RE = re.compile(
    r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")

_QUERY_STOPWORDS = frozenset(
    "the a an of to in for from by with and or is are was were does do did "
    "how what where who which when why show me find all any that this it "
    "its on at as be been has have had not no can could should would my "
    "our your their like using use used via into onto".split())


def _stem(w: str) -> str:
    """Light stemmer applied identically to name and query tokens —
    consistency is what matters, not linguistic correctness ("queue" and
    "queues" both landing on "queu" is a match). Folds plurals and the
    common verb suffixes so "byte count" finds humanize_bytes and
    "deliveries" finds DeliveryQueue."""
    for suf, rep in (("ization", "ize"), ("ational", "ate"),
                     ("ies", "y"), ("sses", "ss")):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            w = w[: -len(suf)] + rep
            break
    if w.endswith("ing") and len(w) > 5:
        w = w[:-3]
    elif w.endswith("ed") and len(w) > 4:
        w = w[:-2]
    elif (w.endswith("s") and len(w) > 3
          and not w.endswith(("ss", "us", "is"))):
        w = w[:-1]
    if w.endswith(("ize", "ise")) and len(w) > 5:
        w = w[:-3]
    if w.endswith("e") and len(w) > 4:
        w = w[:-1]
    return w


def name_token_set(name: str) -> frozenset[str]:
    """Word tokens of an entity name: last two dotted segments (method +
    class, or function + module), split on underscores and camelCase,
    lowercased, stemmed. `DeliveryQueue.drain` -> {delivery, queu,
    drain} (stemmed forms; queries stem the same way)."""
    if not isinstance(name, str):
        # payloads are arbitrary dicts; one non-string 'name' must not
        # crash the index rebuild (which would black out every vector
        # search through the engine's vector phase)
        name = str(name)
    toks: set[str] = set()
    for seg in name.split(".")[-2:]:
        for part in seg.replace("-", "_").split("_"):
            for w in _CAMEL_SPLIT_RE.split(part):
                w = _stem(w.lower())
                if len(w) >= 2:
                    toks.add(w)
    return frozenset(toks)


def query_token_set(text: str) -> frozenset[str]:
    """Lexical query tokens: words + identifier pieces, minus stopwords."""
    toks: set[str] = set()
    for raw in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", text):
        for part in raw.replace("-", "_").split("_"):
            for w in _CAMEL_SPLIT_RE.split(part):
                w = w.lower()
                if len(w) >= 2 and w not in _QUERY_STOPWORDS:
                    w = _stem(w)
                    if len(w) >= 2:
                        toks.add(w)
    return frozenset(toks)


logger = logging.getLogger(__name__)

# The int8 shadow plus the bf16 rows must leave a quarter of device memory
# for transients (`_plan_search_impl`).
SHADOW_MEMORY_FRACTION = 0.75
# ---- IVF thresholds of the auto plan (`_plan_search_impl`) -----------------
# IVF pays a one-time build (k-means, layout, recall self-measure) and then
# reads only nprobe buckets per query; below this corpus size a flat scan
# is cheap and the build never amortizes.
IVF_AUTO_MIN_ROWS = int(os.environ.get("LATTICE_IVF_MIN_ROWS", 131_072))
# Probe selection is not filter-aware: a filter matching under this fraction
# of live rows (or fewer than FILTER_MIN_MATCH_PER_K * k rows) starves the
# probed buckets -> a flat plan, which filters exactly.
IVF_MIN_FILTER_FRACTION = 0.05
IVF_FILTER_MIN_MATCH_PER_K = 50
# Serve through IVF only when its build-time self-measured recall@10 clears
# this bar (a near-isotropic corpus measures far below it).
IVF_MIN_RECALL = float(os.environ.get("LATTICE_IVF_MIN_RECALL", 0.9))
IVF_AUTO_NPROBE = int(os.environ.get("LATTICE_IVF_NPROBE", 8))
# The largest batch at which `search_device` through IVF beat the int8
# flat scan at 1M x 768 on an H100: every batch measured, B = 1 ... 256
# (PERF.md); larger batches were not measured.
IVF_SMALL_BATCH = int(os.environ.get("LATTICE_IVF_SMALL_BATCH", 256))
# Past this corpus size IVF serves at any batch: probe traffic is ~nprobe/C
# of the corpus (a crossover taken over from the JAX store, not yet measured
# on the card).
IVF_FLAT_CROSSOVER_ROWS = int(
    os.environ.get("LATTICE_IVF_CROSSOVER_ROWS", 2_000_000))
# An IVF build needs the padded buckets (max_load 2.0 = up to 2x the rows)
# beside the rows, plus ~1x for build transients, under this fraction of
# device memory.
IVF_MEMORY_FRACTION = 0.85
# Above this k the auto plan serves the exact flat scan (as in the JAX
# store); the scan kernels keep at most `scan_ops.MAX_K1` candidates.
KERNEL_MAX_K = 64
# The largest k at which the auto plan of a CUDA store takes "sharded": the
# int8 view's first stage then widens to 4 x 32 = `scan_ops.MAX_K1` a shard
# (the bf16 and int4 views keep shorter lists)
SHARDED_MAX_K = 32


def _torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise VectorStoreError(f"unknown dtype {dtype!r}")
    return dt


def _device(device: str | torch.device) -> torch.device:
    """The store's device, exactly as asked: "cuda" on a machine without
    CUDA raises rather than landing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise VectorStoreError(f"device {dev} requested but CUDA is not "
                               "available")
    return dev


class ChunkStore:
    def __init__(self, dim: int, dtype: str | torch.dtype = "bfloat16",
                 initial_capacity: int = 1024,
                 device: str | torch.device = "cuda"):
        if dim <= 0:
            raise VectorStoreError(f"bad dim {dim}")
        self.dim = dim
        self.dtype = _torch_dtype(dtype)
        self.device = _device(device)
        self._cap = max(int(initial_capacity), 8)
        self._emb = torch.zeros((self._cap, dim), dtype=self.dtype,
                                device=self.device)
        self._valid = torch.zeros((self._cap,), dtype=torch.bool,
                                  device=self.device)
        self._valid_host = np.zeros((self._cap,), dtype=bool)
        self._payloads: list[dict[str, Any] | None] = [None] * self._cap
        self._free: list[int] = []
        self._size = 0
        self._next = 0
        self._inverted: dict[str, dict[Any, set[int]]] = {f: {} for f in INDEXED_FIELDS}
        # serializes the lazy check-then-build of the int8 shadow: serving
        # surfaces drive searches from many threads
        self._serve_lock = threading.RLock()
        self._ivf = None           # lazily built IVF partition (ops/ivf.py)
        self._ivf_dirty = True
        self._ivf_mutations = 0    # rows churned since the last build
        self._quant = None         # int8 shadow (ops/quant.py)
        self._quant_dirty = True
        self._int4 = None          # packed-int4 shadow (4x capacity tier)
        self._int4_dirty = True
        self._pq = None            # uint8-code capacity tier (ops/pq.py)
        self._pq_dirty = True
        self._pq_mutations = 0
        self._rank_cols = None     # the deep path's resident columns
        self._rank_cols_dirty = True
        self._sharded = None       # row-sharded views (parallel/)
        self._sharded_dirty = True
        self._shardedq = None      # ... int8 or int4
        self._shardedq_dirty = True
        self._sharded_rank = None  # (columns, bits, mesh, view) of the rank
        self._lex_tokens = None    # name-token inverted index, lazy
        # (None = build on next lexical_candidates). Once built, add/
        # remove maintain it incrementally like _inverted; only row-id
        # moves (compact) and clear() fall back to a rebuild.

    @classmethod
    def from_device_arrays(cls, embeddings: torch.Tensor, valid: torch.Tensor,
                           payloads: Sequence[dict[str, Any]] | None = None
                           ) -> "ChunkStore":
        """Wrap an already-resident normalized matrix (read-mostly); the
        store lives on the matrix's device.

        Without `payloads`, rows share one empty payload sentinel and
        payload filtering is unavailable; mutation APIs require real
        payloads (`add` after attach works normally).
        """
        n, d = embeddings.shape
        # tiny initial alloc; the real tensors replace it immediately
        store = cls(dim=int(d), dtype=embeddings.dtype, initial_capacity=8,
                    device=embeddings.device)
        store._cap = int(n)
        store._emb = embeddings
        store._valid = valid.to(device=embeddings.device, dtype=torch.bool)
        store._valid_host = store._valid.cpu().numpy()
        live = np.flatnonzero(store._valid_host)
        if payloads is None:
            sentinel: dict[str, Any] = {}
            store._payloads = [None] * n
            for r in live:
                store._payloads[r] = sentinel
        else:
            if len(payloads) != n:
                raise VectorStoreError("payloads must cover every row")
            store._payloads = [dict(p) if store._valid_host[i] else None
                               for i, p in enumerate(payloads)]
            for r in live:
                _index_payload(store._inverted, int(r), store._payloads[r])
        store._size = int(len(live))
        store._next = int(n)
        return store

    @classmethod
    def from_numpy_state(cls, embeddings: np.ndarray, valid: np.ndarray,
                         payloads: Sequence[dict[str, Any] | None] | None,
                         *, dtype: str | torch.dtype,
                         device: str | torch.device) -> "ChunkStore":
        """A port store from a JAX store's state taken as numpy
        (`np.asarray(store._emb)`, `store._valid_host`, `store._payloads`).

        Rows are widened to f32 on the host (exact for bf16) and cast to
        `dtype` on `device`; row ids, `_next` and the payload index come
        out as `from_device_arrays` makes them."""
        emb = torch.from_numpy(np.array(embeddings, dtype=np.float32))
        emb = emb.to(device=_device(device), dtype=_torch_dtype(dtype))
        val = torch.from_numpy(np.asarray(valid, dtype=bool).copy())
        return cls.from_device_arrays(emb, val, payloads)

    # ---- capacity ------------------------------------------------------

    def __len__(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return self._cap

    def _grow(self, needed: int) -> None:
        new_cap = self._cap
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self._cap
        self._emb = torch.cat([self._emb, torch.zeros(
            (pad, self.dim), dtype=self.dtype, device=self.device)])
        self._valid = torch.cat([self._valid, torch.zeros(
            (pad,), dtype=torch.bool, device=self.device)])
        self._valid_host = np.concatenate(
            [self._valid_host, np.zeros((pad,), dtype=bool)])
        self._payloads.extend([None] * pad)
        self._cap = new_cap

    # ---- mutation ------------------------------------------------------

    def add(self, vectors: np.ndarray | torch.Tensor,
            payloads: Sequence[dict[str, Any]]) -> list[int]:
        """Insert normalized rows; returns assigned row ids.

        `vectors` may be a tensor on any device; it is normalized on the
        store's device without a host round trip.
        """
        on_device = isinstance(vectors, torch.Tensor)
        if on_device:
            if vectors.dim() == 1:
                vectors = vectors[None, :]
        else:
            vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.shape[1] != self.dim:
            raise VectorStoreError(
                f"dim mismatch: got {vectors.shape[1]}, store is {self.dim}")
        if len(payloads) != len(vectors):
            raise VectorStoreError("payloads/vectors length mismatch")
        n = len(vectors)
        if n == 0:
            return []
        rows: list[int] = []
        for _ in range(n):
            if self._free:
                rows.append(self._free.pop())
            else:
                rows.append(self._next)
                self._next += 1
        if self._next > self._cap:
            self._grow(self._next)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        if on_device:
            normed = topk_ops.l2_normalize_t(vectors.to(self.device))
        else:
            normed = torch.from_numpy(topk_ops.l2_normalize(vectors)).to(
                self.device)
        # under the serve lock: a shadow build snapshotting _emb must not
        # interleave with this read-modify-write of the shadow
        with self._serve_lock:
            self._emb[idx] = normed.to(self.dtype)
            self._valid[idx] = True
            for row, payload in zip(rows, payloads):
                self._valid_host[row] = True
                self._payloads[row] = dict(payload)
                _index_payload(self._inverted, row, payload)
                if self._lex_tokens is not None:  # incremental, like
                    # _inverted: never a rebuild on the serving path
                    for t in name_token_set(payload.get("name")
                                            or payload.get("graph_node_id")
                                            or ""):
                        self._lex_tokens.setdefault(t, set()).add(row)
            self._size += n
            self._mutate_views(rows, normed, idx)
        return rows

    def _mutate_views(self, rows: list[int], normed: torch.Tensor | None,
                      idx: torch.Tensor | None = None) -> None:
        with self._serve_lock:  # RLock: add() already holds it
            self._mutate_views_impl(rows, normed, idx)

    def _mutate_views_impl(self, rows: list[int],
                           normed: torch.Tensor | None,
                           idx: torch.Tensor | None) -> None:
        """O(delta) upkeep of the IVF partition, the int8/int4 shadows and
        the PQ view.

        `normed` is the new f32 normalized rows for inserts, None for
        removals. IVF: a hollow (recall-refused) index only counts the
        churn; a live one takes the rows in place (`insert` / `remove`).
        Centroids do not move, so past 20% churn either is marked dirty
        and the next planned search rebuilds it (re-measuring recall).

        int8 and int4: a live shadow that covers the rows re-quantizes the
        f32 input in place, as the JAX store's fused delta does
        (`_fused_delta_apply`), NOT the stored bf16 rows: after a delta the
        shadow holds rows of both histories, bit for bit as in JAX. Rows
        past a shadow (the store grew) mark it dirty for a full rebuild.
        Removals leave the shadows' values stale but masked by `valid`.
        PQ encodes the new rows with its frozen codebooks (or drops removed
        rows from its validity) and, like IVF, is marked dirty past 20%
        churn; a failure there marks it dirty too, except a kernel error,
        a CUDA out-of-memory or a path not ported (`DEVICE_ERRORS`), which
        raise. The sharded views write the delta rows on their shards (or
        invalidate them); a row past a view's capacity (the store grew)
        marks it dirty, and a failure does as PQ's. The rank columns are
        marked for a rebuild and the sharded rank view dropped either
        way."""
        n = len(rows)
        self._rank_cols_dirty = True
        self._sharded_rank = None
        if (self._ivf is not None and not self._ivf_dirty
                and self._ivf.hollow):
            # the refusal verdict stands until 20% churn re-measures it
            self._ivf_mutations += n
            if self._ivf_mutations > 0.2 * max(self._size, 1):
                self._ivf_dirty = True
        elif self._ivf is not None and not self._ivf_dirty:
            try:
                if normed is None:
                    self._ivf.remove(rows)
                else:
                    self._ivf.insert(normed, rows)
                self._ivf_mutations += n
                if self._ivf_mutations > 0.2 * max(self._size, 1):
                    self._ivf_dirty = True
            except Exception:
                # host bookkeeping failed: rebuild, never serve another plan
                logger.exception("incremental IVF update failed; rebuilding")
                self._ivf_dirty = True
        else:
            self._ivf_dirty = True
        if self._pq is not None and not self._pq_dirty:
            try:
                if normed is None:
                    self._pq.remove(rows)
                else:
                    self._pq.insert(normed, rows)
                self._pq_mutations += n
                # frozen codebooks drift like frozen centroids: rebuild
                # (re-training + re-measuring recall) past 20% churn
                if self._pq_mutations > 0.2 * max(self._size, 1):
                    self._pq_dirty = True
            except DEVICE_ERRORS:
                raise
            except Exception:
                logger.exception("incremental PQ update failed; rebuilding")
                self._pq_dirty = True
        for attr in ("_sharded", "_shardedq"):
            view, dirty = getattr(self, attr), attr + "_dirty"
            if view is None or getattr(self, dirty):
                setattr(self, dirty, True)
                continue
            try:
                if normed is None:
                    view.invalidate_rows(rows)
                elif not view.update_rows(normed, rows):
                    setattr(self, dirty, True)
            except DEVICE_ERRORS:
                raise
            except Exception:
                logger.exception("incremental sharded update failed; "
                                 "rebuilding")
                setattr(self, dirty, True)
        if normed is None:
            return
        if (self._quant is not None and not self._quant_dirty
                and max(rows) < self._quant.n):
            self._quant.update_rows(normed, idx)
        else:
            self._quant_dirty = True
        if (self._int4 is not None and not self._int4_dirty
                and max(rows) < self._int4.n):
            self._int4.update_rows(normed, idx)
        else:
            self._int4_dirty = True

    def _drop_row(self, row: int) -> None:
        payload = self._payloads[row]
        if payload is None:
            return
        if self._lex_tokens is not None:
            for t in name_token_set(payload.get("name")
                                    or payload.get("graph_node_id") or ""):
                bucket = self._lex_tokens.get(t)
                if bucket is not None:
                    bucket.discard(row)
                    if not bucket:
                        del self._lex_tokens[t]
        for f in INDEXED_FIELDS:
            v = payload.get(f)
            if v is not None:
                bucket = self._inverted[f].get(v)
                if bucket is not None:
                    bucket.discard(row)
                    if not bucket:
                        del self._inverted[f][v]
        self._payloads[row] = None
        self._valid_host[row] = False
        self._free.append(row)
        self._size -= 1

    def remove(self, rows: Sequence[int]) -> int:
        live = [r for r in rows if self._payloads[r] is not None]
        if not live:
            return 0
        self._valid[torch.as_tensor(live, dtype=torch.int64,
                                    device=self.device)] = False
        for r in live:
            self._drop_row(r)
        self._mutate_views(live, None)
        return len(live)

    def delete_by_filter(self, filters: dict[str, Any]) -> int:
        """Reference: delete points by filter (`embeddings/client.py:159`)."""
        rows = self._filter_rows(filters)
        return self.remove(sorted(rows))

    # Auto-compaction threshold: once tombstoned holes exceed this
    # fraction of a non-trivial capacity, every scan is paying double for
    # dead rows — rewrite the matrix densely.
    COMPACT_HOLE_FRACTION = 0.5
    COMPACT_MIN_CAPACITY = 4096

    def maybe_compact(self) -> dict[int, int] | None:
        """Compact when tombstoned holes (freelist rows — not the
        never-used tail of a geometric growth step) cross the threshold."""
        if (self._cap >= self.COMPACT_MIN_CAPACITY
                and len(self._free) > self.COMPACT_HOLE_FRACTION * self._cap):
            return self.compact()
        return None

    def compact(self) -> dict[int, int]:
        """Rewrite live rows contiguously; returns {old_row: new_row}.

        One gather on the device (no host round trip) into a fresh dense
        matrix, a rebuild of the payload/inverted state, and every derived
        view dropped. Row ids CHANGE — callers holding them must remap via
        the returned mapping.
        """
        live = np.flatnonzero(self._valid_host)
        n_live = len(live)
        mapping = {int(old): new for new, old in enumerate(live)}
        new_cap = 8
        while new_cap < max(n_live, 1):
            new_cap *= 2
        emb_new = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                              device=self.device)
        if n_live:
            emb_new[:n_live] = self._emb[torch.as_tensor(
                live, dtype=torch.int64, device=self.device)]
        valid_new = np.zeros(new_cap, dtype=bool)
        valid_new[:n_live] = True
        payloads_new: list[dict[str, Any] | None] = [None] * new_cap
        inverted_new: dict[str, dict[Any, set[int]]] = {
            f: {} for f in INDEXED_FIELDS}
        for new, old in enumerate(live):
            p = self._payloads[old]
            payloads_new[new] = p
            if p:
                _index_payload(inverted_new, new, p)
        self._emb = emb_new
        self._valid = torch.from_numpy(valid_new.copy()).to(self.device)
        self._valid_host = valid_new
        self._payloads = payloads_new
        self._inverted = inverted_new
        self._lex_tokens = None  # row ids moved; rebuild lazily
        self._cap = new_cap
        self._free = []
        self._next = n_live
        self._size = n_live
        # every derived view indexed by row id is now stale
        self._reset_views()
        return mapping

    def delete_file(self, file_path: str) -> int:
        return self.delete_by_filter({"file_path": file_path})

    def _reset_views(self) -> None:
        """Drop the derived serving views (IVF, the int8 and int4
        shadows, PQ, the sharded views, the rank columns); the next use
        rebuilds them lazily."""
        with self._serve_lock:  # a build mid-flight finishes first
            self._ivf = None
            self._ivf_dirty = True
            self._ivf_mutations = 0
            self._quant = None
            self._quant_dirty = True
            self._int4 = None
            self._int4_dirty = True
            self._pq = None
            self._pq_dirty = True
            self._pq_mutations = 0
            self._rank_cols = None
            self._rank_cols_dirty = True
            self._drop_sharded_views()

    def _drop_sharded_views(self) -> None:
        self._sharded = self._shardedq = self._sharded_rank = None
        self._sharded_dirty = self._shardedq_dirty = True

    def clear(self) -> None:
        self._valid.zero_()
        self._valid_host[:] = False
        self._payloads = [None] * self._cap
        self._free = []
        self._size = 0
        self._next = 0
        self._inverted = {f: {} for f in INDEXED_FIELDS}
        self._lex_tokens = None
        self._reset_views()

    def device_rank_columns(self, graph) -> RankColumns:
        """Resident per-row ranking columns + the node->rows join map.

        The row->node join (the `graph_node_id` payload key), the
        content-length quality heuristic (`query/ranking/scorer.py`) and
        the CALLS degree centrality are per-row constants between
        mutations; held on the store's device, they let the hybrid fuse
        run per query with only the sparse reach set crossing to the card.
        The host reverse CSR (node id -> row ids) expands BFS reach sets to
        rows with vectorized NumPy. Rebuilt after store mutations or a
        graph re-finalize (tracked by `graph.generation`)."""
        graph._ensure_final()
        gen = getattr(graph, "generation", 0)
        with self._serve_lock:
            return self._rank_cols_locked(graph, gen)

    def _rank_cols_locked(self, graph, gen: int) -> RankColumns:
        cached = self._rank_cols
        if (cached is None or self._rank_cols_dirty
                or cached.generation != gen):
            node_ids = np.full(self._cap, -1, dtype=np.int32)
            quality = np.zeros(self._cap, dtype=np.float32)
            for row, payload in enumerate(self._payloads):
                if payload is None:
                    continue
                qn = payload.get("graph_node_id")
                if qn:
                    nid = graph.id_of(qn)
                    if nid is not None:
                        node_ids[row] = nid
                n = len(payload.get("content") or "")
                quality[row] = 1.0 if 80 <= n <= 4000 else (0.5 if n else 0.0)
            # degree centrality as a ROW column (static per generation)
            deg_nodes = graph.degree_vector(EdgeType.CALLS)
            has = node_ids >= 0
            degree = np.zeros(self._cap, dtype=np.int32)
            degree[has] = deg_nodes[node_ids[has]]
            # reverse CSR: node id -> rows (multi-row nodes = _part{n})
            n_nodes = graph.n_nodes()
            counts = np.zeros(n_nodes + 1, dtype=np.int64)
            np.add.at(counts, node_ids[has] + 1, 1)
            indptr = np.cumsum(counts)
            order = np.argsort(node_ids[has], kind="stable")
            indices = np.flatnonzero(has)[order].astype(np.int32)
            self._rank_cols = RankColumns(
                node_ids=torch.from_numpy(node_ids).to(self.device),
                quality=torch.from_numpy(quality).to(self.device),
                degree=torch.from_numpy(degree).to(self.device),
                node_row_indptr=indptr,
                node_row_indices=indices,
                generation=gen,
            )
            self._rank_cols_dirty = False
        return self._rank_cols

    # ---- filters -------------------------------------------------------

    def lexical_candidates(self, tokens, limit: int = 32,
                           filters: dict[str, Any] | None = None,
                           min_name_cov: float = 0.0
                           ) -> list[tuple[int, float]]:
        """Rows whose entity-name tokens overlap `tokens`, scored by
        IDF-weighted name coverage in [0, 1] (1.0 = every token of the
        name appears in the query). The exact-identifier complement to
        the dense cosine channel — a query naming `DeliveryQueue.drain`
        in plain words surfaces it even when the embedding misses.

        Host-side sparse lookup by design (same measured split as the
        graph walks: token -> rows is a dict probe over a handful of
        tokens; no dense [corpus] work). The index builds lazily on
        first use and rebuilds after mutations (`_lex_tokens = None`)."""
        toks = {t.lower() for t in tokens}
        if not toks:
            return []
        with self._serve_lock:
            idx = self._lex_tokens
            if idx is None:
                idx = {}
                for row, p in enumerate(self._payloads):
                    if not p:
                        continue  # dead row or the empty shared sentinel
                    nm = p.get("name") or p.get("graph_node_id") or ""
                    for t in name_token_set(nm):
                        idx.setdefault(t, set()).add(row)
                self._lex_tokens = idx
        n = max(self._size, 1)
        # a token matching >5% of the corpus carries ~no signal and
        # would make this probe O(corpus); idf would discount it anyway
        df_cap = max(int(0.05 * n), 1000)
        # Compound-split fallback: a query token absent from the name
        # vocabulary may EMBED a vocabulary token ("autocomplete" names
        # TextIndex.complete; "unsubscribe" names subscribe). Probe the
        # longest suffix then longest prefix (>=4 chars) against the
        # index — O(len) dict lookups, no vocabulary scan — and ride it
        # at a 0.7 discount (the golden eval's one remaining total miss
        # was exactly this shape).
        weights: dict[str, float] = {t: 1.0 for t in toks}
        for t in toks:
            if t in idx or len(t) < 6:
                continue
            piece = None
            for i in range(1, len(t) - 3):          # longest suffix first
                if t[i:] in idx:
                    piece = t[i:]
                    break
            if piece is None:
                for i in range(len(t) - 1, 3, -1):  # longest prefix
                    if t[:i] in idx:
                        piece = t[:i]
                        break
            if piece is not None:
                weights[piece] = max(weights.get(piece, 0.0), 0.7)
        acc: dict[int, float] = {}
        q_den = 0.0   # total idf the query puts in play (known tokens)
        for t, w in weights.items():
            rows = idx.get(t)
            if not rows or len(rows) > df_cap:
                continue
            idf = w * math.log1p(n / len(rows))
            q_den += idf
            for r in rows:
                acc[r] = acc.get(r, 0.0) + idf
        if not acc:   # implies q_den == 0 too: acc entries add idf > 0
            return []
        allowed = self._filter_rows(filters) if filters else None
        out: list[tuple[int, float]] = []
        for r, num in acc.items():
            if allowed is not None and r not in allowed:
                continue
            p = self._payloads[r]
            if not p:
                continue
            ntoks = name_token_set(p.get("name")
                                   or p.get("graph_node_id") or "")
            den = sum(
                math.log1p(n / len(idx.get(t) or (0,))) for t in ntoks)
            if den <= 0:
                continue
            name_cov = min(num / den, 1.0)
            # Strong-name-hit consumers (the deep paths' binary match
            # slots) threshold on UNDEFLATED name coverage: a one-token
            # name fully spelled out inside a verbose query must not be
            # dropped because query coverage deflated its score.
            if name_cov < min_name_cov:
                continue
            # Query coverage breaks the tie name coverage can't: for
            # "how is the delivery queue implemented", Delivery and
            # DeliveryQueue BOTH have fully-covered names, but
            # DeliveryQueue explains more of the query. Half the score
            # rides on how much of the query's (idf-weighted) token
            # mass this name accounts for.
            query_cov = min(num / q_den, 1.0)
            out.append((r, name_cov * (0.5 + 0.5 * query_cov)))
        out.sort(key=lambda x: (-x[1], x[0]))
        return out[:limit]

    def _filter_rows(self, filters: dict[str, Any]) -> set[int]:
        """AND of per-field matches; values may be scalars or lists (OR)."""
        result: set[int] | None = None
        for f, value in filters.items():
            if f not in self._inverted:
                raise VectorStoreError(f"no payload index for field {f!r}")
            values = value if isinstance(value, (list, tuple, set)) else [value]
            hit: set[int] = set()
            for v in values:
                hit |= self._inverted[f].get(v, set())
            result = hit if result is None else (result & hit)
            if not result:
                return set()
        return result if result is not None else {
            i for i, p in enumerate(self._payloads) if p is not None}

    def filter_mask(self, filters: dict[str, Any] | None
                    ) -> torch.Tensor | None:
        if not filters:
            return None
        mask = np.zeros((self._cap,), dtype=bool)
        rows = self._filter_rows(filters)
        if rows:
            mask[np.fromiter(rows, dtype=np.int64)] = True
        return torch.from_numpy(mask).to(self.device)

    # ---- IVF ------------------------------------------------------------

    def build_ivf(self, n_clusters: int | None = None, iters: int = 10,
                  seed: int = 0, measure: bool = True,
                  max_load: float | None = 2.0):
        """Build (or rebuild) the IVF partition over the current live rows,
        on the store's device. Bucket ids are this store's row ids, so
        payloads are shared with the flat path. With `measure`, the build
        self-samples recall@10 against the exact scan: the number the auto
        plan gates on. max_load=2.0 caps bucket padding at ~2x."""
        from lattice_tpu_torch.ops.ivf import IVFIndex
        with self._serve_lock:
            self._ivf = IVFIndex.build_from_device(
                self._emb, self._valid_host.copy(), n_clusters=n_clusters,
                iters=iters, dtype=self.dtype, seed=seed, max_load=max_load)
            if measure:
                self._ivf.measure_recall(self._emb, self._valid,
                                         nprobe=IVF_AUTO_NPROBE)
            self._ivf_dirty = False
            self._ivf_mutations = 0
            return self._ivf

    def _ivf_ready(self) -> bool:
        """Fresh IVF whose measured recall clears the serving bar."""
        return (self._ivf is not None and not self._ivf_dirty
                and self._ivf.measured_recall is not None
                and self._ivf.measured_recall >= IVF_MIN_RECALL)

    def _serving_ivf(self):
        """The IVF partition to serve from, (re)built if it is missing,
        stale or hollow; captured under the lock, since `compact` and
        `clear` drop it."""
        with self._serve_lock:
            if self._ivf is None or self._ivf_dirty or self._ivf.hollow:
                self.build_ivf()
            return self._ivf

    def search_ivf(self, query_vectors: np.ndarray, k: int,
                   nprobe: int = 8,
                   filters: dict[str, Any] | None = None
                   ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        """ANN search through the IVF partition; payload filters fold into
        the bucket id table as a row mask (filtered rows score NEG_INF)."""
        if self._size == 0:
            return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
        ivf = self._serving_ivf()
        mask = self.filter_mask(filters)
        scores, ids = ivf.search(np.atleast_2d(query_vectors), k,
                                 nprobe, mask=mask)
        out: list[list[tuple[int, float, dict[str, Any]]]] = []
        for qi in range(len(scores)):
            hits = []
            for score, row in zip(scores[qi], ids[qi]):
                if row < 0 or score <= topk_ops.NEG_INF / 2:
                    continue
                payload = self._payloads[int(row)]
                if payload is not None:
                    hits.append((int(row), float(score), payload))
            out.append(hits)
        return out

    def adopt_ivf(self, ivf) -> None:
        """Attach a partition built elsewhere (`IVFIndex.restore`) as fresh."""
        with self._serve_lock:
            self._ivf = ivf
            self._ivf_dirty = False
            self._ivf_mutations = 0

    def _filter_selectivity_ok(self, filters: dict[str, Any] | None,
                               k: int) -> bool:
        """Probe selection is filter-blind; a very selective filter starves
        the probed buckets. A flat plan handles those exactly."""
        if not filters:
            return True
        matched = len(self._filter_rows(filters))
        return (matched >= IVF_FILTER_MIN_MATCH_PER_K * k
                and matched >= IVF_MIN_FILTER_FRACTION * max(self._size, 1))

    # ---- PQ -------------------------------------------------------------

    def build_pq(self, m: int | None = None, ksub: int = 256,
                 measure: bool = True):
        """Build (or rebuild) the PQ capacity view over the current live
        rows, on the store's device. uint8 codes at dsub=4 are 8x smaller
        than the bf16 rows. With `measure`, the build self-samples the
        RESCORED recall@10 (the number `_search_pq_device` serves), which
        gates the auto plan as IVF's does."""
        from lattice_tpu_torch.ops.pq import PQIndex
        with self._serve_lock:
            self._pq = PQIndex.build(self._emb, self._valid_host.copy(),
                                     m=m, ksub=ksub)
            if measure:
                self._pq.measure_recall(self._emb, self._valid_host,
                                        rescore=True)
            self._pq_dirty = False
            self._pq_mutations = 0
            return self._pq

    def _pq_ready(self) -> bool:
        return (self._pq is not None and not self._pq_dirty
                and self._pq.measured_recall is not None
                and self._pq.measured_recall >= IVF_MIN_RECALL)

    def search_pq(self, query_vectors: np.ndarray, k: int,
                  filters: dict[str, Any] | None = None
                  ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        """ADC search through the PQ codes + exact rescore; payload filters
        AND into the validity mask exactly as on the flat path."""
        if self._size == 0:
            return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
        q = torch.from_numpy(topk_ops.l2_normalize(
            np.atleast_2d(query_vectors))).to(self.device)
        scores, ids = self._search_pq_device(q, min(k, self._cap),
                                             self.filter_mask(filters))
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        out: list[list[tuple[int, float, dict[str, Any]]]] = []
        for qi in range(len(scores)):
            hits = []
            for score, row in zip(scores[qi], ids[qi]):
                if row < 0 or score <= topk_ops.NEG_INF / 2:
                    continue
                payload = self._payloads[int(row)]
                if payload is not None:
                    hits.append((int(row), float(score), payload))
            out.append(hits)
        return out

    def _search_pq_device(self, queries: torch.Tensor, k_eff: int,
                          mask: torch.Tensor | None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """PQ first stage widened to max(k, 32) + exact rescore against the
        resident rows (normalized queries in): PQ here buys scan bytes,
        not recall. The view is (re)built if missing or stale, and
        captured under the lock, since `compact` and `clear` drop it."""
        with self._serve_lock:
            if self._pq is None or self._pq_dirty:
                self.build_pq()
            pq = self._pq
        k1 = min(max(k_eff, 32), self._cap)
        s1, c1 = pq.search_device(queries, k1, mask=mask)
        return scan_ops._exact_rescore(queries, self._emb, s1, c1, k_eff)

    # ---- the sharded views (parallel/) ---------------------------------

    def _mesh_kind(self) -> str:
        return "cuda" if self._device_is_cuda() else self.device.type

    def _mesh_shards(self) -> int:
        """Row shards of the store's mesh, counted without building it."""
        return mesh_ops.visible_shards(self._mesh_kind())

    def _sharded_mesh(self, mesh=None) -> mesh_ops.DeviceMesh:
        return mesh if mesh is not None else mesh_ops.visible_mesh(
            self._mesh_kind())

    def to_sharded(self, mesh=None) -> ShardedIndex:
        """The rows split over the mesh with a top-k merge
        (`parallel/sharded_index.py`), copied from the device rows (no host
        round trip) and sized to the store's capacity, so that mutations
        stay O(delta) writes until the store itself grows."""
        return ShardedIndex(self._emb, self._valid,
                            mesh=self._sharded_mesh(mesh), dtype=self.dtype)

    def to_sharded_quantized(self, mesh=None, bits: int = 8
                             ) -> ShardedQuantizedIndex:
        """The quantized sharded view: `bits=8` halves the device memory of
        `to_sharded`, `bits=4` quarters it. Quantizes the stored rows a
        shard at a time on its device."""
        return ShardedQuantizedIndex(self._emb, self._valid,
                                     mesh=self._sharded_mesh(mesh), bits=bits)

    def sharded_hybrid(self, graph, mesh=None) -> ShardedHybridRank:
        """The sharded deep rank: the rows and the rank columns (CALLS
        degree, content quality) split together over the mesh
        (`parallel/sharded_rank.py`), at the tier `_sharded_quant_bits`
        picks. Cached on the rank columns, the tier and the mesh:
        `device_rank_columns` hands back new columns after any mutation or
        graph finalize, so the view is rebuilt exactly when they are."""
        with self._serve_lock:
            cols = self.device_rank_columns(graph)
            mesh = self._sharded_mesh(mesh)
            bits = self._sharded_quant_bits(mesh)
            cached = self._sharded_rank
            if (cached is not None and cached[0] is cols
                    and cached[1] == bits and cached[2] == mesh):
                return cached[3]
            view = ShardedHybridRank(self._emb, self._valid, cols.degree,
                                     cols.quality, mesh=mesh,
                                     dtype=self.dtype, bits=bits)
            self._sharded_rank = (cols, bits, mesh, view)
            return view

    def _sharded_quant_bits(self, mesh=None) -> int:
        """The tier of the sharded views by memory: 16 (the rows' dtype)
        while the bf16 rows a device holds take at most half its memory, 8
        past that, 4 past all of it, over the device the mesh loads most
        (logical shards that share a card add up). `LATTICE_SHARDED_BITS`
        = 16 / 8 / 4, or `LATTICE_SHARDED_INT8` = 1 / 0, force it."""
        forced = os.environ.get("LATTICE_SHARDED_BITS")
        if forced in ("16", "8", "4"):
            return int(forced)
        legacy = os.environ.get("LATTICE_SHARDED_INT8")
        if legacy in ("0", "1"):
            return 8 if legacy == "1" else 16
        mesh = self._sharded_mesh(mesh)
        per_shard = self._cap * self.dim * 2 / len(mesh.row_devices)
        load = max(n * per_shard / mesh_ops.device_memory_bytes(d)
                   for d, n in mesh_ops.shards_per_device(mesh).items())
        if load > 1:
            return 4
        if load > 0.5:
            return 8
        return 16

    def _sharded_view(self) -> ShardedIndex | ShardedQuantizedIndex:
        """The live sharded view at the memory tier on the store's mesh,
        (re)built only when dirty or on another mesh, captured under the
        lock."""
        with self._serve_lock:
            mesh = self._sharded_mesh()
            bits = self._sharded_quant_bits(mesh)
            if bits < 16:
                if (self._shardedq is None or self._shardedq_dirty
                        or self._shardedq.bits != bits
                        or self._shardedq.mesh != mesh):
                    self._shardedq = self.to_sharded_quantized(mesh, bits)
                    self._shardedq_dirty = False
                return self._shardedq
            if (self._sharded is None or self._sharded_dirty
                    or self._sharded.mesh != mesh):
                self._sharded = self.to_sharded(mesh)
                self._sharded_dirty = False
            return self._sharded

    def _sharded_search_rescored(self, raw: torch.Tensor, k_eff: int,
                                 mask: torch.Tensor | None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sharded plan on the store's device; raw queries in. The bf16
        view answers at its storage precision, as the flat scan does. The
        quantized views keep no full-precision rows (their capacity), but
        the store's rows are resident, so their merged candidates, widened
        to max(4k, 32) (int8) or max(8k, 32) (int4), rescore exactly
        against them: the two-stage design of the single-device tiers."""
        view = self._sharded_view()
        lead = view.mesh.lead
        q = raw.to(torch.float32).to(lead)
        if isinstance(view, ShardedIndex):
            s, i = view.search_device(q, k_eff, mask)
            return s.to(self.device), i.to(self.device)
        wide = min(max((4 if view.bits == 8 else 8) * k_eff, 32), self._cap)
        s1, c1 = view.search_device(q, wide, mask)
        # a NEG_INF slot may carry a pad row past the store's capacity
        c1 = c1.to(self.device).clamp(max=self._cap - 1)
        return scan_ops._exact_rescore(
            topk_ops.l2_normalize_t(raw.to(self.device)), self._emb,
            s1.to(self.device), c1, k_eff)

    # ---- queries -------------------------------------------------------

    def _quant_view(self):
        from lattice_tpu_torch.ops.quant import QuantizedView
        with self._serve_lock:
            if self._quant is None or self._quant_dirty:
                # quantizes the STORED rows (bf16 in a bf16 store), as the
                # JAX store's full shadow build does
                self._quant = QuantizedView(self._emb)
                self._quant_dirty = False
            return self._quant

    def _search_view_two_stage(self, view, query_vectors: np.ndarray, k: int,
                               rescore: bool,
                               filters: dict[str, Any] | None
                               ) -> list[list[tuple[int, float,
                                                    dict[str, Any]]]]:
        """Shared host entry for the quantized view's two-stage search."""
        if self._size == 0:
            return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
        q = topk_ops.l2_normalize(np.atleast_2d(query_vectors))
        mask = self.filter_mask(filters)
        valid = self._valid if mask is None else (self._valid & mask)
        scores, idx = view.search(
            q, valid, min(k, self._cap),
            full_precision=self._emb if rescore else None)
        out: list[list[tuple[int, float, dict[str, Any]]]] = []
        for qi in range(len(q)):
            hits = []
            for score, row in zip(scores[qi], idx[qi]):
                if score <= topk_ops.NEG_INF / 2:
                    continue
                payload = self._payloads[int(row)]
                if payload is not None:
                    hits.append((int(row), float(score), payload))
            out.append(hits)
        return out

    def search_quantized(self, query_vectors: np.ndarray, k: int,
                         rescore: bool = True,
                         filters: dict[str, Any] | None = None
                         ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        """Int8 first-stage scan (+ optional full-precision rescore).

        Half the bytes per scanned row of bf16 (ops/quant.py). Payload
        filters AND into the validity mask exactly as on the flat path.
        """
        if self._size == 0:
            return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
        return self._search_view_two_stage(self._quant_view(), query_vectors,
                                           k, rescore, filters)

    def _int4_view(self):
        from lattice_tpu_torch.ops.quant import Int4View
        with self._serve_lock:
            if self._int4 is None or self._int4_dirty:
                # quantizes the STORED rows, as the JAX store's build does
                self._int4 = Int4View(self._emb)
                self._int4_dirty = False
            return self._int4

    def search_int4(self, query_vectors: np.ndarray, k: int,
                    rescore: bool = True,
                    filters: dict[str, Any] | None = None
                    ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        """Packed-int4 first-stage scan (+ optional full-precision rescore).

        A quarter of the bytes per scanned row of bf16 (`ops/quant.
        Int4View`, kernel D). With the rows resident, as here, the widened
        candidates rescore exactly, so int4 buys scan bytes, not recall."""
        if self._size == 0:
            return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
        return self._search_view_two_stage(self._int4_view(), query_vectors,
                                           k, rescore, filters)

    def _device_is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _device_memory_bytes(self) -> int:
        return torch.cuda.get_device_properties(self.device).total_memory

    def _plan_search(self, batch: int, k_eff: int,
                     filters: dict[str, Any] | None,
                     method: str) -> str:
        if method != "auto" and method in SEARCH_METHODS:
            return method
        with self._serve_lock:
            return self._plan_search_impl(batch, k_eff, filters, method)

    def _plan_search_impl(self, batch: int, k_eff: int,
                          filters: dict[str, Any] | None,
                          method: str) -> str:
        """The dispatch decision table. Returns one of "sharded" | "pq" |
        "int4" | "ivf" | "quantized" | "pallas" | "flat" (method strings
        kept as the JAX store names them; serving keys on them).

        auto order, re-derived for the card:
        1. sharded   — LATTICE_SHARDED=1 with a mesh of more than one shard
           (the reference's `len(jax.devices()) > 1`): the default mesh on
           several cards, or the one `default_mesh` set; on a CUDA store only
           at k <= SHARDED_MAX_K (the kernels' lists; a longer k falls
           through). With one shard (one card, or the CPU) the flag falls
           through, as in the reference, and a forced "sharded" serves the
           exact flat scan, as there
        2. pq        — LATTICE_PQ=1 (the 8x-capacity mode), on either
           device, as in the JAX store: the first such call builds the PQ
           view (codebooks, codes, rescored recall self-measure) under the
           serve lock; "pq" only if its measured recall reaches
           IVF_MIN_RECALL, else the table falls through. On a CUDA store
           it also needs the first stage's max(k, 32) candidates within
           kernel B's lists (`scan_ops.MAX_K1_LONG`); a longer k falls
           through (to "flat"), where the reference serves any k
        3. flat      — the exact plain scan: k > 64, and every CPU store
        4. int4      — LATTICE_INT4=1 (the 4x-capacity mode) on a CUDA
           device at k <= 64: kernel D + B at 8k candidates + exact
           rescore. It comes before IVF, as in the JAX store: the operator
           asked for it because the corpus is at the memory limit, where an
           IVF build does not fit
        5. ivf       — CUDA device, k <= 64, >= IVF_AUTO_MIN_ROWS live rows,
           a batch of at most IVF_SMALL_BATCH (the crossover measured
           against "quantized" on the card) or a corpus of at least
           IVF_FLAT_CROSSOVER_ROWS, rows x (1 + 2 + 1) under 85% of device
           memory, and any filter matching enough rows. The first such
           call builds the partition (k-means, layout, recall self-measure
           through `IVFIndex.search`) under the serve lock; a build whose
           recall is under IVF_MIN_RECALL releases its buckets and keeps
           the verdict, so the plan falls through
        6. quantized — CUDA device, k <= 64, and the bf16 rows plus the
           int8 shadow take under 75% of device memory (total_memory),
           unless LATTICE_INT8=0; LATTICE_INT8=1 forces it on CUDA at
           k <= 64 (the auto plan never hands the kernels a k they refuse).
           Int8 first stage (kernel C + B) + exact rescore.
        7. pallas    — CUDA device, k <= 64: the bf16 scan (kernel A + B)
           + exact rescore, when int8 is opted out or does not fit
        A forced "refined" (the widened bf16 scan + exact rescore) or
        "int4" is served on either device, through the plain versions on
        the CPU.
        """
        if method != "auto" and method in SEARCH_METHODS:
            return method
        if method != "auto":
            raise VectorStoreError(f"unknown search method {method!r}")
        if (os.environ.get("LATTICE_SHARDED") == "1"
                and self._mesh_shards() > 1
                and (not self._device_is_cuda() or k_eff <= SHARDED_MAX_K)):
            return "sharded"
        if os.environ.get("LATTICE_PQ") == "1" and (
                not self._device_is_cuda()
                or max(k_eff, 32) <= scan_ops.MAX_K1_LONG):
            if self._pq is None or self._pq_dirty:
                self.build_pq()           # one-time; self-measures recall
            if self._pq_ready():
                return "pq"
        if not self._device_is_cuda() or k_eff > KERNEL_MAX_K:
            return "flat"
        if os.environ.get("LATTICE_INT4") == "1":
            return "int4"
        ivf_pays = (batch <= IVF_SMALL_BATCH
                    or self._size >= IVF_FLAT_CROSSOVER_ROWS)
        ivf_bytes = (self._cap * self.dim * self._emb.element_size()
                     * (1 + 2 + 1))
        ivf_fits = (ivf_bytes
                    < IVF_MEMORY_FRACTION * self._device_memory_bytes())
        if (self._size >= IVF_AUTO_MIN_ROWS and ivf_pays and ivf_fits
                and self._filter_selectivity_ok(filters, k_eff)):
            if self._ivf is None or self._ivf_dirty:
                self.build_ivf()          # one-time; self-measures recall
                if not self._ivf_ready():
                    # remember the refusal, free the corpus-sized buckets
                    self._ivf.release_buckets()
            if self._ivf_ready():
                return "ivf"
        if os.environ.get("LATTICE_INT8") == "1":
            return "quantized"
        resident = self._cap * self.dim * (self._emb.element_size() + 1)
        shadow_fits = (resident < SHADOW_MEMORY_FRACTION
                       * self._device_memory_bytes())
        if shadow_fits and os.environ.get("LATTICE_INT8") != "0":
            return "quantized"
        return "pallas"

    def _resolve_plan(self, batch: int, k_eff: int,
                      filters: dict[str, Any] | None, method: str) -> str:
        """The planned method. A forced kernel plan is served as asked: on
        a CUDA store past the kernels' candidate lists (k1 >
        `scan_ops.MAX_K1`, or 8k > `scan_ops.MAX_K1_LONG` for "int4", or
        max(k, 32) > `scan_ops.MAX_K1_LONG` for "pq", or a shard's first
        stage past its kernel's list for "sharded") the kernel's wrapper
        raises KernelError. Traced as the hot span `search.plan`."""
        with get_tracer().hot("search.plan"):
            return self._plan_search(batch, k_eff, filters, method)

    def _serves_sharded(self, plan: str) -> bool:
        return plan == "sharded" and self._mesh_shards() > 1

    def search(self, query_vectors: np.ndarray, k: int,
               filters: dict[str, Any] | None = None,
               method: str = "auto",
               ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        """Top-k cosine search. Returns per-query [(row, score, payload)].

        The kernel is picked by the `_plan_search` decision table; `method`
        forces a path ("flat"/"pallas"/"refined"/"quantized"/"int4"/"ivf"/
        "pq"/"sharded").
        Payload filters AND into the validity mask (every flat plan), fold
        into the bucket id table (ivf), or split with the rows (sharded).
        """
        if self._size == 0:
            q = np.atleast_2d(query_vectors)
            return [[] for _ in range(len(q))]
        q = topk_ops.l2_normalize(np.atleast_2d(query_vectors))
        k_eff = min(k, self._cap)
        plan = self._resolve_plan(len(q), k_eff, filters, method)
        if self._serves_sharded(plan):
            s, i = self._sharded_search_rescored(
                torch.from_numpy(np.ascontiguousarray(q)).to(self.device),
                k_eff, self.filter_mask(filters))
            return self._assemble_hits(len(q), s.cpu().numpy(),
                                       i.cpu().numpy())
        if plan == "ivf":
            return self.search_ivf(q, k_eff, nprobe=IVF_AUTO_NPROBE,
                                   filters=filters)
        if plan == "pq":
            return self.search_pq(q, k_eff, filters=filters)
        if plan == "quantized":
            return self.search_quantized(q, k_eff, filters=filters)
        if plan == "int4":
            return self.search_int4(q, k_eff, filters=filters)
        mask = self.filter_mask(filters)
        valid = self._valid if mask is None else (self._valid & mask)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        scan = _BF16_SCANS.get(plan, topk_ops.flat_topk)
        scores, idx = scan(qt, self._emb, valid, k_eff)
        return self._assemble_hits(len(q), scores.cpu().numpy(),
                                   idx.cpu().numpy())

    def search_device(self, queries: torch.Tensor, k: int,
                      filters: dict[str, Any] | None = None,
                      method: str = "auto"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Planned search that stays on the device: (scores [B, k] f32,
        row ids [B, k] i32) tensors on the store's device.

        The serving-loop / bench entry; raw (unnormalized) queries in.
        Same decision table as `search`; payload assembly is the caller's
        problem. Traced as the hot span `search.device`, whose self time is
        what its stages' spans leave: the filter mask, the view's lock and
        the validity mask.
        """
        with get_tracer().hot("search.device"):
            if self._size == 0:
                raise VectorStoreError("empty store has no device path")
            raw = queries.to(self.device)
            k_eff = min(k, self._cap)
            plan = self._resolve_plan(int(raw.shape[0]), k_eff, filters,
                                      method)
            mask = self.filter_mask(filters)
            if self._serves_sharded(plan):
                return self._sharded_search_rescored(raw, k_eff, mask)
            if plan == "ivf":
                return self._serving_ivf().search_device(
                    topk_ops.l2_normalize_t(raw), k_eff,
                    nprobe=IVF_AUTO_NPROBE, mask=mask)
            if plan == "pq":
                return self._search_pq_device(topk_ops.l2_normalize_t(raw),
                                              k_eff, mask)
            valid = self._valid if mask is None else (self._valid & mask)
            if plan == "quantized":
                return self._quant_view().search_device(
                    raw, valid, k_eff, full_precision=self._emb)
            if plan == "int4":
                return self._int4_view().search_device(
                    raw, valid, k_eff, full_precision=self._emb)
            if plan in _BF16_SCANS:
                return _BF16_SCANS[plan](raw, self._emb, valid, k_eff,
                                         normalize=True)
            return topk_ops.flat_topk(topk_ops.l2_normalize_t(raw),
                                      self._emb, valid, k_eff)

    def search_device_pipelined(self, queries: torch.Tensor, k: int,
                                chunk: int = 256,
                                filters: dict[str, Any] | None = None,
                                method: str = "auto"
                                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Bulk device search: `search_device` over ceil(B/chunk) query
        chunks, concatenated. (The JAX store ran the chunks inside one
        scanned execution to pay its dispatch cost once; here each chunk
        is a few launches on one stream.)

        The plan is made once, at `chunk`, and serves every slice, the
        short tail included: the JAX store padded the batch to whole
        chunks and planned at `chunk`, so one call never mixes plans."""
        if self._size == 0:
            raise VectorStoreError("empty store has no device path")
        plan = self._resolve_plan(chunk, min(k, self._cap), filters, method)
        outs = [self.search_device(queries[lo:lo + chunk], k, filters=filters,
                                   method=plan)
                for lo in range(0, int(queries.shape[0]), chunk)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _assemble_hits(self, n_queries: int, scores_np: np.ndarray,
                       idx_np: np.ndarray
                       ) -> list[list[tuple[int, float, dict[str, Any]]]]:
        out: list[list[tuple[int, float, dict[str, Any]]]] = []
        for qi in range(n_queries):
            hits = []
            for score, row in zip(scores_np[qi], idx_np[qi]):
                if score <= topk_ops.NEG_INF / 2:
                    break
                payload = self._payloads[int(row)]
                if payload is None:
                    continue
                hits.append((int(row), float(score), payload))
            out.append(hits)
        return out

    def scroll(self, filters: dict[str, Any] | None = None,
               limit: int = 100) -> list[tuple[int, dict[str, Any]]]:
        """Payload scan without scoring (reference scroll, `client.py:178-202`)."""
        rows = sorted(self._filter_rows(filters or {}))[:limit]
        return [(r, self._payloads[r]) for r in rows]

    def file_needs_update(self, file_path: str, content_hash: str) -> bool:
        """Hash-compare against stored payloads (reference `client.py:178-202`)."""
        rows = self._inverted["file_path"].get(file_path)
        if not rows:
            return True
        row = next(iter(rows))
        payload = self._payloads[row]
        return payload is None or payload.get("content_hash") != content_hash

    def payload(self, row: int) -> dict[str, Any] | None:
        return self._payloads[row]

    def get_vector(self, row: int) -> np.ndarray:
        return self._emb[row].to(torch.float32).cpu().numpy()

    @property
    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(embeddings, valid) device tensors for external kernels. They
        are the store's own tensors, updated in place by mutations."""
        return self._emb, self._valid

    @property
    def stats(self) -> dict:
        return {
            "points": self._size,
            "capacity": self._cap,
            "free_rows": len(self._free),
            "dim": self.dim,
            "dtype": str(self.dtype).removeprefix("torch."),
        }
