"""Bounded caches and the function registry.

Parity target: reference `src/lattice/core/cache.py:15-240`:
- `BoundedCache`: LRU with max-entry and approximate-memory caps + hit/miss stats.
- `ASTCache`: bounded cache keyed by path holding parsed ASTs.
- `FunctionRegistry`: qualified-name -> entity-type map with three indexes
  (exact dict, simple-name -> set of QNs, and a trie over dotted segments
  for prefix queries/removal).

Redesigned rather than copied: memory estimation samples value sizes instead
of walking every entry, and the registry additionally hands out dense int32
ids so entities can live as rows of device arrays (GraphStore node table).
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict
from typing import Generic, Hashable, Iterable, Iterator, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class BoundedCache(Generic[K, V]):
    """LRU cache bounded by entry count and approximate memory.

    Reference: `core/cache.py:15-99`.
    """

    def __init__(self, max_entries: int = 1024, max_memory_mb: float = 256.0):
        self.max_entries = max_entries
        self.max_memory_bytes = int(max_memory_mb * 1024 * 1024)
        self._data: OrderedDict[K, V] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._approx_bytes = 0

    @staticmethod
    def _sizeof(value: object) -> int:
        try:
            return sys.getsizeof(value)
        except TypeError:
            return 256

    def get(self, key: K, default: V | None = None) -> V | None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._hits += 1
                return self._data[key]
            self._misses += 1
            return default

    def put(self, key: K, value: V) -> None:
        with self._lock:
            if key in self._data:
                self._approx_bytes -= self._sizeof(self._data[key])
                self._data.move_to_end(key)
            self._data[key] = value
            self._approx_bytes += self._sizeof(value)
            while len(self._data) > self.max_entries or (
                self._approx_bytes > self.max_memory_bytes and len(self._data) > 1
            ):
                _, evicted = self._data.popitem(last=False)
                self._approx_bytes -= self._sizeof(evicted)

    def remove(self, key: K) -> bool:
        with self._lock:
            if key in self._data:
                self._approx_bytes -= self._sizeof(self._data[key])
                del self._data[key]
                return True
            return False

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._approx_bytes = 0

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._data),
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": (self._hits / total) if total else 0.0,
                "approx_bytes": max(self._approx_bytes, 0),
            }


class ASTCache(BoundedCache):
    """Cache of parsed ASTs keyed by file path. Reference: `core/cache.py:102`."""

    def __init__(self, max_entries: int = 512, max_memory_mb: float = 512.0):
        super().__init__(max_entries=max_entries, max_memory_mb=max_memory_mb)


class _TrieNode:
    __slots__ = ("children", "terminal")

    def __init__(self) -> None:
        self.children: dict[str, _TrieNode] = {}
        self.terminal: bool = False


class FunctionRegistry:
    """Qualified-name registry with exact, simple-name, and trie prefix indexes.

    Reference: `core/cache.py:113-240` (`find_by_simple_name` :180,
    `find_with_prefix` :190, `remove_by_prefix` :215).

    TPU-native addition: `id_of()` assigns dense, stable int ids on first
    registration so qualified names map to rows of device-side node arrays.
    """

    def __init__(self) -> None:
        self._exact: dict[str, str] = {}           # qualified_name -> entity_type
        self._by_simple: dict[str, set[str]] = {}  # simple name -> {qualified_name}
        self._root = _TrieNode()
        self._ids: dict[str, int] = {}             # qualified_name -> dense id
        self._names: list[str] = []                # dense id -> qualified_name

    def __len__(self) -> int:
        return len(self._exact)

    def __contains__(self, qualified_name: str) -> bool:
        return qualified_name in self._exact

    def register(self, qualified_name: str, entity_type: str) -> int:
        """Register a QN; returns its dense id (stable across re-registration)."""
        if qualified_name not in self._exact:
            simple = qualified_name.rsplit(".", 1)[-1]
            self._by_simple.setdefault(simple, set()).add(qualified_name)
            node = self._root
            for seg in qualified_name.split("."):
                node = node.children.setdefault(seg, _TrieNode())
            node.terminal = True
        self._exact[qualified_name] = entity_type
        if qualified_name not in self._ids:
            self._ids[qualified_name] = len(self._names)
            self._names.append(qualified_name)
        return self._ids[qualified_name]

    def id_of(self, qualified_name: str) -> int | None:
        return self._ids.get(qualified_name)

    def name_of(self, dense_id: int) -> str | None:
        if 0 <= dense_id < len(self._names):
            return self._names[dense_id]
        return None

    def get_type(self, qualified_name: str) -> str | None:
        return self._exact.get(qualified_name)

    # Reference API name (`core/cache.py:160`)
    def lookup(self, qualified_name: str) -> str | None:
        return self.get_type(qualified_name)

    def find_by_simple_name(self, simple_name: str) -> list[str]:
        """All registered QNs whose last segment matches. Reference `:180`."""
        return sorted(self._by_simple.get(simple_name, ()))

    def find_with_prefix(self, prefix: str) -> list[str]:
        """All registered QNs under a dotted prefix. Reference `:190`."""
        node = self._root
        segs = prefix.split(".") if prefix else []
        for seg in segs:
            node = node.children.get(seg)
            if node is None:
                return []
        out: list[str] = []
        self._collect(node, segs, out)
        return sorted(out)

    def _collect(self, node: _TrieNode, segs: list[str], out: list[str]) -> None:
        if node.terminal:
            out.append(".".join(segs))
        for seg, child in node.children.items():
            segs.append(seg)
            self._collect(child, segs, out)
            segs.pop()

    def remove_by_prefix(self, prefix: str) -> int:
        """Remove every QN under a dotted prefix; returns count. Reference `:215`.

        Dense ids of removed names are retired (never reused) so device
        arrays referencing them stay consistent until the next compaction.
        """
        doomed = self.find_with_prefix(prefix)
        for qn in doomed:
            self._remove_one(qn)
        return len(doomed)

    def remove(self, qualified_name: str) -> bool:
        if qualified_name not in self._exact:
            return False
        self._remove_one(qualified_name)
        return True

    def _remove_one(self, qn: str) -> None:
        self._exact.pop(qn, None)
        simple = qn.rsplit(".", 1)[-1]
        bucket = self._by_simple.get(simple)
        if bucket is not None:
            bucket.discard(qn)
            if not bucket:
                del self._by_simple[simple]
        # Prune trie path.
        segs = qn.split(".")
        stack: list[tuple[_TrieNode, str]] = []
        node = self._root
        for seg in segs:
            nxt = node.children.get(seg)
            if nxt is None:
                return
            stack.append((node, seg))
            node = nxt
        node.terminal = False
        while stack and not node.terminal and not node.children:
            parent, seg = stack.pop()
            del parent.children[seg]
            node = parent

    def all_names(self) -> Iterator[str]:
        return iter(self._exact)

    def items(self) -> Iterable[tuple[str, str]]:
        return self._exact.items()

    @property
    def stats(self) -> dict:
        return {
            "entities": len(self._exact),
            "simple_names": len(self._by_simple),
            "dense_ids": len(self._names),
        }
