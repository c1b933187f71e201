"""Structural protocols decoupling domain logic from storage and providers.

Parity target: reference `src/lattice/core/protocols.py:10-71`. These are
the testable seams: the NumPy oracle index and the device index both satisfy
`VectorStore`; the hash embedder and the UniXcoder Flax model both satisfy
`Embedder`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable, Protocol, Sequence, TypeVar, runtime_checkable

T = TypeVar("T")


@runtime_checkable
class Embedder(Protocol):
    """Reference: `core/protocols.py:10`."""

    @property
    def dimensions(self) -> int: ...

    def embed(self, text: str) -> Sequence[float]: ...

    def embed_batch(self, texts: Sequence[str]) -> Sequence[Sequence[float]]: ...


@runtime_checkable
class LLMProvider(Protocol):
    """Reference: `core/protocols.py:22`."""

    async def complete(self, messages: Sequence[dict], **kwargs: Any) -> str: ...


@runtime_checkable
class GraphBackend(Protocol):
    """Graph store seam (reference `GraphClient`, `core/protocols.py:30`).

    The reference's protocol speaks Cypher; ours speaks typed traversal
    primitives that both the NumPy oracle and the device CSR kernels provide.
    """

    def neighbors(self, node_ids: Sequence[int], edge_type: str,
                  reverse: bool = False) -> list[list[int]]: ...

    def k_hop(self, node_ids: Sequence[int], edge_type: str, hops: int,
              reverse: bool = False) -> Any: ...

    def degree(self, node_ids: Sequence[int], edge_type: str) -> Any: ...


@runtime_checkable
class VectorStore(Protocol):
    """Reference: `core/protocols.py:42`."""

    def add(self, ids: Sequence[int], vectors: Any, payloads: Sequence[dict]) -> None: ...

    def search(self, query_vectors: Any, k: int, filters: dict | None = None) -> Any: ...

    def remove(self, ids: Sequence[int]) -> int: ...

    def __len__(self) -> int: ...


@runtime_checkable
class ProgressCallback(Protocol):
    """Reference: `core/protocols.py:52`."""

    def __call__(self, progress: Any) -> None: ...


@runtime_checkable
class Chunker(Protocol):
    """Reference: `core/protocols.py:58`."""

    def chunk_file(self, parsed_file: Any) -> list[Any]: ...


@runtime_checkable
class TokenCounter(Protocol):
    """TPU-native addition: seam between the C++ BPE counter and the
    pure-Python fallback (replaces the tiktoken dependency at
    `embeddings/chunker.py:50`)."""

    def count(self, text: str) -> int: ...


@runtime_checkable
class Repository(Protocol[T]):
    """Generic persistence seam. Reference: `core/protocols.py:64`."""

    async def get(self, key: str) -> T | None: ...

    async def put(self, key: str, value: T) -> None: ...

    async def delete(self, key: str) -> bool: ...

    async def list(self) -> Iterable[T]: ...


@runtime_checkable
class FileSource(Protocol):
    """Seam over the filesystem scanner for tests."""

    def scan(self) -> Iterable[Any]: ...

    def read(self, path: Path) -> str: ...
