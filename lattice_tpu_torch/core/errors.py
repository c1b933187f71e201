"""Exception hierarchy for lattice-tpu.

Parity target: reference `src/lattice/core/errors.py:1-77` — a tree rooted
at one base error, each subclass carrying structured context plus an
optional chained `cause`.
"""

from __future__ import annotations

from typing import Any


class LatticeError(Exception):
    """Base error. Reference analog: `CodeRAGError` (`core/errors.py:1`)."""

    def __init__(self, message: str, *, cause: Exception | None = None, **context: Any):
        super().__init__(message)
        self.message = message
        self.cause = cause
        self.context = context

    def __str__(self) -> str:
        parts = [self.message]
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in self.context.items() if v is not None)
            if ctx:
                parts.append(f"({ctx})")
        if self.cause is not None:
            parts.append(f"caused by: {type(self.cause).__name__}: {self.cause}")
        return " ".join(parts)


# Back-compat alias matching the reference's public name.
CodeRAGError = LatticeError


class ConfigurationError(LatticeError):
    """Invalid or missing configuration (`core/errors.py:8`)."""


class ConnectionError(LatticeError):  # noqa: A001 - mirrors reference name
    """Failure reaching a backing service or device (`core/errors.py:14`)."""


class ParsingError(LatticeError):
    """Source parsing failure with file/line context (`core/errors.py:20`)."""

    def __init__(self, message: str, *, file_path: str | None = None,
                 line: int | None = None, cause: Exception | None = None):
        super().__init__(message, cause=cause, file_path=file_path, line=line)
        self.file_path = file_path
        self.line = line


class GraphError(LatticeError):
    """Graph store construction/traversal failure (`core/errors.py:33`)."""


class VectorStoreError(LatticeError):
    """Vector index failure (`core/errors.py:39`)."""


class EmbeddingError(LatticeError):
    """Embedding computation failure (`core/errors.py:42`)."""


class IndexingError(LatticeError):
    """Pipeline failure, carries the stage it died in (`core/errors.py:45`)."""

    def __init__(self, message: str, *, stage: str | None = None,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause, stage=stage)
        self.stage = stage


class QueryError(LatticeError):
    """Query-side failure (`core/errors.py:56`)."""


class SummarizationError(LatticeError):
    """Summary generation failure (`core/errors.py:59`)."""


class StorageError(LatticeError):
    """Host-side metadata store failure (analog of `PostgresError`, `core/errors.py:62`)."""


PostgresError = StorageError


class MetadataError(LatticeError):
    """Metadata generation failure, carries field name (`core/errors.py:68`)."""

    def __init__(self, message: str, *, field_name: str | None = None,
                 cause: Exception | None = None):
        super().__init__(message, cause=cause, field_name=field_name)
        self.field_name = field_name


class KernelError(LatticeError):
    """TPU-native addition: a Pallas/XLA kernel failed validation against its oracle."""
