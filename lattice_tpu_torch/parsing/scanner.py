"""Repository file scanner.

Parity target: reference `src/lattice/parsing/scanner.py:36-96` — recursive
walk, fnmatch ignore patterns matched against every path part, extension
filter, SHA-256 content hash per file, `FileInfo` records, statistics.

The SHA-256 hash is the backbone of incremental indexing (reference checks
it graph-side at `graph/queries.py:57-60` and vector-side at
`embeddings/client.py:178-202`); here it keys the index manifest used for
delta upserts into the device-resident index.
"""

from __future__ import annotations

import fnmatch
import hashlib
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from lattice_tpu_torch.config.settings import FileSettings
from lattice_tpu_torch.core.types import Language
from lattice_tpu_torch.parsing.models import FileInfo

logger = logging.getLogger(__name__)

try:  # C++ fast path for bulk hashing (native/liblattice_native.so)
    from lattice_tpu_torch.utils.native import sha256_file as _native_sha256
except Exception:  # pragma: no cover - native lib optional
    _native_sha256 = None


def _hash_file(path: Path) -> str:
    if _native_sha256 is not None:
        digest = _native_sha256(str(path))
        if digest:
            return digest
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclass
class ScanStatistics:
    """Reference: `parsing/scanner.py:82-96`."""

    total_files: int = 0
    total_bytes: int = 0
    skipped_ignored: int = 0
    skipped_extension: int = 0
    skipped_too_large: int = 0
    by_language: dict[str, int] = field(default_factory=dict)


class FileScanner:
    """Walks a repository yielding `FileInfo` per relevant source file."""

    def __init__(self, root: Path | str, settings: FileSettings | None = None):
        self.root = Path(root).resolve()
        self.settings = settings or FileSettings()
        self.stats = ScanStatistics()
        self._extensions = set(self.settings.extensions)
        self._max_bytes = int(self.settings.max_file_size_mb * 1024 * 1024)

    def _is_ignored(self, rel_path: str) -> bool:
        """fnmatch against the whole relative path and each part.

        Reference: `parsing/scanner.py:36-41` checks patterns against every
        path component.
        """
        posix = rel_path.replace(os.sep, "/")
        parts = posix.split("/")
        for pattern in self.settings.ignore_patterns:
            if fnmatch.fnmatch(posix, pattern) or fnmatch.fnmatch("/" + posix, pattern):
                return True
            bare = pattern.strip("*/")
            if bare and any(fnmatch.fnmatch(part, bare) for part in parts):
                return True
        return False

    def scan(self) -> Iterator[FileInfo]:
        """Yield FileInfo for each source file. Reference: `scanner.py:46-77`."""
        self.stats = ScanStatistics()
        for dirpath, dirnames, filenames in os.walk(self.root):
            rel_dir = os.path.relpath(dirpath, self.root)
            if rel_dir == ".":
                rel_dir = ""
            # Prune ignored directories in place so we never descend.
            dirnames[:] = sorted(
                d for d in dirnames
                if not self._is_ignored(os.path.join(rel_dir, d) + "/")
                and not d.startswith(".")
            )
            for fname in sorted(filenames):
                rel_path = os.path.join(rel_dir, fname) if rel_dir else fname
                if self._is_ignored(rel_path):
                    self.stats.skipped_ignored += 1
                    continue
                ext = os.path.splitext(fname)[1].lower()
                if ext not in self._extensions:
                    self.stats.skipped_extension += 1
                    continue
                full = Path(dirpath) / fname
                try:
                    stat = full.stat()
                except OSError:
                    continue
                if stat.st_size > self._max_bytes:
                    self.stats.skipped_too_large += 1
                    continue
                language = Language.from_extension(ext)
                try:
                    content_hash = _hash_file(full)
                except OSError as exc:
                    logger.warning("hash failed for %s: %s", full, exc)
                    continue
                self.stats.total_files += 1
                self.stats.total_bytes += stat.st_size
                self.stats.by_language[language.value] = (
                    self.stats.by_language.get(language.value, 0) + 1
                )
                yield FileInfo(
                    path=full,
                    relative_path=rel_path.replace(os.sep, "/"),
                    language=language,
                    size_bytes=stat.st_size,
                    content_hash=content_hash,
                    mtime=stat.st_mtime,
                )

    def info_for(self, rel_path: str) -> FileInfo | None:
        """FileInfo for a single path, or None when it is irrelevant
        (ignored / wrong extension / oversized) or no longer on disk.

        Targeted re-stat used by the inotify watcher so a kernel event
        touches one file instead of triggering a tree rescan.
        """
        rel = rel_path.replace(os.sep, "/")
        if self._is_ignored(rel):
            return None
        ext = os.path.splitext(rel)[1].lower()
        if ext not in self._extensions:
            return None
        full = self.root / rel
        try:
            stat = full.stat()
        except OSError:
            return None
        if not full.is_file() or stat.st_size > self._max_bytes:
            return None
        try:
            content_hash = _hash_file(full)
        except OSError:
            return None
        return FileInfo(
            path=full,
            relative_path=rel,
            language=Language.from_extension(ext),
            size_bytes=stat.st_size,
            content_hash=content_hash,
            mtime=stat.st_mtime,
        )

    def scan_all(self) -> list[FileInfo]:
        """Materialized scan. Reference: `parsing/scanner.py:79`."""
        return list(self.scan())

    def get_statistics(self) -> ScanStatistics:
        return self.stats
