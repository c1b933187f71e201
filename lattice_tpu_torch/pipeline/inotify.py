"""Linux inotify change detection via ctypes — no polling, no rescans.

A copy of `lattice_tpu/pipeline/inotify.py`, its imports pointed at the port.

Parity target: reference `src/lattice/pipeline/watcher.py:21-99` uses the
watchdog library's native OS observer so file events arrive from the
kernel instead of a scan loop. watchdog is not installed here, so this
talks to inotify(7) directly through libc: `inotify_init1` /
`inotify_add_watch` / non-blocking reads of the event stream.

Semantics:
- one watch per non-ignored directory (recursive), registered lazily as
  directories appear;
- `drain()` returns the set of relative file paths the kernel reported
  touched since the last call, plus a `need_full_rescan` flag raised on
  queue overflow or directory-level moves/deletes (events inside a moved
  subtree are unreliable — the caller falls back to one full scan pass);
- irrelevance filtering (ignore patterns, extensions) is the caller's
  job via `FileScanner.info_for`; this layer only decodes kernel events.

Falls back cleanly: `InotifyBackend.available()` is False off-Linux or
when libc lacks the symbols, and the watcher keeps its polling scanner.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import logging
import os
import struct
import sys
from pathlib import Path
from typing import Callable

logger = logging.getLogger(__name__)

# inotify(7) constants (linux/inotify.h)
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_DELETE_SELF = 0x00000400
IN_MOVE_SELF = 0x00000800
IN_Q_OVERFLOW = 0x00004000
IN_IGNORED = 0x00008000
IN_ISDIR = 0x40000000
IN_NONBLOCK = 0x00000800
IN_CLOEXEC = 0x00080000

_WATCH_MASK = (IN_CLOSE_WRITE | IN_MOVED_FROM | IN_MOVED_TO | IN_CREATE
               | IN_DELETE | IN_DELETE_SELF | IN_MOVE_SELF)
_EVENT_HEADER = struct.Struct("iIII")  # wd, mask, cookie, len


def _libc():
    try:
        return ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
    except OSError:  # pragma: no cover - non-glibc platforms
        return None


class InotifyBackend:
    """Kernel-event change detection over a directory tree."""

    def __init__(self, root: Path,
                 is_ignored_dir: Callable[[str], bool] | None = None):
        if not self.available():
            raise OSError("inotify unavailable on this platform")
        self.root = Path(root).resolve()
        self._is_ignored_dir = is_ignored_dir or (lambda rel: False)
        self._lib = _libc()
        self.fd = self._lib.inotify_init1(IN_NONBLOCK | IN_CLOEXEC)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._wd_to_rel: dict[int, str] = {}
        self._rel_to_wd: dict[str, int] = {}
        self.need_full_rescan = False
        self._watch_tree("")

    @staticmethod
    def available() -> bool:
        if not sys.platform.startswith("linux"):
            return False
        lib = _libc()
        return lib is not None and hasattr(lib, "inotify_init1")

    # ---- watch management -------------------------------------------------

    def _dir_relevant(self, rel_dir: str) -> bool:
        if not rel_dir:
            return True
        base = os.path.basename(rel_dir)
        if base.startswith("."):
            return False
        return not self._is_ignored_dir(rel_dir + "/")

    def _add_watch(self, rel_dir: str) -> bool:
        full = str(self.root / rel_dir) if rel_dir else str(self.root)
        wd = self._lib.inotify_add_watch(
            self.fd, full.encode(), _WATCH_MASK)
        if wd < 0:
            err = ctypes.get_errno()
            if err not in (errno.ENOENT, errno.ENOTDIR):
                logger.warning("inotify_add_watch(%s): %s",
                               full, os.strerror(err))
            return False
        self._wd_to_rel[wd] = rel_dir
        self._rel_to_wd[rel_dir] = wd
        return True

    def _watch_tree(self, rel_dir: str) -> list[str]:
        """Watch rel_dir and every non-ignored subdirectory.

        Returns relative paths of files already inside (a directory can
        arrive populated, e.g. via mv), so the caller can report them.
        """
        found: list[str] = []
        top = self.root / rel_dir if rel_dir else self.root
        if not top.is_dir() or not self._dir_relevant(rel_dir):
            return found
        self._add_watch(rel_dir)
        try:
            entries = sorted(os.scandir(top), key=lambda e: e.name)
        except OSError:
            return found
        for entry in entries:
            rel = f"{rel_dir}/{entry.name}" if rel_dir else entry.name
            try:
                if entry.is_dir(follow_symlinks=False):
                    found.extend(self._watch_tree(rel))
                elif entry.is_file(follow_symlinks=False) and rel_dir:
                    found.append(rel)
            except OSError:
                continue
        return found

    def _drop_watch(self, wd: int) -> None:
        rel = self._wd_to_rel.pop(wd, None)
        if rel is not None:
            self._rel_to_wd.pop(rel, None)

    # ---- event stream -----------------------------------------------------

    def drain(self) -> tuple[set[str], bool]:
        """(touched relative file paths, need_full_rescan) since last call."""
        touched: set[str] = set()
        need_full = self.need_full_rescan
        self.need_full_rescan = False
        while True:
            try:
                buf = os.read(self.fd, 1 << 16)
            except BlockingIOError:
                break
            except OSError as exc:  # pragma: no cover - fd torn down
                if exc.errno == errno.EINTR:
                    continue
                need_full = True
                break
            if not buf:
                break
            off = 0
            while off + _EVENT_HEADER.size <= len(buf):
                wd, mask, _cookie, nlen = _EVENT_HEADER.unpack_from(buf, off)
                off += _EVENT_HEADER.size
                name = buf[off:off + nlen].split(b"\0", 1)[0].decode(
                    "utf-8", "replace")
                off += nlen
                if mask & IN_Q_OVERFLOW:
                    need_full = True
                    continue
                if mask & IN_IGNORED:
                    self._drop_watch(wd)
                    continue
                rel_dir = self._wd_to_rel.get(wd)
                if rel_dir is None:
                    continue
                if mask & (IN_DELETE_SELF | IN_MOVE_SELF):
                    # a watched directory vanished/moved: its subtree
                    # state is stale, let the scanner reconcile
                    self._drop_watch(wd)
                    if rel_dir:
                        need_full = True
                    continue
                rel = f"{rel_dir}/{name}" if rel_dir else name
                if mask & IN_ISDIR:
                    if mask & (IN_CREATE | IN_MOVED_TO):
                        # new subtree: watch it and surface its contents
                        touched.update(self._watch_tree(rel))
                    elif mask & (IN_DELETE | IN_MOVED_FROM):
                        # files under it got no per-file events
                        need_full = True
                    continue
                touched.add(rel)
        return touched, need_full

    def close(self) -> None:
        if getattr(self, "fd", -1) >= 0:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = -1
        self._wd_to_rel.clear()
        self._rel_to_wd.clear()

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:
            pass
