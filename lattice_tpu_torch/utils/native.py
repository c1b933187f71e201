"""ctypes bindings for the C++ host kernels (csrc/host/lattice_native.cpp).

A copy of `lattice_tpu/utils/native.py` over the port's own copy of the
source. The shared object is built with g++ (OpenMP first, as the
reference) the first time it is needed, into
`build/lattice_tpu_torch/native/<hash>/liblattice_native.so` at the root
of the checkout, keyed by a hash of the source and the flags; nothing is
written beside the source. It is built in a temporary directory and
renamed into place, so two processes building at once never load a
half-written file. Every caller degrades to the pure-Python
implementation when the toolchain or library is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "lattice_native.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "lattice_tpu_torch"
              / "native")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
SO_NAME = "liblattice_native.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / SO_NAME


def _build(out: Path) -> bool:
    for extra in (["-fopenmp"], []):   # OpenMP for batch BFS; optional
        try:
            out.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
                so = Path(tmp) / SO_NAME
                subprocess.run(["g++", *_FLAGS, *extra, "-o", str(so),
                                str(_SRC)],
                               check=True, capture_output=True, timeout=120)
                os.replace(so, out)
            return True
        except (subprocess.SubprocessError, OSError) as exc:
            logger.debug("native build failed (%s): %s", extra, exc)
    return False


def get_lib() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = library_path() if _SRC.is_file() else None
        if so is None or (not so.is_file() and not _build(so)):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            logger.debug("native load failed: %s", exc)
            _load_failed = True
            return None
        lib.lattice_sha256_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.lattice_sha256_file.restype = ctypes.c_int
        lib.lattice_sha256_bytes.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
        lib.lattice_sha256_bytes.restype = ctypes.c_int
        lib.lattice_bpe_create.argtypes = [ctypes.c_char_p]
        lib.lattice_bpe_create.restype = ctypes.c_void_p
        lib.lattice_bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.lattice_bpe_count.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.lattice_bpe_count.restype = ctypes.c_int64
        _i32p = ctypes.POINTER(ctypes.c_int32)
        _i64p = ctypes.POINTER(ctypes.c_int64)
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        try:
            lib.lattice_bfs_khop.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_int64,          # csr + alive + n
                _i32p, ctypes.c_int64,                        # seeds
                ctypes.c_int32, ctypes.c_int64,               # hops, limit
                _i32p, ctypes.c_int32,                        # mark, epoch
                _i32p, _i32p, ctypes.c_int64]                 # out ids/depths/cap
            lib.lattice_bfs_khop.restype = ctypes.c_int64
            lib.lattice_bfs_khop_batch.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_int64,
                _i32p, _i64p, ctypes.c_int64,                 # seeds, offsets, Q
                ctypes.c_int32, ctypes.c_int64,
                _i32p, _i32p, _i64p, ctypes.c_int64]          # ids/depths/counts/cap
            lib.lattice_bfs_khop_batch.restype = ctypes.c_int64
        except AttributeError:
            # stale .so without the BFS entry points; callers fall back
            logger.debug("native BFS symbols missing; host paths degrade")
        _lib = lib
        return _lib


def sha256_file(path: str) -> str | None:
    """Hex digest of a file via the C++ kernel; None -> caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(65)
    rc = lib.lattice_sha256_file(path.encode("utf-8"), out)
    if rc != 0:
        return None
    return out.value.decode("ascii")


def sha256_bytes(data: bytes) -> str | None:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(65)
    lib.lattice_sha256_bytes(data, len(data), out)
    return out.value.decode("ascii")


class BFSScratch:
    """Reusable epoch-marked visited array for the C++ k-hop BFS.

    The mark array is allocated once per graph size and never re-zeroed
    between queries — each call bumps the epoch and the kernel treats any
    other value as unvisited. GraphStore keeps one of these per finalize
    generation.
    """

    def __init__(self, n: int):
        import threading

        import numpy as np
        self.n = n
        self.mark = np.full(n, -1, dtype=np.int32)
        self.epoch = 0
        # The mark array is shared mutable state and ctypes releases the
        # GIL during the C++ walk: two concurrent traversals (watcher
        # reconcile + a query thread) could run the same epoch on the
        # same marks and silently drop each other's nodes. The walk is
        # sub-ms, so a lock costs nothing (r4 review finding).
        self.lock = threading.Lock()

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= 2**31 - 1:      # wrap: re-clear and restart
            self.mark.fill(-1)
            self.epoch = 1
        return self.epoch


def bfs_khop(indptr, indices, alive_u8, seeds, hops: int, limit: int,
             scratch: BFSScratch, out_cap: int):
    """Bounded k-hop BFS via the C++ kernel; None -> caller falls back.

    Returns (ids[i32], depths[i32]) of alive reached nodes excluding the
    seeds, in (depth, id) lexicographic order, truncated to out_cap.
    `limit<=0` means unbounded (traverse all `hops` levels).
    """
    import numpy as np
    lib = get_lib()
    if lib is None or not hasattr(lib, "lattice_bfs_khop"):
        return None
    n = len(indptr) - 1
    out_ids = np.empty(out_cap, dtype=np.int32)
    out_depths = np.empty(out_cap, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    with scratch.lock:
        written = lib.lattice_bfs_khop(
            indptr.ctypes.data_as(i64p), indices.ctypes.data_as(i32p),
            alive_u8.ctypes.data_as(u8p), n,
            seeds.ctypes.data_as(i32p), len(seeds),
            hops, limit,
            scratch.mark.ctypes.data_as(i32p), scratch.next_epoch(),
            out_ids.ctypes.data_as(i32p),
            out_depths.ctypes.data_as(i32p), out_cap)
    return out_ids[:written], out_depths[:written]


def bfs_khop_batch(indptr, indices, alive_u8, seed_sets, hops: int,
                   limit: int, out_cap: int):
    """Q independent bounded traversals; OpenMP-parallel across queries.

    Returns a list of (ids, depths) pairs, or None when the native
    library is unavailable.
    """
    import numpy as np
    lib = get_lib()
    if lib is None or not hasattr(lib, "lattice_bfs_khop_batch"):
        return None
    n = len(indptr) - 1
    q = len(seed_sets)
    flat = np.concatenate([np.asarray(s, dtype=np.int32)
                           for s in seed_sets]) if q else \
        np.empty(0, dtype=np.int32)
    offsets = np.zeros(q + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seed_sets], out=offsets[1:])
    out_ids = np.empty((q, out_cap), dtype=np.int32)
    out_depths = np.empty((q, out_cap), dtype=np.int32)
    out_counts = np.empty(q, dtype=np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lattice_bfs_khop_batch(
        indptr.ctypes.data_as(i64p), indices.ctypes.data_as(i32p),
        alive_u8.ctypes.data_as(u8p), n,
        flat.ctypes.data_as(i32p), offsets.ctypes.data_as(i64p), q,
        hops, limit,
        out_ids.ctypes.data_as(i32p), out_depths.ctypes.data_as(i32p),
        out_counts.ctypes.data_as(i64p), out_cap)
    return [(out_ids[i, :out_counts[i]].copy(),
             out_depths[i, :out_counts[i]].copy()) for i in range(q)]


class BPECounter:
    """Token counter over a local merges.txt (tiktoken replacement)."""

    def __init__(self, merges_path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.lattice_bpe_create(merges_path.encode("utf-8"))
        if not self._handle:
            raise RuntimeError(f"cannot load merges from {merges_path}")

    def count(self, text: str) -> int:
        data = text.encode("utf-8")
        return int(self._lib.lattice_bpe_count(self._handle, data, len(data)))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.lattice_bpe_destroy(handle)
            except Exception:
                pass
            self._handle = None
