"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The sources are compiled at first use, on the machine with the card, one
`nvcc` per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -I lattice_tpu_torch/csrc -c -o <source>.o <source>.cu

then linked with `nvcc -shared` into
`build/lattice_tpu_torch/<hash>/liblattice_kernels.so` at the root of the
checkout, keyed by a hash of the sources and the flags, and loaded with
`ctypes`. Each C entry takes its pointers
and the stream as `void*` and returns `cudaGetLastError()` after its
launch; `Kernel.launch` raises when that is not 0. A missing `nvcc` or a
failed compile raises too: nothing here falls back to a plain version.

Each kernel is one `Kernel` object with a plain integer `launches`, which
goes up by one at each successful launch and nowhere else, so that a run
can show which kernels its main path went through; `entry_launches`
counts the same launches by C entry, so that it can show which route of a
kernel ran. The counts are taken under a lock: serving launches from
several worker threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from lattice_tpu_torch.core.errors import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lattice_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "liblattice_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# argument types of every C entry point in csrc/
_ENTRIES: dict[str, tuple] = {
    "lt_scan_topk_bf16": (_P, _P, _P) + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_bf16_scalar": (_P, _P, _P) + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_f32": (_P, _P, _P) + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_int8": (_P,) * 5 + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_int8_scalar": (_P,) * 5 + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_int4": (_P,) * 5 + (_I,) * 8 + (_P, _P, _P),
    "lt_scan_topk_int4_scalar": (_P,) * 5 + (_I,) * 8 + (_P, _P, _P),
    "lt_merge_candidates": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "lt_merge_positions": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
    "lt_ivf_probe_bf16": (_P,) * 4 + (_I,) * 9 + (_P, _P, _P),
    "lt_ivf_probe_f32": (_P,) * 4 + (_I,) * 9 + (_P, _P, _P),
    # q, k, v, mask, B, L, H, the row and batch strides of q, k and v, ...
    "lt_paired_attention_bf16": ((_P,) * 4 + (_I,) * 3 + (_LL,) * 6
                                 + (_F, _P, _P)),
    "lt_paired_attention_f32": ((_P,) * 4 + (_I,) * 3 + (_LL,) * 6
                                + (_F, _P, _P)),
    "lt_score_probe_bf16": (_P, _P) + (_I,) * 9 + (_P, _P),
    "lt_score_probe_bf16_scalar": (_P, _P) + (_I,) * 9 + (_P, _P),
    "lt_score_probe_int8": (_P, _P) + (_I,) * 9 + (_P, _P),
    "lt_score_probe_int8_scalar": (_P, _P) + (_I,) * 9 + (_P, _P),
    "lt_score_probe_int4": (_P, _P) + (_I,) * 9 + (_P, _P),
    "lt_score_probe_int4_scalar": (_P, _P) + (_I,) * 9 + (_P, _P),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise KernelError("nvcc not found: the CUDA kernels of lattice_tpu_torch "
                      "are built on the machine with the card")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile `csrc/*.cu` into the content-keyed library unless it is
    already there: one `nvcc -c` per source in parallel, then one link.
    Builds in a temporary directory and renames the library into place, so
    two processes building at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, compiles = [], []
        for src in sources():
            if src.suffix == ".cu":
                objs.append(str(Path(tmp) / f"{src.stem}.o"))
                compiles.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                                 "-o", objs[-1], str(src)])
        _run(compiles)
        lib = str(Path(tmp) / LIB_NAME)
        _run([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.lt_error_string.argtypes = [ctypes.c_int]
            lib.lt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One hand-written kernel: its C entry points and its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source        # path in the repo
        self.replaces = replaces    # file:line of the TPU kernel
        self.launches = 0
        self.entry_launches: dict[str, int] = {}
        KERNELS.append(self)

    def launch(self, entry: str, *args) -> None:
        if entry not in _ENTRIES:
            raise KernelError(f"{self.name}: unknown entry {entry!r}")
        lib = library()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = lib.lt_error_string(rc).decode()
            raise KernelError(f"{self.name} ({entry}) failed: {msg} [{rc}]")
        with _count_lock:
            self.launches += 1
            self.entry_launches[entry] = self.entry_launches.get(entry, 0) + 1


KERNELS: list[Kernel] = []


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def entry_launch_counts() -> dict[str, int]:
    """Launches by C entry since the last reset, of every kernel."""
    return {e: n for k in KERNELS for e, n in k.entry_launches.items()}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.entry_launches = {}

