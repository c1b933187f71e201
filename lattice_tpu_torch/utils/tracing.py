"""Lightweight phase tracing and device-trace summaries over torch.profiler.

Port of `lattice_tpu/utils/tracing.py`. `SpanStats`, `Tracer` and
`get_tracer` are copied: a process-wide tracer that aggregates named
spans (count / total / max) on the host clock. The device side moves from
`jax.profiler`'s XSpace capture to `torch.profiler`: `device_trace`
records CPU and CUDA activity into a Chrome trace (`*.pt.trace.json`),
and the two readers sum its device events (CUDA kernels, memcpy and
memset, each on its device and stream) by name, as the JAX readers summed
the ops of a device plane.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class SpanStats:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    def record(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


@dataclass
class Tracer:
    _lock: threading.Lock = field(default_factory=threading.Lock)
    spans: dict[str, SpanStats] = field(
        default_factory=lambda: defaultdict(SpanStats))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000
            with self._lock:
                self.spans[name].record(ms)

    def report(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {"count": s.count, "total_ms": round(s.total_ms, 2),
                       "mean_ms": round(s.mean_ms, 2),
                       "max_ms": round(s.max_ms, 2)}
                for name, s in sorted(self.spans.items())
            }

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


TRACE_SUFFIX = ".pt.trace.json"
# Chrome-trace categories of the events that ran on a device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record CPU and (where there is a card) CUDA activity inside the
    region with `torch.profiler`; on exit, wait for the card and write a
    Chrome trace `<ns>.pt.trace.json` into `log_dir` (open it in
    chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{time.time_ns()}{TRACE_SUFFIX}"))


def _load_events(trace_dir: str) -> list[dict] | None:
    """The events of the newest trace under `trace_dir`, or None."""
    paths = sorted(glob.glob(f"{trace_dir}/**/*{TRACE_SUFFIX}",
                             recursive=True))
    if not paths:
        return None
    with open(paths[-1]) as f:
        return json.load(f).get("traceEvents", [])


def _plane(ev: dict) -> str:
    """XSpace-style plane name: `/device:GPU:<n>` for device events,
    `/host:CPU` for the rest."""
    if ev.get("cat") in DEVICE_CATEGORIES:
        return f"/device:GPU:{(ev.get('args') or {}).get('device', 0)}"
    return "/host:CPU"


def _device_events(events: list[dict]):
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            yield ev


def summarize_device_trace(trace_dir: str,
                           device_filter: str = "",
                           top: int = 20) -> dict:
    """Sum device time per kernel name from the newest trace under
    `trace_dir`, over every device whose plane name (`/device:GPU:0`)
    contains `device_filter`.

    Returns {"planes": [...], "total_ms": float, "ops": [(name, ms,
    fraction), ...]} sorted by time, or {"error": ...} when there is no
    trace. Device events do not nest, so the total is device busy time
    (summed over streams and devices).
    """
    events = _load_events(trace_dir)
    if events is None:
        return {"error": f"no {TRACE_SUFFIX} trace under {trace_dir}"}
    planes = sorted({_plane(ev) for ev in events if ev.get("ph") == "X"})
    op_us: dict[str, float] = {}
    for ev in _device_events(events):
        if device_filter in _plane(ev):
            op_us[ev["name"]] = op_us.get(ev["name"], 0.0) + ev.get("dur", 0)
    total = sum(op_us.values())
    ops = sorted(op_us.items(), key=lambda kv: -kv[1])[:top]
    return {
        "planes": planes,
        "total_ms": total / 1e3,
        "ops": [(name, us / 1e3, (us / total if total else 0.0))
                for name, us in ops],
    }


# Kernel-name needles, first match wins. The port's own kernels (the
# `__global__` functions of `csrc/`, launched through the `lt_*` entries)
# are "custom-call", as Pallas kernels were in XLA's traces; cuBLAS and
# CUTLASS GEMMs are "matmul"; PyTorch's eager elementwise kernels take the
# place of XLA's fusions.
_OP_CATEGORIES = (
    ("copy", ("memcpy", "memset", "copy")),
    ("transpose", ("transpose",)),
    ("custom-call", ("scan_topk_kernel", "merge_candidates_kernel",
                     "ivf_probe_kernel", "paired_attn_",
                     "score_probe_")),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "matmul")),
    ("collective", ("nccl",)),
    ("softmax-exp", ("softmax", "exp_kernel")),
    ("reduce", ("reduce",)),
    ("sort-topk", ("sort", "topk")),
    ("elementwise", ("elementwise",)),
)


def _short_name(name: str) -> str:
    """A kernel's function name without return type, namespace or
    template arguments."""
    name = re.sub(r"^void\s+", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1][:24] or "other"


def categorize_device_trace(trace_dir: str, top: int = 25) -> dict:
    """Per-category device time of the busiest stream of the newest trace.

    The busiest (device, stream) line's kernels run one after another, so
    its events tile its busy time without overlap; each kernel name goes
    to the first category whose needle it contains (else its short name),
    and categories under 0.2% of the line merge into "other". Returns
    {"line": "/device:GPU:<n>//stream <s>", "total_ms", "categories":
    {...}, "ops": top N (names truncated)}, or {"error": ...}.
    """
    events = _load_events(trace_dir)
    if events is None:
        return {"error": f"no {TRACE_SUFFIX} trace under {trace_dir}"}
    lines: dict[str, dict[str, float]] = {}
    for ev in _device_events(events):
        stream = (ev.get("args") or {}).get("stream", ev.get("tid"))
        ops = lines.setdefault(f"{_plane(ev)}//stream {stream}", {})
        ops[ev["name"]] = ops.get(ev["name"], 0.0) + ev.get("dur", 0)
    if not lines:
        return {"error": "no device events in the trace"}
    label, op_us = max(lines.items(), key=lambda kv: sum(kv[1].values()))
    total = sum(op_us.values())
    cats: dict[str, float] = {}
    for name, us in op_us.items():
        low = name.lower()
        cat = next((c for c, needles in _OP_CATEGORIES
                    if any(nd in low for nd in needles)), _short_name(name))
        cats[cat] = cats.get(cat, 0.0) + us
    floor = total * 0.002
    tail = {c: us for c, us in cats.items() if us < floor and c != "other"}
    if tail:
        cats = {c: us for c, us in cats.items() if c not in tail}
        cats["other"] = cats.get("other", 0.0) + sum(tail.values())
    ops = sorted(op_us.items(), key=lambda kv: -kv[1])[:top]
    trunc = lambda s: re.sub(r"\s+", " ", s)[:220]  # noqa: E731
    return {
        "line": label,
        "total_ms": total / 1e3,
        "categories": {c: round(us / 1e3, 3)
                       for c, us in sorted(cats.items(),
                                           key=lambda kv: -kv[1])},
        "ops": [(trunc(name), round(us / 1e3, 3),
                 round(us / total if total else 0.0, 4))
                for name, us in ops],
    }
