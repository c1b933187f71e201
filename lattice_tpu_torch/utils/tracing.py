"""Phase tracing on the profiler's clock, and device-trace summaries over
torch.profiler.

Port of `lattice_tpu/utils/tracing.py`. `SpanStats`, `Tracer` and
`get_tracer` keep the JAX package's shape: a process-wide tracer that
aggregates named spans (count / total / max) on the host clock, and whose
`report()` has the same keys. Beside that one tracer keeps:

- two kinds of span. `span(name)` always records: cold, per-request
  phases (`query.planning`). `hot(name)` records only while tracing is
  on, and costs one flag check and no allocation while it is off: the
  stages of a hot path (`search.plan`, `encode.host_prep`). Tracing is on
  while a `torch.profiler` session records, or after `enable()`, or from
  the start when `LATTICE_TRACE=1` is set (read once, at import);
- while a profiler records, every span also opens a user-scope record
  function of its name (the binding under
  `torch.autograd.profiler.record_function`, without that wrapper's two
  dispatched profiler ops: a third of its cost), so it lies in the Chrome
  trace as a `user_annotation` nested under its caller, on the clock of
  the device's events: an idle gap of the card can be put down to the
  stage the host was in;
- each span's self time, its time less that of the spans opened inside
  it on the same thread (a per-thread stack of open spans), and integer
  counters (`count`, gated like `hot`); `snapshot()` returns them with
  the spans, unrounded.

The device side moves from `jax.profiler`'s XSpace capture to
`torch.profiler`: `device_trace` records CPU and CUDA activity into a
Chrome trace (`*.pt.trace.json`), and `summarize_device_trace` sums its
device events (CUDA kernels, memcpy and memset, each on its device and
stream) by name, as the JAX reader summed the ops of a device plane.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_ENV = "LATTICE_TRACE"
_annotate = torch._C._autograd._record_function_with_args_enter
_end_annotation = torch._C._autograd._record_function_with_args_exit


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


class _OpenSpans(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self) -> None:
        self.stack: list[_Span] = []


class _Span:
    """One timing of a named span; the context manager `span` and `hot`
    hand out."""

    __slots__ = ("tracer", "name", "t0", "child_ms", "annotation")

    def __init__(self, tracer: Tracer, name: str) -> None:
        self.tracer = tracer
        self.name = name
        self.child_ms = 0.0
        self.annotation = None

    def __enter__(self) -> _Span:
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = _annotate(self.name)
        self.tracer._open.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        ms = (time.perf_counter() - self.t0) * 1000
        stack = self.tracer._open.stack
        # a span held across an `await` may close after one opened later
        # by another coroutine of the thread: take it out where it is
        at = len(stack) - 1
        while stack[at] is not self:
            at -= 1
        del stack[at]
        if at:
            stack[at - 1].child_ms += ms
        if self.annotation is not None:
            _end_annotation(self.annotation)
        self.tracer._record(self.name, ms, ms - self.child_ms)


_OFF = contextlib.nullcontext()


@dataclass
class Tracer:
    _lock: threading.Lock = field(default_factory=threading.Lock)
    spans: dict[str, SpanStats] = field(
        default_factory=lambda: defaultdict(SpanStats))
    self_ms: dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    enabled: bool = False
    _open: _OpenSpans = field(default_factory=_OpenSpans, repr=False)

    @property
    def on(self) -> bool:
        """Whether `hot` spans and `count` record now: after `enable()`,
        or while a `torch.profiler` session records."""
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str) -> _Span:
        """An always-on span."""
        return _Span(self, name)

    def hot(self, name: str):
        """A span that records only while tracing is `on`; else a shared
        null context."""
        # `on` spelled out: while tracing is off this check is all a span
        # costs
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int) -> None:
        """Add `n` to the counter `name` while tracing is `on`."""
        if self.on:
            with self._lock:
                self.counters[name] += int(n)

    def _record(self, name: str, ms: float, self_ms: float) -> None:
        with self._lock:
            self.spans[name].record(ms)
            self.self_ms[name] += self_ms

    def report(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {"count": s.count, "total_ms": round(s.total_ms, 2),
                       "mean_ms": round(s.mean_ms, 2),
                       "max_ms": round(s.max_ms, 2)}
                for name, s in sorted(self.spans.items())
            }

    def snapshot(self) -> dict[str, dict]:
        """{"spans": {name: {"count", "total_ms", "self_ms", "max_ms"}},
        "counters": {name: n}}, unrounded, in name order."""
        with self._lock:
            return {
                "spans": {name: {"count": s.count, "total_ms": s.total_ms,
                                 "self_ms": self.self_ms[name],
                                 "max_ms": s.max_ms}
                          for name, s in sorted(self.spans.items())},
                "counters": dict(sorted(self.counters.items())),
            }

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.self_ms.clear()
            self.counters.clear()


_GLOBAL = Tracer(enabled=os.environ.get(TRACE_ENV) == "1")


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
