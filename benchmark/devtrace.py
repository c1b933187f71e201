"""Reading a `torch.profiler` Chrome trace of the measured window.

The event helpers are frozen copies of `lattice_tpu_torch/utils/
tracing.py`'s readers (`summarize_device_trace`): device events are CUDA
kernels, memcpy and memset (categories `kernel`, `gpu_memcpy`,
`gpu_memset`), each on its device and stream. `read_window` sums their
device time by name, as that reader does, inside the traced window (the
span of the `bench.window` annotation), and adds the seconds in which any
device operation ran and the idle gaps named by what the host was doing
in them."""

from __future__ import annotations

import bisect
import glob
import json
from dataclasses import dataclass

TRACE_SUFFIX = ".pt.trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
TOP = 10


def load_events(trace_dir: str) -> list[dict] | None:
    """The events of the newest trace under `trace_dir`, or None."""
    paths = sorted(glob.glob(f"{trace_dir}/**/*{TRACE_SUFFIX}",
                             recursive=True))
    if not paths:
        return None
    with open(paths[-1]) as f:
        return json.load(f).get("traceEvents", [])


def _plane(ev: dict) -> str:
    if ev.get("cat") in DEVICE_CATEGORIES:
        return f"/device:GPU:{(ev.get('args') or {}).get('device', 0)}"
    return "/host:CPU"


def device_events(events: list[dict]):
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            yield ev


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


@dataclass
class TraceWindow:
    window_s: float
    busy_s: float
    ops: dict[str, tuple[float, int]]   # device seconds and count by name
    idle_by_host_s: dict[str, float]    # idle seconds by host activity

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def op_seconds(self, needle: str) -> tuple[float, int]:
        """Summed device seconds and count of the operations whose name
        holds `needle`."""
        total, count = 0.0, 0
        for name, (sec, n) in self.ops.items():
            if needle in name:
                total, count = total + sec, count + n
        return total, count

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top({k: v[0] for k, v in self.ops.items()}),
                "idle_gaps": top(self.idle_by_host_s)}


def read_window(events: list[dict]) -> TraceWindow | None:
    """The traced window of `events`, or None when the trace has no
    `bench.window` span."""
    spans = [ev for ev in events if ev.get("ph") == "X"
             and ev.get("name") == WINDOW_SPAN
             and ev.get("cat") == "user_annotation"]
    if not spans:
        return None
    w0 = min(float(ev["ts"]) for ev in spans)
    w1 = max(float(ev["ts"]) + float(ev.get("dur", 0)) for ev in spans)
    per_device: dict[str, list[tuple[float, float]]] = {}
    ops: dict[str, list] = {}
    for ev in device_events(events):
        lo = max(float(ev["ts"]), w0)
        hi = min(float(ev["ts"]) + float(ev.get("dur", 0)), w1)
        if hi <= lo:
            continue
        per_device.setdefault(_plane(ev), []).append((lo, hi))
        acc = ops.setdefault(ev["name"], [0.0, 0])
        acc[0] += (hi - lo) / 1e6
        acc[1] += 1
    merged = {dev: _merge(iv) for dev, iv in per_device.items()}
    n_dev = max(len(merged), 1)
    busy_us = sum(hi - lo for iv in merged.values() for lo, hi in iv) / n_dev
    return TraceWindow(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                       ops={k: (v[0], v[1]) for k, v in ops.items()},
                       idle_by_host_s=_idle_by_host(events, merged, w0, w1))


def _host_events(events: list[dict]) -> list[tuple[float, float, str]]:
    out = []
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") not in DEVICE_CATEGORIES
                and ev.get("cat") != "gpu_user_annotation"
                and ev.get("name") != WINDOW_SPAN):
            ts = float(ev["ts"])
            out.append((ts, ts + float(ev.get("dur", 0)), ev["name"]))
    out.sort()
    return out


def _idle_by_host(events: list[dict],
                  merged: dict[str, list[tuple[float, float]]],
                  w0: float, w1: float) -> dict[str, float]:
    """Each idle gap of the first device, named by the innermost host
    operation running at its midpoint, summed by name in seconds."""
    busy = next(iter(merged.values()), [])
    gaps, at = [], w0
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if at < w1:
        gaps.append((at, w1))
    host = _host_events(events)
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    active: list[tuple[float, float, str]] = []
    nxt = 0
    for lo, hi in gaps:         # gaps come in time order
        mid = (lo + hi) / 2
        stop = bisect.bisect_right(starts, mid)
        active.extend(host[nxt:stop])
        nxt = max(nxt, stop)
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else (
            "(no host operation)")
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return out
