"""Run one cell of `BENCHMARK.json` once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, from files of its own:
- the cell, its configuration and its traffic mix in `BENCHMARK.json`;
- the configuration in `benchmark/configs/<config>.json`;
- the traffic mix in `benchmark/traffic/<traffic>.json`, whose `entry`
  names the driver `benchmark/drivers/<entry>.py`; the driver's own
  `measure`, where it has one, is the window's loop, and `measure` here,
  a closed loop of one caller, where it has none;
- each metric's reader in `benchmark/metrics/<metric>.py`.

A run builds the cell's inputs from the seed and warms its shapes (set-up),
drives the loop for `--seconds` (the window), reads the peak device memory
of the window, frees the program, checks a sample of the window's
answers against the plain reference, and prints on its last line of
standard output one JSON object: `correct`, `attempted`, `failed`,
`metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (also the last
lines of standard error). With `--trace 1`, `torch.profiler` traces the
first `trace_seconds` of the window (the traffic mix's), and the device
metrics read that traced window.

It exits non-zero, printing no result, when the card or the cell's count
of cards is missing, when the program cannot be imported, or when jax,
jaxlib, flax or the JAX package is loaded once the window has closed."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BLOCKED = ("jax", "jaxlib", "flax", "lattice_tpu")
_T_IMPORT = time.time()


def process_start() -> float:
    """When this process started, in seconds since the epoch: its start in
    clock ticks after boot (`/proc/self/stat`) plus the boot time; the
    time this module was imported where `/proc` says nothing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def load_named(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """`<root>/benchmark/<kind>/<name>.py` as a module."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    mod_name = f"benchmark_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    metrics: dict[str, list[dict]]   # "end_to_end" / "per_layer" -> entries


def load_cell(name: str, seed: int, device: str, root: Path = ROOT,
              overrides: dict | None = None) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json` with its configuration,
    traffic and metrics; `overrides` {"config": {...}, "traffic": {...}}
    replaces keys (the tests' small sizes)."""
    bench = _json(root / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = _json(root / conf["file"])
    traffic = _json(root / "benchmark" / "traffic" / f"{work['traffic']}.json")
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved
                              else [])]
    return Cell(work, config, traffic, int(seed), device,
                {"end_to_end": e2e, "per_layer": layer})


class Call(NamedTuple):
    """One call of the window. Its fields are plain numbers, so that the
    collector stops tracking it: a window of thousands of calls adds no
    work to the interpreter's garbage collection."""
    index: int          # position in the window, 0, 1, ...
    start: float        # seconds from the window's start
    issue_s: float      # host seconds until the entry returned
    end: float          # seconds from the window's start, answers in hand
    units: int          # answers the call gave (queries, chunks); 0 failed
    traced: bool


@dataclass
class Window:
    seconds: float
    calls: list[Call] = field(default_factory=list)
    # the newest answers for each input of the pool: {slot: (call, out)}
    latest: dict[int, tuple[int, object]] = field(default_factory=dict)
    failed: int = 0
    trace: object = None            # devtrace.TraceWindow or None

    def answered(self) -> list[Call]:
        return [c for c in self.calls if c.units]

    def steady(self) -> tuple[list[Call], float]:
        """The calls the profiler did not record and the seconds they
        span; the whole window where it recorded every call."""
        calls = [c for c in self.calls if not c.traced] or self.calls
        return calls, calls[-1].end - calls[0].start


def _sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def measure(state, seconds: float, trace_seconds: float | None,
            device: str, batch: int) -> Window:
    """The closed loop: call after call until `seconds` have passed, each
    call's answers in hand before the next; the window ends with the call
    that crosses `seconds`. With `trace_seconds`, the profiler records the
    window's first `trace_seconds`."""
    from torch.autograd.profiler import record_function

    from benchmark import devtrace

    prof = marker = traced = None
    if trace_seconds:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    _sync(device)
    win = Window(seconds=0.0)
    t0 = time.perf_counter()
    if prof is not None:
        marker = record_function(devtrace.WINDOW_SPAN)
        marker.__enter__()
    i = 0
    while True:
        start = time.perf_counter() - t0
        span = (record_function(state.SPAN) if prof is not None
                else contextlib.nullcontext())
        try:
            with span:
                issued, units, out = state.call(i)
        except Exception:   # a failed call counts; the window goes on
            if not win.failed:
                traceback.print_exc()
            win.failed += batch
            issued, units, out = time.perf_counter() - t0 - start, 0, None
        end = time.perf_counter() - t0
        win.calls.append(Call(i, start, issued, end, units,
                              prof is not None))
        if units:
            win.latest[i % len(state.pool)] = (i, out)
        i += 1
        if prof is not None and (end >= trace_seconds or end >= seconds):
            marker.__exit__(None, None, None)
            _sync(device)
            prof.stop()
            traced, prof = prof, None
        if end >= seconds:
            break
    win.seconds = end
    if traced is not None:
        trace_dir = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            traced.export_chrome_trace(
                os.path.join(trace_dir, f"window{devtrace.TRACE_SUFFIX}"))
            del traced
            win.trace = devtrace.read_window(
                devtrace.load_events(trace_dir) or [])
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
    return win


def blocked_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)


def _launches() -> dict[str, int]:
    build = sys.modules.get("lattice_tpu_torch.ops._build")
    return dict(build.entry_launch_counts()) if build else {}


def prepare(cell: Cell, root: Path = ROOT) -> tuple[ModuleType, object]:
    """The cell's environment (the configuration's `env` pins the port's
    levers), its driver, and the window's loop: the driver's `measure`,
    or the closed loop here."""
    os.environ["USE_FLAX"] = "0"        # a library that could load JAX
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    for key, value in cell.config.get("env", {}).items():
        os.environ[key] = str(value)
    driver = load_named("drivers", cell.traffic["entry"], root)
    return driver, getattr(driver, "measure", measure)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             overrides: dict | None = None, fault: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of the cell: the result object printed on the last line
    (its `checks` too). `fault` breaks the timed path underneath (the
    driver's `FAULTS`; tests and `calibrate.py` only)."""
    import torch

    t_start = process_start() if t_start is None else t_start
    cell = load_cell(workload, seed, device, root, overrides)
    driver, loop = prepare(cell, root)
    state = driver.setup(cell)
    if fault:
        state.plant(fault)
    _sync(device)
    setup_s = time.time() - t_start
    if device.startswith("cuda"):   # the peak of the window, not set-up's
        torch.cuda.reset_peak_memory_stats()
    before = _launches()
    win = loop(state, seconds,
               cell.traffic["trace_seconds"] if trace else None, device,
               cell.traffic["batch"])
    after = _launches()
    launches = {k: n - before.get(k, 0) for k, n in after.items()
                if n > before.get(k, 0)}
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    calls = win.answered()
    numbers = state.check(sorted(win.latest.values())) if calls else {}
    limits = cell.config["limits"]
    checks = {name: {"value": numbers.get(name), "limit": float(limit)}
              for name, limit in limits.items()}
    correct = (bool(calls) and not win.failed and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                          setup_s=setup_s, window=win, state=state)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in cell.metrics[kind]:
        value = load_named("metrics", entry["name"], root).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    attempted = sum(c.units for c in calls) + win.failed
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["launches"] = launches
    result["checks"] = checks
    del state, ctx
    gc.collect()
    return result


def main(argv: list[str] | None = None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(HERE) in sys.path:
        sys.path.remove(str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    chips = int(load_cell(args.workload, args.seed, "cuda").workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=t_start)
    found = blocked_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    launches = result.pop("launches")
    print("launches " + json.dumps(launches, sort_keys=True))
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
