"""A later change adds a configuration, a traffic mix, a driver and a
metric as new files and `BENCHMARK.json` entries, and the harness finds
each by name, with no edit to a file that is there."""

import json
import shutil
import textwrap

from benchmark import run

DRIVER = '''
"""A driver of its own: doubles each input row."""
import time
import torch

FAULTS = ()


class State:
    SPAN = "bench.double"

    def __init__(self, cell):
        self.cell = cell
        gen = torch.Generator().manual_seed(cell.seed)
        self.pool = [torch.randn(cell.traffic["batch"], cell.config["width"],
                                 generator=gen) for _ in range(3)]

    def call(self, i):
        t0 = time.perf_counter()
        out = self.pool[i % 3] * 2
        return time.perf_counter() - t0, out.shape[0], out

    def inputs_of(self, i):
        return self.pool[i % 3]

    def free(self):
        pass

    def check(self, latest, free=True):
        return {"gap": max(float((out - 2 * self.inputs_of(i)).abs().max())
                           for i, out in latest)}


def setup(cell):
    return State(cell)
'''

METRIC = '''
"""Rows doubled per second."""


def read(ctx):
    return sum(c.units for c in ctx.window.calls) / ctx.window.seconds
'''


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "configs/doubler.json").write_text(json.dumps(
        {"width": 4, "limits": {"gap": 0}}))
    (b / "traffic/rows-b8.json").write_text(json.dumps(
        {"entry": "double_rows", "batch": 8, "trace_seconds": 0.1}))
    (b / "drivers/double_rows.py").write_text(textwrap.dedent(DRIVER))
    (b / "metrics/rows_per_s.py").write_text(textwrap.dedent(METRIC))
    bench["configs"].append({"name": "doubler", "source": "https://example.org",
                             "file": "benchmark/configs/doubler.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "doubler.rows-b8", "config": "doubler",
                               "traffic": "rows-b8", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["doubler.rows-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell("doubler.rows-b8", 3, 0.2, False, device="cpu",
                          root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"rows_per_s", "setup_s"}
    assert result["checks"] == {"gap": {"value": 0.0, "limit": 0.0}}


LOOP = '''

LOOPS = []


def measure(state, seconds, trace_seconds, device, batch):
    """A loop of its own: the harness's, counted."""
    from benchmark import run
    LOOPS.append(seconds)
    return run.measure(state, seconds, trace_seconds, device, batch)
'''


def test_a_driver_brings_its_own_loop(tmp_path, monkeypatch):
    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "configs/doubler.json").write_text(json.dumps(
        {"width": 4, "limits": {"gap": 0}}))
    (b / "traffic/rows-open.json").write_text(json.dumps(
        {"entry": "double_open", "batch": 8, "trace_seconds": 0.1}))
    (b / "drivers/double_open.py").write_text(textwrap.dedent(DRIVER) + LOOP)
    bench["configs"].append({"name": "doubler", "source": "https://example.org",
                             "file": "benchmark/configs/doubler.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "doubler.open", "config": "doubler",
                               "traffic": "rows-open", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = []
    real = run.load_named

    def spy(kind, name, root=run.ROOT):
        mod = real(kind, name, root)
        loaded.append(mod)
        return mod
    monkeypatch.setattr(run, "load_named", spy)
    result = run.run_cell("doubler.open", 3, 0.2, False, device="cpu",
                          root=tmp_path)
    assert result["correct"] is True
    assert [m.LOOPS for m in loaded if hasattr(m, "LOOPS")] == [[0.2]]
