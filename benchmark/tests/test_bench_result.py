"""A run's last line, at the cells' small sizes on the CPU: the keys the
contract names, the cell's metrics for each kind of run, the checks last."""

import json
import os

import pytest
import torch

from benchmark import run

CELLS = ["code1m.b256-k10", "unixcoder-base.index-b128"]
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def _names(kind, cell):
    entries = BENCH[kind]
    if kind == "per_layer":
        return {m["name"] for m in entries if cell in m["workloads"]}
    return {m["name"] for m in entries if cell in m.get("workloads", [cell])}


def test_the_configuration_pins_the_attention_levers(tiny, monkeypatch):
    cell = "unixcoder-base.index-b128"
    monkeypatch.setenv("LATTICE_PAIRED_ATTN", "0")
    monkeypatch.setenv("LATTICE_FLASH_ATTN", "1")
    result = run.run_cell(cell, 5, 0.2, False, device="cpu",
                          overrides=tiny[cell])
    assert result["correct"] is True
    assert os.environ["LATTICE_PAIRED_ATTN"] == "1"
    assert os.environ["LATTICE_FLASH_ATTN"] == "0"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_schema(cell, trace, tiny):
    result = run.run_cell(cell, 2**31 + 99, 0.4, bool(trace), device="cpu",
                          overrides=tiny[cell])
    result.pop("launches")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    units = {m["name"]: m["unit"] for kind in ("end_to_end", "per_layer")
             for m in BENCH[kind]}
    got = set(result["metrics"])
    if trace:
        # no device on the CPU: only the host-clock readers find something
        assert got <= _names("per_layer", cell) and got
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == _names("end_to_end", cell)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] == m["value"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result, allow_nan=False)


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_every_metric_and_cell_names_files_of_its_own():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert (run.ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        traffic = json.loads((run.ROOT / "benchmark/traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (run.ROOT / "benchmark/drivers"
                / f"{traffic['entry']}.py").is_file()
