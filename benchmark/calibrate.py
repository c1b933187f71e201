"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --faulty-seeds 1,2,3 --seconds 2 [--out FILE]

For every seed it sets the cell up once, drives a window of `--seconds`
through the timed path, and has the reference judge the window's sample as
a run does: the program's readings, whose largest over the seeds is each
number's lower reading. On the faulty seeds it then runs the same window
with the timed path broken underneath, once for each of the driver's
`FAULTS`: `control` (the reference in the next precision below the
configuration's, in the program's place) and each fault the cell can have;
the smallest such reading that is three times the lower one or more is a
number's upper reading. The benchmark's own runs never run this. Prints
one JSON object (and writes it to `--out`)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def calibrate(workload: str, seeds: list[int], faulty: list[int],
              seconds: float, device: str = "cuda",
              overrides: dict | None = None) -> dict:
    from benchmark.run import _sync, load_cell, prepare

    readings: dict = {"workload": workload, "seconds": seconds, "runs": []}
    for seed in seeds:
        cell = load_cell(workload, seed, device, ROOT, overrides)
        driver, loop = prepare(cell)
        t0 = time.perf_counter()
        state = driver.setup(cell)
        _sync(device)
        setup = time.perf_counter() - t0
        # half_rows changes the store's state, so it goes last
        variants = [None] + (sorted(driver.FAULTS,
                                    key=lambda f: f == "half_rows")
                             if seed in faulty else [])
        for fault in variants:
            if fault:
                state.plant(fault)
            win = loop(state, seconds, None, device, cell.traffic["batch"])
            calls = win.answered()
            t1 = time.perf_counter()
            numbers = (state.check(sorted(win.latest.values()), free=False)
                       if calls else {})
            readings["runs"].append({
                "seed": seed, "fault": fault or "sound", "setup_s": setup,
                "calls": len(calls), "failed": win.failed,
                "units_per_s": sum(c.units for c in calls) / win.seconds,
                "check_s": time.perf_counter() - t1, "numbers": numbers})
            print(json.dumps(readings["runs"][-1]), file=sys.stderr,
                  flush=True)
        state.free()
        del state
    sound = [r["numbers"] for r in readings["runs"] if r["fault"] == "sound"]
    readings["lower"] = {k: max(n[k] for n in sound) for k in sound[0]}
    readings["faults"] = {}
    for r in readings["runs"]:
        if r["fault"] != "sound":
            low = readings["faults"].setdefault(r["fault"], {})
            for k, v in r["numbers"].items():
                low[k] = min(low.get(k, v), v)
    return readings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faulty-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",")]
    faulty = [int(s) for s in args.faulty_seeds.split(",") if s]
    out = calibrate(args.workload, seeds, faulty, args.seconds)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({k: out[k] for k in ("workload", "lower", "faults")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
