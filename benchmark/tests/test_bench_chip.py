"""Each cell once on the card, as the benchmark's command runs it, for a
short window: the result line and `correct`. Skips where there is no card.

    python -m pytest benchmark/tests -m chip
"""

import json
import subprocess
import sys

import pytest

from benchmark import run

CELLS = ["code1m.b256-k10", "unixcoder-base.index-b128"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    done = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=run.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
