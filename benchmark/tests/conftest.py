"""Shared pieces of the benchmark's tests: the checkout on `sys.path`, the
`chip` marker, and the small sizes at which a cell runs on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEARCH = "code1m.b256-k10"
ENCODE = "unixcoder-base.index-b128"
# the cells at a size a CPU test holds; the search takes the quantized
# plan by name, since a CPU store's auto plan is the exact scan
TINY = {
    SEARCH: {"config": {"rows": 4096, "dim": 64, "centers": 16,
                        "add_batch": 1024},
             "traffic": {"batch": 32, "pool_batches": 4, "warm_calls": 1,
                         "check_calls": 4, "method": "quantized",
                         "trace_seconds": 0.2}},
    # six layers: the fp8 control's error grows with depth, and reads
    # over the cell's limit from about six layers at this width
    ENCODE: {"config": {"vocab_size": 1000, "hidden_size": 128,
                        "num_hidden_layers": 6, "num_attention_heads": 2,
                        "intermediate_size": 256,
                        "max_position_embeddings": 130},
             "traffic": {"batch": 8, "pool_batches": 3, "warm_calls": 1,
                         "check_batches": 2, "trace_seconds": 0.2,
                         "lengths": {"histogram": [[16, 4], [48, 9],
                                                   [90, 4], [128, 3]]},
                         "ids": {"low": 3, "high": 1000}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: runs on an NVIDIA card; skips where there is none")


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)
