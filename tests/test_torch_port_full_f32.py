"""`full_f32` across threads (lattice_tpu_torch/ops/topk.py).

`torch.backends.cuda.matmul.allow_tf32` is one flag for the whole process,
and `QueryEngine` scores its vector phase in a worker thread, so two
`full_f32` blocks can overlap. TF32 must be off inside every block, and
once the last block has left the flag must read what the caller set,
whichever block leaves first. The flag is a plain Python-visible setting,
so this runs on the CPU.
"""

import threading

import pytest
import torch

from lattice_tpu_torch.ops.topk import full_f32

WAIT = 10.0     # seconds a step may take before the test fails


@pytest.fixture
def tf32_on():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _flag() -> bool:
    return torch.backends.cuda.matmul.allow_tf32


class _Block(threading.Thread):
    """A thread that enters `full_f32`, reports, waits to be let out, reads
    the flag once more inside the block and leaves."""

    def __init__(self):
        super().__init__(daemon=True)
        self.entered = threading.Event()
        self.release = threading.Event()
        self.left = threading.Event()
        self.inside = []

    def run(self):
        with full_f32():
            self.inside.append(_flag())
            self.entered.set()
            assert self.release.wait(WAIT)
            self.inside.append(_flag())
        self.left.set()


@pytest.mark.parametrize("first_out", ["first in", "second in"])
def test_overlapping_blocks_keep_tf32_off_and_restore_it(tf32_on, first_out):
    a, b = _Block(), _Block()
    a.start()
    assert a.entered.wait(WAIT)
    assert _flag() is False
    b.start()
    assert b.entered.wait(WAIT)
    assert _flag() is False
    out, stay = (a, b) if first_out == "first in" else (b, a)
    out.release.set()
    assert out.left.wait(WAIT)
    # one block is still open: TF32 stays off for it
    assert _flag() is False
    stay.release.set()
    assert stay.left.wait(WAIT)
    a.join(WAIT)
    b.join(WAIT)
    assert a.inside == [False, False] and b.inside == [False, False]
    assert _flag() is True


def test_nested_and_sequential_blocks_restore_the_callers_flag(tf32_on):
    with full_f32():
        assert _flag() is False
        with full_f32():
            assert _flag() is False
        assert _flag() is False
    assert _flag() is True
    torch.backends.cuda.matmul.allow_tf32 = False
    with full_f32():
        assert _flag() is False
    assert _flag() is False


def test_a_block_left_by_an_exception_restores_the_flag(tf32_on):
    with pytest.raises(RuntimeError):
        with full_f32():
            raise RuntimeError("inside")
    assert _flag() is True
