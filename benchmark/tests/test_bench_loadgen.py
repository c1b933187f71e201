"""The traffic generator: the same seed gives the same inputs, every seed
the same work, and the mixes follow their stated distributions."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs, loadgen

ROOT = Path(__file__).resolve().parents[2]

INDEX = json.loads((ROOT / "benchmark/traffic/index-b128.json").read_text())
SEARCH = json.loads((ROOT / "benchmark/traffic/b256-k10.json").read_text())
BIG = 2**31 + 12345


def _centers(seed):
    cfg = {"centers": 8, "dim": 32}
    return inputs.corpus_centers(cfg, seed, "cpu")


def test_query_pool_is_the_seeds_own():
    traffic = dict(SEARCH, batch=16, pool_batches=3)
    a = loadgen.query_pool(traffic, _centers(BIG), BIG)
    b = loadgen.query_pool(traffic, _centers(BIG), BIG)
    c = loadgen.query_pool(traffic, _centers(BIG + 1), BIG + 1)
    assert len(a) == 3 and a[0].shape == (16, 32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    norms = torch.linalg.vector_norm(torch.cat(a), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_corpus_blocks_repeat_for_a_seed():
    cfg = {"centers": 8, "dim": 32, "rows": 1000, "add_batch": 300,
           "spread": 0.35}
    first = list(inputs.corpus_blocks(cfg, BIG, _centers(BIG)))
    again = list(inputs.corpus_blocks(cfg, BIG, _centers(BIG)))
    assert [(lo, hi) for lo, hi, _ in first] == [(0, 300), (300, 600),
                                                 (600, 900), (900, 1000)]
    assert all(torch.equal(a[2], b[2]) for a, b in zip(first, again))


def test_chunk_pool_same_seed_same_inputs():
    a = loadgen.chunk_pool(INDEX, BIG)
    b = loadgen.chunk_pool(INDEX, BIG)
    assert len(a) == INDEX["pool_batches"]
    for (ia, ma), (ib, mb) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(ma, mb)
    other = loadgen.chunk_pool(INDEX, BIG + 1)
    assert not np.array_equal(a[0][0][:, :8], other[0][0][:, :8])


def test_every_seed_does_the_same_work():
    lengths = [np.sort(np.concatenate([m.sum(1) for _, m in
                                       loadgen.chunk_pool(INDEX, s)]))
               for s in (1, BIG, 7 * BIG)]
    assert all(np.array_equal(lengths[0], x) for x in lengths[1:])


def _measured(traffic):
    table = np.asarray(traffic["lengths"]["histogram"])
    return np.repeat(table[:, 0], table[:, 1])


def test_chunk_lengths_follow_the_measured_histogram():
    measured, ln = _measured(INDEX), loadgen.chunk_lengths(INDEX)
    assert len(measured) == 6502
    assert len(ln) == INDEX["batch"] * INDEX["pool_batches"]
    assert ln.min() == measured.min() and ln.max() == measured.max() == 512
    assert set(ln) <= set(measured)
    # the pool takes the histogram's quantiles: its median, mean, quartiles
    # and share at the cap are the measured ones, to a length's step
    assert abs(np.median(ln) - np.median(measured)) <= 1
    assert abs(ln.mean() - measured.mean()) / measured.mean() < 0.005
    for q in (10, 25, 75, 90):
        assert abs(np.percentile(ln, q) - np.percentile(measured, q)) <= 2
    assert abs(np.mean(ln == 512) - np.mean(measured == 512)) < 0.001


def test_chunk_lengths_are_a_histograms_quantiles():
    traffic = {"batch": 4, "pool_batches": 2,
               "lengths": {"histogram": [[10, 1], [20, 2], [40, 1]]}}
    assert loadgen.chunk_lengths(traffic).tolist() == [10, 10, 20, 20, 20,
                                                       20, 40, 40]


def test_the_histogram_tool_measures_a_tree(tmp_path):
    from benchmark import chunk_lengths
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "mod.py").write_text(
        "def small(a, b):\n    return a + b\n\n\n"
        "class Big:\n    def method(self, x):\n"
        + "".join(f"        x = x * {i} + {i}\n" for i in range(400))
        + "        return x\n")
    files, lengths = chunk_lengths.chunk_lengths(tmp_path, 512, 51416)
    assert files == 1 and len(lengths) >= 2
    assert min(lengths) >= 8 and max(lengths) == 512


def test_chunks_are_framed_as_the_tokenizer_frames_them():
    frame, ids_spec = INDEX["frame"], INDEX["ids"]
    for ids, mask in loadgen.chunk_pool(INDEX, BIG)[:4]:
        ln = mask.sum(1)
        assert ids.shape == (INDEX["batch"], ln.max())
        assert (ids[:, 0] == frame["cls"]).all()
        assert (ids[:, 1] == frame["mode"]).all()
        assert (ids[:, 2] == frame["sep"]).all()
        assert (ids[np.arange(len(ln)), ln - 1] == frame["sep"]).all()
        live = mask.astype(bool)
        assert (ids[~live] == frame["pad"]).all()
        assert np.array_equal(live, np.arange(ids.shape[1]) < ln[:, None])
        body = np.concatenate([row[3:n - 1] for row, n in zip(ids, ln)])
        assert body.min() >= ids_spec["low"] and body.max() < ids_spec["high"]


@pytest.mark.parametrize("n_calls", [1, 5, 100])
def test_sample_calls(n_calls):
    a = loadgen.sample_calls(n_calls, 4, BIG, must=(n_calls - 1,))
    assert a == loadgen.sample_calls(n_calls, 4, BIG, must=(n_calls - 1,))
    assert n_calls - 1 in a and len(a) <= 5 and a == sorted(set(a))
    assert all(0 <= j < n_calls for j in a)


def test_derived_seeds_differ_by_use():
    tags = ["centers", "rows", "queries", "chunks", "sample", "weights"]
    seeds = {inputs.derive_seed(BIG, t) for t in tags}
    assert len(seeds) == len(tags) and max(seeds) < 2**63
