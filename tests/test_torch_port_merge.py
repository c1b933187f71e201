"""Kernel B (`merge_candidates`) of the port against the JAX finish.

The JAX package finishes `_binned_candidates` with `approx_max_k`; the
port made it exact: the sorted top-k1 by (score desc, id asc), which is
`jax.lax.top_k` applied after a stable sort by id. The inputs are
`chip_smoke.merge_cases`, the adversarial lists the card then holds the
kernel to. Scores must agree bit for bit (the plain version only moves
them), ids exactly. On the CPU the wrapper runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import merge_cases
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import scan_topk as scan

CASES = merge_cases(7)


def _jax_merge(s: np.ndarray, i: np.ndarray, k1: int):
    by_id = np.argsort(i, axis=1, kind="stable")
    s, i = (np.take_along_axis(a, by_id, axis=1) for a in (s, i))
    vals, pos = jax.lax.top_k(jnp.asarray(s), k1)
    return np.asarray(vals), np.take_along_axis(i, np.asarray(pos), axis=1)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "signed zeros"],
                         ids=lambda c: c[0])
def test_plain_matches_lax_top_k_after_a_stable_sort_by_id(case):
    _, s, i, k1 = case
    vals, ids = scan.merge_candidates(torch.from_numpy(s),
                                      torch.from_numpy(i), k1)
    j_vals, j_ids = _jax_merge(s, i, k1)
    assert vals.shape == ids.shape == (s.shape[0], k1)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(j_vals))


def test_cases_cover_the_inputs_the_kernel_must_take():
    names = {c[0] for c in CASES}
    assert len(names) == len(CASES) == 8
    by = {c[0]: c for c in CASES}
    _, s, i, k1 = by["k1 above the live candidates (pads)"]
    assert k1 > int((s > -np.inf).sum(axis=1).max())
    assert (i == 0x7fffffff).sum() > s.shape[0]          # duplicated pads
    _, s, _, k1 = by["NEG_INF rows among the winners"]
    assert int((s > -1e30).sum(axis=1).max()) < k1
    _, s, _, k1 = by["m = k1"]
    assert s.shape[1] == k1
    _, s, _, k1 = by["unsorted, m no multiple of k1 or 4"]
    assert s.shape[1] % k1 and s.shape[1] % 4
    assert max(c[3] for c in CASES) == scan.MAX_K1_LONG
    # the three large shapes are the card's only
    assert len(merge_cases(7, large=True)) == len(CASES) + 3


def test_signed_zeros_tie_and_break_by_id():
    """`lax.top_k` ranks +0.0 before -0.0; the plain version (a stable
    `torch.sort`) ties them and breaks the tie by id, and kernel B follows
    it. A deviation kept on purpose (ROADMAP queue 3)."""
    s = np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)
    i = np.arange(4, dtype=np.int32)[None]
    _, pos = jax.lax.top_k(jnp.asarray(s), 4)
    assert np.asarray(pos).tolist() == [[1, 3, 0, 2]]
    vals, ids = scan.merge_candidates_plain(torch.from_numpy(s),
                                            torch.from_numpy(i), 4)
    assert ids.tolist() == [[0, 1, 2, 3]]
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(s))
    # the wider case: (score desc, id asc) with -0.0 == +0.0, scores kept
    _, s, i, k1 = next(c for c in CASES if c[0] == "signed zeros")
    vals, ids = scan.merge_candidates_plain(torch.from_numpy(s),
                                            torch.from_numpy(i), k1)
    for q in range(s.shape[0]):
        order = np.lexsort((i[q], -s[q]))[:k1]
        np.testing.assert_array_equal(ids[q].numpy(), i[q, order])
        np.testing.assert_array_equal(_bits(vals[q].numpy()),
                                      _bits(s[q, order]))
    assert (_bits(vals.numpy()) == _bits(np.float32(-0.0))).any()


@pytest.mark.parametrize("b, m, k1, want", [
    (1, 8192, 16, 1), (256, 2096, 16, 1), (1, 40960, 80, 22),
    (256, 10480, 80, 1), (1, 262144, 512, 22), (1024, 2640, 80, 1),
    (1024, 528, 16, 1), (16, 2096, 16, 1), (64, 2096, 16, 1),
    (1, 10, 10, 1), (200, 20000, 80, 2), (1, 600000, 512, 37),
    (1, 8193, 16, 22), (16, 40960, 80, 17)])
def test_merge_splits(b, m, k1, want):
    """Blocks per query of kernel B's first pass on a 132-SM card: one when
    the batch fills the card or the list is short, about sqrt(m / k1)
    otherwise, and never a slice longer than a block holds."""
    g = scan.merge_splits(b, m, k1, 132)
    assert g == want
    assert -(-m // g) <= scan.MERGE_CAP


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors take the plain version: nothing is launched."""
    _build.reset_launch_counts()
    _, s, i, k1 = CASES[0]
    scan.merge_candidates(torch.from_numpy(s), torch.from_numpy(i), k1)
    assert _build.launch_counts()["merge_candidates"] == 0
    assert scan.MERGE_CANDIDATES.source.endswith("csrc/merge_candidates.cu")
