"""Kernel C's blocking and route on the CPU, against the JAX package.

Kernel C (`scan_topk_int8`) runs on `wgmma` from a TMA ring where the
shape allows it (`csrc/scan_wg.cuh`), one block an SM, 128 or 64 queries a
block. What of that lives in Python is tested here, with inputs made from a
numpy seed:

- (a) the plan as a pure function (`int8_plan`, `int8_block_queries`,
  `int8_smem_bytes`): whole 128-row tiles, chunks that cover the rows with
  none empty, at most one wave of blocks, the instance by batch and list
  length, every instance's shared memory under the H100's 227 KB at every
  list it takes, and the constants the CUDA source shares with it;
- (b) the blocking emulated on the CPU: `scan_topk_int8_plain` over each
  chunk of the plan, padded as the kernel pads a short chunk, then
  `merge_candidates_plain`, equal to JAX's `int8_topk` bit for bit and
  held to the Pallas `binned_topk_int8` (interpret mode) within its
  packed keys, on `chip_smoke.int8_cases` (ties across tile and chunk
  edges, invalid chunks, fewer live rows than k1) and random rows;
- (c) the route: `scan_blocks_int8` and the int8 `score_probe` name the
  wgmma entry for d % 16 == 0 with 16-byte aligned queries and rows and
  the wmma tile loop otherwise, with the plan's instance and chunking,
  checked through a recorded `Kernel.launch` with no CUDA.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import pallas_topk as jax_scan
from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.ops import _build, probe
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.ops import topk as topk_ops

from chip_smoke import int8_cases

t = torch.from_numpy
SMS = 132                       # the H100's SMs
EMPTY_ID = 0x7FFFFFFF           # an empty list slot's id (topk_select.cuh)
CSRC = Path(scan.__file__).resolve().parent.parent / "csrc"


# ---- (a) the plan ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4099, 70_000, 1 << 20,
                               3_000_001])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 127, 128, 129, 256, 300, 1024,
                               20_000])
def test_plan_tiles_cover_the_rows_in_one_wave(n, b):
    for k1 in (1, 16, 32, 33, 128):
        for sms in (SMS, 7):
            bq, rows, chunks = scan.int8_plan(n, b, k1, sms)
            q_tiles = -(-b // bq)
            assert rows >= scan.BN and rows % scan.BN == 0
            assert (chunks - 1) * rows < n <= chunks * rows  # none empty
            assert chunks * q_tiles <= max(sms, q_tiles)     # one wave
            assert bq == scan.int8_block_queries(b, k1)


@pytest.mark.parametrize("b,k1,bq", [(1, 16, 64), (64, 16, 64), (65, 16, 128),
                                     (256, 1, 128), (256, 32, 128),
                                     (256, 33, 64), (256, 128, 64),
                                     (5000, 16, 128), (5000, 64, 64)])
def test_instance_by_batch_and_list_length(b, k1, bq):
    assert scan.int8_block_queries(b, k1) == bq


def test_one_block_an_sm_at_the_main_path_shapes():
    """1M x 768 rows: two query tiles of 66 chunks at B=256, k1=16; one
    query tile of 131 chunks at B=1."""
    assert scan.int8_plan(1 << 20, 256, 16, SMS) == (128, 16_000, 66)
    assert scan.int8_plan(1 << 20, 1, 16, SMS) == (64, 8064, 131)
    assert scan.int8_plan(1 << 20, 256, 80, SMS)[0] == 64


def test_every_instance_fits_its_shared_memory():
    for k1 in range(1, scan.MAX_K1 + 1):
        for b in (1, 64, 65, 256):
            bq = scan.int8_block_queries(b, k1)
            assert scan.int8_smem_bytes(bq, k1) <= scan.SMEM_MAX, (b, k1)
        assert scan.int8_smem_bytes(scan.BQ, k1) <= scan.SMEM_MAX
    for k1 in range(1, scan.K1_WIDE + 1):
        assert scan.int8_smem_bytes(scan.BQ_WIDE, k1) <= scan.SMEM_MAX
    # the budget that sets K1_WIDE: a list twice as long does not fit
    assert scan.int8_smem_bytes(scan.BQ_WIDE, 2 * scan.K1_WIDE) \
        > scan.SMEM_MAX


def test_python_mirrors_the_cuda_constants():
    src = (CSRC / "scan_wg.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("BQ_WIDE") == scan.BQ_WIDE
    assert const("K1_WIDE") == scan.K1_WIDE
    assert const("WG_BK") == scan.WG_BK
    assert const("WG_BN") == scan.WG_BN
    assert "constexpr int WG_SC_LD = WG_BN + 8;" in src
    assert scan.WG_SC_LD == scan.WG_BN + 8
    stages = re.search(r"STAGES = BQ_ == BQ_WIDE \? (\d+) : (\d+);", src)
    ring = [int(stages[1]) * (scan.WG_BN + 2 * 64) * scan.WG_BK,
            int(stages[2]) * (scan.WG_BN + 64) * scan.WG_BK]
    for bq, want in zip((scan.BQ_WIDE, scan.BQ), ring):
        # smem less the ring is alignment, barriers, score tile and lists
        rest = (1024 + const("WG_BAR_BYTES") + bq * scan.WG_SC_LD * 4
                + 2 * bq * 4 * 4)
        assert scan.int8_smem_bytes(bq, 4) == want + rest


# ---- (b) the blocking, emulated --------------------------------------------


def emulate_blocks(qv, qs, ev, es, valid, k1, sms):
    """What kernel C writes for kernel B: per chunk of `int8_plan`, the
    exact top-k1 of the chunk's rows (global ids), its empty slots (a
    chunk of fewer than k1 rows) as (-inf, EMPTY_ID)."""
    n, b = ev.shape[0], qv.shape[0]
    _, rows, chunks = scan.int8_plan(n, b, k1, sms)
    cand_s, cand_i = [], []
    for c in range(chunks):
        lo, hi = c * rows, min((c + 1) * rows, n)
        kk = min(k1, hi - lo)
        s, i = scan.scan_topk_int8_plain(qv, qs, ev[lo:hi], es[lo:hi],
                                         valid[lo:hi], kk)
        pad = k1 - kk
        cand_s.append(torch.nn.functional.pad(s, (0, pad),
                                              value=float("-inf")))
        cand_i.append(torch.nn.functional.pad(i + lo, (0, pad),
                                              value=EMPTY_ID))
    return torch.cat(cand_s, 1), torch.cat(cand_i, 1), chunks


def _quantized(rng, n, b, d, live):
    qv, qs = jax_quant.quantize_rows(topk_ops.l2_normalize(
        rng.normal(size=(b, d)).astype(np.float32)))
    ev, es = jax_quant.quantize_rows(topk_ops.l2_normalize(
        rng.normal(size=(n, d)).astype(np.float32)))
    return qv, qs, ev, es, rng.random(n) < live


INT8_CASES = {c[0]: c[1:] for c in int8_cases(11, n=1500, b=6, d=64)}
INT8_CASES["random rows"] = _quantized(np.random.default_rng(12), 1500, 6,
                                       64, 0.8)


@pytest.mark.parametrize("sms", [3, 11])
@pytest.mark.parametrize("k1", [1, 16, 33, 128])
@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_emulated_blocking_equals_jax_int8_topk(name, k1, sms):
    arrays = INT8_CASES[name]
    qv, qs, ev, es, valid = map(t, arrays)
    cs, ci, chunks = emulate_blocks(qv, qs, ev, es, valid, k1, sms)
    assert chunks > 1
    s, i = scan.merge_candidates_plain(cs, ci, k1)
    j_s, j_i = jax_quant.int8_topk(*map(jnp.asarray, arrays), k1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    # and the wrapper's plain version, which the card holds the kernel to
    ps, pi = scan.scan_topk_int8(qv, qs, ev, es, valid, k1)
    assert torch.equal(ps, s) and torch.equal(pi, i)


def test_int8_cases_are_what_they_say():
    cases = int8_cases(11, n=1500, b=6, d=64)
    assert [c[0] for c in cases] == ["ties across tile and chunk edges",
                                     "chunks entirely invalid",
                                     "fewer live rows than k1"]
    for name, qv, qs, ev, es, valid in cases:
        assert qv.dtype == ev.dtype == np.int8 and valid.dtype == bool
        assert ev.shape == (1500, 64) and es.shape == valid.shape == (1500,)
        if name.startswith("ties"):
            assert np.array_equal(ev[:7], ev[7:14])
            assert np.array_equal(es[:7], es[700:707])
        elif name.startswith("chunks"):
            assert not valid[200:750].any() and not valid[-700:].any()
        else:
            assert valid.sum() == 20 < 33
    # at the plan's chunking the invalid run covers whole chunks
    _, rows, _ = scan.int8_plan(1500, 6, 16, 11)
    assert any(not cases[1][5][lo:lo + rows].any()
               for lo in range(0, 1500, rows))


def _key_tol(score: float) -> float:
    """Two steps of the Pallas kernel's packed key at `score`: the f32 bits
    of score + 2 with the low 12 bits cleared keep 11 mantissa bits (2e-3
    for normalized scores, as the other JAX comparisons allow; ~8e-3 for
    the int8 cases' scores near 8)."""
    return 2.0 ** (np.floor(np.log2(abs(score) + 2.0)) - 10)


@pytest.mark.parametrize("name", ["ties across tile and chunk edges",
                                  "chunks entirely invalid", "random rows"])
def test_emulated_blocking_against_pallas_interpret(name):
    """The Pallas kernel's packed keys resolve scores to two key steps
    (`_key_tol`): each of its winners more than that above the emulation's
    k1-th score is in the emulated list, and shared ids agree within it."""
    qv, qs, ev, es, valid = INT8_CASES[name]
    n = 1280                       # `binned_topk_int8` takes whole tiles
    arrays = (qv, qs, ev[:n], es[:n], valid[:n])
    k1 = 16
    cs, ci, _ = emulate_blocks(*map(t, arrays), k1, 5)
    s, i = (x.numpy() for x in scan.merge_candidates_plain(cs, ci, k1))
    j_s, j_i = jax_scan.binned_topk_int8(*map(jnp.asarray, arrays), 10,
                                         tile=256, interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    assert not set(i.flatten()) & set(np.flatnonzero(~arrays[4]))
    for row in range(len(qv)):
        mine = dict(zip(i[row].tolist(), s[row].tolist()))
        for c, js_ in zip(j_i[row].tolist(), j_s[row].tolist()):
            if js_ > s[row, -1] + _key_tol(js_):
                assert c in mine, (row, c, js_, s[row, -1])
            if c in mine:
                assert abs(mine[c] - js_) < _key_tol(js_)


# ---- (c) the route -----------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Kernel launches recorded, not made: no CUDA is touched."""
    calls = []
    monkeypatch.setattr(scan, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(scan, "_stream", lambda device: 0)
    monkeypatch.setattr(probe, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(probe, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for kernel in (scan.SCAN_TOPK_INT8, probe.SCORE_PROBE):
        monkeypatch.setattr(kernel, "launch",
                            lambda entry, *args, k=kernel:
                            calls.append((k.name, entry, args)))
    _build.reset_launch_counts()
    yield calls
    assert set(_build.launch_counts().values()) == {0}


def _int8(b, d, n, offset=0, row_offset=0):
    """int8 queries and rows, each `offset` / `row_offset` bytes past a
    16-byte aligned start."""
    def at(shape, off):
        buf = torch.zeros(shape[0] * shape[1] + 32, dtype=torch.int8)
        base = (16 - buf.data_ptr() % 16) % 16 + off
        return buf[base:base + shape[0] * shape[1]].view(shape)
    return (at((b, d), offset), torch.ones(b), at((n, d), row_offset),
            torch.ones(n), torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("d,offset,row_offset,route", [
    (768, 0, 0, "lt_scan_topk_int8"), (256, 0, 0, "lt_scan_topk_int8"),
    (1024, 0, 0, "lt_scan_topk_int8"), (16, 0, 0, "lt_scan_topk_int8"),
    (100, 0, 0, "lt_scan_topk_int8_scalar"),
    (776, 0, 0, "lt_scan_topk_int8_scalar"),
    (768, 1, 0, "lt_scan_topk_int8_scalar"),
    (768, 0, 8, "lt_scan_topk_int8_scalar")])
@pytest.mark.parametrize("b,k1", [(1, 16), (256, 16), (256, 64)])
def test_route_by_shape(recorded, d, offset, row_offset, route, b, k1):
    n = 5000
    qv, qs, ev, es, valid = _int8(b, d, n, offset, row_offset)
    assert bool(qv.data_ptr() % 16) == bool(offset)
    assert scan.int8_route(qv, ev) == route
    cs, ci = scan.scan_blocks_int8(qv, qs, ev, es, valid, k1)
    [(name, entry, args)] = recorded
    assert (name, entry) == ("scan_topk_int8", route)
    ptrs, (bb, nn, dd, kk, bq, rows, chunks, vec) = args[:5], args[5:13]
    assert ptrs == (qv.data_ptr(), qs.data_ptr(), ev.data_ptr(),
                    es.data_ptr(), valid.data_ptr())
    assert (bb, nn, dd, kk) == (b, n, d, k1)
    if route == "lt_scan_topk_int8":
        assert (bq, rows, chunks) == scan.int8_plan(n, b, k1, SMS)
        assert vec == 1
    else:  # the wmma tile loop at 64 queries, four blocks an SM
        q_tiles = -(-b // scan.BQ)
        assert (bq, vec) == (scan.BQ, 0)
        assert (rows, chunks) == scan._rows_per_chunk(
            n, max(1, -(-4 * SMS // q_tiles)))
    assert cs.shape == ci.shape == (b, chunks * k1)


@pytest.mark.parametrize("d,offset,wg", [(768, 0, True), (100, 0, False),
                                         (768, 4, False)])
@pytest.mark.parametrize("b,k1", [(64, 16), (256, 16), (256, 80)])
def test_int8_probe_takes_kernel_c_route_and_instance(recorded, monkeypatch,
                                                      d, offset, wg, b, k1):
    monkeypatch.setattr(probe, "_on_cpu", lambda *tensors: False)
    tile, n = 256, 8 * 256 + 100
    qv, _, ev, _, _ = _int8(b, d, n, offset)
    out = probe.score_probe(qv, ev, tile=tile, mode="pack", k1=k1)
    assert out.shape == (b, 8 * 128)
    [(name, entry, args)] = recorded
    assert name == "score_probe"
    (bb, nn, dd, tt, per, chunks, bq, pack, vec) = args[2:11]
    assert (bb, nn, dd, tt, pack) == (b, n, d, tile, 1)
    if wg:
        assert entry == "lt_score_probe_int8" and vec == 1
        bq_, rows, chunks_ = scan.int8_plan(8 * scan.BN, b, k1, SMS)
        assert (bq, per * scan.BN, chunks) == (bq_, rows, chunks_)
    else:
        assert entry == "lt_score_probe_int8_scalar" and bq == scan.BQ
