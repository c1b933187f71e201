"""Kernel D's blocking and route on the CPU, against the JAX package.

Kernel D (`scan_topk_int4`) runs on kernel C's `wgmma` loop where the shape
allows it (`csrc/scan_wg.cuh` with `WgS4`): one block an SM, 128 or 64
queries a block, each slot a packed row slab of 128 bytes (256 dims) and
two query slabs read through maps over the query halves, the packed slab
unpacked into an s8 pair in shared memory. What of that lives in Python is
tested here, with inputs made from a numpy seed:

- (a) the plan (`wg_plan`, shared with kernels A and C) at kernel D's
  shapes, every instance's shared memory (`int4_smem_bytes`, with its
  staging cap, mirrored here from the constants the CUDA source declares)
  under the H100's 227 KB at every list it takes, and the constants the
  CUDA source shares with `ops/scan_topk.py`;
- (b) the blocking emulated on the CPU: per chunk of the plan, per 64-row
  tile, the sums built slab by slab as the kernel builds them (a packed
  slab past d/2 reads as 0 bytes, which unpack to -8 in the low nibble;
  the query halves past d/2 read as 0), the chunk's exact top-k1, then
  `merge_candidates_plain`: equal to JAX's `int4_topk` bit for bit on
  `chip_smoke.selection_cases` and random rows at d in {256, 320, 768};
- (c) the route: `scan_blocks_int4` and the int4 `score_probe` name the
  wgmma entry for d/2 % 16 == 0 with 16-byte aligned queries and packed
  rows and k1 <= MAX_K1, and the wmma tile loop otherwise, with the
  plan's instance and chunking, through a recorded `Kernel.launch` with no
  CUDA.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.ops import _build, probe
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.ops import topk as topk_ops

from chip_smoke import selection_cases

t = torch.from_numpy
SMS = 132                       # the H100's SMs
EMPTY_ID = 0x7FFFFFFF           # an empty list slot's id (topk_select.cuh)
CSRC = Path(scan.__file__).resolve().parent.parent / "csrc"
WG_SRC = (CSRC / "scan_wg.cuh").read_text()
TOPK_SRC = (CSRC / "scan_topk.cu").read_text()
SEL_SRC = (CSRC / "batch_select.cuh").read_text()


def _const(src, name, kind="int"):
    return int(re.search(rf"constexpr {kind} {name} = (\d+);", src)[1])


# kernel D's shared memory on wgmma, mirrored from the CUDA source
# (`WgRing` in scan_wg.cuh, `int4_wg_smem_bytes` / `int4_wg_cap` in
# scan_topk.cu): ring slots by queries a block, the longest list folded by
# serial `offer` at 64 queries, the most staging entries a query past it
_STAGES = re.search(r"Op::QSLABS == 1 \? C::STAGES : "
                    r"\(BQ_ == BQ_WIDE \? (\d+) : (\d+)\);", WG_SRC)
INT4_STAGES = {scan.BQ_WIDE: int(_STAGES[1]), scan.BQ: int(_STAGES[2])}
WG_SERIAL_K1 = _const(TOPK_SRC, "WG_SERIAL_K1")
SEL_CAP = _const(SEL_SRC, "SEL_CAP")


def int4_smem_bytes(bq: int, k1: int, cap: int = 0) -> int:
    """Dynamic shared memory of kernel D on `wgmma`: alignment slack, the
    ring (each slot a packed row slab of 64 x 128 bytes and two 64 x
    128-byte query slabs, the halves', per warpgroup), two s8 slab pairs
    to unpack into, the mbarriers, the i32 score tile, two lists of k1 per
    query and `cap` staging entries (f32 + i32) a query and their fills."""
    up = scan._up
    ring = INT4_STAGES[bq] * (scan.WG_BN * scan.WG_BK
                              + bq // scan.BQ * 2 * scan.BQ * scan.WG_BK)
    staging = 2 * up(bq * cap * 4) + up(bq * 4) if cap else 0
    return (1024 + ring + 4 * scan.WG_BN * scan.WG_BK + 256
            + up(bq * scan.WG_SC_LD * 4) + 2 * up(bq * k1 * 4) + staging)


def int4_staging_cap(bq: int, k1: int) -> int:
    """Staging entries a query: 0 (serial `offer`) at 128 queries a block
    or up to WG_SERIAL_K1, else SEL_CAP or the most that fit beside the
    ring and the lists."""
    if bq == scan.BQ_WIDE or k1 <= WG_SERIAL_K1:
        return 0
    cap = SEL_CAP
    while cap > 1 and int4_smem_bytes(bq, k1, cap) > scan.SMEM_MAX:
        cap -= 1
    return cap


# ---- (a) the plan -----------------------------------------------------------


def test_one_block_an_sm_at_the_main_path_shapes():
    """1M x 768 packed rows: k1 = 16 and 32 (the capacity tier's k <= 4)
    on two query tiles of 128 at B=256, k1 = 80 (k = 10) on four of 64;
    every plan one wave."""
    assert scan.wg_plan(1 << 20, 256, 16, SMS) == (128, 16_000, 66)
    assert scan.wg_plan(1 << 20, 256, 32, SMS) == (128, 16_000, 66)
    bq, rows, chunks = scan.wg_plan(1 << 20, 256, 80, SMS)
    assert bq == 64 and chunks * 4 <= SMS and (chunks - 1) * rows < 1 << 20
    assert scan.wg_plan(1 << 20, 1, 80, SMS) == (64, 8064, 131)
    bq, rows, chunks = scan.wg_plan(1 << 22, 1024, 16, SMS)
    assert bq == 128 and chunks * 8 <= SMS and rows % scan.BN == 0


@pytest.mark.parametrize("bq", [scan.BQ, scan.BQ_WIDE])
def test_every_instance_fits_its_shared_memory(bq):
    top = scan.MAX_K1 if bq == scan.BQ else scan.K1_WIDE
    for k1 in range(1, top + 1):
        cap = int4_staging_cap(bq, k1)
        assert (cap == 0) == (bq == scan.BQ_WIDE or k1 <= WG_SERIAL_K1)
        assert 0 <= cap <= SEL_CAP
        assert int4_smem_bytes(bq, k1, cap) <= scan.SMEM_MAX, (bq, k1)
        if cap and cap < SEL_CAP:  # the largest cap that fits
            assert int4_smem_bytes(bq, k1, cap + 1) > scan.SMEM_MAX
    # the instance the route gives every (B, k1) it takes is one of these
    for b in (1, 64, 65, 256, 1024):
        for k1 in range(1, scan.MAX_K1 + 1):
            assert scan.wg_block_queries(b, k1) in (
                scan.BQ, scan.BQ_WIDE if k1 <= scan.K1_WIDE else None)


def test_staging_at_the_main_path_widths():
    """k1 = 80 stages a full buffer of 32 a query at 64 queries a block;
    k1 = 128 one fewer (the lists take the room); k1 = 16 and the 128-query
    instance stage nothing."""
    assert int4_staging_cap(scan.BQ, 80) == SEL_CAP
    assert int4_staging_cap(scan.BQ, 128) == SEL_CAP - 1
    assert int4_staging_cap(scan.BQ, 16) == 0
    for k1 in (16, 32):  # 128 queries a block fold serially
        assert int4_staging_cap(scan.BQ_WIDE, k1) == 0


def test_python_mirrors_the_cuda_constants():
    assert INT4_STAGES == {scan.BQ_WIDE: 3, scan.BQ: 4}
    assert "UNPACKED = Op::QSLABS == 1 ? 0 : 2 * 2 * WG_RSLAB;" in WG_SRC
    assert "WG_RSLAB + C::CONSUMERS * Op::QSLABS * WG_QSLAB" in WG_SRC
    assert "if (BQ_ == BQ_WIDE || k1 <= WG_SERIAL_K1) return 0;" in TOPK_SRC
    assert ("(cap > 0 ? 2 * round_up((size_t)BQ_ * cap * 4) "
            "+ round_up(BQ_ * 4)") in TOPK_SRC
    assert _const(TOPK_SRC, "WG_SMEM_MAX", "size_t") == scan.SMEM_MAX
    assert _const(WG_SRC, "WG_BAR_BYTES") == 256
    # smem less the ring and the two s8 pairs is alignment, barriers,
    # score tile, lists and staging
    for bq in (scan.BQ, scan.BQ_WIDE):
        slot = scan.WG_BN * scan.WG_BK * (1 + 2 * bq // scan.BQ)
        rest = 1024 + 256 + bq * scan.WG_SC_LD * 4 + 2 * bq * 8 * 4
        assert int4_smem_bytes(bq, 8) == (
            INT4_STAGES[bq] * slot + 4 * scan.WG_BN * scan.WG_BK + rest)
        assert int4_smem_bytes(bq, 8, 3) == int4_smem_bytes(
            bq, 8) + 2 * scan._up(bq * 3 * 4) + scan._up(bq * 4)


# ---- (b) the blocking, emulated --------------------------------------------


def _slab_sums(qv, packed):
    """i32 sums [B, R] of int8 queries [B, d] against packed rows [R, d/2]
    as the wgmma loop builds them: slab by slab, 128 packed bytes each; a
    slab past d/2 holds 0 bytes (TMA's fill), whose low nibble unpacks to
    -8, against query halves that read 0 past d/2."""
    b, d = qv.shape
    dh = d // 2
    slabs = -(-dh // scan.WG_BK)
    width = slabs * scan.WG_BK
    pk = np.zeros((packed.shape[0], width), np.int64)
    pk[:, :dh] = packed
    lo, hi = (pk & 0xF) - 8, pk >> 4        # biased low nibble, signed high
    qlo = np.zeros((b, width), np.int64)
    qhi = np.zeros((b, width), np.int64)
    qlo[:, :dh], qhi[:, :dh] = qv[:, :dh], qv[:, dh:]
    acc = np.zeros((b, packed.shape[0]), np.int64)
    for s in range(slabs):
        cols = slice(s * scan.WG_BK, (s + 1) * scan.WG_BK)
        acc += qlo[:, cols] @ lo[:, cols].T + qhi[:, cols] @ hi[:, cols].T
    assert np.abs(acc).max(initial=0) < 2 ** 31
    return acc.astype(np.int32)


def emulate_blocks(qv, qs, ep, es, valid, k1, sms):
    """What kernel D's wgmma route writes for kernel B: per chunk of
    `wg_plan`, per 64-row tile, (f32(sum) * qs) * es (NEG_INF where a row
    is invalid), the chunk's exact top-k1 by (score desc, id asc), its empty
    slots (a chunk of fewer than k1 rows) as (-inf, EMPTY_ID)."""
    n, b = ep.shape[0], qv.shape[0]
    _, rows, chunks = scan.wg_plan(n, b, k1, sms)
    cand_s, cand_i = [], []
    for c in range(chunks):
        lo, hi = c * rows, min((c + 1) * rows, n)
        parts = []
        for r0 in range(lo, hi, scan.WG_BN):
            r1 = min(r0 + scan.WG_BN, hi)
            acc = torch.from_numpy(_slab_sums(qv, ep[r0:r1]))
            s = acc.to(torch.float32) * t(qs)[:, None] * t(es[r0:r1])[None, :]
            parts.append(torch.where(t(valid[r0:r1])[None, :], s,
                                     torch.full_like(s, topk_ops.NEG_INF)))
        kk = min(k1, hi - lo)
        s, i = topk_ops.stable_topk(torch.cat(parts, 1), kk)
        pad = k1 - kk
        cand_s.append(torch.nn.functional.pad(s, (0, pad),
                                              value=float("-inf")))
        cand_i.append(torch.nn.functional.pad(i + lo, (0, pad),
                                              value=EMPTY_ID))
    return torch.cat(cand_s, 1), torch.cat(cand_i, 1), chunks


def _random_rows(seed, n, b, d, live):
    rng = np.random.default_rng(seed)
    qv, qs = jax_quant.quantize_rows(topk_ops.l2_normalize(
        rng.normal(size=(b, d)).astype(np.float32)))
    ep, es = jax_quant.quantize_rows_int4(topk_ops.l2_normalize(
        rng.normal(size=(n, d)).astype(np.float32)))
    return (np.asarray(qv), np.asarray(qs), np.asarray(ep), np.asarray(es),
            rng.random(n) < live)


CASES = {(d, name): arrays for d in (256, 320, 768)
         for name, *arrays in selection_cases(13 + d, n=700, b=5, d=d)}
for _d in (256, 320, 768):
    CASES[(_d, "random rows")] = _random_rows(_d, 700, 5, _d, 0.8)


@pytest.mark.parametrize("sms", [3, 9])
@pytest.mark.parametrize("k1", [1, 16, 33, 80])
@pytest.mark.parametrize("key", sorted(CASES))
def test_emulated_blocking_equals_jax_int4_topk(key, k1, sms):
    arrays = CASES[key]
    cs, ci, chunks = emulate_blocks(*arrays, k1, sms)
    assert chunks > 1
    s, i = scan.merge_candidates_plain(cs, ci, k1)
    j_s, j_i = jax_quant.int4_topk(*map(jnp.asarray, arrays), k1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    # and the wrapper's plain version, which the card holds the kernel to
    ps, pi = scan.scan_topk_int4(*map(t, arrays), k1)
    assert torch.equal(ps, s) and torch.equal(pi, i)


def test_a_partial_slab_needs_the_zero_query_halves():
    """At d = 320 (d/2 = 160: one whole slab and 32 bytes of the next) the
    packed fill bytes unpack to -8: read against the other half's query
    columns (one map over [B, d] would read them there), the sums change;
    against the halves' zeros they do not."""
    qv, _, ep, _, _ = CASES[(320, "random rows")]
    exact = qv.astype(np.int64) @ np.concatenate(
        [(ep.astype(np.int64) & 0xF) - 8, ep.astype(np.int64) >> 4], 1).T
    np.testing.assert_array_equal(_slab_sums(qv, ep), exact)
    # one map over [B, d] would load slab 2's low query columns [128, 256):
    # [160, 256) are the high half's, against the fill's -8
    fill = np.full((ep.shape[0], 256 - 160), -8, np.int64)
    wrong = exact + qv[:, 160:256].astype(np.int64) @ fill.T
    assert not np.array_equal(wrong, exact)


# ---- (c) the route ----------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Kernel launches recorded, not made: no CUDA is touched."""
    calls = []
    for mod in (scan, probe):
        monkeypatch.setattr(mod, "_sm_count", lambda device: SMS)
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for kernel in (scan.SCAN_TOPK_INT4, probe.SCORE_PROBE):
        monkeypatch.setattr(kernel, "launch",
                            lambda entry, *args, k=kernel:
                            calls.append((k.name, entry, args)))
    _build.reset_launch_counts()
    yield calls
    assert set(_build.launch_counts().values()) == {0}


def _int4(b, d, n, offset=0, row_offset=0):
    """int8 queries [b, d] and packed rows [n, d/2], each `offset` /
    `row_offset` bytes past a 16-byte aligned start."""
    def at(shape, off):
        buf = torch.zeros(shape[0] * shape[1] + 32, dtype=torch.int8)
        base = (16 - buf.data_ptr() % 16) % 16 + off
        return buf[base:base + shape[0] * shape[1]].view(shape)
    return (at((b, d), offset), torch.ones(b), at((n, d // 2), row_offset),
            torch.ones(n), torch.ones(n, dtype=torch.bool))


WG, SCALAR = "lt_scan_topk_int4", "lt_scan_topk_int4_scalar"


@pytest.mark.parametrize("d,offset,row_offset,route", [
    (768, 0, 0, WG), (256, 0, 0, WG), (320, 0, 0, WG), (1024, 0, 0, WG),
    (32, 0, 0, WG), (100, 0, 0, SCALAR), (200, 0, 0, SCALAR),
    (784, 0, 0, SCALAR), (768, 1, 0, SCALAR), (768, 0, 8, SCALAR)])
@pytest.mark.parametrize("b,k1", [(1, 16), (256, 32), (256, 80), (256, 128),
                                  (256, 129), (70, 512)])
def test_route_by_shape(recorded, d, offset, row_offset, route, b, k1):
    n = 5000
    qv, qs, ep, es, valid = _int4(b, d, n, offset, row_offset)
    assert bool(qv.data_ptr() % 16) == bool(offset)
    if k1 > scan.MAX_K1:
        route = SCALAR
    assert scan.int4_route(qv, ep, k1) == route
    cs, ci = scan.scan_blocks_int4(qv, qs, ep, es, valid, k1)
    [(name, entry, args)] = recorded
    assert (name, entry) == ("scan_topk_int4", route)
    ptrs, (bb, nn, dd, kk, bq, rows, chunks, vec) = args[:5], args[5:13]
    assert ptrs == (qv.data_ptr(), qs.data_ptr(), ep.data_ptr(),
                    es.data_ptr(), valid.data_ptr())
    assert (bb, nn, dd, kk) == (b, n, d, k1)
    if route == WG:
        assert (bq, rows, chunks) == scan.wg_plan(n, b, k1, SMS)
        assert vec == 1
    else:  # the wmma tile loop, four blocks an SM
        want = scan.BQ if k1 <= scan.MAX_K1 else scan.BQ_LONG
        q_tiles = -(-b // want)
        assert bq == want
        assert vec == int((d // 2) % 16 == 0 and not offset and not row_offset)
        assert (rows, chunks) == scan._rows_per_chunk(
            n, max(1, -(-4 * SMS // q_tiles)))
    assert cs.shape == ci.shape == (b, chunks * k1)


@pytest.mark.parametrize("d,offset,wg", [(768, 0, True), (320, 0, True),
                                         (100, 0, False), (768, 4, False)])
@pytest.mark.parametrize("b,k1", [(1, 80), (64, 16), (256, 16), (256, 80),
                                  (256, 512)])
def test_int4_probe_takes_kernel_d_route_and_instance(recorded, monkeypatch,
                                                      d, offset, wg, b, k1):
    monkeypatch.setattr(probe, "_on_cpu", lambda *tensors: False)
    tile, n = 256, 8 * 256 + 100
    qv, _, ep, _, _ = _int4(b, d, n, offset)
    out = probe.score_probe(qv, ep, tile=tile, k1=k1)
    assert out.shape == (b, 8 * 128)
    [(name, entry, args)] = recorded
    assert name == "score_probe"
    (bb, nn, dd, tt, per, chunks, bq, pack, vec) = args[2:11]
    assert (bb, nn, dd, tt, pack) == (b, n, d, tile, 0)
    if wg and k1 <= scan.MAX_K1:
        assert entry == "lt_score_probe_int4" and vec == 1
        bq_, rows, chunks_ = scan.wg_plan(8 * scan.BN, b, k1, SMS)
        assert (bq, per * scan.BN, chunks) == (bq_, rows, chunks_)
    else:
        assert entry == "lt_score_probe_int4_scalar" and bq == scan.BQ
