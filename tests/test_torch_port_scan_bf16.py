"""Kernel A's blocking and route on the CPU, against the JAX package.

Kernel A (`scan_topk`) runs on bf16 rows on kernel C's `wgmma` main loop
(`csrc/scan_wg.cuh`) where the shape allows it, one block an SM, 128 or
64 queries a block, from a bf16 copy of the queries. What of that lives
in Python is tested here, with inputs made from a numpy seed:

- (a) the plan as a pure function (`wg_plan`, `wg_block_queries`,
  `wg_smem_bytes`, shared with kernel C): whole 128-row tiles, chunks
  that cover the rows with none empty, at most one wave of blocks, the
  instance by batch and list length, every instance's shared memory under
  the H100's 227 KB at every list it takes, and the constants the CUDA
  source shares with it;
- (b) the blocking emulated on the CPU: `scan_topk_plain` over each chunk
  of the plan, padded as the kernel pads a short chunk, then
  `merge_candidates_plain`, equal to JAX's exact scan of the bf16-cast
  queries (`flat_topk`) and, rescored, held to the Pallas `binned_topk`
  (interpret mode, tile 128) within its packed keys;
- (c) the same on `chip_smoke.bf16_cases` (ties across tile and chunk
  edges, invalid chunks, fewer live rows than k1), where tied rows rank
  by the lower id;
- (d) the route: `scan_blocks` and the bf16 `score_probe` name the wgmma
  entry for bf16 rows with d % 8 == 0 and 16-byte aligned queries and
  rows, with the plan's instance and chunking and a bf16 copy of the
  queries equal to JAX's `astype(bfloat16)` bit for bit, and the wmma tile
  loop otherwise (d = 100, misaligned queries or rows, f32 rows), checked
  through a recorded `Kernel.launch` with no CUDA.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import pallas_topk as jax_scan
from lattice_tpu.ops import topk as jax_topk
from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build, probe
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.ops import topk as topk_ops

from chip_smoke import bf16_cases, bf16_values

t = torch.from_numpy
SMS = 132                       # the H100's SMs
EMPTY_ID = 0x7FFFFFFF           # an empty list slot's id (topk_select.cuh)
CSRC = Path(scan.__file__).resolve().parent.parent / "csrc"


# ---- (a) the plan ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4099, 70_000, 1 << 20,
                               3_000_001])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 128, 129, 256, 300, 20_000])
def test_plan_tiles_cover_the_rows_in_one_wave(n, b):
    for k1 in (1, 16, 32, 33, 128):
        for sms in (SMS, 7):
            bq, rows, chunks = scan.wg_plan(n, b, k1, sms)
            q_tiles = -(-b // bq)
            assert rows >= scan.BN and rows % scan.BN == 0
            assert (chunks - 1) * rows < n <= chunks * rows  # none empty
            assert chunks * q_tiles <= max(sms, q_tiles)     # one wave
            assert bq == scan.wg_block_queries(b, k1)


@pytest.mark.parametrize("b,k1,bq", [(1, 16, 64), (64, 16, 64), (65, 16, 128),
                                     (256, 1, 128), (256, 32, 128),
                                     (256, 33, 64), (256, 64, 64),
                                     (256, 128, 64), (5000, 16, 128)])
def test_instance_by_batch_and_list_length(b, k1, bq):
    assert scan.wg_block_queries(b, k1) == bq


def test_one_block_an_sm_at_the_main_path_shapes():
    """1M x 768 rows: two query tiles of 66 chunks at B=256, k1=16; one
    query tile of 131 chunks at B=1; four of 33 at B=256, k1=64."""
    assert scan.wg_plan(1 << 20, 256, 16, SMS) == (128, 16_000, 66)
    assert scan.wg_plan(1 << 20, 1, 16, SMS) == (64, 8064, 131)
    assert scan.wg_plan(1 << 20, 256, 64, SMS) == (64, 31_872, 33)


def test_every_instance_fits_its_shared_memory():
    for k1 in range(1, scan.MAX_K1 + 1):
        for b in (1, 64, 65, 256):
            bq = scan.wg_block_queries(b, k1)
            assert scan.wg_smem_bytes(bq, k1) <= scan.SMEM_MAX, (b, k1)
    for k1 in range(1, scan.K1_WIDE + 1):
        assert scan.wg_smem_bytes(scan.BQ_WIDE, k1) <= scan.SMEM_MAX
    assert scan.wg_smem_bytes(scan.BQ_WIDE, 2 * scan.K1_WIDE) \
        > scan.SMEM_MAX


def test_python_mirrors_the_cuda_source():
    """The bf16 operand of the wgmma loop reads 128 bytes of each row a k
    slab (64 dims), so the ring, the score tile and the lists take the
    bytes `wg_smem_bytes` counts, as for int8."""
    wg = (CSRC / "scan_wg.cuh").read_text()
    topk = (CSRC / "scan_topk.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", wg)[1])

    assert const("WG_BK") == scan.WG_BK == 128
    assert const("WG_BN") == scan.WG_BN
    bf16 = wg[wg.index("struct WgBf16"):]
    bf16 = bf16[:bf16.index("};")]
    assert "static constexpr int K = WG_BK / 2;" in bf16
    assert "using Acc = float;" in bf16
    assert "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16" in bf16
    assert "m64n64k16.f32.bf16.bf16" in bf16
    # four k steps of 16 bf16 (32 bytes, +2 on the descriptor) a slab
    assert "Op::mma(acc, da + 2 * kk, db + 2 * kk" in wg
    assert "for (int kk = 0; kk < 4; ++kk)" in wg
    # the selection epilogue's lists: two of k1 per query, as Python's
    assert "return 2 * round_up((size_t)BQ_ * k1 * 4);" in topk
    assert "scan_topk_bf16_wg_kernel" in topk
    assert "wg_smem_bytes<BQ_>(select_epi_bytes<BQ_>(k1))" in topk
    stages = re.search(r"STAGES = BQ_ == BQ_WIDE \? (\d+) : (\d+);", wg)
    ring = [int(stages[1]) * (scan.WG_BN + 2 * 64) * scan.WG_BK,
            int(stages[2]) * (scan.WG_BN + 64) * scan.WG_BK]
    for bq, want in zip((scan.BQ_WIDE, scan.BQ), ring):
        rest = (1024 + const("WG_BAR_BYTES") + bq * scan.WG_SC_LD * 4
                + 2 * bq * 4 * 4)
        assert scan.wg_smem_bytes(bq, 4) == want + rest


# ---- (b) and (c) the blocking, emulated --------------------------------------


def emulate_blocks(q, emb, valid, k1, sms):
    """What kernel A writes for kernel B: per chunk of `wg_plan`, the
    exact top-k1 of the chunk's rows (global ids) at the bf16 queries,
    its empty slots (a chunk of fewer than k1 rows) as (-inf, EMPTY_ID)."""
    n, b = emb.shape[0], q.shape[0]
    _, rows, chunks = scan.wg_plan(n, b, k1, sms)
    cand_s, cand_i = [], []
    for c in range(chunks):
        lo, hi = c * rows, min((c + 1) * rows, n)
        kk = min(k1, hi - lo)
        s, i = scan.scan_topk_plain(q, emb[lo:hi], valid[lo:hi], kk)
        pad = k1 - kk
        cand_s.append(torch.nn.functional.pad(s, (0, pad),
                                              value=float("-inf")))
        cand_i.append(torch.nn.functional.pad(i + lo, (0, pad),
                                              value=EMPTY_ID))
    return torch.cat(cand_s, 1), torch.cat(cand_i, 1), chunks


def _random_rows(seed, n, b, d, live):
    rng = np.random.default_rng(seed)
    q = topk_ops.l2_normalize(rng.normal(size=(b, d)).astype(np.float32))
    e = bf16_values(topk_ops.l2_normalize(
        rng.normal(size=(n, d)).astype(np.float32)))
    return q, e, rng.random(n) < live


BF16_CASES = {c[0]: c[1:] for c in bf16_cases(13, n=1500, b=6, d=64)}
BF16_CASES["random rows"] = _random_rows(14, 1500, 6, 64, 0.8)


def _tensors(name):
    q, e, valid = BF16_CASES[name]
    return t(q), t(e).to(torch.bfloat16), t(valid)


@pytest.mark.parametrize("sms", [3, 11])
@pytest.mark.parametrize("k1", [1, 16, 33, 128])
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_emulated_blocking_equals_jax_exact_scan(name, k1, sms):
    """Against JAX's exact scan of the bf16-cast queries (`flat_topk`: the
    queries cast to the rows' bf16, f32 sums): ids equal, scores within
    1e-6 (exact bf16 products summed in another order)."""
    q, emb, valid = _tensors(name)
    cs, ci, chunks = emulate_blocks(q, emb, valid, k1, sms)
    assert chunks > 1
    s, i = scan.merge_candidates_plain(cs, ci, k1)
    j_s, j_i = jax_topk.flat_topk(jnp.asarray(q.numpy()),
                                  jnp.asarray(BF16_CASES[name][1],
                                              jnp.bfloat16),
                                  jnp.asarray(valid.numpy()), k1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-6)
    # and the wrapper's plain version, which the card holds the kernel to
    ps, pi = scan.scan_topk(q, emb, valid, k1)
    assert torch.equal(pi, i)
    np.testing.assert_allclose(ps.numpy(), s.numpy(), atol=1e-6)


@pytest.mark.parametrize("k1", [16, 64])
def test_tied_rows_rank_by_the_lower_id(k1):
    """Every row a copy of row r % 7: each run of equal scores holds one
    group's rows from its lowest id up, in steps of 7, as the card's check
    (`chip_smoke.check_bf16`) requires of the kernel."""
    q, emb, valid = _tensors("ties across tile and chunk edges")
    cs, ci, _ = emulate_blocks(q, emb, valid, k1, 11)
    s, i = scan.merge_candidates_plain(cs, ci, k1)
    same = s[:, 1:] == s[:, :-1]
    assert bool(same.any())
    assert bool(torch.where(same, i[:, 1:] == i[:, :-1] + 7,
                            i[:, 1:] < 7).all())
    assert bool((i[:, 0] < 7).all())


def test_bf16_cases_are_what_they_say():
    cases = bf16_cases(13, n=1500, b=6, d=64)
    assert [c[0] for c in cases] == ["ties across tile and chunk edges",
                                     "chunks entirely invalid",
                                     "fewer live rows than k1"]
    for name, q, e, valid in cases:
        assert q.dtype == e.dtype == np.float32 and valid.dtype == bool
        assert q.shape == (6, 64) and e.shape == (1500, 64)
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, atol=1e-6)
        # every row value is a bf16 value
        assert np.array_equal(
            t(e).to(torch.bfloat16).to(torch.float32).numpy(), e)
        if name.startswith("ties"):
            assert np.array_equal(e[:7], e[7:14]) and valid.all()
        elif name.startswith("chunks"):
            assert not valid[200:750].any() and not valid[-700:].any()
        else:
            assert valid.sum() == 20 < 33
    # at the plan's chunking the invalid run covers whole chunks
    _, rows, _ = scan.wg_plan(1500, 6, 16, 11)
    assert any(not cases[1][3][lo:lo + rows].any()
               for lo in range(0, 1500, rows))


def test_bf16_values_round_as_torch_and_jax():
    x = np.random.default_rng(15).normal(size=(64, 33)).astype(np.float32)
    x[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -130]
    want = t(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(bf16_values(x).view(np.uint32),
                          want.view(np.uint32))
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(j.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["ties across tile and chunk edges",
                                  "chunks entirely invalid", "random rows"])
def test_emulated_blocking_against_pallas_interpret(name):
    """The emulated first stage at k1 = 16, rescored in f32 as
    `binned_topk` rescores, against the Pallas `binned_topk` at tile 128
    (each row its own bin, so only its ~1e-3 packed keys differ): ids
    agree on >= 99%, a disagreement is a near-tie within 2e-3, agreed
    scores within 1e-5 (as `test_binned_topk_matches_oracle_and_jax`).
    Two copies of one row score alike (within 1e-6), so the Pallas keys,
    which rank a tie by the higher column, may name another copy: that is
    no disagreement."""
    q, e, valid = BF16_CASES[name]
    n, k, k1, tile = 1280, 10, 16, 128  # `binned_topk` takes whole tiles
    e, valid = e[:n], valid[:n]
    tq, temb, tv = t(q), t(e).to(torch.bfloat16), t(valid)
    cs, ci, _ = emulate_blocks(tq, temb, tv, k1, 5)
    s1, c1 = scan.merge_candidates_plain(cs, ci, k1)
    s, i = (x.numpy() for x in scan._exact_rescore(tq, temb, s1, c1, k))
    pe, pv = jax_scan.pad_for_tile(np.asarray(jnp.asarray(e, jnp.bfloat16)),
                                   valid, tile)
    j_s, j_i = jax_scan.binned_topk(jnp.asarray(q), jnp.asarray(pe),
                                    jnp.asarray(pv), k, tile=tile,
                                    interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    live = s > topk_ops.NEG_INF / 2
    agree = (i == j_i) | ~live | (np.abs(s - j_s) <= 1e-6)
    assert agree.mean() >= 0.99
    assert np.all(np.abs(s - j_s)[~agree] < 2e-3)
    np.testing.assert_allclose(s[agree & live], j_s[agree & live], atol=1e-5)
    assert not set(i[live].tolist()) & set(np.flatnonzero(~valid).tolist())


# ---- (d) the route -----------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Kernel launches recorded, not made: no CUDA is touched. A launch of
    a wgmma entry also records the bf16 queries it was handed, read from
    their pointer while the wrapper holds them."""
    calls = []
    monkeypatch.setattr(scan, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(scan, "_stream", lambda device: 0)
    monkeypatch.setattr(probe, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(probe, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())

    def record(kernel, entry, *args):
        q_bytes = None
        if entry in ("lt_scan_topk_bf16", "lt_score_probe_bf16"):
            b, d = ((args[3], args[5]) if kernel is scan.SCAN_TOPK
                    else (args[2], args[4]))
            q_bytes = ctypes.string_at(args[0], 2 * b * d)
        calls.append((kernel.name, entry, args, q_bytes))

    for kernel in (scan.SCAN_TOPK, probe.SCORE_PROBE):
        monkeypatch.setattr(kernel, "launch",
                            lambda entry, *args, k=kernel: record(k, entry,
                                                                  *args))
    _build.reset_launch_counts()
    yield calls
    assert set(_build.launch_counts().values()) == {0}


def _at(shape, dtype, offset):
    """A tensor of `shape` whose data starts `offset` bytes past a 16-byte
    boundary, filled from a seed."""
    size = torch.tensor([], dtype=dtype).element_size()
    count = shape[0] * shape[1]
    buf = torch.zeros(count + 64 // size, dtype=dtype)
    base = ((16 - buf.data_ptr() % 16) % 16 + offset) // size
    x = buf[base:base + count].view(shape)
    vals = np.random.default_rng(count).normal(size=shape).astype(np.float32)
    x.copy_(t(vals).to(dtype))
    return x


def _jax_bf16_bytes(q: torch.Tensor) -> bytes:
    return np.asarray(jnp.asarray(q.numpy()).astype(jnp.bfloat16)).tobytes()


@pytest.mark.parametrize("d,offset,row_offset,dtype,route", [
    (768, 0, 0, torch.bfloat16, "lt_scan_topk_bf16"),
    (256, 0, 0, torch.bfloat16, "lt_scan_topk_bf16"),
    (1024, 0, 0, torch.bfloat16, "lt_scan_topk_bf16"),
    (776, 0, 0, torch.bfloat16, "lt_scan_topk_bf16"),
    (8, 0, 0, torch.bfloat16, "lt_scan_topk_bf16"),
    (100, 0, 0, torch.bfloat16, "lt_scan_topk_bf16_scalar"),
    (772, 0, 0, torch.bfloat16, "lt_scan_topk_bf16_scalar"),
    (768, 4, 0, torch.bfloat16, "lt_scan_topk_bf16_scalar"),
    (768, 0, 8, torch.bfloat16, "lt_scan_topk_bf16_scalar"),
    (768, 0, 0, torch.float32, "lt_scan_topk_f32")])
@pytest.mark.parametrize("b,k1", [(1, 16), (256, 16), (256, 64)])
def test_route_by_shape(recorded, d, offset, row_offset, dtype, route, b, k1):
    n = 5000
    q = _at((b, d), torch.float32, offset)
    emb = _at((n, d), dtype, row_offset)
    valid = torch.ones(n, dtype=torch.bool)
    assert bool(q.data_ptr() % 16) == bool(offset)
    assert bool(emb.data_ptr() % 16) == bool(row_offset)
    if dtype == torch.bfloat16:
        assert scan.bf16_route(q, emb) == route
    cs, ci = scan.scan_blocks(q, emb, valid, k1)
    [(name, entry, args, q_bytes)] = recorded
    assert (name, entry) == ("scan_topk", route)
    (qp, ep, vp), (bb, nn, dd, kk, bq, rows, chunks, vec) = args[:3], args[3:11]
    assert (ep, vp) == (emb.data_ptr(), valid.data_ptr())
    assert (bb, nn, dd, kk) == (b, n, d, k1)
    if route == "lt_scan_topk_bf16":
        assert (bq, rows, chunks) == scan.wg_plan(n, b, k1, SMS)
        assert vec == 1
        # a bf16 copy of the queries, rounded as JAX rounds
        assert qp != q.data_ptr() and qp % 16 == 0
        assert q_bytes == _jax_bf16_bytes(q)
    else:  # the wmma tile loop on the f32 queries, four blocks an SM
        q_tiles = -(-b // scan.BQ)
        assert qp == q.data_ptr() and q_bytes is None
        assert (bq, vec) == (scan.BQ, int(route == "lt_scan_topk_f32"))
        assert (rows, chunks) == scan._rows_per_chunk(
            n, max(1, -(-4 * SMS // q_tiles)))
    assert cs.shape == ci.shape == (b, chunks * k1)


@pytest.mark.parametrize("d,offset,wg", [(768, 0, True), (100, 0, False),
                                         (768, 4, False)])
@pytest.mark.parametrize("b,k1", [(64, 16), (256, 16), (256, 80)])
@pytest.mark.parametrize("mode", ["rawmax", "pack"])
def test_bf16_probe_takes_kernel_a_route_and_instance(recorded, monkeypatch,
                                                      d, offset, wg, b, k1,
                                                      mode):
    monkeypatch.setattr(probe, "_on_cpu", lambda *tensors: False)
    tile, n = 256, 8 * 256 + 100
    q = _at((b, d), torch.float32, offset)
    rows = _at((n, d), torch.bfloat16, 0)
    out = probe.score_probe(q, rows, tile=tile, mode=mode, k1=k1)
    assert out.shape == (b, 8 * 128)
    [(name, entry, args, q_bytes)] = recorded
    assert name == "score_probe"
    (bb, nn, dd, tt, per, chunks, bq, pack, vec) = args[2:11]
    assert (bb, nn, dd, tt, pack) == (b, n, d, tile, int(mode == "pack"))
    assert args[1] == rows.data_ptr()
    if wg:
        assert entry == "lt_score_probe_bf16" and vec == 1
        bq_, rows_, chunks_ = scan.wg_plan(8 * scan.BN, b, k1, SMS)
        assert (bq, per * scan.BN, chunks) == (bq_, rows_, chunks_)
        assert q_bytes == _jax_bf16_bytes(q)
    else:
        assert entry == "lt_score_probe_bf16_scalar" and bq == scan.BQ
        assert args[0] == q.data_ptr() and q_bytes is None


def test_a_failed_launch_raises_and_nothing_falls_back(monkeypatch):
    """The wgmma route's failure reaches the caller as KernelError: no
    retry on the wmma loop, no plain version."""
    monkeypatch.setattr(scan, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(scan, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    entries = []

    def fail(entry, *args):
        entries.append(entry)
        raise KernelError(f"scan_topk ({entry}) failed: invalid argument [1]")

    monkeypatch.setattr(scan.SCAN_TOPK, "launch", fail)
    q = _at((4, 64), torch.float32, 0)
    emb = _at((300, 64), torch.bfloat16, 0)
    with pytest.raises(KernelError, match="lt_scan_topk_bf16"):
        scan.scan_blocks(q, emb, torch.ones(300, dtype=torch.bool), 16)
    assert entries == ["lt_scan_topk_bf16"]
