"""The port's score-floor probe against the round-2 scripts' Pallas kernels.

The three probe kernels are closures inside the scripts' `main()`, so their
bodies are copied here, each cited by file:line, and run with
`pl.pallas_call(..., interpret=True)` on the CPU with the scripts' grid and
block specs. The same seeded numpy inputs go through
`lattice_tpu_torch.ops.probe.score_probe` (its plain version on CPU
tensors) at N = 2,048 rows plus a ragged tail of 100, D = 96, B = 8,
tiles 256 and 512:

- int8 (rawmax and pack) and int4 are bit-equal: integer sums below 2^24;
- bf16 rawmax within 1e-5: the same bf16 products summed in f32 in
  another order (|score| <= 1 over 96 terms);
- bf16 pack key-equal on >= 99% of bins, and elsewhere within one score
  step of the key (4,096 key units; 8,192 where the column takes bit 12):
  a sum that differs in its last bits can cross a truncation boundary;
- the tail past (N // tile) * tile is dropped.

int4 runs on bytes packed by `lattice_tpu.ops.quant.quantize_rows_int4`
(low nibble v + 8), which the scripts unpack as two's complement: the
quirk is part of what is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lattice_tpu.ops import pallas_topk as pk
from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build, probe
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.tools import dissect

N, TAIL, D, B = 2048, 100, 96, 8
TILES = (256, 512)
BF16_TOL = 1e-5
t = torch.from_numpy


# ---- the scripts' kernel bodies --------------------------------------------


def _kern_bf16(mode, tile):
    """scripts/r2_tpu_experiments6.py:109-118 (`kern_bf16`); the same
    function as r2_tpu_experiments3.py:106-121 (`make_probe.kern`)."""
    def kern_bf16(q_ref, e_ref, out_ref):
        s = jax.lax.dot_general(
            q_ref[:].astype(e_ref.dtype), e_ref[:],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        b = s.shape[0]
        if mode == "pack":
            cols = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
            s = pk._pack_keys_fast(s, cols).astype(jnp.float32)
        out_ref[:] = jnp.max(s.reshape(b, tile // 128, 128), axis=1)
    return kern_bf16


def _kern_bf16_script3(mode, tile):
    """scripts/r2_tpu_experiments3.py:106-121 (`make_probe.kern`): the max
    over the i32 keys, then the cast."""
    def kern(q_ref, e_ref, out_ref):
        e_tile = e_ref[:]
        scores = jax.lax.dot_general(
            q_ref[:].astype(e_tile.dtype), e_tile,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        b = scores.shape[0]
        if mode == "rawmax":
            out_ref[:] = jnp.max(
                scores.reshape(b, tile // 128, 128), axis=1)
        else:  # pack
            cols = jax.lax.broadcasted_iota(jnp.int32, (b, tile), 1)
            keys = pk._pack_keys_fast(scores, cols)
            out_ref[:] = jnp.max(
                keys.reshape(b, tile // 128, 128), axis=1
            ).astype(jnp.float32)
    return kern


def _kern_int8(mode, tile):
    """scripts/r2_tpu_experiments6.py:120-130 (`kern_int8`)."""
    def kern_int8(q_ref, e_ref, out_ref):
        acc = jax.lax.dot_general(
            q_ref[:], e_ref[:],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        b = acc.shape[0]
        s = acc.astype(jnp.float32)
        if mode == "pack":
            cols = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
            s = pk._pack_keys_fast(s, cols).astype(jnp.float32)
        out_ref[:] = jnp.max(s.reshape(b, tile // 128, 128), axis=1)
    return kern_int8


def _kern_int4(mode, tile):
    """scripts/r2_tpu_experiments6.py:132-146 (`kern_int4`); the same body
    as r2_tpu_experiments4.py:121-135 (`make_int4_probe.kern`)."""
    def kern_int4(q_ref, e_ref, out_ref):
        x = e_ref[:].astype(jnp.int32)
        lo = (((x & 0xF) ^ 8) - 8).astype(jnp.int8)
        hi = (x >> 4).astype(jnp.int8)
        qq = q_ref[:]
        dh = x.shape[1]
        dims = (((1,), (1,)), ((), ()))
        acc = jax.lax.dot_general(qq[:, :dh], lo, dimension_numbers=dims,
                                  preferred_element_type=jnp.int32)
        acc = acc + jax.lax.dot_general(
            qq[:, dh:], hi, dimension_numbers=dims,
            preferred_element_type=jnp.int32)
        b = acc.shape[0]
        out_ref[:] = jnp.max(
            acc.reshape(b, tile // 128, 128), axis=1).astype(jnp.float32)
    return kern_int4


def _run_pallas(kern, q, e, tile):
    """The scripts' call (r2_tpu_experiments6.py:154-168), in interpret
    mode: grid N // tile, the whole query block, one row tile per step."""
    n, b = e.shape[0], q.shape[0]
    return np.asarray(pl.pallas_call(
        kern,
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec((b, q.shape[1]), lambda j: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, e.shape[1]), lambda j: (j, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((b, 128), lambda j: (0, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, (n // tile) * 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(e)))


# ---- inputs -----------------------------------------------------------------


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(kind, seed=0):
    """(numpy q, numpy rows) of the probe of `kind` at N + TAIL rows."""
    rng = np.random.default_rng(seed)
    q, e = _unit(rng, B, D), _unit(rng, N + TAIL, D)
    if kind == "bf16":
        return q, np.array(jnp.asarray(e, jnp.bfloat16))
    qv, _ = jax_quant.quantize_rows(q)
    if kind == "int8":
        return qv, jax_quant.quantize_rows(e)[0]
    return qv, jax_quant.quantize_rows_int4(e)[0]


def _torch(kind, e):
    return t(e.view(np.int16)).view(torch.bfloat16) if kind == "bf16" else t(e)


def _port(kind, q, e, tile, mode):
    return probe.score_probe(t(q), _torch(kind, e), tile=tile,
                             mode=mode).numpy()


def _step(tile):
    """One score step of a packed key, in key units: the low bits the
    key clears, or the column's top bit where it reaches past them."""
    return 1 << max(12, (tile - 1).bit_length())


# ---- the port against the scripts ------------------------------------------


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", ["rawmax", "pack"])
def test_int8_probe_bit_equal_to_script(tile, mode):
    q, e = _inputs("int8")
    want = _run_pallas(_kern_int8(mode, tile), q, e, tile)
    got = _port("int8", q, e, tile, mode)
    assert got.shape == want.shape == (B, N // tile * 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", ["rawmax", "pack"])
def test_int4_probe_bit_equal_to_script(tile, mode):
    """The int4 body ignores `mode`; so does the port."""
    q, e = _inputs("int4")
    assert e.shape == (N + TAIL, D // 2)
    want = _run_pallas(_kern_int4(mode, tile), q, e, tile)
    got = _port("int4", q, e, tile, mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kern", [_kern_bf16, _kern_bf16_script3])
def test_bf16_rawmax_probe_matches_script(tile, kern):
    q, e = _inputs("bf16")
    want = _run_pallas(kern("rawmax", tile), q, e, tile)
    got = _port("bf16", q, e, tile, "rawmax")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kern", [_kern_bf16, _kern_bf16_script3])
def test_bf16_pack_probe_matches_script(tile, kern):
    q, e = _inputs("bf16")
    want = _run_pallas(kern("pack", tile), q, e, tile)
    got = _port("bf16", q, e, tile, "pack")
    same = got == want
    assert same.mean() >= 0.99, same.mean()
    assert np.abs(got - want).max() <= _step(tile)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_tail_rows_are_dropped(kind):
    q, e = _inputs(kind, seed=3)
    tile = 512
    base = _port(kind, q, e, tile, "rawmax")
    moved = e.copy()
    moved[N:] = moved[:TAIL][::-1]        # other rows in the ragged tail
    np.testing.assert_array_equal(_port(kind, q, moved, tile, "rawmax"), base)
    moved[N - 1] = moved[0]               # the last full tile's row counts
    assert not np.array_equal(_port(kind, q, moved, tile, "rawmax"), base)


def test_int4_probe_reads_the_low_nibble_as_twos_complement():
    """On biased bytes the scripts' product is not the view's: the quirk
    kept on purpose."""
    q, e = _inputs("int4", seed=5)
    tile = 256
    got = _port("int4", q, e, tile, "rawmax")
    view = scan.unpack_int4(t(e)).to(torch.float32)
    signed = probe.unpack_int4_signed(t(e)).to(torch.float32)
    assert not torch.equal(view, signed)
    acc = (t(q).to(torch.float32) @ signed[:N].T).view(B, N // tile,
                                                       tile // 128, 128)
    np.testing.assert_array_equal(got, acc.amax(2).reshape(B, -1).numpy())


# ---- pieces and checks ------------------------------------------------------


@pytest.mark.parametrize("shift", [12, 13])
def test_pack_keys_fast_bit_equal_to_jax(shift):
    rng = np.random.default_rng(shift)
    s = rng.uniform(-1.2, 1.2, size=(4, 300)).astype(np.float32)
    s[0, :5] = [-1e30, -2.5, 0.0, -0.0, 1.0]
    cols = np.broadcast_to(np.arange(300, dtype=np.int32), s.shape)
    want = np.asarray(pk._pack_keys_fast(jnp.asarray(s), jnp.asarray(cols),
                                         shift))
    got = probe.pack_keys_fast(t(s), t(np.ascontiguousarray(cols)), shift)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_blocks_agree_with_one_block(monkeypatch):
    """The plain version scores PLAIN_BLOCK rows at a time; the result does
    not depend on the block."""
    q, e = _inputs("int8", seed=7)
    whole = _port("int8", q, e, 256, "pack")
    monkeypatch.setattr(probe, "PLAIN_BLOCK", 512)
    np.testing.assert_array_equal(_port("int8", q, e, 256, "pack"), whole)


def test_cpu_tensors_take_the_plain_version_without_launching():
    _build.reset_launch_counts()
    for kind in ("bf16", "int8", "int4"):
        q, e = _inputs(kind)
        _port(kind, q, e, 256, "pack")
    assert _build.launch_counts()["score_probe"] == 0


def test_fewer_rows_than_a_tile_give_an_empty_result():
    q, e = _inputs("int8")
    out = probe.score_probe(t(q), t(e[:200]), tile=256)
    assert out.shape == (B, 0) and out.dtype == torch.float32


@pytest.mark.parametrize("bad", ["tile", "mode", "width", "dtype"])
def test_bad_arguments_raise(bad):
    q, e = _inputs("int8")
    q, e = t(q), t(e)
    kw = {"tile": 256, "mode": "rawmax"}
    if bad == "tile":
        kw["tile"] = 200
    elif bad == "mode":
        kw["mode"] = "keys"
    elif bad == "width":
        e = e[:, :40]
    else:
        q = q.to(torch.float32)
    with pytest.raises((KernelError, ValueError)):
        probe.score_probe(q, e, **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_check_probe_accepts_the_plain_version(kind):
    q, e = _inputs(kind, seed=11)
    for mode in ("rawmax",) if kind == "int4" else probe.MODES:
        ref = probe.score_probe_plain(t(q), _torch(kind, e), tile=512,
                                      mode=mode)
        assert dissect.check_probe(ref.clone(), ref, kind, mode, 512,
                                   "test") == (0.0, 1.0)


@pytest.mark.parametrize("fault", ["row_tile", "int8_sum", "rawmax", "shape"])
def test_check_probe_refuses_a_wrong_output(fault):
    """A bf16 pack key with a wrong row tile i (bits 7-12) is within one
    score step of the right one, so only the share of equal bins catches
    it; an integer sum off by one and a bf16 score off by 2e-4 fail too."""
    kind = "int8" if fault == "int8_sum" else "bf16"
    mode = "pack" if fault == "row_tile" else "rawmax"
    q, e = _inputs(kind, seed=13)
    ref = probe.score_probe_plain(t(q), _torch(kind, e), tile=512, mode=mode)
    if fault == "row_tile":
        out = (ref.to(torch.int64) ^ (1 << 7)).to(torch.float32)
        assert (out - ref).abs().max().item() < _step(512)
    elif fault == "int8_sum":
        out = ref.clone()
        out[1, 3] += 1
    elif fault == "rawmax":
        out = ref + 2e-4
    else:
        out = ref[:, :-128]
    with pytest.raises(KernelError, match="score_probe"):
        dissect.check_probe(out, ref, kind, mode, 512, "test")
