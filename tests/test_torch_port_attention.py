"""The port's paired attention (plain version on the CPU) against JAX.

Seeded numpy q/k/v/mask go through `lattice_tpu_torch.ops.attention` and
through the JAX package's `paired_attention` (the Pallas kernel in
interpret mode, as its own tests run it) and `attention_oracle`. The
oracle adds its -1e9 bias in float64, where the bias does not absorb the
scores, so a fully masked row is compared with the kernels (the mean of V
in f32) and with the oracle only where a key is live. Tolerances: f32
2e-4 (the JAX test's own, `tests/test_models_parallel.py:444`); bf16 2e-3
on the same bf16-rounded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops.attention import attention_oracle
from lattice_tpu.ops.attention import paired_attention as jax_paired
from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import attention as attn

B, L, W = 3, 64, 256      # 4 heads of 64
SCALE = 0.125


def _inputs(seed=2, b=B, ln=L, w=W):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, ln, w)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, ln), np.int32)
    mask[0, 40:] = 0          # ragged
    mask[1, :] = 0            # fully masked
    if b > 2:
        mask[2, 5:] = 0
    return q, k, v, mask


def _jax(q, k, v, mask, dtype):
    return np.asarray(jax_paired(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(mask),
        SCALE, interpret=True))


def _port(q, k, v, mask, dtype, fn=attn.paired_attention):
    return fn(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
              torch.from_numpy(mask), SCALE).numpy()


def test_plain_f32_matches_jax_kernel_and_oracle():
    q, k, v, mask = _inputs()
    got = _port(q, k, v, mask, torch.float32)
    assert got.dtype == np.float32 and got.shape == (B, L, W)
    np.testing.assert_allclose(got, _jax(q, k, v, mask, jnp.float32),
                               atol=2e-4)
    live = mask.sum(1) > 0
    np.testing.assert_allclose(got[live],
                               attention_oracle(q, k, v, mask, SCALE)[live],
                               atol=2e-4)


def test_plain_bf16_matches_jax_kernel():
    q, k, v, mask = _inputs(seed=5)
    got = _port(q, k, v, mask, torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(q, k, v, mask, jnp.bfloat16),
                               atol=2e-3)
    # the same function on bf16-rounded inputs in f32 differs only by the
    # rounding of p before the PV product
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                  for x in (q, k, v))
    np.testing.assert_allclose(got, _port(qb, kb, vb, mask, torch.float32),
                               atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_keys_get_no_weight(dtype):
    """Perturbing the masked keys and values changes no row that has a
    live key (the JAX test's check, test_models_parallel.py:447-453)."""
    q, k, v, mask = _inputs(seed=7)
    out = _port(q, k, v, mask, dtype)
    k2, v2 = k.copy(), v.copy()
    k2[mask == 0] += 100.0
    v2[mask == 0] -= 100.0
    out2 = _port(q, k2, v2, mask, dtype)
    live = mask.sum(1) > 0
    np.testing.assert_allclose(out2[live], out[live], atol=1e-6)
    assert not np.allclose(out2[~live], out[~live])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_row_is_mean_of_v(dtype):
    q, k, v, mask = _inputs(seed=11)
    out = _port(q, k, v, mask, dtype)
    vt = torch.from_numpy(v).to(dtype).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[1], np.broadcast_to(vt[1].mean(0), (L, W)),
                               atol=1e-5)


@pytest.mark.parametrize("ln", [8, 33, 128])
def test_lengths_match_jax(ln):
    q, k, v, mask = _inputs(seed=ln, b=2, ln=ln, w=128)
    np.testing.assert_allclose(_port(q, k, v, mask, torch.float32),
                               _jax(q, k, v, mask, jnp.float32), atol=2e-4)


def _mask(kind, b, ln, seed):
    """Masks that are not prefixes (the card's kernel skips the 64-key
    tiles that hold no live key): the first 64 or 128 keys masked,
    Bernoulli(0.5) holes, or one live key at L - 1 (a partial last tile
    when L is not a multiple of 64). The last row is fully masked."""
    pos = np.arange(ln)[None, :]
    mask = {"first64": pos >= 64, "first128": pos >= 128,
            "holes": np.random.default_rng(seed).random((b, ln)) < 0.5,
            "last": pos == ln - 1}[kind]
    mask = np.broadcast_to(mask, (b, ln)).astype(np.int32).copy()
    mask[-1] = 0
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind, ln", [("first64", 192), ("first128", 192),
                                      ("holes", 192), ("last", 100),
                                      ("last", 150)])
def test_non_prefix_masks_match_jax(kind, ln, dtype):
    q, k, v, _ = _inputs(seed=ln, ln=ln)
    mask = _mask(kind, B, ln, seed=ln)
    jdt, tol = ((jnp.float32, 2e-4) if dtype == torch.float32
                else (jnp.bfloat16, 2e-3))
    got = _port(q, k, v, mask, dtype)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(q, k, v, mask, jdt), atol=tol)
    if dtype == torch.float32:
        live = mask.sum(1) > 0
        np.testing.assert_allclose(
            got[live], attention_oracle(q, k, v, mask, SCALE)[live],
            atol=tol)


def _attend(q, k, v, mask, sm_scale):
    """`paired_attention_plain`'s arithmetic step for step, with K, V and
    the mask of their own length (not Q's)."""
    neg = torch.where(mask > 0, 0.0, attn.MASKED).to(torch.float32)
    s = attn._heads(q) @ attn._heads(k).transpose(-1, -2)
    s = s * sm_scale + neg[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    c = p.to(v.dtype).float() @ attn._heads(v)
    return (c / p.sum(dim=-1, keepdim=True)).transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropping_all_masked_key_tiles_is_exact(dtype):
    """The invariant the card's tile skip rests on: in a row with a live
    key, a whole 64-key tile of masked keys adds exp(-1e9 - max) = 0 to
    every sum, so dropping it from K, V and the mask changes nothing. In a
    row with no live key every key counts (the mean of V), so dropping a
    tile changes the output and the kernel must run every tile there."""
    ln = 192
    q, k, v, _ = _inputs(seed=13, ln=ln)
    mask = _mask("holes", B, ln, seed=13)
    mask[0, :64] = 0                  # tile 0 masked, tiles 1 and 2 live
    mask[1, :64] = mask[1, 128:] = 0  # only tile 1 live
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    mask = torch.from_numpy(mask)
    out = attn.paired_attention(q, k, v, mask, SCALE)
    torch.testing.assert_close(_attend(q, k, v, mask, SCALE), out,
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        out.numpy(), _jax(*(x.float().numpy() for x in (q, k, v)),
                          mask.numpy(),
                          jnp.float32 if dtype == torch.float32
                          else jnp.bfloat16),
        atol=2e-4 if dtype == torch.float32 else 2e-3)
    for row, drop in ((0, [0]), (1, [0, 2]), (2, [0])):
        keep = torch.cat([torch.arange(64 * t, 64 * t + 64)
                          for t in range(ln // 64) if t not in drop])
        less = _attend(q[row:row + 1], k[row:row + 1, keep],
                       v[row:row + 1, keep], mask[row:row + 1, keep], SCALE)
        diff = (less - out[row:row + 1]).abs().max().item()
        if row < 2:
            assert diff <= 1e-6, (row, diff)
        else:
            assert diff > 1e-3, (row, diff)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_masked_row_at_encoder_score_range(dtype):
    """Unit-normal q/k at the encoder's scale and longest length: the
    -1e9 bias absorbs every score (|dot * 0.125| stays far below half an
    f32 ulp of 1e9, 32), so all scores of a row without a live key are
    equal and the row is the mean of V, as the card's folded
    `dot * scale * log2 e + bias * log2 e` relies on."""
    ln = attn.MAX_LEN
    q, k, v, _ = _inputs(seed=17, b=2, ln=ln)
    mask = np.ones((2, ln), np.int32)
    mask[1] = 0
    got = _port(q, k, v, mask, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(dtype).float().numpy()
                  for x in (q, k, v))
    dots = np.einsum("lhd,mhd->hlm", qt[1].reshape(ln, -1, 64),
                     kt[1].reshape(ln, -1, 64)) * SCALE
    assert 1.0 < np.abs(dots).max() < 32.0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], np.broadcast_to(vt[1].mean(0),
                                                       (ln, W)), atol=1e-5)
    np.testing.assert_allclose(
        got, _jax(q, k, v, mask,
                  jnp.float32 if dtype == torch.float32 else jnp.bfloat16),
        atol=2e-4 if dtype == torch.float32 else 2e-3)


def test_cpu_tensors_launch_nothing():
    before = _build.launch_counts()["paired_attention"]
    q, k, v, mask = _inputs()
    np.testing.assert_array_equal(
        _port(q, k, v, mask, torch.float32),
        _port(q, k, v, mask, torch.float32, attn.paired_attention_plain))
    assert _build.launch_counts()["paired_attention"] == before
    assert attn.PAIRED_ATTENTION.replaces == "lattice_tpu/ops/attention.py:42"


@pytest.mark.parametrize("case", ["float16", "odd_heads", "too_long",
                                  "mask_shape", "mixed_dtypes"])
def test_kernel_wrapper_refuses(case, monkeypatch):
    """What the CUDA wrapper refuses, checked before any launch (the CPU
    dispatch is switched off so that the kernel path's checks run)."""
    monkeypatch.setattr(attn, "_on_cpu", lambda *t: False)
    b, ln, w, dt = 2, 64, 256, torch.bfloat16
    if case == "odd_heads":
        w = 192
    if case == "too_long":
        ln = attn.MAX_LEN + 1
    q = torch.zeros((b, ln, w), dtype=torch.float16 if case == "float16"
                    else dt)
    k = torch.zeros((b, ln, w), dtype=torch.float32 if case == "mixed_dtypes"
                    else q.dtype)
    mask = torch.ones((b, ln + (case == "mask_shape")), dtype=torch.int32)
    with pytest.raises(KernelError):
        attn.paired_attention(q, k, q.clone(), mask, SCALE)
