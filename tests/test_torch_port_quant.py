"""Port int8 quantization and QuantizedView against the JAX package.

Quantization must be bit-equal (both round half to even after the same
f32 division), so the two packages hold identical int8 shadows; searches
through the view agree on ids, with scores within 1e-5 (f32 rescore in
two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.ops import quant
from lattice_tpu_torch.ops import topk as topk_ops


def _rows(rng, n, d):
    return topk_ops.l2_normalize(rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [None, 64])
def test_quantize_rows_device_bit_equal(monkeypatch, dtype, block):
    if block is not None:  # exercise the blocked path at a small size
        monkeypatch.setattr(quant, "QUANT_BLOCK", block)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 96)).astype(np.float32)
    x[[3, 77]] = 0.0                                 # all-zero rows
    x[5] = np.linspace(-1, 1, 96)                    # exact .5 quotients
    v, s = quant.quantize_rows_device(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    jv, js = jax_quant.quantize_rows_device(jnp.asarray(x, dtype))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not v[3].any() and s[3] == 0


def test_quantize_rows_numpy_matches_jax():
    rng = np.random.default_rng(2)
    x = _rows(rng, 50, 64)
    v, s = quant.quantize_rows(x)
    jv, js = jax_quant.quantize_rows(x)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("dtype,d,k", [("bfloat16", 256, 10),
                                       ("float32", 64, 5),
                                       ("bfloat16", 768, 20)])
def test_quantized_view_search_matches_jax(dtype, d, k):
    rng = np.random.default_rng(d + k)
    n, b = 1500, 12
    emb = _rows(rng, n, d)
    q = rng.normal(size=(b, d)).astype(np.float32)   # raw queries
    valid = rng.random(n) < 0.9
    t_emb = torch.from_numpy(emb).to(getattr(torch, dtype))
    j_emb = jnp.asarray(emb, dtype)
    view = quant.QuantizedView(t_emb)
    j_view = jax_quant.QuantizedView(j_emb)
    np.testing.assert_array_equal(view.values.numpy(),
                                  np.asarray(j_view.values))
    s, i = view.search(q, torch.from_numpy(valid), k, full_precision=t_emb)
    j_s, j_i = j_view.search(q, jnp.asarray(valid), k, full_precision=j_emb)
    np.testing.assert_array_equal(i, np.asarray(j_i))
    np.testing.assert_allclose(s, np.asarray(j_s), atol=1e-5)
    # first stage only (no rescore)
    s1, i1 = view.search(q, torch.from_numpy(valid), k)
    j_s1, j_i1 = j_view.search(q, jnp.asarray(valid), k)
    np.testing.assert_array_equal(i1, np.asarray(j_i1))
    np.testing.assert_allclose(s1, np.asarray(j_s1), atol=1e-6)


def test_update_rows_stays_bit_equal():
    rng = np.random.default_rng(3)
    emb = _rows(rng, 300, 128)
    t_emb = torch.from_numpy(emb).to(torch.bfloat16)
    view = quant.QuantizedView(t_emb)
    j_view = jax_quant.QuantizedView(jnp.asarray(emb, jnp.bfloat16))
    new = _rows(rng, 7, 128)                         # f32 delta rows
    idx = np.array([0, 5, 6, 100, 150, 298, 299])
    view.update_rows(torch.from_numpy(new), torch.from_numpy(idx))
    j_view.update_rows(jnp.asarray(new), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(view.values.numpy(),
                                  np.asarray(j_view.values))
    np.testing.assert_array_equal(view.scales.numpy(),
                                  np.asarray(j_view.scales))
    # the delta rows quantize from f32, not from their bf16 rounding
    f_v, _ = quant.quantize_rows_device(torch.from_numpy(new))
    assert torch.equal(view.values[idx], f_v)
    assert view.memory_bytes() == 300 * 128 + 300 * 4


def test_int8_topk_is_the_plain_kernel_c():
    rng = np.random.default_rng(4)
    qv, qs = quant.quantize_rows(_rows(rng, 4, 64))
    ev, es = quant.quantize_rows(_rows(rng, 400, 64))
    valid = np.ones(400, dtype=bool)
    s, i = quant.int8_topk(*map(torch.from_numpy, (qv, qs, ev, es, valid)), 9)
    j_s, j_i = jax_quant.int8_topk(*map(jnp.asarray, (qv, qs, ev, es, valid)),
                                   9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-6)
