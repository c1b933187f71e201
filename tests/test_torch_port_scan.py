"""Port scan kernels (plain versions on the CPU) against the JAX package.

The same seeded numpy inputs go through `lattice_tpu_torch.ops.scan_topk`
and `lattice_tpu.ops.pallas_topk` (Pallas in interpret mode) or the JAX
package's exact XLA functions. The port's selection is exact while the
TPU kernel's packed keys resolve scores to ~1e-3 (pallas_topk.py:54-56),
so the JAX comparison allows rare swaps whose score gap is under 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import pallas_topk as jax_scan
from lattice_tpu.ops import quant as jax_quant
from lattice_tpu.ops import topk as jax_topk
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops import attention  # noqa: F401 (paired_attention)
from lattice_tpu_torch.ops import ivf  # noqa: F401 (registers ivf_probe)
from lattice_tpu_torch.ops import probe  # noqa: F401 (registers score_probe)
from lattice_tpu_torch.ops import quant
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.ops import topk as topk_ops

NEG = topk_ops.NEG_INF / 2


def _rows(rng, n, d):
    return topk_ops.l2_normalize(rng.normal(size=(n, d)).astype(np.float32))


def _as_dtype_np(x, dtype):
    """Rows as the store keeps them, widened back to f32 on the host."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


# (row dtype, d, N, B, k, live fraction)
SCAN_CASES = [
    ("bfloat16", 64, 1000, 8, 10, 0.8),
    ("bfloat16", 256, 2048, 16, 10, 0.9),
    ("float32", 64, 1500, 8, 16, 0.7),
    ("bfloat16", 768, 600, 4, 10, 0.85),
]


@pytest.mark.parametrize("dtype,d,n,b,k,live", SCAN_CASES)
def test_binned_topk_matches_oracle_and_jax(dtype, d, n, b, k, live):
    rng = np.random.default_rng(d + n + k)
    emb = _rows(rng, n, d)
    q = _rows(rng, b, d)
    valid = rng.random(n) < live
    t_emb = torch.from_numpy(emb).to(getattr(torch, dtype))
    s, i = scan.binned_topk(torch.from_numpy(q), t_emb,
                            torch.from_numpy(valid), k)
    s, i = s.numpy(), i.numpy()
    assert s.shape == (b, k) and i.shape == (b, k)
    assert np.all(np.diff(s, axis=1) <= 0)
    # exact: ids equal the f64 oracle over the stored rows
    o_s, o_i = topk_ops.topk_oracle(q, _as_dtype_np(emb, dtype), valid, k)
    np.testing.assert_array_equal(i, o_i)
    np.testing.assert_allclose(s, o_s, atol=1e-5)

    # tile 128 gives each row its own bin, so the TPU kernel loses no row
    # to a bin collision and only its ~1e-3 key resolution differs
    tile = 128
    pe, pv = jax_scan.pad_for_tile(np.asarray(jnp.asarray(emb, dtype)),
                                   valid, tile)
    j_s, j_i = jax_scan.binned_topk(jnp.asarray(q), jnp.asarray(pe),
                                    jnp.asarray(pv), k, tile=tile,
                                    interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    agree = i == j_i
    assert agree.mean() >= 0.99
    # a disagreement is a near-tie the packed keys could not resolve
    assert np.all(np.abs(s - j_s)[~agree] < 2e-3)
    np.testing.assert_allclose(s[agree], j_s[agree], atol=1e-5)


def test_binned_topk_k_above_live_rows():
    rng = np.random.default_rng(3)
    n, d, k = 300, 64, 20
    emb = _rows(rng, n, d)
    q = _rows(rng, 4, d)
    valid = np.zeros(n, dtype=bool)
    valid[rng.choice(n, 12, replace=False)] = True
    s, i = scan.binned_topk(torch.from_numpy(q),
                            torch.from_numpy(emb).to(torch.bfloat16),
                            torch.from_numpy(valid), k)
    s, i = s.numpy(), i.numpy()
    live = s > NEG
    assert live.sum(axis=1).tolist() == [12] * 4
    o_s, o_i = topk_ops.topk_oracle(q, _as_dtype_np(emb, "bfloat16"),
                                    valid, 12)
    np.testing.assert_array_equal(i[:, :12], o_i)

    pe, pv = jax_scan.pad_for_tile(np.asarray(jnp.asarray(emb, "bfloat16")),
                                   valid, 128)
    j_s, j_i = jax_scan.binned_topk(jnp.asarray(q), jnp.asarray(pe),
                                    jnp.asarray(pv), k, tile=128,
                                    interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    np.testing.assert_array_equal(j_s > NEG, live)
    np.testing.assert_array_equal(i[live], j_i[live])
    np.testing.assert_allclose(s[live], j_s[live], atol=1e-5)


def test_binned_topk_pads_when_corpus_smaller_than_k():
    rng = np.random.default_rng(4)
    emb = _rows(rng, 6, 16)
    s, i = scan.binned_topk(torch.from_numpy(emb[:2]), torch.from_numpy(emb),
                            torch.ones(6, dtype=torch.bool), 10)
    assert s.shape == (2, 10)
    assert torch.all(s[:, 6:] == topk_ops.NEG_INF)
    assert torch.all(i[:, 6:] == -1)
    assert i[0, 0] == 0 and i[1, 0] == 1


@pytest.mark.parametrize("d,n,b,k", [(64, 1000, 8, 16), (256, 3000, 16, 40),
                                     (768, 500, 3, 16)])
def test_binned_topk_int8_matches_jax_int8_topk(d, n, b, k):
    rng = np.random.default_rng(n + k)
    qv, qs = jax_quant.quantize_rows(_rows(rng, b, d))
    ev, es = jax_quant.quantize_rows(_rows(rng, n, d))
    valid = rng.random(n) < 0.8
    s, i = scan.binned_topk_int8(*map(torch.from_numpy, (qv, qs, ev, es,
                                                         valid)), k)
    assert s.shape == (b, max(k, 16))
    j_s, j_i = jax_quant.int8_topk(*map(jnp.asarray, (qv, qs, ev, es,
                                                      valid)), k)
    np.testing.assert_array_equal(i.numpy()[:, :k], np.asarray(j_i))
    np.testing.assert_allclose(s.numpy()[:, :k], np.asarray(j_s), atol=1e-6)


def test_binned_topk_int8_ties_and_padding_match_jax():
    """Duplicate rows tie exactly; fewer live rows than k1 pads NEG_INF
    with the lowest invalid ids, as `lax.top_k` does."""
    rng = np.random.default_rng(5)
    base = _rows(rng, 10, 32)
    emb = np.concatenate([base, base, base])          # rows i, i+10, i+20 tie
    ev, es = jax_quant.quantize_rows(emb)
    qv, qs = jax_quant.quantize_rows(base[:3])
    valid = np.ones(30, dtype=bool)
    valid[[1, 11, 25]] = False
    for vmask, k in ((valid, 16), (np.arange(30) < 5, 16)):
        s, i = scan.binned_topk_int8(*map(torch.from_numpy, (qv, qs, ev, es,
                                                             vmask)), k)
        j_s, j_i = jax_quant.int8_topk(*map(jnp.asarray, (qv, qs, ev, es,
                                                          vmask)), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
        np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-6)


def test_exact_rescore_matches_jax():
    rng = np.random.default_rng(6)
    n, d, b, k1, k = 400, 128, 6, 24, 10
    emb = _rows(rng, n, d)
    q = _rows(rng, b, d)
    cand = rng.integers(0, n, size=(b, k1)).astype(np.int32)
    stage = rng.normal(size=(b, k1)).astype(np.float32)
    stage[:, -5:] = topk_ops.NEG_INF          # padded first-stage slots
    emb_bf16 = torch.from_numpy(emb).to(torch.bfloat16)
    s, i = scan._exact_rescore(torch.from_numpy(q), emb_bf16,
                               torch.from_numpy(stage),
                               torch.from_numpy(cand), k)
    j_s, j_i = jax_scan._exact_rescore(
        jnp.asarray(q), jnp.asarray(emb, jnp.bfloat16), jnp.asarray(stage),
        jnp.asarray(cand), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)


def test_merge_candidates_orders_by_score_then_id():
    cs = torch.tensor([[0.5, 0.9, 0.5, -1e30, 0.9, 0.1]])
    ci = torch.tensor([[7, 3, 2, 0, 1, 9]], dtype=torch.int32)
    s, i = scan.merge_candidates(cs, ci, 4)
    assert i.tolist() == [[1, 3, 2, 7]]
    assert s[0].tolist() == pytest.approx([0.9, 0.9, 0.5, 0.5])


def test_flat_topk_blocked_matches_flat_and_jax():
    rng = np.random.default_rng(7)
    emb = _rows(rng, 1000, 32)
    q = _rows(rng, 5, 32)
    valid = rng.random(1000) < 0.9
    tq, te, tv = map(torch.from_numpy, (q, emb, valid))
    s, i = topk_ops.flat_topk(tq, te, tv, 12)
    bs, bi = topk_ops.flat_topk_blocked(tq, te, tv, 12, block=128)
    np.testing.assert_array_equal(i.numpy(), bi.numpy())
    j_s, j_i = jax_topk.flat_topk(jnp.asarray(q), jnp.asarray(emb),
                                  jnp.asarray(valid), 12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)
    ms, mi = topk_ops.merge_topk(s[:, :6], i[:, :6], s[:, 6:], i[:, 6:], 12)
    np.testing.assert_array_equal(mi.numpy(), i.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filtered_topk_and_raw_scores_match_jax(dtype):
    rng = np.random.default_rng(9)
    emb = _rows(rng, 700, 48)
    q = _rows(rng, 4, 48)
    valid = rng.random(700) < 0.9
    flt = rng.random(700) < 0.3
    te = torch.from_numpy(emb).to(getattr(torch, dtype))
    je = jnp.asarray(emb, dtype)
    raw = topk_ops.batched_matmul_scores(torch.from_numpy(q), te)
    j_raw = jax_topk.batched_matmul_scores(jnp.asarray(q), je)
    np.testing.assert_allclose(raw.numpy(), np.asarray(j_raw), atol=1e-5)
    s, i = topk_ops.flat_topk_filtered(torch.from_numpy(q), te,
                                       torch.from_numpy(valid),
                                       torch.from_numpy(flt), 9)
    j_s, j_i = jax_topk.flat_topk_filtered(jnp.asarray(q), je,
                                           jnp.asarray(valid),
                                           jnp.asarray(flt), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)
    assert np.all((valid & flt)[i.numpy()])


def test_cpu_tensors_take_the_plain_version_without_launching():
    _build.reset_launch_counts()
    rng = np.random.default_rng(8)
    emb = torch.from_numpy(_rows(rng, 200, 32))
    scan.binned_topk(emb[:3], emb, torch.ones(200, dtype=torch.bool), 5)
    qv, qs = jax_quant.quantize_rows(emb.numpy())
    t = torch.from_numpy
    scan.binned_topk_int8(t(qv[:3]), t(qs[:3]), t(qv), t(qs),
                          torch.ones(200, dtype=torch.bool), 5)
    pv, ps = quant.quantize_rows_int4_device(emb)
    scan.binned_topk_int4(t(qv[:3]), t(qs[:3]), pv, ps,
                          torch.ones(200, dtype=torch.bool), 5)
    assert _build.launch_counts() == {"scan_topk": 0, "merge_candidates": 0,
                                      "scan_topk_int8": 0,
                                      "scan_topk_int4": 0, "ivf_probe": 0,
                                      "paired_attention": 0,
                                      "score_probe": 0}
    # one registration each, in whatever order the modules were imported
    names = [k.name for k in _build.KERNELS]
    assert sorted(names) == ["ivf_probe", "merge_candidates",
                             "paired_attention", "scan_topk",
                             "scan_topk_int4", "scan_topk_int8",
                             "score_probe"]


# ---- refined, fused and the int8 hoistq chain ---------------------------------


def _padded_jax(emb, valid, dtype, tile=128):
    pe, pv = jax_scan.pad_for_tile(np.asarray(jnp.asarray(emb, dtype)),
                                   valid, tile)
    return jnp.asarray(pe), jnp.asarray(pv)


@pytest.mark.parametrize("dtype,n,b,k,n_live", [("float32", 1024, 4, 10, None),
                                                ("bfloat16", 1024, 4, 10, None),
                                                ("float32", 700, 3, 5, None),
                                                ("float32", 256, 2, 10, 6)])
def test_refined_topk_matches_jax(dtype, n, b, k, n_live):
    """Widened first stage + exact f32 rescore: ids identical to JAX's
    `refined_topk` in interpret mode, scores within 1e-5; with fewer live
    rows than the width, padded slots never surface."""
    rng = np.random.default_rng(n + k)
    emb = _rows(rng, n, 64)
    q = _rows(rng, b, 64)
    valid = np.ones(n, dtype=bool)
    if n_live is not None:
        valid[:] = False
        valid[rng.choice(n, n_live, replace=False)] = True
    te = torch.from_numpy(emb).to(getattr(torch, dtype))
    s, i = scan.refined_topk(torch.from_numpy(q), te, torch.from_numpy(valid),
                             k, widen=16)
    s, i = s.numpy(), i.numpy()
    je, jv = _padded_jax(emb, valid, dtype)
    j_s, j_i = jax_scan.refined_topk(jnp.asarray(q), je, jv, k, widen=16,
                                     tile=128, interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    live = j_s > NEG
    np.testing.assert_array_equal(s > NEG, live)
    np.testing.assert_array_equal(i[live], j_i[live])
    np.testing.assert_allclose(s[live], j_s[live], atol=1e-5)
    assert np.all(valid[i[live]])


def test_refined_topk_passes_the_first_stage_through_at_k_above_widen():
    rng = np.random.default_rng(6)
    emb = torch.from_numpy(_rows(rng, 512, 32))
    q = torch.from_numpy(_rows(rng, 2, 32))
    valid = torch.ones(512, dtype=torch.bool)
    a = scan.refined_topk(q, emb, valid, 20, widen=16)
    b = scan.fused_topk(q, emb, valid, 20)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [5, 16, 20])
def test_refined_topk_normalizes_raw_queries_as_binned_topk(k):
    """`normalize=True` on raw queries equals the call on normalized ones;
    below the width (k < 16) the result is `binned_topk`'s."""
    rng = np.random.default_rng(k)
    emb = torch.from_numpy(_rows(rng, 600, 32)).to(torch.bfloat16)
    raw = torch.from_numpy(3.0 * rng.normal(size=(3, 32)).astype(np.float32))
    valid = torch.from_numpy(rng.random(600) < 0.9)
    a = scan.refined_topk(raw, emb, valid, k, normalize=True)
    b = scan.refined_topk(topk_ops.l2_normalize_t(raw), emb, valid, k)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if k < 16:
        c = scan.binned_topk(raw, emb, valid, k, normalize=True)
        assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_topk_matches_jax_away_from_ties(dtype):
    """Kernel A + B at k1 = k against the insertion scan (`_topk_kernel`),
    whose packed keys resolve scores to ~1e-3: ids identical except where
    the two scores are within 2e-3."""
    rng = np.random.default_rng(11)
    emb = _rows(rng, 1024, 64)
    q = _rows(rng, 6, 64)
    valid = rng.random(1024) < 0.9
    te = torch.from_numpy(emb).to(getattr(torch, dtype))
    s, i = scan.fused_topk(torch.from_numpy(q), te, torch.from_numpy(valid), 12)
    s, i = s.numpy(), i.numpy()
    if dtype == "float32":   # exact at f32 storage
        np.testing.assert_array_equal(
            i, topk_ops.topk_oracle(q, emb, valid, 12)[1])
    je, jv = _padded_jax(emb, valid, dtype)
    j_s, j_i = jax_scan.fused_topk(jnp.asarray(q), je, jv, 12, tile=128,
                                   interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    agree = i == j_i
    assert agree.mean() >= 0.8   # d=64: many top-12 scores sit within 2e-3
    assert np.all(np.abs(s - j_s)[~agree] < 2e-3)
    np.testing.assert_allclose(s, j_s, atol=2e-3)


def test_fused_topk_int8_matches_jax_away_from_ties():
    rng = np.random.default_rng(12)
    qv, qs = jax_quant.quantize_rows(_rows(rng, 5, 64))
    ev, es = jax_quant.quantize_rows(_rows(rng, 1024, 64))
    valid = rng.random(1024) < 0.85
    s, i = scan.fused_topk_int8(*map(torch.from_numpy, (qv, qs, ev, es,
                                                        valid)), 10)
    s, i = s.numpy(), i.numpy()
    e_s, e_i = jax_quant.int8_topk(*map(jnp.asarray, (qv, qs, ev, es, valid)),
                                   10)
    np.testing.assert_array_equal(i, np.asarray(e_i))     # exact int8 scan
    j_s, j_i = jax_scan.fused_topk_int8(
        *map(jnp.asarray, (qv, qs, ev, es, valid)), 10, tile=256,
        interpret=True)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    agree = i == j_i
    assert agree.mean() >= 0.8
    assert np.all(np.abs(s - j_s)[~agree] < 2e-3)


def test_binned_topk_int8_hoistq_is_kernel_c():
    """Both selection chains of the TPU kernel are kernel C + B here: the
    same exact list; JAX's hoistq list agrees within its packed keys."""
    rng = np.random.default_rng(13)
    qv, qs = jax_quant.quantize_rows(_rows(rng, 4, 64))
    ev, es = jax_quant.quantize_rows(_rows(rng, 1024, 64))
    valid = rng.random(1024) < 0.9
    args = tuple(map(torch.from_numpy, (qv, qs, ev, es, valid)))
    s_m, i_m = scan.binned_topk_int8(*args, 10)
    s_h, i_h = scan.binned_topk_int8(*args, 10, selection="hoistq")
    assert torch.equal(s_m, s_h) and torch.equal(i_m, i_h)
    with pytest.raises(ValueError):
        scan.binned_topk_int8(*args, 10, selection="fma")
    j_s, j_i = jax_scan.binned_topk_int8(
        *map(jnp.asarray, (qv, qs, ev, es, valid)), 10, tile=256,
        interpret=True, selection="hoistq")
    s_h, i_h = s_h.numpy(), i_h.numpy()
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    for row in range(4):
        mine = dict(zip(i_h[row].tolist(), s_h[row].tolist()))
        for c, js_ in zip(j_i[row].tolist(), j_s[row].tolist()):
            if js_ > s_h[row, -1] + 2e-3:
                assert c in mine
            if c in mine:
                assert abs(mine[c] - js_) < 2e-3
