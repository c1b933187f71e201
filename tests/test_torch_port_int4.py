"""The port's int4 tier against the JAX package.

The same seeded numpy inputs go through `lattice_tpu_torch.ops.quant` /
`ops.scan_topk` and `lattice_tpu.ops.quant` / `ops.pallas_topk` on the CPU:

- packing is bit-equal (XLA folds `amax / 7.0` into a multiply by the f32
  reciprocal of 7, and the port does the same);
- kernel D's plain version equals JAX's `int4_topk` exactly: an integer
  dot below 2^24, then (acc * qs) * es in both;
- against the Pallas `binned_topk_int4` in interpret mode, whose packed
  keys resolve scores to ~2e-3 (pallas_topk.py:1123-1126): every JAX
  winner more than 2e-3 above the port's k1-th score is in the port's
  list, and shared ids agree within 2e-3;
- `Int4View` and the store's `"int4"` plan agree on ids, scores within
  1e-5 (f32 rescores in two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.ops import pallas_topk as jax_scan
from lattice_tpu.ops import quant as jax_quant
from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.index import chunk_store as port_cs
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import quant
from lattice_tpu_torch.ops import scan_topk as scan
from lattice_tpu_torch.ops import topk as topk_ops

from chip_smoke import selection_cases

t = torch.from_numpy
PACKED_RES = 2e-3   # the TPU kernel's packed-key score resolution


def _rows(rng, n, d):
    return topk_ops.l2_normalize(rng.normal(size=(n, d)).astype(np.float32))


# ---- quantize / pack / unpack ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [None, 64])
def test_quantize_rows_int4_device_bit_equal(monkeypatch, dtype, block):
    if block is not None:  # exercise the blocked path at a small size
        monkeypatch.setattr(quant, "QUANT_BLOCK", block)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 96)).astype(np.float32)
    x[[3, 77]] = 0.0                                 # all-zero rows
    x[5] = np.linspace(-1, 1, 96)                    # exact .5 quotients
    v, s = quant.quantize_rows_int4_device(t(x).to(getattr(torch, dtype)))
    jv, js = jax_quant.quantize_rows_int4_device(jnp.asarray(x, dtype))
    assert v.shape == (200, 48) and v.dtype == torch.int8
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # an all-zero row packs as v = 0 everywhere: low nibble 8, high 0
    assert torch.all(v[3] == 8) and s[3] == 0


def test_quantize_rows_int4_numpy_matches_jax():
    rng = np.random.default_rng(2)
    x = _rows(rng, 50, 64)
    v, s = quant.quantize_rows_int4(x)
    jv, js = jax_quant.quantize_rows_int4(x)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(s, js)


def test_unpack_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    packed, _ = jax_quant.quantize_rows_int4(_rows(rng, 40, 32))
    # every byte value, not only those quantization produces
    packed[0] = np.arange(-128, 128, 16).astype(np.int8)
    u = quant.unpack_int4(t(packed))
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jax_quant.unpack_int4(
                                      jnp.asarray(packed))))
    np.testing.assert_array_equal(quant.unpack_int4_oracle(packed),
                                  jax_quant.unpack_int4_oracle(packed))
    assert u.shape == (40, 32) and int(u.min()) >= -8 and int(u.max()) <= 7


def test_odd_dim_is_refused():
    with pytest.raises(ValueError, match="even"):
        quant.quantize_rows_int4(np.ones((2, 5), np.float32))
    with pytest.raises(ValueError, match="even"):
        quant.quantize_rows_int4_device(torch.ones(2, 5))
    qv = torch.zeros(1, 5, dtype=torch.int8)
    with pytest.raises(KernelError, match="even"):
        scan.scan_blocks_int4(qv, torch.ones(1), torch.zeros(
            4, 2, dtype=torch.int8), torch.ones(4), torch.ones(
            4, dtype=torch.bool), 2)


# ---- kernel D's plain version ---------------------------------------------


@pytest.mark.parametrize("d,n,b,k,live", [(64, 1000, 8, 16, 0.8),
                                          (768, 500, 3, 80, 0.9),
                                          (100, 700, 5, 10, 1.0),
                                          (256, 600, 4, 512, 0.7)])
def test_plain_kernel_d_equals_jax_int4_topk(d, n, b, k, live):
    rng = np.random.default_rng(d + n + k)
    qv, qs = jax_quant.quantize_rows(_rows(rng, b, d))
    ep, es = jax_quant.quantize_rows_int4(_rows(rng, n, d))
    valid = rng.random(n) < live
    k = min(k, n)
    s, i = quant.int4_topk(*map(t, (qv, qs, ep, es, valid)), k)
    j_s, j_i = jax_quant.int4_topk(*map(jnp.asarray, (qv, qs, ep, es, valid)),
                                   k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    # the wrapper takes the plain version for CPU tensors
    s2, i2 = scan.scan_topk_int4(*map(t, (qv, qs, ep, es, valid)), k)
    assert torch.equal(s2, s) and torch.equal(i2, i)


def test_plain_kernel_d_ties_and_padding_match_jax():
    """Duplicate rows tie exactly; fewer live rows than k1 pads NEG_INF
    with the lowest invalid ids, as `lax.top_k` does."""
    rng = np.random.default_rng(5)
    base = _rows(rng, 10, 32)
    ep, es = jax_quant.quantize_rows_int4(np.concatenate([base] * 3))
    qv, qs = jax_quant.quantize_rows(base[:3])
    for vmask in (np.arange(30) % 7 != 1, np.arange(30) < 5):
        s, i = quant.int4_topk(*map(t, (qv, qs, ep, es, vmask)), 16)
        j_s, j_i = jax_quant.int4_topk(
            *map(jnp.asarray, (qv, qs, ep, es, vmask)), 16)
        np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))


SELECTION_CASES = {c[0]: c[1:] for c in selection_cases(11, n=900, b=5,
                                                        d=64)}


@pytest.mark.parametrize("k", [1, 33, 129])
@pytest.mark.parametrize("name", sorted(SELECTION_CASES))
def test_plain_kernel_d_equals_jax_on_selection_cases(name, k):
    """`chip_smoke.selection_cases` (ties across tile and chunk edges,
    rising and falling scores, invalid chunks, fewer live rows than k1),
    which the card holds kernels D + B to: the plain version equals JAX's
    `int4_topk`, and the wrapper takes it for CPU tensors."""
    arrays = SELECTION_CASES[name]
    s, i = quant.int4_topk(*map(t, arrays), k)
    j_s, j_i = jax_quant.int4_topk(*map(jnp.asarray, arrays), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    s2, i2 = scan.scan_topk_int4(*map(t, arrays), k)
    assert torch.equal(s2, s) and torch.equal(i2, i)


def test_selection_cases_are_what_they_say():
    """Each case has the property it is named for."""
    cases = selection_cases(11, n=900, b=5, d=64)
    assert len({c[0] for c in cases}) == len(cases) == 5
    for name, qv, qs, ep, es, valid in cases:
        assert qv.dtype == ep.dtype == np.int8 and valid.dtype == bool
        assert ep.shape == (900, 32) and es.shape == valid.shape == (900,)
        acc = qv.astype(np.int32) @ quant.unpack_int4(t(ep)).numpy().T
        scores = acc.astype(np.float32) * qs[:, None] * es[None, :]
        if name.startswith("ties"):
            assert len(np.unique(scores[0])) <= 7
            assert np.array_equal(scores[:, :7], scores[:, 7:14])
        elif name.startswith("scores rising"):
            assert (np.diff(scores, axis=1) >= 0).all()
        elif name.startswith("scores falling"):
            assert (np.diff(scores, axis=1) <= 0).all()
        elif name.startswith("chunks"):
            assert not valid[200:400].any() and not valid[-700:].any()
        else:
            assert valid.sum() == 20 < 33


def _planted(n, d, rows, seed):
    """`tests/test_pallas_ivf.py`'s corpus: `rows` are near-duplicates of
    the query (the same-file-chunks regime)."""
    rng = np.random.default_rng(seed)
    emb = topk_ops.l2_normalize(rng.normal(size=(n, d)))
    q = topk_ops.l2_normalize(rng.normal(size=(1, d)))
    for j, r in enumerate(rows):
        emb[r] = topk_ops.l2_normalize(q[0] + 0.01 * (j + 1)
                                       * rng.normal(size=d))
    return emb, q


def _pallas_ivf_inputs(name):
    """The inputs of `tests/test_pallas_ivf.py:358-480`."""
    if name == "planted":
        emb, q = _planted(1024, 64, list(range(100, 110)), seed=3)
        valid = np.ones(1024, bool)
    elif name == "planted_masked":
        emb, q = _planted(1024, 64, list(range(40, 50)), seed=5)
        valid = np.ones(1024, bool)
        valid[np.random.default_rng(33).integers(0, 1024, 100)] = False
        valid[40:50] = True
    elif name == "random":
        rng = np.random.default_rng(21)
        emb = topk_ops.l2_normalize(rng.normal(size=(1024, 64)))
        q = topk_ops.l2_normalize(rng.normal(size=(4, 64)))
        valid = np.ones(1024, bool)
    else:  # every row anti-aligned with the query: all scores negative
        rng = np.random.default_rng(7)
        base = topk_ops.l2_normalize(rng.normal(size=(1, 64)))
        emb = topk_ops.l2_normalize(-np.abs(rng.normal()) * base
                                    + rng.normal(size=(256, 64)) * 0.05)
        emb = topk_ops.l2_normalize(np.where(emb @ base.T > 0, -emb, emb))
        q = base
        valid = np.ones(256, bool)
        valid[rng.integers(0, 256, 30)] = False
    ep, es = jax_quant.quantize_rows_int4(emb)
    qv, qs = jax_quant.quantize_rows(q)
    return qv, qs, ep, es, valid


@pytest.mark.parametrize("data", ["planted", "planted_masked", "random",
                                  "negative"])
@pytest.mark.parametrize("unpack,selection", [("vpu", "hoistq"),
                                              ("vpu", "mul"),
                                              ("matmul", "mul"),
                                              ("vpu", "fma")])
def test_binned_topk_int4_against_pallas_interpret(data, unpack, selection):
    qv, qs, ep, es, valid = _pallas_ivf_inputs(data)
    k, n = 10, ep.shape[0]
    s, i = scan.binned_topk_int4(*map(t, (qv, qs, ep, es, valid)), k,
                                 unpack=unpack, selection=selection)
    s, i = s.numpy(), i.numpy()
    k1 = scan.first_stage_width(k, n)
    assert s.shape == i.shape == (len(qv), k1)
    j_s, j_i = jax_scan.binned_topk_int4(
        *map(jnp.asarray, (qv, qs, ep, es, valid)), k, tile=256 if n > 256
        else 128, interpret=True, unpack=unpack, selection=selection)
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    assert not set(i.flatten()) & set(np.flatnonzero(~valid))
    for row in range(len(qv)):
        mine = dict(zip(i[row].tolist(), s[row].tolist()))
        for c, js_ in zip(j_i[row].tolist(), j_s[row].tolist()):
            if js_ > s[row, -1] + PACKED_RES:
                assert c in mine, (row, c, js_, s[row, -1])
            if c in mine:
                assert abs(mine[c] - js_) < PACKED_RES
    # and the port's list is the exact top-k1 of the int4 scores
    ps, pi = jax_quant.int4_topk(*map(jnp.asarray, (qv, qs, ep, es, valid)),
                                 k1)
    np.testing.assert_array_equal(i, np.asarray(pi))


def test_binned_topk_int4_rejects_unknown_variants():
    qv, qs, ep, es, valid = _pallas_ivf_inputs("random")
    args = tuple(map(t, (qv, qs, ep, es, valid)))
    with pytest.raises(ValueError):
        scan.binned_topk_int4(*args, 10, unpack="mxu")
    with pytest.raises(ValueError):
        scan.binned_topk_int4(*args, 10, selection="approx")


def test_first_stage_widths():
    for k, n, k1 in ((1, 1000, 32), (4, 1000, 32), (10, 1000, 80),
                     (64, 1000, 512), (10, 50, 50)):
        assert scan.int4_first_stage_width(k, n) == k1
    assert scan.int4_first_stage_width(64, 10 ** 6) == scan.MAX_K1_LONG


# ---- Int4View ---------------------------------------------------------------


def _view_pair(dtype, n, d, seed):
    rng = np.random.default_rng(seed)
    emb = _rows(rng, n, d)
    t_emb = t(emb).to(getattr(torch, dtype))
    j_emb = jnp.asarray(emb, dtype)
    return quant.Int4View(t_emb), jax_quant.Int4View(j_emb), t_emb, j_emb, rng


@pytest.mark.parametrize("dtype,d,k", [("bfloat16", 256, 10),
                                       ("float32", 64, 5),
                                       ("bfloat16", 768, 20)])
def test_int4_view_search_matches_jax(dtype, d, k):
    view, j_view, t_emb, j_emb, rng = _view_pair(dtype, 1500, d, d + k)
    np.testing.assert_array_equal(view.values.numpy(),
                                  np.asarray(j_view.values))
    np.testing.assert_array_equal(view.scales.numpy(),
                                  np.asarray(j_view.scales))
    assert (view.n, view.d) == (j_view.n, j_view.d)
    q = rng.normal(size=(12, d)).astype(np.float32)   # raw queries
    valid = rng.random(1500) < 0.9
    # full-precision rescore of 8k candidates
    s, i = view.search(q, t(valid), k, full_precision=t_emb)
    j_s, j_i = j_view.search(q, jnp.asarray(valid), k, full_precision=j_emb)
    np.testing.assert_array_equal(i, np.asarray(j_i))
    np.testing.assert_allclose(s, np.asarray(j_s), atol=1e-5)
    # first stage only
    s1, i1 = view.search(q, t(valid), k)
    j_s1, j_i1 = j_view.search(q, jnp.asarray(valid), k)
    np.testing.assert_array_equal(i1, np.asarray(j_i1))
    np.testing.assert_allclose(s1, np.asarray(j_s1), atol=1e-6)
    # capacity mode: rescored from the packed rows
    s2, i2 = view.search_device(t(q), t(valid), k, dequant_rescore=True)
    j_s2, j_i2 = j_view.search_device(jnp.asarray(q), jnp.asarray(valid), k,
                                      dequant_rescore=True)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(j_i2))
    np.testing.assert_allclose(s2.numpy(), np.asarray(j_s2), atol=1e-5)
    assert bool((valid[i2.numpy()]).all())


def test_int4_dequant_rescore_never_promotes_padded_slots():
    rng = np.random.default_rng(6)
    emb = _rows(rng, 300, 64)
    ep, es = jax_quant.quantize_rows_int4(emb)
    q = _rows(rng, 3, 64)
    cand = rng.integers(0, 300, size=(3, 24)).astype(np.int32)
    stage = rng.normal(size=(3, 24)).astype(np.float32)
    stage[:, -6:] = topk_ops.NEG_INF
    s, i = quant.int4_dequant_rescore(t(q), t(ep), t(es), t(stage), t(cand),
                                      20)
    j_s, j_i = jax_quant.int4_dequant_rescore(
        jnp.asarray(q), jnp.asarray(ep), jnp.asarray(es), jnp.asarray(stage),
        jnp.asarray(cand), 20)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)
    assert bool((s[:, -2:] == topk_ops.NEG_INF).all())


def test_update_rows_and_from_packed_stay_bit_equal():
    view, j_view, t_emb, j_emb, rng = _view_pair("bfloat16", 300, 128, 3)
    new = _rows(rng, 7, 128)                         # f32 delta rows
    idx = np.array([0, 5, 6, 100, 150, 298, 299])
    view.update_rows(t(new), t(idx))
    j_view.update_rows(jnp.asarray(new), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(view.values.numpy(),
                                  np.asarray(j_view.values))
    np.testing.assert_array_equal(view.scales.numpy(),
                                  np.asarray(j_view.scales))
    # the delta rows quantize from f32, not from their bf16 rounding
    f_v, _ = quant.quantize_rows_int4_device(t(new))
    assert torch.equal(view.values[idx], f_v)
    assert view.memory_bytes() == 300 * 64 + 300 * 4
    # a view adopted from packed blocks searches like the one it copies
    blocks = [quant.quantize_rows_int4_device(t_emb[lo:lo + 128])
              for lo in range(0, 300, 128)]
    adopted = quant.Int4View.from_packed(torch.cat([b[0] for b in blocks]),
                                         torch.cat([b[1] for b in blocks]))
    j_adopted = jax_quant.Int4View.from_packed(
        *jax_quant.quantize_rows_int4_device(j_emb))
    assert (adopted.n, adopted.d) == (300, 128)
    q = rng.normal(size=(4, 128)).astype(np.float32)
    valid = np.ones(300, dtype=bool)
    s, i = adopted.search_device(t(q), t(valid), 5, dequant_rescore=True)
    j_s, j_i = j_adopted.search_device(jnp.asarray(q), jnp.asarray(valid), 5,
                                       dequant_rescore=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), atol=1e-5)


# ---- the store's "int4" plan -----------------------------------------------


def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _payloads(n, start=0):
    return [{"file_path": f"f{(start + i) % 7}.py", "content_hash": "h",
             "entity_type": ("function", "class")[i % 2]} for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_int4_and_refined_match_jax_store(dtype):
    """A JAX store carried over with `from_numpy_state`, searched through
    forced "int4" against the JAX store's, and through forced "refined"
    against JAX `refined_topk` in interpret mode over the same rows (the
    JAX store itself serves a forced "refined" at this capacity, no
    multiple of a Pallas tile, through its flat scan)."""
    js = JaxStore(dim=64, dtype=dtype, initial_capacity=300)
    js.add(_vecs(280, 64, seed=1), _payloads(280))
    js.remove([3, 50, 51, 200])
    ps = ChunkStore.from_numpy_state(np.asarray(js._emb, np.float32),
                                     js._valid_host, js._payloads,
                                     dtype=dtype, device="cpu")
    q = _vecs(6, 64, seed=2)
    for method, k, flt in (("int4", 10, None), ("int4", 5,
                                                {"entity_type": "class"}),
                           ("refined", 10, None),
                           ("refined", 7, {"file_path": "f2.py"})):
        got = ps.search(q, k, filters=flt, method=method)
        want = (js.search(q, k, filters=flt, method=method)
                if method == "int4" else _jax_refined(js, q, k, flt))
        assert [[r for r, _, _ in h] for h in got] == \
            [[r for r, _, _ in h] for h in want], (method, k, flt)
        for hg, hw in zip(got, want):
            np.testing.assert_allclose([s for _, s, _ in hg],
                                       [s for _, s, _ in hw], atol=1e-5)
    s_i4 = ps.search_int4(q, 10)
    assert [[r for r, _, _ in h] for h in s_i4] == \
        [[r for r, _, _ in h] for h in js.search_int4(q, 10)]
    np.testing.assert_array_equal(ps._int4.values.numpy(),
                                  np.asarray(js._int4.values))
    # the device path serves the same rows
    ds, di = ps.search_device(t(q), 10, method="int4")
    assert di.numpy().tolist() == [[r for r, _, _ in h]
                                   for h in ps.search(q, 10, method="int4")]
    rs, ri = ps.search_device(t(q), 10, method="refined")
    hits = ps.search(q, 10, method="refined")
    assert ri.numpy().tolist() == [[r for r, _, _ in h] for h in hits]
    np.testing.assert_allclose(rs.numpy(), [[sc for _, sc, _ in h]
                                            for h in hits], atol=1e-6)


def test_refined_passes_first_stage_through_at_k_above_widen():
    ps = ChunkStore(dim=32, dtype="float32", initial_capacity=64,
                    device="cpu")
    ps.add(_vecs(60, 32, seed=3), _payloads(60))
    q = t(_vecs(3, 32, seed=4))
    s, i = ps.search_device(q, 20, method="refined")
    fs, fi = ps.search_device(q, 20, method="flat")
    assert torch.equal(i, fi) and torch.allclose(s, fs, atol=1e-6)


def _jax_refined(js, q, k, flt):
    """JAX `refined_topk` (interpret mode) over a JAX store's rows, as hits."""
    valid = js._valid_host.copy()
    if flt:
        valid &= np.asarray(js.filter_mask(flt))
    emb, valid = jax_scan.pad_for_tile(np.asarray(js._emb), valid, 128)
    s, i = jax_scan.refined_topk(jnp.asarray(topk_ops.l2_normalize(q)),
                                 jnp.asarray(emb), jnp.asarray(valid), k,
                                 tile=128, interpret=True)
    return [[(int(r), float(sc), None) for sc, r in zip(srow, irow)
             if sc > topk_ops.NEG_INF / 2]
            for srow, irow in zip(np.asarray(s), np.asarray(i))]


class TestInt4Upkeep:
    """`tests/test_chunk_store.py:221-242` on the port store."""

    def test_int4_matches_flat(self):
        s = ChunkStore(dim=48, dtype="float32", initial_capacity=128,
                       device="cpu")
        s.add(_vecs(60, 48, seed=23), _payloads(60))
        q = _vecs(3, 48, seed=24)
        flat = s.search(q, k=8)
        i4 = s.search_int4(q, k=8)
        overlaps = [len({r for r, _, _ in fr} & {r for r, _, _ in ir}) / 8
                    for fr, ir in zip(flat, i4)]
        assert np.mean(overlaps) >= 0.85, overlaps
        unscored = s.search_int4(q, k=8, rescore=False)
        assert all(len(h) == 8 for h in unscored)

    def test_int4_sees_new_rows_delta(self):
        s = ChunkStore(dim=16, dtype="float32", initial_capacity=32,
                       device="cpu")
        s.add(_vecs(10, 16), _payloads(10))
        s.search_int4(_vecs(1, 16), k=3)          # builds the view
        assert not s._int4_dirty
        view = s._int4
        new = _vecs(1, 16, seed=15)
        row = s.add(new, _payloads(1))[0]
        assert not s._int4_dirty and s._int4 is view   # in place
        got = s.search_int4(new, k=1)
        assert got[0][0][0] == row
        f_v, _ = quant.quantize_rows_int4_device(
            topk_ops.l2_normalize_t(t(new)))
        assert torch.equal(view.values[row], f_v[0])

    def test_growth_compact_and_clear_drop_the_shadow(self):
        s = ChunkStore(dim=16, dtype="float32", initial_capacity=16,
                       device="cpu")
        s.add(_vecs(10, 16), _payloads(10))
        s.search_int4(_vecs(1, 16), k=3)
        s.add(_vecs(20, 16, seed=2), _payloads(20))    # past the shadow
        assert s._int4_dirty
        s.search_int4(_vecs(1, 16), k=3)
        assert not s._int4_dirty
        s.remove([0, 1])
        s.compact()
        assert s._int4 is None and s._int4_dirty
        s.search_int4(_vecs(1, 16), k=3)
        s.clear()
        assert s._int4 is None and s._int4_dirty


class TestInt4Plan:
    """`tests/test_chunk_store.py:575-589, :659-663` on a faked CUDA store
    (the tensors stay on the CPU, so the plan's kernels run their plain
    versions)."""

    @pytest.fixture
    def cuda(self, monkeypatch):
        monkeypatch.setattr(ChunkStore, "_device_is_cuda", lambda self: True)
        monkeypatch.setattr(ChunkStore, "_device_memory_bytes",
                            lambda self: 80 * 1024 ** 3)
        for flag in ("LATTICE_INT8", "LATTICE_INT4", "LATTICE_PQ",
                     "LATTICE_SHARDED"):
            monkeypatch.delenv(flag, raising=False)
        return monkeypatch

    def _store(self, n=64, d=32):
        s = ChunkStore(dim=d, dtype="float32", initial_capacity=n,
                       device="cpu")
        s.add(_vecs(n, d, seed=9), _payloads(n))
        return s

    def test_int4_env_serves_int4(self, cuda):
        s = self._store()
        cuda.setenv("LATTICE_INT4", "1")
        assert s._plan_search(4, 10, None, "auto") == "int4"
        assert s._plan_search(256, 64, None, "auto") == "int4"
        assert s._plan_search(4, 65, None, "auto") == "flat"   # 8k > 512
        got = s.search(_vecs(3, 32, seed=1), 5)
        want = s.search(_vecs(3, 32, seed=1), 5, method="flat")
        assert [[r for r, _, _ in h] for h in got] == \
            [[r for r, _, _ in h] for h in want]
        assert s._int4 is not None and s._quant is None
        flt = {"file_path": "f3.py"}
        hits = s.search(_vecs(2, 32, seed=5), 5, filters=flt)
        assert all(p["file_path"] == "f3.py" for h in hits for _, _, p in h)

    def test_cpu_store_plans_flat_under_int4_env(self, monkeypatch):
        s = self._store()
        monkeypatch.setenv("LATTICE_INT4", "1")
        assert s._plan_search(4, 10, None, "auto") == "flat"

    def test_forced_int4_preempts_ivf(self, cuda):
        s = self._store(n=256)
        cuda.setattr(port_cs, "IVF_AUTO_MIN_ROWS", 128)
        cuda.setattr(port_cs, "IVF_FLAT_CROSSOVER_ROWS", 128)
        cuda.setenv("LATTICE_INT4", "1")
        called = {"n": 0}
        cuda.setattr(s, "build_ivf",
                     lambda *a, **k: called.__setitem__("n", called["n"] + 1))
        assert s._plan_search(256, 10, None, "auto") == "int4"
        assert s._plan_search(1, 10, None, "auto") == "int4"
        assert called["n"] == 0  # IVF build never attempted

    def test_int4_search_device_shapes_and_order(self, cuda):
        s = self._store(n=64)
        cuda.setenv("LATTICE_INT4", "1")
        sc, ids = s.search_device(t(_vecs(5, 32, seed=3)), 10)
        assert sc.shape == ids.shape == (5, 10)
        assert bool((sc[:, :-1] >= sc[:, 1:]).all())
        ps, pi = s.search_device_pipelined(t(_vecs(5, 32, seed=3)), 10,
                                           chunk=2)
        assert torch.equal(pi, ids) and torch.equal(ps, sc)
