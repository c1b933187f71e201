"""The port's UniXcoder encoder, loaders, provider and slice against JAX.

The config is `tests/test_models_parallel.py:458-461`'s (hidden 128, two
heads of 64, 2 layers, FFN 256), so the paired path applies. JAX params
are carried into the port by `params_from_jax`; seeded numpy ids with
ragged masks, padded to the 64 bucket, go through both. float32 must agree
within 2e-4 with JAX's paired kernel (interpret mode) and with its einsum
path; bfloat16 within 2e-2 with every row's cosine >= 0.999.

The attention levers: `fused_attention=True` (SDPA in the port) against
the reference's flash kernel in interpret mode over the live rows at L in
the 128 and 256 buckets (f32 2e-4; bf16 2e-2 and cosine >= 0.999), and
LATTICE_PAIRED_ATTN / LATTICE_FLASH_ATTN routed as the reference routes
them (the calls into `paired_attention` under each setting).

The host path's split: a batch whose rows span the four length buckets
runs one forward a bucket, longest first, and returns the rows of one
forward at 512 in the caller's order (f32 1e-5, bf16 2e-2).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu.models.unixcoder import UniXcoderModel as JaxModel
from lattice_tpu.models.unixcoder import fuse_qkv_params as jax_fuse_qkv
from lattice_tpu.providers import unixcoder_provider as jax_up
from lattice_tpu.query.golden_eval import load_cases
from lattice_tpu_torch.core.errors import EmbeddingError, KernelError
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer, VectorSearcher
from lattice_tpu_torch.models import unixcoder as um
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.providers import unixcoder_provider as up

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=66)
SEED = 7


def flat_params(params) -> dict:
    """The JAX param tree as `models/finetune.py:66-70` flattens it."""
    flat = {}
    for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[key] = np.asarray(value)
    return flat


def port_model(jax_model, **overrides) -> um.UniXcoderModel:
    cfg = um.UniXcoderConfig(**{**SMALL, "dtype": jax_model.config.dtype,
                                **overrides})
    model = um.UniXcoderModel(cfg, seed=SEED, device="cpu")
    model.encoder.load_state_dict(um.params_from_jax(
        flat_params(jax_model.params)))
    return model


def batch(seed=3, b=4, ln=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (b, ln)).astype(np.int32)
    mask = np.ones_like(ids)
    lengths = rng.integers(1, ln + 1, b)
    lengths[0] = ln           # one row at full length
    for r, n in enumerate(lengths):
        ids[r, n:] = 1        # RoBERTa's pad id
        mask[r, n:] = 0
    return ids, mask


def cosine(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b,
                                                                          axis=1)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    cfg = JaxConfig(**SMALL, dtype=request.param)
    einsum = JaxModel(cfg, seed=SEED)
    paired = JaxModel(dataclasses.replace(cfg, paired_attention=True),
                      seed=SEED)
    return request.param, einsum, paired, port_model(einsum)


@pytest.mark.parametrize("path", ["einsum", "paired"])
def test_encoder_matches_jax(models, path):
    dtype, einsum, paired, port = models
    ids, mask = batch()
    want = (einsum if path == "einsum" else paired).encode(ids, mask)
    before = _build.launch_counts()["paired_attention"]
    got = port.encode(ids, mask)          # pads L=40 to the 64 bucket
    assert _build.launch_counts()["paired_attention"] == before
    assert got.shape == (4, SMALL["hidden_size"]) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)
        assert cosine(got, want).min() >= 0.999


def test_port_einsum_path_matches_paired(models):
    dtype, einsum, _, port = models
    ids, mask = batch(seed=4)
    port_einsum = port_model(einsum, paired_attention=False)
    a, b = port.encode(ids, mask), port_einsum.encode(ids, mask)
    np.testing.assert_allclose(a, b, atol=2e-4 if dtype == "float32" else 2e-2)
    np.testing.assert_allclose(b, einsum.encode(ids, mask),
                               atol=2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("scores_dtype,atol", [("float32", 2e-4),
                                               ("bfloat16", 2e-3)])
def test_einsum_path_head_dim_32_matches_jax(scores_dtype, atol):
    """Four heads of 32: the paired path does not apply, so both packages
    take the einsum path, with the scores rounded to `scores_dtype`
    (a bf16 score can land one rounding apart: atol 2e-3)."""
    cfg = JaxConfig(**{**SMALL, "num_heads": 4}, dtype="float32",
                    scores_dtype=scores_dtype)
    jm = JaxModel(cfg, seed=SEED)
    port = port_model(jm, num_heads=4, scores_dtype=scores_dtype)
    ids, mask = batch(seed=12)
    np.testing.assert_allclose(port.encode(ids, mask), jm.encode(ids, mask),
                               atol=atol)


def test_padding_and_device_fast_path(models, monkeypatch):
    _, _, _, port = models
    ids, mask = batch(seed=5, ln=20)
    host = port.encode(ids, mask)
    padded = np.pad(ids, ((0, 0), (0, 44)), constant_values=1)
    pmask = np.pad(mask, ((0, 0), (0, 44)))
    # a bucket-length tensor on the model's device skips the host pad path
    monkeypatch.setattr(port, "_encode_device_host",
                        lambda *a: pytest.fail("took the host pad path"))
    dev = port.encode_device(torch.from_numpy(padded), torch.from_numpy(pmask))
    np.testing.assert_allclose(dev.numpy(), host, atol=1e-6)
    assert [port.bucket_length(n) for n in (1, 64, 65, 300, 9999)] == [
        64, 64, 128, 512, 512]


SPLIT = {**SMALL, "num_layers": 1, "max_position_embeddings": 514}


def split_batch(seed=9, width=600):
    """Rows in all four buckets: one past 512 (truncated), one with no live
    token, one whose mask has a hole (its last live token sets its
    bucket)."""
    rng = np.random.default_rng(seed)
    lengths = np.array([600, 0, 30, 100, 200, 300, 64, 65, 129, 10])
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int64)
    mask[4, 50:60] = 0
    ids = np.where(mask == 1, rng.integers(5, 500, mask.shape), 1)
    return ids, mask


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_host_path_splits_batch_by_row_bucket(dtype, atol, monkeypatch):
    """The host path runs one `_forward` a length bucket of the rows' own
    lengths, longest first, and returns the rows of one forward over the
    whole batch padded to 512, in the caller's order; rows that share a
    bucket take one forward at it, unreordered."""
    model = um.UniXcoderModel(um.UniXcoderConfig(**SPLIT, dtype=dtype),
                              seed=SEED, device="cpu")
    forward, calls = model._forward, []

    def recorded(ids, mask, *weights):
        calls.append(ids.clone())
        return forward(ids, mask, *weights)

    monkeypatch.setattr(model, "_forward", recorded)
    ids, mask = split_batch()
    whole = forward(torch.from_numpy(ids[:, :512]),
                    torch.from_numpy(mask[:, :512])).numpy()
    got = model.encode(ids, mask)
    assert [tuple(c.shape) for c in calls] == [(2, 512), (2, 256), (2, 128),
                                               (4, 64)]
    assert got.shape == whole.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, whole, atol=atol)

    calls.clear()
    ids, mask = ids[[1, 2, 6, 9], :100], mask[[1, 2, 6, 9], :100]
    got = model.encode(ids, mask)
    assert len(calls) == 1
    torch.testing.assert_close(calls[0], torch.from_numpy(ids[:, :64]))
    np.testing.assert_allclose(
        got, forward(torch.from_numpy(ids[:, :64]),
                     torch.from_numpy(mask[:, :64])).numpy(), atol=atol)


def test_bf16_serve_matches_jax():
    cfg = JaxConfig(**SMALL)
    jm = JaxModel(cfg, seed=SEED)
    port = port_model(jm)
    jm.enable_bf16_inference()
    port.enable_bf16_inference()
    assert port.weights_fingerprint.endswith("+bf16serve")
    assert port.encoder.layers[0].attention.query.weight.dtype == torch.bfloat16
    assert port.encoder.word_embeddings.weight.dtype == torch.bfloat16
    assert port.encoder.layers[0].attention.query.bias.dtype == torch.float32
    ids, mask = batch(seed=6)
    got, want = port.encode(ids, mask), jm.encode(ids, mask)
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert cosine(got, want).min() >= 0.999


def test_finetune_npz_round_trip(tmp_path):
    """A checkpoint written as `models/finetune.py:66-73` writes it loads
    through `finetune_dir` (and `weights_dir`) into the port."""
    cfg = JaxConfig(**SMALL, dtype="float32")
    trained = JaxModel(cfg, seed=11)       # stands in for trained weights
    np.savez_compressed(tmp_path / "finetuned_params.npz",
                        **flat_params(trained.params))
    jm = JaxModel(cfg, seed=SEED, finetune_dir=tmp_path)
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, dtype="float32"),
                             seed=SEED, finetune_dir=tmp_path, device="cpu")
    assert port.loaded_finetuned and port.loaded_pretrained
    assert port.weights_fingerprint == jm.weights_fingerprint
    ids, mask = batch(seed=8)
    np.testing.assert_allclose(port.encode(ids, mask), jm.encode(ids, mask),
                               atol=2e-4)
    by_dir = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, dtype="float32"),
                               weights_dir=tmp_path, device="cpu")
    assert by_dir.loaded_pretrained
    assert by_dir.weights_fingerprint == "unixcoder-pretrained"
    np.testing.assert_allclose(by_dir.encode(ids, mask), port.encode(ids, mask),
                               atol=1e-6)


def test_finetune_npz_mismatch_keeps_base(tmp_path):
    flat = flat_params(JaxModel(JaxConfig(**SMALL), seed=1).params)
    flat["layer_1/intermediate/kernel"] = np.zeros((128, 8), np.float32)
    np.savez_compressed(tmp_path / "finetuned_params.npz", **flat)
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), seed=SEED,
                             finetune_dir=tmp_path, device="cpu")
    assert not port.loaded_finetuned
    assert port.weights_fingerprint == f"unixcoder-torch-random-seed{SEED}"
    base = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), seed=SEED,
                             device="cpu")
    for a, b in zip(port.encoder.parameters(), base.encoder.parameters()):
        assert torch.equal(a, b)


def test_hf_state_matches_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.RobertaConfig(
        vocab_size=SMALL["vocab_size"], hidden_size=SMALL["hidden_size"],
        num_hidden_layers=SMALL["num_layers"],
        num_attention_heads=SMALL["num_heads"],
        intermediate_size=SMALL["intermediate_size"],
        max_position_embeddings=SMALL["max_position_embeddings"],
        type_vocab_size=10, layer_norm_eps=1e-5, pad_token_id=1,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    ref = transformers.RobertaModel(tcfg, add_pooling_layer=False).eval()
    with torch.no_grad():   # a non-zero type row, so the fold is tested
        ref.embeddings.token_type_embeddings.weight.normal_(0.0, 0.5)
    torch.save({"roberta." + k: v for k, v in ref.state_dict().items()},
               tmp_path / "pytorch_model.bin")
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, dtype="float32"),
                             weights_dir=tmp_path, device="cpu")
    assert port.loaded_pretrained
    assert port.weights_fingerprint == "unixcoder-pretrained"
    ids, mask = batch(seed=9)
    with torch.no_grad():
        hidden = ref(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()
                     ).last_hidden_state
    m = torch.from_numpy(mask).float()[:, :, None]
    want = ((hidden * m).sum(1) / m.sum(1).clamp(min=1.0)).numpy()
    np.testing.assert_allclose(port.encode(ids, mask), want, atol=2e-4)
    # the mapper on an in-memory state dict, without the prefix
    state = um._map_roberta_params(ref.state_dict(), port.config)
    for name, value in port.encoder.state_dict().items():
        assert torch.equal(state[name], value), name


def test_missing_checkpoint_falls_back(tmp_path):
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL),
                             weights_dir=tmp_path / "nope", device="cpu")
    assert not port.loaded_pretrained
    assert um._read_torch_state(tmp_path) is None
    (tmp_path / "pytorch_model.bin").write_bytes(b"not a checkpoint")
    assert um._read_torch_state(tmp_path) is None
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), weights_dir=tmp_path,
                             device="cpu")
    assert not port.loaded_pretrained
    assert port.weights_fingerprint == "unixcoder-torch-random-seed0"


def test_random_init_fingerprint_and_statistics():
    cfg = um.UniXcoderConfig(vocab_size=4096, hidden_size=256, num_layers=2,
                             num_heads=4, intermediate_size=1024,
                             max_position_embeddings=130)
    a = um.UniXcoderModel(cfg, seed=3, device="cpu")
    assert a.weights_fingerprint == "unixcoder-torch-random-seed3"
    assert a.weights_fingerprint != JaxModel(
        JaxConfig(**SMALL), seed=3).weights_fingerprint
    b = um.UniXcoderModel(cfg, seed=3, device="cpu")
    c = um.UniXcoderModel(cfg, seed=4, device="cpu")
    sa, sb, sc = (m.encoder.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.attention.query.weight"],
                           sc["layers.0.attention.query.weight"])
    # flax's initialisers: lecun-normal kernels (truncated at 2 sigma of the
    # untruncated normal), Embed normal(0, 1/sqrt(features)), zero biases,
    # unit LayerNorm scales
    for name, fan_in in (("layers.0.intermediate.weight", 256),
                         ("layers.1.output.weight", 1024)):
        w = sa[name]
        assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.03, name
        assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(
            fan_in) + 1e-6
    emb = sa["word_embeddings.weight"]
    assert abs(emb.std().item() * np.sqrt(256) - 1.0) < 0.03
    assert emb.abs().max().item() > 3.0 / np.sqrt(256)   # not truncated
    assert torch.equal(sa["layers.0.attention.query.bias"], torch.zeros(256))
    assert torch.equal(sa["embeddings_norm.weight"], torch.ones(256))


# ---- the attention levers: LATTICE_PAIRED_ATTN, LATTICE_FLASH_ATTN and
# fused_attention (the reference's flash path; SDPA here) -------------------

# SMALL with positions for the 256 bucket, so that flash (L >= 128) applies
FLASH = {**SMALL, "max_position_embeddings": 260}


def _live_cosine_and_diff(got, want, mask):
    live = mask.sum(1) > 0
    return cosine(got[live], want[live]).min(), np.abs(got[live]
                                                      - want[live]).max()


@pytest.mark.parametrize("ln", [100, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_matches_jax_flash(dtype, ln):
    """`fused_attention=True`: the port's SDPA path against the reference's
    flash kernel (JAX's library code, run in interpret mode), over the live
    rows, at the 128 and 256 buckets."""
    from jax.experimental.pallas import tpu as pltpu
    cfg = JaxConfig(**FLASH, dtype=dtype, fused_attention=True)
    jm = JaxModel(cfg, seed=SEED)
    port = port_model(jm, max_position_embeddings=260, fused_attention=True)
    ids, mask = batch(seed=16, b=5, ln=ln)
    with pltpu.force_tpu_interpret_mode():
        want = jm.encode(ids, mask)
    got = port.encode(ids, mask)
    cos, diff = _live_cosine_and_diff(got, want, mask)
    if dtype == "float32":
        assert diff <= 2e-4, diff
    else:
        assert diff <= 2e-2 and cos >= 0.999, (diff, cos)
    # the einsum path gives the live rows the same embeddings
    einsum = port_model(jm, max_position_embeddings=260,
                        paired_attention=False).encode(ids, mask)
    cos, diff = _live_cosine_and_diff(got, einsum, mask)
    assert diff <= (2e-4 if dtype == "float32" else 2e-2) and cos >= 0.999


def test_flash_env_and_short_lengths(monkeypatch):
    """LATTICE_FLASH_ATTN=1 is `fused_attention=True`; below L = 128 both
    take the einsum path (flash on keeps the paired path off), as the
    reference does; the SDPA path is reached only at L >= 128."""
    jm = JaxModel(JaxConfig(**FLASH, dtype="float32"), seed=SEED)
    opt_in = port_model(jm, max_position_embeddings=260,
                        fused_attention=True)
    plain = port_model(jm, max_position_embeddings=260)
    einsum = port_model(jm, max_position_embeddings=260,
                        paired_attention=False)
    calls = []
    real = um._flash_attention

    def spy(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(um, "_flash_attention", spy)
    long_ids, long_mask = batch(seed=17, b=3, ln=120)
    short_ids, short_mask = batch(seed=18, b=3, ln=50)
    a = opt_in.encode(long_ids, long_mask)
    np.testing.assert_array_equal(opt_in.encode(short_ids, short_mask),
                                  einsum.encode(short_ids, short_mask))
    monkeypatch.setenv("LATTICE_FLASH_ATTN", "1")
    b = plain.encode(long_ids, long_mask)
    np.testing.assert_array_equal(a, b)
    assert calls == [128] * (2 * SMALL["num_layers"])
    # LATTICE_FLASH_ATTN=0 beats the config: the paired path again
    monkeypatch.setenv("LATTICE_FLASH_ATTN", "0")
    np.testing.assert_array_equal(opt_in.encode(long_ids, long_mask),
                                  plain.encode(long_ids, long_mask))
    assert len(calls) == 2 * SMALL["num_layers"]


# (LATTICE_PAIRED_ATTN, LATTICE_FLASH_ATTN, config's paired_attention) ->
# paired_attention calls a forward of SMALL's two layers, as the reference
# routes (`lattice_tpu/models/unixcoder.py:82-107, 134-138`)
LEVERS = {
    "auto": (None, None, None, 2),
    "paired_0": ("0", None, None, 0),
    "paired_1": ("1", None, None, 2),
    "paired_1_over_config_off": ("1", None, False, 2),
    "paired_0_over_config_on": ("0", None, True, 0),
    "paired_true_is_off": ("true", None, None, 0),
    "flash_1": (None, "1", None, 0),
    "flash_1_beats_paired_1": ("1", "1", None, 0),
    "flash_0": (None, "0", None, 2),
    "config_off": (None, None, False, 0),
}


@pytest.mark.parametrize("case", sorted(LEVERS))
def test_attention_levers_route_as_the_reference(monkeypatch, case):
    """F2: the port reads LATTICE_PAIRED_ATTN and LATTICE_FLASH_ATTN as the
    reference does: the variable wins over the config, "1" is on and any
    other value off, and an explicit flash opt-in wins over the paired
    path. On the CPU the kernel's wrapper runs its plain version, so the
    launch counter stays where it was; the calls into the wrapper are the
    routes the card would launch."""
    paired_env, flash_env, paired_cfg, want = LEVERS[case]
    for name, value in (("LATTICE_PAIRED_ATTN", paired_env),
                        ("LATTICE_FLASH_ATTN", flash_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    model = um.UniXcoderModel(um.UniXcoderConfig(
        **SMALL, paired_attention=paired_cfg), device="cpu")
    calls = []
    real = um.paired_attention

    def spy(q, k, v, m, scale):
        calls.append(q.shape)
        return real(q, k, v, m, scale)

    monkeypatch.setattr(um, "paired_attention", spy)
    before = _build.launch_counts()["paired_attention"]
    ids, mask = batch(seed=19)
    model.encode(ids, mask)
    assert len(calls) == want
    assert _build.launch_counts()["paired_attention"] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paired_off_matches_jax_einsum(monkeypatch, dtype):
    """Under LATTICE_PAIRED_ATTN=0 the port's einsum path against the JAX
    package's (the variable set for both)."""
    monkeypatch.setenv("LATTICE_PAIRED_ATTN", "0")
    jm = JaxModel(JaxConfig(**SMALL, dtype=dtype, paired_attention=True),
                  seed=SEED)
    port = port_model(jm, paired_attention=True)
    monkeypatch.setattr(um, "paired_attention",
                        lambda *a: pytest.fail("took the paired path"))
    ids, mask = batch(seed=20)
    got, want = port.encode(ids, mask), jm.encode(ids, mask)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)
        assert cosine(got, want).min() >= 0.999


def test_fuse_qkv_params_matches_jax():
    """`fuse_qkv_params` on the port's state dict equals the reference's on
    the JAX tree, carried across: one [3H, H] weight and [3H] bias a layer,
    query, key and value in that order."""
    params = JaxModel(JaxConfig(**SMALL), seed=1).params
    want = um.params_from_jax(flat_params(jax_fuse_qkv(params, 2)))
    got = um.fuse_qkv_params(um.params_from_jax(flat_params(params)), 2)
    assert got.keys() == want.keys()
    assert "layers.1.attention.qkv.weight" in got
    assert "layers.1.attention.query.weight" not in got
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert got["layers.0.attention.qkv.weight"].shape == (384, 128)


def test_fused_qkv_matches_unfused_and_jax(models):
    """`enable_fused_qkv` gives the unfused embeddings (bit-equal on the
    CPU, where each column of the product is the same sum) and the JAX
    package's fused ones; the fused q/k/v reach the attention as column
    slices of one tensor. The fingerprint gains `+qkvfused`."""
    dtype, einsum, paired, _ = models
    ids, mask = batch(seed=10)
    jm = JaxModel(dataclasses.replace(paired.config), seed=SEED)
    port = port_model(jm)
    unfused = port.encode(ids, mask)
    seen = []

    def spy(q, k, v, m, scale, _real=um.paired_attention):
        seen.append((q.is_contiguous(), q.data_ptr() + q.shape[-1]
                     * q.element_size() == k.data_ptr()))
        return _real(q, k, v, m, scale)

    port.enable_fused_qkv()
    port.enable_fused_qkv()                    # once only
    assert port.config.fused_qkv
    assert port.weights_fingerprint.endswith("random-seed7+qkvfused")
    assert not hasattr(port.encoder.layers[0].attention, "query")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(um, "paired_attention", spy)
        fused = port.encode(ids, mask)
    assert seen == [(False, True)] * SMALL["num_layers"]
    np.testing.assert_array_equal(fused, unfused)
    jm.enable_fused_qkv()
    assert jm.weights_fingerprint.endswith("+qkvfused")
    want = jm.encode(ids, mask)
    if dtype == "float32":
        np.testing.assert_allclose(fused, want, atol=2e-4)
    else:
        np.testing.assert_allclose(fused, want, atol=2e-2)
        assert cosine(fused, want).min() >= 0.999


def test_fused_qkv_config_and_bf16_serve():
    """A model made with `fused_qkv=True` runs (random init, `qkv` layer);
    `enable_fused_qkv` keeps the dtypes `enable_bf16_inference` set."""
    made = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, fused_qkv=True),
                             device="cpu")
    assert made.encoder.layers[0].attention.qkv.weight.shape == (384, 128)
    ids, mask = batch(seed=14)
    assert np.isfinite(made.encode(ids, mask)).all()
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL), seed=SEED,
                             device="cpu")
    port.enable_bf16_inference()
    served = port.encode(ids, mask)
    port.enable_fused_qkv()
    attn_mod = port.encoder.layers[0].attention
    assert attn_mod.qkv.weight.dtype == torch.bfloat16
    assert attn_mod.qkv.bias.dtype == torch.float32
    assert port.encoder.word_embeddings.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.encode(ids, mask), served)


def test_paired_path_refuses_grad_mode():
    """The encoder on its paired path under grad mode raises instead of
    giving Q/K/V no gradient; its einsum path trains."""
    port = um.UniXcoderModel(um.UniXcoderConfig(**SMALL, dtype="float32"),
                             device="cpu")
    ids, mask = (torch.from_numpy(x) for x in batch(seed=15))
    with pytest.raises(KernelError, match="no backward"):
        port.encoder(ids, mask)
    einsum = um.UniXcoderEncoder(um.UniXcoderConfig(
        **SMALL, dtype="float32", paired_attention=False))
    einsum(ids, mask)[1].sum().backward()
    assert einsum.layers[0].attention.query.weight.grad.abs().sum() > 0


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EmbeddingError):
        um.UniXcoderModel(um.UniXcoderConfig(**SMALL), device="cuda")
    with pytest.raises(EmbeddingError):
        up.UniXcoderEmbedder(device="cuda")


@pytest.fixture
def tiny_providers(monkeypatch):
    """The JAX and port providers over one set of SMALL float32 weights."""
    cfg = JaxConfig(**SMALL, dtype="float32")
    jm = JaxModel(cfg, seed=SEED)
    pm = port_model(jm)
    monkeypatch.setenv("LATTICE_EMBED_DP", "0")
    monkeypatch.setattr(jax_up, "_get_model", lambda w, f=None, seed=0: jm)
    monkeypatch.setattr(up, "_get_model",
                        lambda w, f=None, seed=0, device="cpu": pm)
    return (jax_up.UniXcoderEmbedder(batch_size=16),
            up.UniXcoderEmbedder(batch_size=16, device="cpu"))


def test_provider_matches_jax(tiny_providers, monkeypatch):
    jax_emb, port_emb = tiny_providers
    texts = ["def f(): pass", "class A:\n    x = 1", "", "retry with backoff"]
    want = np.asarray(jax_emb.embed_batch(texts))
    np.testing.assert_allclose(np.asarray(port_emb.embed_batch(texts)), want,
                               atol=2e-4)
    np.testing.assert_allclose(port_emb.embed(texts[1]), want[1], atol=2e-4)
    dev = port_emb.embed_batch_device(texts * 5)      # 20 texts: 2 batches
    assert dev.shape == (20, SMALL["hidden_size"]) and dev.device.type == "cpu"
    np.testing.assert_allclose(dev[:4].numpy(), want, atol=2e-4)
    assert port_emb.embed_batch_device([]).shape == (0, SMALL["hidden_size"])
    assert port_emb.dimensions == SMALL["hidden_size"]
    monkeypatch.setenv("LATTICE_BF16_SERVE", "1")
    served = up.UniXcoderEmbedder(batch_size=16, device="cpu")
    assert served.model.weights_fingerprint.endswith("+bf16serve")
    up.UniXcoderEmbedder(batch_size=16, device="cpu")   # cast only once
    assert served.model.weights_fingerprint.count("+bf16serve") == 1


def _windows(lines=24, stride=12):
    from pathlib import Path
    root = Path(__file__).resolve().parent / "fixtures" / "golden_project"
    texts, payloads = [], []
    for path in sorted(root.rglob("*")):
        if not path.is_file():
            continue
        rows = path.read_text(encoding="utf-8").splitlines()
        for lo in range(0, max(len(rows) - lines, 0) + 1, stride):
            texts.append("\n".join(rows[lo:lo + lines]))
            payloads.append({"file_path": str(path.relative_to(root)),
                             "name": f"{path.stem}:{lo + 1}",
                             "start_line": lo + 1, "entity_type": "chunk",
                             "language": path.suffix[1:]})
    return texts, payloads


def test_slice_embed_index_search_matches_jax(tiny_providers):
    """Chunks of the golden project through each package's embedder and
    store; 20 golden query texts give the same top-10 rows (a swap is
    allowed only between scores within 1e-5)."""
    jax_emb, port_emb = tiny_providers
    # positions past max_position_embeddings (66) do not exist
    jax_emb.max_length = port_emb.max_length = 60
    texts, payloads = _windows()
    assert len(texts) > 100
    js = JaxStore(SMALL["hidden_size"], dtype="float32")
    js.add(np.asarray(jax_emb.embed_batch(texts)), payloads)

    embedder = Embedder(port_emb, batch_size=16)
    before = _build.launch_counts()["paired_attention"]
    vectors = embedder.embed_with_progress(texts)
    assert isinstance(vectors, torch.Tensor)
    assert vectors.shape == (len(texts), SMALL["hidden_size"])
    assert _build.launch_counts()["paired_attention"] == before  # CPU: plain
    indexer = VectorIndexer(embedder, dtype="float32", device="cpu")
    assert indexer.code.add(vectors, payloads) == list(range(len(texts)))
    searcher = VectorSearcher(indexer)

    queries = [c["query"] for c in load_cases()[:20]]
    want = js.search(np.asarray(jax_emb.embed_batch(queries)), k=10)
    for q, ref in zip(queries, want):
        got = searcher.search_code(q, limit=10)
        assert len(got) == len(ref) == 10
        for hit, (row, score, payload) in zip(got, ref):
            assert abs(hit.score - score) < 1e-5, q
            if hit.row != row:   # a near-tie may swap places
                assert any(r == hit.row and abs(s - hit.score) < 1e-5
                           for r, s, _ in ref), q
            else:
                assert hit.file_path == payload["file_path"]
