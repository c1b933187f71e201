"""The port's UniXcoder encoder, loaders, provider and slice against JAX.

The config is `tests/test_models_parallel.py:458-461`'s (hidden 128, two
heads of 64, 2 layers, FFN 256), so the paired path applies. JAX params
are carried into the port by `params_from_jax`; seeded numpy ids with
ragged masks, padded to the 64 bucket, go through both. float32 must agree
within 2e-4 with JAX's paired kernel (interpret mode) and with its einsum
path; bfloat16 within 2e-2 with every row's cosine >= 0.999.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lattice_tpu.index.chunk_store import ChunkStore as JaxStore
from lattice_tpu.models.unixcoder import UniXcoderConfig as JaxConfig
from lattice_tpu.models.unixcoder import UniXcoderModel as JaxModel
from lattice_tpu.providers import unixcoder_provider as jax_up
from lattice_tpu.query.golden_eval import load_cases
from lattice_tpu_torch.core.errors import ConfigurationError, EmbeddingError
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


@pytest.mark.parametrize("field", ["fused_qkv", "fused_attention"])
def test_unported_options_raise(field):
    with pytest.raises(ConfigurationError):
        um.UniXcoderModel(um.UniXcoderConfig(**SMALL, **{field: True}),
                          device="cpu")


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
