"""The port's `validate_weights` against the JAX package's.

One FULL-SIZE synthetic checkpoint (the unixcoder-base config: 12 layers,
768 hidden, 50,265 vocab, in HF layout, with a tiny `vocab.json` /
`merges.txt`), written as `tests/test_validate_weights.py` writes it, goes
through both packages' `validate_weights`: every check gives the same
`ok`, the mapped config is the same, and the port's encoder is held to
`transformers.RobertaModel` within the same atol. With `transformers`
hidden, the port reports the reference's own skip (`ok: null`).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from lattice_tpu.models.validate_weights import (  # noqa: E402
    validate_weights as jax_validate)
from lattice_tpu_torch.models import validate_weights as vw  # noqa: E402

FULL = dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=514, type_vocab_size=10,
            layer_norm_eps=1e-5, pad_token_id=1)
SMALL = dict(FULL, vocab_size=512, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=66)


def write_checkpoint(d, cfg, with_config=True):
    tcfg = transformers.RobertaConfig(
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, **cfg)
    torch.manual_seed(0)
    ref = transformers.RobertaModel(tcfg, add_pooling_layer=False).eval()
    torch.save(ref.state_dict(), d / "pytorch_model.bin")
    if with_config:
        (d / "config.json").write_text(json.dumps(
            {**cfg, "model_type": "roberta"}))
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3,
             "h": 10, "e": 11, "t": 12, "l": 13, "o": 14, "w": 15,
             "d": 16, "r": 17, "a": 18, "i": 19, "n": 20,
             "he": 30, "the": 31, "dr": 32, "drain": 33, "Ġ": 34}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: test\nh e\nt he\nd r\ndr a\ndra i\ndrai n\n")
    return d


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = write_checkpoint(tmp_path_factory.mktemp("unixcoder_ckpt"), FULL)
    return jax_validate(d), vw.validate_weights(d, device="cpu")


def test_every_check_agrees(reports):
    want, got = reports
    assert got["ok"] and want["ok"], json.dumps(got, indent=2)
    assert got["checks"].keys() == want["checks"].keys()
    for name, check in want["checks"].items():
        assert got["checks"][name]["ok"] == check["ok"], name
    assert got["checks"]["state_dict"] == want["checks"]["state_dict"]
    assert got["checks"]["dir"] == want["checks"]["dir"]


def test_full_config_parity(reports):
    _, got = reports
    tp = got["checks"]["torch_parity"]
    assert tp["ok"] and tp["max_abs_diff"] <= tp["atol"] == 5e-3
    assert not tp["missing_keys"]
    cfg = got["checks"]["state_dict"]["config"]
    assert (cfg["hidden_size"], cfg["num_layers"], cfg["vocab_size"]) == (
        768, 12, 50265)
    probe = got["checks"]["embedding_probe"]
    assert probe["ok"] and probe["finite"] and probe["distinct_rows"]


@pytest.mark.parametrize("case", ["no_dir", "no_state", "no_config"])
def test_failures_and_inference_agree(tmp_path, case):
    """A missing dir, a dir without a state dict, and a checkpoint without
    config.json (the config inferred from shapes, heads assumed): the same
    per-check `ok` and config in both packages."""
    d = tmp_path / "ckpt"
    if case != "no_dir":
        d.mkdir()
    if case == "no_config":
        # twelve heads, the number both packages assume without config.json
        write_checkpoint(d, dict(SMALL, hidden_size=192,
                                 num_attention_heads=12), with_config=False)
    want, got = jax_validate(d), vw.validate_weights(d, device="cpu")
    assert got["ok"] == want["ok"]
    assert {k: c["ok"] for k, c in got["checks"].items()} == \
        {k: c["ok"] for k, c in want["checks"].items()}
    if case == "no_config":
        assert got["checks"]["state_dict"] == want["checks"]["state_dict"]
        assert got["checks"]["state_dict"]["config"]["num_heads_assumed"]


def test_without_transformers_reports_the_skip(tmp_path, monkeypatch):
    d = write_checkpoint(tmp_path, SMALL)
    monkeypatch.setitem(sys.modules, "transformers", None)
    report = vw.validate_weights(d, device="cpu")
    assert report["ok"]
    tp = report["checks"]["torch_parity"]
    assert tp["ok"] is None and "transformers" in tp["skipped"]
    assert report["checks"]["embedding_probe"]["ok"]


def test_cuda_without_cuda_is_reported(tmp_path, monkeypatch):
    """The check never raises: "cuda" without CUDA fails the mapping check
    with the error, and the CLI exits 1."""
    d = write_checkpoint(tmp_path, SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = vw.validate_weights(d)
    assert report["ok"] is False
    assert "CUDA" in report["checks"]["param_mapping"]["error"]
    assert vw.main([str(d)]) == 1
    assert vw.main([str(d), "--device", "cpu"]) == 0
    assert np.isfinite(report["checks"]["state_dict"]["tensors"])
