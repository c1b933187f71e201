"""One-command real-checkpoint validation, on the port.

Port of `lattice_tpu/models/validate_weights.py`:

    lattice validate-weights /path/to/checkpoint_dir

Given a local HF checkpoint dir it runs, at the checkpoint's own config
(`config.json`, else inferred from the tensor shapes):
1. weight mapping: the torch state dict through the port's
   `_map_roberta_params` into its `UniXcoderEncoder`;
2. full-config parity: pooled embeddings against a
   `transformers.RobertaModel` running the same state dict (masked
   mean-pool), max |diff| reported, on the device asked for. The encoder
   is already a torch module, so no framework lies between the two;
3. tokenizer: with `vocab.json` / `merges.txt` present, the native BPE
   counter against the approximation on sample code, and a round trip
   through `CodeTokenizer` with the real vocab;
4. an embedding sanity probe through the same encoder.

Each check reports ok / skip / fail with a reason, and nothing raises.
Where `transformers` does not import, check 2 reports `{"ok": null,
"skipped": ...}`, the reference's own skip on `ImportError`. The CLI
exits non-zero when any check fails.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

SAMPLE_TEXTS = (
    "def drain(self, transport):\n    for d in list(self.pending):\n"
    "        transport.post(d)\n",
    "class DeliveryQueue:\n    \"\"\"Orders webhook deliveries.\"\"\"\n",
    "const rows = await client.get('/tasks?status=open');",
)


def _config_from_checkpoint(weights_dir: Path, state: dict | None):
    """The checkpoint's own config: config.json when present, else
    inferred from the state dict's shapes. Returns (config, heads_assumed):
    num_heads is not recoverable from shapes (q/k/v are [H, H] whatever
    the head split), so without config.json it is assumed and the report
    says so."""
    from lattice_tpu_torch.models.unixcoder import UniXcoderConfig

    cfg_path = weights_dir / "config.json"
    if cfg_path.is_file():
        raw = json.loads(cfg_path.read_text())
        return UniXcoderConfig(
            vocab_size=raw.get("vocab_size", 50265),
            hidden_size=raw.get("hidden_size", 768),
            num_layers=raw.get("num_hidden_layers", 12),
            num_heads=raw.get("num_attention_heads", 12),
            intermediate_size=raw.get("intermediate_size", 3072),
            max_position_embeddings=raw.get("max_position_embeddings", 514),
            type_vocab_size=raw.get("type_vocab_size", 10),
            layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
            pad_token_id=raw.get("pad_token_id", 1),
            dtype="float32"), False
    if state is None:
        return UniXcoderConfig(dtype="float32"), True

    def g(suffix):
        for k, v in state.items():
            if k.endswith(suffix):
                return v
        raise KeyError(suffix)

    word = g("embeddings.word_embeddings.weight")
    pos = g("embeddings.position_embeddings.weight")
    typ = g("embeddings.token_type_embeddings.weight")
    ffn = g("layer.0.intermediate.dense.weight")
    n_layers = 1 + max(
        int(k.split(".layer.")[1].split(".")[0])
        for k in state if ".layer." in k)
    return UniXcoderConfig(
        vocab_size=int(word.shape[0]), hidden_size=int(word.shape[1]),
        num_layers=n_layers, intermediate_size=int(ffn.shape[0]),
        max_position_embeddings=int(pos.shape[0]),
        type_vocab_size=int(typ.shape[0]), dtype="float32"), True


def _probe_batch(cfg, seed=7, b=2, lmax=24):
    rng = np.random.default_rng(seed)
    ids = np.full((b, lmax), cfg.pad_token_id, dtype=np.int64)
    mask = np.zeros((b, lmax), dtype=np.int64)
    for r in range(b):
        n = int(rng.integers(6, lmax))
        ids[r, :n] = rng.integers(3, cfg.vocab_size, size=n)
        mask[r, :n] = 1
    return ids, mask


def validate_weights(weights_dir: str | Path, atol: float = 5e-3,
                     device: str | torch.device = "cuda") -> dict:
    """Run every check that a mounted checkpoint enables; never raises:
    each check reports ok/skip/fail with a reason."""
    from lattice_tpu_torch.models.unixcoder import (UniXcoderModel,
                                                    _map_roberta_params,
                                                    _read_torch_state)

    weights_dir = Path(weights_dir)
    report: dict = {"weights_dir": str(weights_dir), "checks": {}}
    checks = report["checks"]

    def record(name, ok, **info):
        checks[name] = {"ok": ok, **info}

    if not weights_dir.is_dir():
        record("dir", False, error="not a directory")
        report["ok"] = False
        return report
    present = sorted(p.name for p in weights_dir.iterdir())
    record("dir", True, files=present)

    # ---- 1. mapping ------------------------------------------------------
    state = _read_torch_state(weights_dir)
    model = cfg = None
    if state is None:
        record("state_dict", False,
               error="no model.safetensors / pytorch_model.bin readable")
    else:
        cfg, heads_assumed = _config_from_checkpoint(weights_dir, state)
        info = {
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings}
        if heads_assumed:
            # a parity failure below may be this assumption, not the mapping
            info["num_heads_assumed"] = True
        record("state_dict", True, tensors=len(state), config=info)
        try:
            model = UniXcoderModel(cfg, device=device)
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            record("param_mapping", False, error=repr(exc)[:200])
        else:
            try:
                model.encoder.load_state_dict(_map_roberta_params(state, cfg))
                record("param_mapping", True)
            except KeyError as exc:
                record("param_mapping", False, missing_key=str(exc))
                model = None
            except RuntimeError as exc:
                record("param_mapping", False, error=repr(exc)[:200])
                model = None

    # ---- 2. parity with transformers at the checkpoint's full config ------
    if model is not None:
        try:
            import transformers

            tcfg = transformers.RobertaConfig(
                vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads,
                intermediate_size=cfg.intermediate_size,
                max_position_embeddings=cfg.max_position_embeddings,
                type_vocab_size=cfg.type_vocab_size,
                layer_norm_eps=cfg.layer_norm_eps,
                pad_token_id=cfg.pad_token_id, hidden_act="gelu",
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
            # made on the model's device: a random init of the full size
            # takes seconds on the host
            with torch.device(model.device):
                ref = transformers.RobertaModel(
                    tcfg, add_pooling_layer=False).eval()
            cleaned = {
                k.removeprefix("roberta.").removeprefix("model."):
                    torch.as_tensor(v)
                for k, v in state.items()}
            missing, unexpected = ref.load_state_dict(cleaned, strict=False)
            missing = [m for m in missing if "pooler" not in m]
            ids, mask = _probe_batch(cfg)
            ids_t = torch.from_numpy(ids).to(model.device)
            mask_t = torch.from_numpy(mask).to(model.device)
            with torch.no_grad():
                hid = ref(input_ids=ids_t, attention_mask=mask_t
                          ).last_hidden_state
            m = mask_t.float().unsqueeze(-1)
            want = ((hid * m).sum(1) / m.sum(1).clamp(min=1.0)).cpu().numpy()
            got = model.encode(ids, mask)
            diff = float(np.abs(got - want).max())
            record("torch_parity", diff <= atol and not missing,
                   max_abs_diff=diff, atol=atol,
                   missing_keys=missing[:5],
                   unexpected_keys=list(unexpected)[:5])
        except ImportError as exc:
            record("torch_parity", None, skipped=f"no transformers: {exc}")
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            record("torch_parity", False, error=repr(exc)[:200])

    # ---- 3. tokenizer: real vocab vs approximation ------------------------
    vocab = weights_dir / "vocab.json"
    merges = weights_dir / "merges.txt"
    if vocab.is_file() and merges.is_file():
        try:
            from lattice_tpu_torch.text.tokenizer import (ApproxTokenCounter,
                                                          CodeTokenizer,
                                                          NativeBPECounter)
            native = NativeBPECounter(merges)  # the C++ BPE loads merges.txt
            approx = ApproxTokenCounter()
            rows = []
            for t in SAMPLE_TEXTS:
                rows.append({"native": native.count(t),
                             "approx": approx.count(t)})
            ok = all(r["native"] > 0 for r in rows)
            tok = CodeTokenizer(vocab_dir=weights_dir)
            ids = tok.tokenize_ids(SAMPLE_TEXTS[0])
            record("tokenizer", ok and len(ids) > 0, samples=rows,
                   real_vocab_ids=len(ids))
        except Exception as exc:  # noqa: BLE001
            record("tokenizer", False, error=repr(exc)[:200])
    else:
        record("tokenizer", None,
               skipped="no vocab.json/merges.txt in dir")

    # ---- 4. embedding sanity probe through the same encoder ---------------
    if model is not None:
        try:
            ids, mask = _probe_batch(cfg, seed=11, b=3)
            out = model.encode(ids, mask)
            finite = bool(np.isfinite(out).all())
            distinct = bool(np.abs(out[0] - out[1]).max() > 1e-6)
            record("embedding_probe", finite and distinct,
                   finite=finite, distinct_rows=distinct,
                   norm_mean=float(np.linalg.norm(out, axis=1).mean()))
        except Exception as exc:  # noqa: BLE001
            record("embedding_probe", False, error=repr(exc)[:200])

    report["ok"] = all(c["ok"] is not False for c in checks.values())
    return report


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="validate a local UniXcoder/RoBERTa checkpoint dir")
    parser.add_argument("weights_dir")
    parser.add_argument("--atol", type=float, default=5e-3)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the checks (default cuda)")
    args = parser.parse_args(argv)
    report = validate_weights(args.weights_dir, atol=args.atol,
                              device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
