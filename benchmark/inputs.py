"""What the benchmark makes from `--seed` and hands to the program and the
reference alike: the vector corpus, its payloads and the encoder's weights.

Frozen copies, so that a later change to the program cannot move the
yardstick: `cluster_centers` and `cluster_rows` are
`lattice_tpu_torch/tools/dissect.py`'s corpus generator (with the device
as an argument), `l2_normalize` is `ops/topk.l2_normalize_t`, and
`payloads` is `chip_smoke.py`'s payload maker (~50 chunks a file, with the
fields the indexer writes)."""

from __future__ import annotations

import hashlib
import math
from collections.abc import Iterator

import torch


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed, so that the
    corpus, the queries and the sample never share a stream."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device: str | torch.device
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, tag))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def cluster_centers(gen: torch.Generator, n: int, d: int,
                    device: str | torch.device) -> torch.Tensor:
    """n unit-normal directions (the bench's centers)."""
    return l2_normalize(torch.randn(n, d, device=device, generator=gen))


def cluster_rows(centers: torch.Tensor, n: int, gen: torch.Generator,
                 spread: float) -> torch.Tensor:
    """Rows around bf16 cluster centers with Gaussian spread, normalized
    (the bench's `gen_block`; spread 0.35 is corpus A)."""
    assign = torch.randint(0, centers.shape[0], (n,), device=centers.device,
                           generator=gen)
    base = centers.to(torch.bfloat16).to(torch.float32)[assign]
    return l2_normalize(base + spread * torch.randn(
        n, centers.shape[1], device=centers.device, generator=gen))


def corpus_centers(config: dict, seed: int, device) -> torch.Tensor:
    return cluster_centers(generator(seed, "centers", device),
                           config["centers"], config["dim"], device)


def corpus_blocks(config: dict, seed: int, centers: torch.Tensor
                  ) -> Iterator[tuple[int, int, torch.Tensor]]:
    """(lo, hi, f32 rows) of the corpus in `add_batch` blocks, the same
    rows every time for one seed."""
    gen = generator(seed, "rows", centers.device)
    n, step = config["rows"], config["add_batch"]
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        yield lo, hi, cluster_rows(centers, hi - lo, gen, config["spread"])


_SYL = ("ba", "co", "de", "fi", "gu", "ka", "lo", "mi", "no", "pe", "ra",
        "si", "tu", "ve", "xo", "za")
_WORDS = [a + b for a in _SYL for b in _SYL]          # 256 words
_KINDS = ("function", "method", "class")
_LANGS = ("python", "typescript", "go", "rust")


def payloads(lo: int, hi: int, rows_per_file: int) -> list[dict]:
    """Chunk payloads as the indexer writes them: `rows_per_file` chunks
    per file."""
    out = []
    for r in range(lo, hi):
        f = r // rows_per_file
        a, b, c = _WORDS[r % 256], _WORDS[(r // 7) % 256], _WORDS[(r // 3) % 251]
        name = f"{a.title()}{b.title()}.{c}_{_WORDS[f % 256]}"
        start = (r % rows_per_file) * 20 + 1
        out.append({
            "file_path": f"src/pkg{f // 100}/mod{f}.py",
            "name": name,
            "graph_node_id": f"pkg{f // 100}.mod{f}.{name}",
            "entity_type": _KINDS[r % 3],
            "language": _LANGS[f % 4],
            "project_name": "bench",
            "content_hash": f"{f:08x}",
            "start_line": start,
            "end_line": start + 19,
        })
    return out


# ---- the encoder's weights --------------------------------------------------


def roberta_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of a RoBERTa encoder under the Hugging Face names,
    from the configuration's sizes."""
    h, i = config["hidden_size"], config["intermediate_size"]
    shapes = {
        "embeddings.word_embeddings.weight": (config["vocab_size"], h),
        "embeddings.position_embeddings.weight":
            (config["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight":
            (config["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": (h,),
        "embeddings.LayerNorm.bias": (h,),
    }
    for n in range(config["num_hidden_layers"]):
        pre = f"encoder.layer.{n}."
        for name, out_f, in_f in (("attention.self.query", h, h),
                                  ("attention.self.key", h, h),
                                  ("attention.self.value", h, h),
                                  ("attention.output.dense", h, h),
                                  ("intermediate.dense", i, h),
                                  ("output.dense", h, i)):
            shapes[pre + name + ".weight"] = (out_f, in_f)
            shapes[pre + name + ".bias"] = (out_f,)
        for norm in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[pre + norm + ".weight"] = (h,)
            shapes[pre + norm + ".bias"] = (h,)
    return shapes


def roberta_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random f32 weights from the seed, made on `device` in one call:
    projections normal with std 1/sqrt(fan in) (flax's lecun normal, as the
    port's own init), tables std 1/sqrt(hidden), biases and LayerNorm
    shifts std `bias_std`, LayerNorm scales 1 + the same."""
    shapes = roberta_shapes(config)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, device=device, dtype=torch.float32,
                       generator=generator(seed, "weights", device))
    small = config["init"]["bias_std"]
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 2:   # [out, in] or [rows, hidden]
            out[name] = t * (1.0 / math.sqrt(shape[1]))
        elif "LayerNorm.weight" in name:
            out[name] = 1.0 + small * t
        else:
            out[name] = small * t
    return out


def port_state(weights: dict[str, torch.Tensor], config: dict
               ) -> dict[str, torch.Tensor]:
    """The same weights under lattice_tpu_torch's encoder names. The port
    has no token-type table: type 0's row, which RoBERTa adds to every
    position in encoder-only use, is folded into the position table (the
    port's own loader does the same)."""
    state = {
        "word_embeddings.weight": weights["embeddings.word_embeddings.weight"],
        "position_embeddings.weight": (
            weights["embeddings.position_embeddings.weight"]
            + weights["embeddings.token_type_embeddings.weight"][0][None, :]),
        "embeddings_norm.weight": weights["embeddings.LayerNorm.weight"],
        "embeddings_norm.bias": weights["embeddings.LayerNorm.bias"],
    }
    for n in range(config["num_hidden_layers"]):
        hf, ours = f"encoder.layer.{n}.", f"layers.{n}."
        for name, theirs in (("attention.query", "attention.self.query"),
                             ("attention.key", "attention.self.key"),
                             ("attention.value", "attention.self.value"),
                             ("attention.output", "attention.output.dense"),
                             ("attention_norm", "attention.output.LayerNorm"),
                             ("intermediate", "intermediate.dense"),
                             ("output", "output.dense"),
                             ("output_norm", "output.LayerNorm")):
            for leaf in ("weight", "bias"):
                state[f"{ours}{name}.{leaf}"] = weights[f"{hf}{theirs}.{leaf}"]
    return state
