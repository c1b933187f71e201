"""UniXcoder (RoBERTa-base encoder) as a torch module for on-device embedding.

Port of `lattice_tpu/models/unixcoder.py`'s serving path: RobertaModel in
encoder-only mode with mode-token framing, whose sentence embedding is the
attention-mask-weighted mean-pool of the final hidden states. The config
matches `microsoft/unixcoder-base` (12 layers, 768 hidden, 12 heads, 3072
FFN, vocab 51416). Numerics follow the flax module:
- every projection is flax `Dense(dtype=compute, param_dtype=f32)`: input
  and weight cast to the compute dtype, the product's output in that dtype,
  then the bias added in that dtype;
- word + position embeddings summed as stored (f32), positions
  `cumsum(mask) * mask + pad_id`; every LayerNorm in f32 on the f32
  residual sum, eps 1e-5; exact GELU; the mean-pool in f32, divided by
  max(mask sum, 1);
- attention, chosen as the JAX package chooses it (`SelfAttention`):
  `ops.attention.paired_attention` (the hand-written kernel on a CUDA
  tensor, its plain version on a CPU one) when paired attention is on,
  flash is off, head_dim is 64, the heads pair up and L >= 8; else, when
  flash is on and L >= 128, `F.scaled_dot_product_attention` over
  [B, H, L, 64] in the compute dtype with pad tokens as their own segment
  (a real token attends only to real tokens, a pad token only to pads);
  else the einsum path: f32 scores / sqrt(d), the -1e9 bias, an f32
  softmax, probabilities in the compute dtype, f32 context.
  `LATTICE_PAIRED_ATTN` and `LATTICE_FLASH_ATTN` override the config's
  `paired_attention` and `fused_attention` as in the reference ("1" on,
  any other value off). The paired auto default is "on" (the reference's
  is "on a TPU"). The kernel has no backward, so training takes the einsum
  path or, with flash on, SDPA (`models/train.py`);
- `fused_attention`: the reference runs JAX's library flash kernel
  (`jax.experimental.pallas.ops.tpu.flash_attention`, not one of the
  repository's Pallas kernels), so its counterpart here is the library's
  `scaled_dot_product_attention`, which has a backward;
- `fused_qkv`: one [H, 3H] projection named `qkv` whose output's three
  column slices (q, k, v in that order, as `jnp.split(qkv, 3)`) feed the
  attention as they are, strided, without a copy;
- `remat`: under grad mode each layer runs through
  `torch.utils.checkpoint`, so the backward recomputes its activations.

`use_mesh` splits each batch over a mesh's data axis (the JAX package's
pjit batch data parallelism): the batch is padded to a multiple of the
data rows and split, each row runs `tensor_parallel_forward` over its
model positions (its `paired_attention` launches among them) on the
weights `parallel.mesh.shard_params` places on them (rows on the same
devices share them), and the pooled rows are gathered on the model's
device. That function is the encoder's only forward: the modules hold
the parameters, their names and their init, and `UniXcoderEncoder.forward`
runs it over one position. On mp > 1 it is the Megatron encoder of the
JAX package's rules: the query, key, value and intermediate layers
column-parallel, each position computing its own output columns and
attending over its own num_heads / mp heads (`paired_attention` where
that count is even); the attention-output and FFN-output layers
row-parallel, their partial products summed in f32 on the row's lead
device with the bias added once and one rounding to the compute dtype.
The JAX package lets GSPMD insert those all-reduces.

Left behind: the TPU layout pinning. Random init draws from an explicit
`torch.Generator(seed)` with flax's initialisers; it cannot reproduce
JAX's draws, so its fingerprint says `unixcoder-torch-random-seed{seed}`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
import pickle
import re
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lattice_tpu_torch.core.errors import ConfigurationError, EmbeddingError
from lattice_tpu_torch.ops.attention import MASKED, paired_attention
from lattice_tpu_torch.ops.topk import full_f32
from lattice_tpu_torch.parallel.mesh import (MODEL_AXIS, DeviceMesh,
                                             shard_params)
from lattice_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)

# flax's lecun_normal: a unit normal truncated to [-2, 2], rescaled to unit
# variance by this constant (the truncated normal's std)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class UniXcoderConfig:
    vocab_size: int = 51416
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1026
    type_vocab_size: int = 10
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1           # RoBERTa pad
    dtype: str = "bfloat16"         # compute dtype; params stay f32
    # None = auto = off. True: flash attention at L >= 128, here
    # `F.scaled_dot_product_attention` (the JAX package runs JAX's library
    # flash kernel). LATTICE_FLASH_ATTN=0/1 overrides
    fused_attention: bool | None = None
    # dtype the einsum path rounds its scores to before the softmax
    scores_dtype: str = "float32"
    # recompute each layer's activations in the backward (training only;
    # without grad mode it changes nothing)
    remat: bool = False
    # one [H, 3H] Q/K/V projection (`fuse_qkv_params` derives its weights;
    # checkpoints stay in the three-matmul layout)
    fused_qkv: bool = False
    # ops/attention.paired_attention: None (auto) or True = the paired path
    # where it applies (the kernel on a CUDA tensor, its plain version on a
    # CPU one); False = the einsum path. LATTICE_PAIRED_ATTN=0/1 overrides
    paired_attention: bool | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _paired_enabled(cfg: UniXcoderConfig) -> bool:
    """The reference's lever: LATTICE_PAIRED_ATTN ("1" on, anything else
    off) over the config; auto is on (the reference's auto is "on a
    TPU")."""
    env = os.environ.get("LATTICE_PAIRED_ATTN")
    if env is not None:
        return env == "1"
    return cfg.paired_attention is not False


def _flash_enabled(cfg: UniXcoderConfig) -> bool:
    """LATTICE_FLASH_ATTN ("1" on, anything else off) over the config's
    `fused_attention`; auto is off, as in the reference."""
    env = os.environ.get("LATTICE_FLASH_ATTN")
    if env is not None:
        return env == "1"
    return bool(cfg.fused_attention)


def _paired_applies(cfg: UniXcoderConfig, heads: int, length: int) -> bool:
    """Whether `heads` heads at `length` take `paired_attention`: paired on,
    flash off (an explicit flash opt-in wins over the paired default, as in
    the reference), heads of 64 that pair up, L >= 8."""
    return (_paired_enabled(cfg) and not _flash_enabled(cfg)
            and cfg.hidden_size // cfg.num_heads == 64
            and heads % 2 == 0 and length >= 8)


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, cfg: UniXcoderConfig,
                      heads: int) -> torch.Tensor:
    """The JAX package's einsum path over `heads` heads; [B, L, W] f32
    context."""
    bsz, ln, width = q.shape
    head_dim = width // heads

    def split(x):
        return x.reshape(bsz, ln, heads, head_dim).transpose(1, 2)

    # the products run in full f32 in the forward. Their backward runs
    # outside these blocks, at the process's f32 matmul precision: full f32
    # unless a caller turned TF32 on (PyTorch's default is off, and nothing
    # in the port turns it on)
    with full_f32():
        scores = split(q).float() @ split(k).float().transpose(-1, -2)
    # scaled in the scores dtype, as the JAX package does
    scores = (scores.to(getattr(torch, cfg.scores_dtype))
              / math.sqrt(head_dim)).float()
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, MASKED)
    probs = torch.softmax(scores + bias, dim=-1)
    with full_f32():
        ctx = probs.to(cfg.compute_dtype).float() @ split(v).float()
    return ctx.transpose(1, 2).reshape(bsz, ln, width)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, cfg: UniXcoderConfig,
                     heads: int) -> torch.Tensor:
    """The reference's flash path: q, k, v in the compute dtype as
    [B, H, L, d] through `scaled_dot_product_attention`, the mask's values
    as segment ids (a query attends to the keys of its own segment, so pad
    tokens form a segment of their own); [B, L, W] context in the compute
    dtype."""
    bsz, ln, width = q.shape
    head_dim = width // heads

    def split(x):
        return x.reshape(bsz, ln, heads, head_dim).transpose(1, 2).to(
            cfg.compute_dtype)

    same = mask[:, None, :, None] == mask[:, None, None, :]
    ctx = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                         attn_mask=same,
                                         scale=1.0 / math.sqrt(head_dim))
    return ctx.transpose(1, 2).reshape(bsz, ln, width)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, cfg: UniXcoderConfig,
               heads: int) -> torch.Tensor:
    """Attention over q/k/v [B, L, heads * d] by the reference's order of
    paths: paired, then flash at L >= 128, then einsum."""
    ln = q.shape[1]
    if _paired_applies(cfg, heads, ln):
        # the projections in their native [B, L, H*64] layout: no split,
        # transpose or copy feeds the kernel
        return paired_attention(q, k, v, mask, 1.0 / math.sqrt(
            cfg.hidden_size // cfg.num_heads))
    if _flash_enabled(cfg) and ln >= 128:
        return _flash_attention(q, k, v, mask, cfg, heads)
    return _einsum_attention(q, k, v, mask, cfg, heads)


class SelfAttention(nn.Module):
    """The attention's parameters; the forward is `tensor_parallel_forward`."""

    def __init__(self, config: UniXcoderConfig):
        super().__init__()
        h = config.hidden_size
        if config.fused_qkv:
            self.qkv = nn.Linear(h, 3 * h)
        else:
            self.query = nn.Linear(h, h)
            self.key = nn.Linear(h, h)
            self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)


class EncoderLayer(nn.Module):
    """One layer's parameters; the forward is `tensor_parallel_forward`."""

    def __init__(self, config: UniXcoderConfig):
        super().__init__()
        h = config.hidden_size
        self.attention = SelfAttention(config)
        self.attention_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.intermediate = nn.Linear(h, config.intermediate_size)
        self.output = nn.Linear(config.intermediate_size, h)
        self.output_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)


class UniXcoderEncoder(nn.Module):
    """Embeddings + N transformer layers + mean-pool sentence embedding:
    the parameters under their state-dict names, and the forward on their
    device (`tensor_parallel_forward` over one position)."""

    def __init__(self, config: UniXcoderConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.embeddings_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(config) for _ in range(config.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        params = dict(self.named_parameters())
        return tensor_parallel_forward(
            self.config, lambda name, p: params[name],
            (self.word_embeddings.weight.device,), input_ids, attention_mask)


def init_random_(encoder: UniXcoderEncoder, seed: int) -> None:
    """flax's default initialisers from one CPU `torch.Generator(seed)`, in
    module order: lecun-normal Dense kernels and zero biases, Embed's
    normal(0, 1/sqrt(features)), unit LayerNorm scales and zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in encoder.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=gen)
                mod.weight.mul_(math.sqrt(1.0 / mod.in_features) / _TRUNC_STD)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, math.sqrt(1.0 / mod.embedding_dim),
                                   generator=gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


# ---- tensor parallelism over a mesh's model axis ---------------------------


def check_tensor_parallel(cfg: UniXcoderConfig, mp: int) -> None:
    """Raise `ConfigurationError` unless the heads and the FFN width split
    `mp` ways."""
    if cfg.num_heads % mp or cfg.intermediate_size % mp:
        raise ConfigurationError(
            f"a model axis of {mp} does not split {cfg.num_heads} heads "
            f"and an FFN of {cfg.intermediate_size}")


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           cdt: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=compute, param_dtype=f32)`: the product in the
    compute dtype, then the bias added in that dtype (two roundings); no
    bias: a row-parallel layer's partial product."""
    y = F.linear(x.to(cdt), weight.to(cdt))
    return y if bias is None else y + bias.to(cdt)


def _reduce(parts: list[torch.Tensor], bias: torch.Tensor,
            lead: torch.device, cdt: torch.dtype) -> torch.Tensor:
    """A row-parallel layer's result on `lead` from its positions' partial
    products: one partial is `_dense`'s own result; more are summed in f32
    with the bias added once, then rounded once to the compute dtype."""
    if len(parts) == 1:
        return parts[0] + bias.to(cdt)
    total = parts[0].to(lead).float()
    for part in parts[1:]:
        total = total + part.to(lead).float()
    return (total + bias.float()).to(cdt)


def tensor_parallel_forward(
        cfg: UniXcoderConfig, weight: Callable[[str, int], torch.Tensor],
        devices: Sequence[torch.device], input_ids: torch.Tensor,
        attention_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's one forward, over the model positions of one data row,
    `devices[p]` being position p's device; returns (hidden, pooled) on
    `devices[0]`, the row's lead, where the inputs are. Over one position
    it is the plain encoder (`UniXcoderEncoder.forward`, the single-device
    trainer, a mesh without a model axis).

    `weight(name, p)` is position p's tensor of a state-dict name, on
    `devices[p]`: the column or row slice `parallel.mesh.shard_params`
    gives for the names `param_sharding_rules` splits, else the whole
    tensor. The embeddings, residuals, LayerNorms and the pool run on the
    lead; the query, key, value and intermediate layers run column-parallel
    (the whole q/k/v biases sliced here, as the rules keep them whole; a
    fused-QKV weight is whole, its product sliced), attention over each
    position's num_heads / mp heads; the attention-output and FFN-output
    layers row-parallel (`_reduce`). Differentiable: the copies between
    devices are `.to()`."""
    mp = len(devices)
    lead, cdt = devices[0], cfg.compute_dtype
    h = cfg.hidden_size
    width, heads = h // mp, cfg.num_heads // mp
    mask = attention_mask.to(torch.int64)
    # RoBERTa positions: pad tokens get pad_id; others count from pad+1
    positions = torch.cumsum(mask, dim=-1) * mask + cfg.pad_token_id
    emb = (F.embedding(input_ids, weight("word_embeddings.weight", 0))
           + F.embedding(positions, weight("position_embeddings.weight", 0)))
    hidden = F.layer_norm(emb.float(), (h,), weight("embeddings_norm.weight",
                                                    0),
                          weight("embeddings_norm.bias", 0),
                          cfg.layer_norm_eps).to(cdt)
    masks = [mask.to(d) for d in devices]

    def norm(x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (h,), weight(name + ".weight", 0),
                            weight(name + ".bias", 0), cfg.layer_norm_eps)

    def qkv(pre: str, p: int, x: torch.Tensor):
        cols = slice(p * width, (p + 1) * width)
        if cfg.fused_qkv:
            out = _dense(x, weight(pre + "qkv.weight", p),
                         weight(pre + "qkv.bias", p), cdt)
            return [t[..., cols] for t in out.split(h, dim=-1)]
        return [_dense(x, weight(f"{pre}{n}.weight", p),
                       weight(f"{pre}{n}.bias", p)[cols], cdt)
                for n in ("query", "key", "value")]

    def layer(i: int, hidden: torch.Tensor) -> torch.Tensor:
        pre = f"layers.{i}."
        xs = [hidden.to(d) for d in devices]
        parts = []
        for p in range(mp):
            ctx = _attention(*qkv(pre + "attention.", p, xs[p]), masks[p],
                             cfg, heads)
            parts.append(_dense(ctx, weight(pre + "attention.output.weight",
                                            p), None, cdt))
        attn_out = _reduce(parts, weight(pre + "attention.output.bias", 0),
                           lead, cdt)
        hidden = norm(hidden.float() + attn_out.float(),
                      pre + "attention_norm").to(cdt)
        xs = [hidden.to(d) for d in devices]
        parts = [_dense(F.gelu(_dense(xs[p], weight(pre + "intermediate."
                                                    "weight", p),
                                      weight(pre + "intermediate.bias", p),
                                      cdt), approximate="none"),
                        weight(pre + "output.weight", p), None, cdt)
                 for p in range(mp)]
        out = _reduce(parts, weight(pre + "output.bias", 0), lead, cdt)
        return norm(hidden.float() + out.float(), pre + "output_norm").to(cdt)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        if remat:
            # non-reentrant: the weights `layer` closes over get their
            # gradients from the recomputation
            hidden = checkpoint(layer, i, hidden, use_reentrant=False)
        else:
            hidden = layer(i, hidden)
    mask_f = mask.to(torch.float32)[:, :, None]
    pooled = (hidden.float() * mask_f).sum(dim=1) / torch.clamp(
        mask_f.sum(dim=1), min=1.0)
    return hidden, pooled


def _device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EmbeddingError(f"device {dev} requested but CUDA is not "
                             "available")
    return dev


class UniXcoderModel:
    """Host-facing wrapper: the encoder on one explicit device, with
    length bucketing."""

    LENGTH_BUCKETS = (64, 128, 256, 512)

    def __init__(self, config: UniXcoderConfig | None = None,
                 weights_dir: str | Path | None = None, seed: int = 0,
                 finetune_dir: str | Path | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or UniXcoderConfig()
        self.device = _device(device)
        self.encoder = UniXcoderEncoder(self.config)
        init_random_(self.encoder, seed)
        self.loaded_pretrained = False
        self.loaded_finetuned = False
        if weights_dir is not None:
            self.loaded_pretrained = self._load_hf_weights(Path(weights_dir))
        # persisted in the index manifest so that a query-time encoder
        # mismatch is detectable: random torch weights are not JAX's
        self.weights_fingerprint = (
            "unixcoder-pretrained" if self.loaded_pretrained
            else f"unixcoder-torch-random-seed{seed}")
        if finetune_dir is not None:
            npz = Path(finetune_dir) / "finetuned_params.npz"
            if npz.is_file():
                try:
                    self.encoder.load_state_dict(
                        _load_flat_npz(npz, self.encoder))
                except (KeyError, ValueError) as exc:
                    logger.warning(
                        "fine-tuned checkpoint mismatch at %s (%s); "
                        "keeping base weights", npz, exc)
                else:
                    if not self.loaded_pretrained:
                        # every weight is now the JAX checkpoint's: keep
                        # the JAX package's string for the same weights
                        self.weights_fingerprint = (
                            f"unixcoder-random-seed{seed}")
                    self.loaded_finetuned = True
                    self.loaded_pretrained = True
                    digest = hashlib.blake2b(npz.read_bytes(),
                                             digest_size=8).hexdigest()
                    self.weights_fingerprint += f"+ft-{digest}"
                    logger.info("loaded fine-tuned checkpoint %s", npz)
        self.encoder.to(self.device).eval()
        self.mesh: DeviceMesh | None = None
        # each data row's weights, `shard_params`' placement on the row's
        # devices, made at first use (rows on the same devices share them)
        self._row_weights: dict[tuple[torch.device, ...],
                                dict[str, list[torch.Tensor]]] = {}

    def use_mesh(self, mesh: DeviceMesh) -> None:
        """Split every batch over the mesh's data axis (batch data
        parallelism) and, on a model axis larger than 1, each row's
        forward over its model positions (`tensor_parallel_forward`); the
        pooled rows come back on the model's device."""
        check_tensor_parallel(self.config, mesh.shape.get(MODEL_AXIS, 1))
        self.mesh = mesh
        self._row_weights = {}

    @property
    def data_shards(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    def _placed(self, devices: tuple[torch.device, ...]
                ) -> dict[str, list[torch.Tensor]]:
        """The weights of a data row on `devices`: `shard_params` of the
        encoder's (no copy where a tensor is already in place)."""
        placed = self._row_weights.get(devices)
        if placed is None:
            placed = self._row_weights[devices] = shard_params(
                self.encoder.state_dict(), devices)
        return placed

    def bucket_length(self, n: int) -> int:
        for b in self.LENGTH_BUCKETS:
            if n <= b:
                return b
        return self.LENGTH_BUCKETS[-1]

    def enable_fused_qkv(self) -> None:
        """Serve the attention projections through one [H, 3H] matmul:
        the weights fused from the three-matmul ones (`fuse_qkv_params`),
        the encoder rebuilt around them on the same device and in the same
        dtypes. Call it after any weight load: checkpoints stay in the
        three-matmul layout."""
        if self.config.fused_qkv:
            return
        self.config = dataclasses.replace(self.config, fused_qkv=True)
        state = fuse_qkv_params(self.encoder.state_dict(),
                                self.config.num_layers)
        with torch.device("meta"):
            encoder = UniXcoderEncoder(self.config)
        encoder.load_state_dict(state, assign=True)
        self.encoder = encoder.eval()
        self._row_weights = {}
        self.weights_fingerprint += "+qkvfused"

    def enable_bf16_inference(self) -> None:
        """Cast the matrix params (2-D: projections and embedding tables)
        to bf16 in place for serving, as the JAX package does; vectors
        (biases, LayerNorm) stay f32. The forward already computes in
        bf16, so the projections are unchanged; the embedding sum is then
        taken in bf16, as there."""
        with torch.no_grad():
            for p in self.encoder.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(torch.bfloat16)
        self._row_weights = {}
        self.weights_fingerprint += "+bf16serve"

    def _forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 weights: dict[str, torch.Tensor] | None = None
                 ) -> torch.Tensor:
        """Pooled rows on the model's device; `weights` (`_cast_weights`),
        where given, in place of the encoder's parameters. With a mesh, the
        batch padded (pad tokens, an all-zero mask) to a multiple of the
        data rows, one slice a row, every row launched before any is
        read."""
        with torch.inference_mode():
            if self.mesh is None or input_ids.shape[0] == 0:
                if weights is None:
                    return self.encoder(input_ids, attention_mask)[1]
                return tensor_parallel_forward(
                    self.config, lambda name, p: weights[name],
                    (self.device,), input_ids, attention_mask)[1]
            rows = self.mesh.model_rows
            b = input_ids.shape[0]
            pad = (-b) % len(rows)
            ids = F.pad(input_ids, (0, 0, 0, pad),
                        value=self.config.pad_token_id)
            mask = F.pad(attention_mask, (0, 0, 0, pad))
            per = ids.shape[0] // len(rows)
            pooled = []
            for i, devices in enumerate(rows):
                placed = self._placed(devices)
                pooled.append(tensor_parallel_forward(
                    self.config, lambda name, p: placed[name][p], devices,
                    ids[i * per:(i + 1) * per].to(devices[0]),
                    mask[i * per:(i + 1) * per].to(devices[0]))[1])
            return torch.cat([p.to(self.device) for p in pooled])[:b]

    def _cast_weights(self) -> dict[str, torch.Tensor]:
        """The encoder's parameters by name, the Linear layers' cast once to
        the compute dtype as `_dense` casts them at each use: the forwards
        of one batch's groups share one cast, with the same products."""
        cdt = self.config.compute_dtype
        with torch.inference_mode():
            weights = dict(self.encoder.named_parameters())
            for name, mod in self.encoder.named_modules():
                if isinstance(mod, nn.Linear):
                    weights[f"{name}.weight"] = mod.weight.to(cdt)
                    weights[f"{name}.bias"] = mod.bias.to(cdt)
        return weights

    def encode_device(self, input_ids, attention_mask) -> torch.Tensor:
        """Pooled [B, H] f32 embeddings left on the model's device. Inputs
        that are already tensors on that device at a bucket length go
        straight in; anything else takes the host pad path. Only the host
        pad path feeds the tracer's token counters: the device tensors'
        mask is not read back to count them."""
        if (isinstance(input_ids, torch.Tensor)
                and isinstance(attention_mask, torch.Tensor)
                and input_ids.device == self.device
                and attention_mask.device == self.device
                and input_ids.dim() == 2
                and attention_mask.shape == input_ids.shape
                and input_ids.shape[1] == self.bucket_length(
                    input_ids.shape[1])):
            return self._forward(input_ids, attention_mask)
        return self._encode_device_host(input_ids, attention_mask)

    def _encode_device_host(self, input_ids, attention_mask) -> torch.Tensor:
        """Host pad path: numpy, truncation at the largest bucket, and the
        rows grouped by the length bucket of each row's own length (its
        last live token + 1, so a mask with holes keeps every live token; a
        row with none goes to the smallest bucket). The rows are reordered
        so that each group is contiguous, longest group first, and padded
        to the longest group's bucket; one upload each of ids and mask (and
        of the inverse permutation, where there is one). Traced as the hot
        span `encode.host_prep`. Then one `_forward` a group, on its row
        slice at its bucket, longest first, so the card runs the longest
        while the host issues the rest, the groups sharing one cast of the
        weights; the pooled rows come back in the caller's order. A batch
        whose rows share one bucket runs one `_forward` at it, unreordered.
        While tracing is on, the counters `encode.tokens_live` (the mask's
        sum), `encode.tokens_padded` (each group's rows x its bucket) and
        `encode.sub_batches` (the `_forward` calls) take the batch."""
        tracer = get_tracer()
        buckets = self.LENGTH_BUCKETS
        with tracer.hot("encode.host_prep"):
            if isinstance(input_ids, torch.Tensor):
                input_ids = input_ids.cpu().numpy()
            if isinstance(attention_mask, torch.Tensor):
                attention_mask = attention_mask.cpu().numpy()
            ids = np.asarray(input_ids, dtype=np.int64)
            mask = np.asarray(attention_mask, dtype=np.int64)
            if ids.ndim == 1:
                ids, mask = ids[None, :], mask[None, :]
            ids, mask = ids[:, :buckets[-1]], mask[:, :buckets[-1]]
            ends = ((mask != 0) * np.arange(1, mask.shape[1] + 1)).max(
                axis=1, initial=0)
            # each row's bucket, as an index into `buckets`
            which = np.searchsorted(buckets, ends)
            sizes = np.bincount(which, minlength=len(buckets))
            groups, start = [], 0          # (first row, end row, bucket)
            for g in reversed(range(len(buckets))):
                if sizes[g]:
                    groups.append((start, start + int(sizes[g]), buckets[g]))
                    start += int(sizes[g])
            groups = groups or [(0, 0, buckets[0])]
            length = groups[0][2]
            inverse = None
            if len(groups) > 1:
                order = np.argsort(-which, kind="stable")
                ids, mask = ids[order], mask[order]
                inverse = torch.from_numpy(np.argsort(order)).to(self.device)
            ids, mask = ids[:, :length], mask[:, :length]
            if ids.shape[1] < length:
                pad = length - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)),
                             constant_values=self.config.pad_token_id)
                mask = np.pad(mask, ((0, 0), (0, pad)))
            if tracer.on:
                tracer.count("encode.tokens_live", mask.sum())
                tracer.count("encode.tokens_padded",
                             sum((b - a) * n for a, b, n in groups))
                tracer.count("encode.sub_batches", len(groups))
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
        # a mesh's rows hold their own placed weights
        weights = self._cast_weights() if self.mesh is None else None
        pooled = [self._forward(ids_t[a:b, :n], mask_t[a:b, :n], weights)
                  for a, b, n in groups]
        if inverse is None:
            return pooled[0]
        return torch.cat(pooled).index_select(0, inverse)

    def encode(self, input_ids, attention_mask) -> np.ndarray:
        """Pooled [B, H] embeddings on the host (`encode_device` + copy)."""
        return self.encode_device(input_ids, attention_mask).float().cpu(
        ).numpy()

    # ---- weight loading (optional, offline) ----------------------------

    def _load_hf_weights(self, weights_dir: Path) -> bool:
        """Our own fine-tune checkpoint (`finetuned_params.npz`, the flat
        slash-joined names `lattice_tpu/models/finetune.py` writes) or a local
        `microsoft/unixcoder-base` torch checkpoint. False (random init)
        when neither loads."""
        npz = weights_dir / "finetuned_params.npz"
        if npz.is_file():
            try:
                self.encoder.load_state_dict(_load_flat_npz(npz, self.encoder))
                return True
            except (KeyError, ValueError) as exc:
                logger.warning("finetuned checkpoint mismatch (%s)", exc)
        state = _read_torch_state(weights_dir)
        if state is None:
            logger.warning("no loadable weights under %s; using random init",
                           weights_dir)
            return False
        try:
            self.encoder.load_state_dict(
                _map_roberta_params(state, self.config))
            return True
        except (KeyError, RuntimeError) as exc:
            logger.warning("weight mapping failed (%s); using random init", exc)
            return False


# ---- weights carried across -------------------------------------------------

_LAYER_RE = re.compile(r"layer_(\d+)$")
# flax leaf name -> torch parameter name
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX encoder's parameters under the slash-joined names that the
    fine-tune (`models/finetune.py`) writes (`layer_3/attention/query/kernel`,
    `word_embeddings/embedding`, ...) -> this module's state dict. Dense
    kernels are flax [in, out] and become torch [out, in]."""
    state = {}
    for name, value in flat.items():
        parts = name.split("/")
        leaf = parts[-1]
        if leaf not in _LEAF:
            raise KeyError(name)
        path = []
        for p in parts[:-1]:
            m = _LAYER_RE.match(p)
            path += ["layers", m.group(1)] if m else [p]
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if leaf == "kernel":
            t = t.T.contiguous()
        state[".".join(path + [_LEAF[leaf]])] = t
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: this module's state dict -> f32
    arrays under the JAX encoder's slash-joined names, as
    `lattice_tpu/models/finetune.py` writes them. Dense kernels go back to
    flax's [in, out]; a 1-D weight is a LayerNorm scale, the tables'
    weights are embeddings."""
    flat = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        parts = []
        for i, p in enumerate(path):
            if p == "layers":
                continue
            parts.append(f"layer_{p}" if i and path[i - 1] == "layers"
                         else p)
        t = value.detach().float().cpu()
        if leaf == "bias":
            key = "bias"
        elif t.dim() == 1:
            key = "scale"
        elif path[-1].endswith("embeddings"):
            key = "embedding"
        else:
            key, t = "kernel", t.T
        flat["/".join(parts + [key])] = t.contiguous().numpy()
    return flat


def fuse_qkv_params(state: dict[str, torch.Tensor], num_layers: int
                    ) -> dict[str, torch.Tensor]:
    """A three-matmul state dict -> the fused-QKV layout: each layer's
    query, key and value weights ([out, in]) and biases concatenated along
    the output, in that order, as `lattice_tpu`'s `fuse_qkv_params`
    concatenates flax's [in, out] kernels (the order of `jnp.split(qkv,
    3)`)."""
    out = dict(state)
    for i in range(num_layers):
        pre = f"layers.{i}.attention."
        for leaf in ("weight", "bias"):
            out[f"{pre}qkv.{leaf}"] = torch.cat(
                [out.pop(f"{pre}{name}.{leaf}")
                 for name in ("query", "key", "value")])
    return out


def _load_flat_npz(path: Path, encoder: UniXcoderEncoder
                   ) -> dict[str, torch.Tensor]:
    """The encoder's state dict from the fine-tune's flat npz:
    every parameter must be there at its shape (KeyError / ValueError
    otherwise); other entries are ignored."""
    with np.load(path) as flat:
        state = params_from_jax({k: flat[k] for k in flat.files})
    out = {}
    for name, want in encoder.state_dict().items():
        if name not in state:
            raise KeyError(name)
        if state[name].shape != want.shape:
            raise ValueError(f"{name}: shape {tuple(state[name].shape)} != "
                             f"{tuple(want.shape)}")
        out[name] = state[name]
    return out


def _read_torch_state(weights_dir: Path) -> dict[str, torch.Tensor] | None:
    """`model.safetensors` (when `safetensors` imports) or
    `pytorch_model.bin` (`torch.load(weights_only=True)`); None if neither
    is there or loads."""
    path = weights_dir / "model.safetensors"
    if path.is_file():
        try:
            from safetensors.torch import load_file
            return dict(load_file(str(path)))
        except (ImportError, OSError, RuntimeError, ValueError) as exc:
            logger.warning("cannot read %s (%s)", path, exc)
    path = weights_dir / "pytorch_model.bin"
    if path.is_file():
        try:
            return dict(torch.load(str(path), map_location="cpu",
                                   weights_only=True))
        except (OSError, RuntimeError, ValueError,
                pickle.UnpicklingError) as exc:
            logger.warning("cannot read %s (%s)", path, exc)
    return None


def _map_roberta_params(state: dict, cfg: UniXcoderConfig
                        ) -> dict[str, torch.Tensor]:
    """HF `roberta.*` names -> this module's state dict (torch Linear
    weights are already [out, in])."""
    def g(key: str) -> torch.Tensor:
        for prefix in ("roberta.", "", "model."):
            if prefix + key in state:
                v = state[prefix + key]
                if isinstance(v, torch.Tensor):
                    return v.float()
                return torch.from_numpy(np.asarray(v, dtype=np.float32))
        raise KeyError(key)

    out = {"word_embeddings.weight": g("embeddings.word_embeddings.weight")}
    pos_table = g("embeddings.position_embeddings.weight")
    # HF RoBERTa adds token_type_embeddings[0] to every position (token
    # type ids are all zero in encoder-only use); this module has no type
    # table, so that constant row folds into the position table: summed
    # before the LayerNorm, the result is the same
    try:
        pos_table = pos_table + g(
            "embeddings.token_type_embeddings.weight")[0][None, :]
    except KeyError:
        pass
    out["position_embeddings.weight"] = pos_table
    out["embeddings_norm.weight"] = g("embeddings.LayerNorm.weight")
    out["embeddings_norm.bias"] = g("embeddings.LayerNorm.bias")
    for i in range(cfg.num_layers):
        hf, ours = f"encoder.layer.{i}.", f"layers.{i}."
        for name, theirs in (("attention.query", "attention.self.query"),
                             ("attention.key", "attention.self.key"),
                             ("attention.value", "attention.self.value"),
                             ("attention.output", "attention.output.dense"),
                             ("attention_norm", "attention.output.LayerNorm"),
                             ("intermediate", "intermediate.dense"),
                             ("output", "output.dense"),
                             ("output_norm", "output.LayerNorm")):
            out[f"{ours}{name}.weight"] = g(f"{hf}{theirs}.weight")
            out[f"{ours}{name}.bias"] = g(f"{hf}{theirs}.bias")
    return out
