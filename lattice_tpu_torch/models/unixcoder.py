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
- attention through `ops.attention.paired_attention` (the hand-written
  kernel on a CUDA tensor, its plain version on a CPU one) when head_dim is
  64, the heads pair up and L >= 8; otherwise, or with
  `paired_attention=False`, the einsum path: f32 scores / sqrt(d), the
  -1e9 bias, an f32 softmax, probabilities in the compute dtype, f32
  context. The kernel has no backward, so training runs the einsum path
  (`models/train.py`);
- `fused_qkv`: one `Dense(H, 3H)` named `qkv` whose output's three column
  slices (q, k, v in that order, as `jnp.split(qkv, 3)`) feed the
  attention as they are, strided, without a copy;
- `remat`: under grad mode each layer runs through
  `torch.utils.checkpoint`, so the backward recomputes its activations.

`use_mesh` splits each batch over a mesh's data axis (the JAX package's
pjit batch data parallelism): the weights are copied to each shard's
device (shards that share a card share one copy), the batch is padded to a
multiple of the shards and split, each shard runs the forward (its
`paired_attention` launches among them), and the pooled rows are gathered
on the model's device. A model axis larger than 1 (tensor parallelism)
raises `NotImplementedError`.

Left behind: the TPU layout pinning and the stock Pallas flash path
(`fused_attention` set True raises). Random init draws from an explicit
`torch.Generator(seed)` with flax's initialisers; it cannot reproduce
JAX's draws, so its fingerprint says `unixcoder-torch-random-seed{seed}`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import pickle
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lattice_tpu_torch.core.errors import ConfigurationError, EmbeddingError
from lattice_tpu_torch.ops.attention import MASKED, paired_attention
from lattice_tpu_torch.ops.topk import full_f32
from lattice_tpu_torch.parallel.mesh import DeviceMesh, require_no_model_axis

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
    # the stock Pallas flash path of the JAX package; not ported (True raises)
    fused_attention: bool | None = None
    # dtype the einsum path rounds its scores to before the softmax
    scores_dtype: str = "float32"
    # recompute each layer's activations in the backward (training only;
    # without grad mode it changes nothing)
    remat: bool = False
    # one [H, 3H] Q/K/V projection (`fuse_qkv_params` derives its weights;
    # checkpoints stay in the three-matmul layout)
    fused_qkv: bool = False
    # ops/attention.paired_attention: None or True = the paired path where
    # it applies (the kernel on a CUDA tensor, its plain version on a CPU
    # one); False = the einsum path
    paired_attention: bool | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _paired_enabled(cfg: UniXcoderConfig, length: int) -> bool:
    return (cfg.paired_attention is not False
            and cfg.hidden_size // cfg.num_heads == 64
            and cfg.num_heads % 2 == 0 and length >= 8)


class Dense(nn.Linear):
    """flax `Dense(dtype=compute, param_dtype=f32)`: the product in the
    compute dtype, then the bias added in that dtype (two roundings)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        y = F.linear(x.to(cdt), self.weight.to(cdt))
        return y + self.bias.to(cdt)


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, cfg: UniXcoderConfig) -> torch.Tensor:
    """The JAX package's einsum path; [B, L, W] f32 context."""
    bsz, ln, width = q.shape
    head_dim = width // cfg.num_heads

    def split(x):
        return x.reshape(bsz, ln, cfg.num_heads, head_dim).transpose(1, 2)

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


class SelfAttention(nn.Module):
    def __init__(self, config: UniXcoderConfig):
        super().__init__()
        self.config = config
        h, cdt = config.hidden_size, config.compute_dtype
        if config.fused_qkv:
            self.qkv = Dense(h, 3 * h, cdt)
        else:
            self.query = Dense(h, h, cdt)
            self.key = Dense(h, h, cdt)
            self.value = Dense(h, h, cdt)
        self.output = Dense(h, h, cdt)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.fused_qkv:
            # three column slices of one [B, L, 3H] product, views
            q, k, v = self.qkv(hidden).split(cfg.hidden_size, dim=-1)
        else:
            q, k, v = self.query(hidden), self.key(hidden), self.value(hidden)
        if _paired_enabled(cfg, hidden.shape[1]):
            # the projections in their native [B, L, H*64] layout: no
            # split, transpose or copy feeds the kernel
            ctx = paired_attention(q, k, v, mask,
                                   1.0 / math.sqrt(cfg.hidden_size
                                                   // cfg.num_heads))
        else:
            ctx = _einsum_attention(q, k, v, mask, cfg)
        return self.output(ctx.to(cfg.compute_dtype))


class EncoderLayer(nn.Module):
    def __init__(self, config: UniXcoderConfig):
        super().__init__()
        self.config = config
        h, cdt = config.hidden_size, config.compute_dtype
        self.attention = SelfAttention(config)
        self.attention_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.intermediate = Dense(h, config.intermediate_size, cdt)
        self.output = Dense(config.intermediate_size, h, cdt)
        self.output_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cdt = self.config.compute_dtype
        attn_out = self.attention(hidden, mask)
        hidden = self.attention_norm(hidden.float() + attn_out.float()).to(cdt)
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = self.output(inter)
        return self.output_norm(hidden.float() + out.float()).to(cdt)


class UniXcoderEncoder(nn.Module):
    """Embeddings + N transformer layers + mean-pool sentence embedding."""

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
        cfg = self.config
        mask = attention_mask.to(torch.int64)
        # RoBERTa positions: pad tokens get pad_id; others count from pad+1
        positions = torch.cumsum(mask, dim=-1) * mask + cfg.pad_token_id
        emb = self.word_embeddings(input_ids) + self.position_embeddings(
            positions)
        hidden = self.embeddings_norm(emb.float()).to(cfg.compute_dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                hidden = checkpoint(layer, hidden, mask, use_reentrant=False)
            else:
                hidden = layer(hidden, mask)
        mask_f = mask.to(torch.float32)[:, :, None]
        pooled = (hidden.float() * mask_f).sum(dim=1) / torch.clamp(
            mask_f.sum(dim=1), min=1.0)
        return hidden, pooled


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
        if self.config.fused_attention:
            raise ConfigurationError(
                "fused_attention (the JAX package's stock Pallas flash "
                "path) is not ported to lattice_tpu_torch")
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
        self._replicas: dict[torch.device, UniXcoderEncoder] = {}

    def use_mesh(self, mesh: DeviceMesh) -> None:
        """Split every batch over the mesh's data axis (batch data
        parallelism); the pooled rows come back on the model's device."""
        require_no_model_axis(mesh, "UniXcoderModel.use_mesh")
        self.mesh = mesh
        self._replicas = {}

    @property
    def data_shards(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    def _replica(self, device: torch.device) -> "UniXcoderEncoder":
        """The encoder on `device`: itself where its weights live, else a
        copy of its current weights made at first use."""
        if device == next(self.encoder.parameters()).device:
            return self.encoder
        enc = self._replicas.get(device)
        if enc is None:
            state = {k: v.to(device)
                     for k, v in self.encoder.state_dict().items()}
            with torch.device("meta"):
                enc = UniXcoderEncoder(self.config)
            enc.load_state_dict(state, assign=True)
            enc = self._replicas[device] = enc.eval()
        return enc

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
        self._replicas = {}
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
        self._replicas = {}
        self.weights_fingerprint += "+bf16serve"

    def _forward(self, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
        """Pooled rows on the model's device; with a mesh, the batch padded
        (pad tokens, an all-zero mask) to a multiple of the data shards,
        one slice a shard, every shard launched before any is read."""
        with torch.inference_mode():
            if self.mesh is None or input_ids.shape[0] == 0:
                return self.encoder(input_ids, attention_mask)[1]
            devices = self.mesh.row_devices
            b = input_ids.shape[0]
            pad = (-b) % len(devices)
            ids = F.pad(input_ids, (0, 0, 0, pad),
                        value=self.config.pad_token_id)
            mask = F.pad(attention_mask, (0, 0, 0, pad))
            per = ids.shape[0] // len(devices)
            pooled = [self._replica(d)(ids[i * per:(i + 1) * per].to(d),
                                       mask[i * per:(i + 1) * per].to(d))[1]
                      for i, d in enumerate(devices)]
            return torch.cat([p.to(self.device) for p in pooled])[:b]

    def encode_device(self, input_ids, attention_mask) -> torch.Tensor:
        """Pooled [B, H] f32 embeddings left on the model's device. Inputs
        that are already tensors on that device at a bucket length go
        straight in; anything else takes the host pad path."""
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
        """Host pad path: numpy, truncation and padding to the length
        bucket, one upload."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        if isinstance(attention_mask, torch.Tensor):
            attention_mask = attention_mask.cpu().numpy()
        ids = np.asarray(input_ids, dtype=np.int64)
        mask = np.asarray(attention_mask, dtype=np.int64)
        if ids.ndim == 1:
            ids, mask = ids[None, :], mask[None, :]
        length = self.bucket_length(ids.shape[1])
        ids, mask = ids[:, :length], mask[:, :length]
        if ids.shape[1] < length:
            pad = length - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)),
                         constant_values=self.config.pad_token_id)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return self._forward(torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(mask).to(self.device))

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
