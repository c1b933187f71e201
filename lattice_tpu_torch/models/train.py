"""Contrastive fine-tuning of the UniXcoder encoder (training subsystem).

Port of `lattice_tpu/models/train.py`: the standard bi-encoder recipe,
InfoNCE over (anchor, positive) pairs mined from the index
(`models/data.py`) with in-batch negatives, bidirectional cross-entropy at
a fixed scale of 20.

The differences from the reference:
- the step runs eagerly on one explicit device (default "cuda", which
  raises without CUDA); `mesh` raises `NotImplementedError`: the
  trainer's data and tensor parallelism over a `parallel/` mesh come in
  the next slice (ROADMAP queue 1, item 11);
- the optimizer is `torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)`, optax's `adamw`: decoupled decay on every
  parameter, the same bias correction, eps outside the square root;
- the encoder's attention runs the einsum path (`paired_attention=False`).
  The paired-attention kernel has no backward in either package (`jax.grad`
  through the Pallas kernel fails), and its wrapper refuses grad mode, so
  the trainer never reaches it. The reference's auto gate would pick the
  kernel on a TPU and fail there;
- random init draws from `torch.Generator(seed)` (`init_random_`), not
  JAX's keys: the tests carry the parameters across.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from lattice_tpu_torch.core.errors import ConfigurationError
from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                               UniXcoderEncoder, _device,
                                               init_random_)
from lattice_tpu_torch.ops.topk import full_f32
from lattice_tpu_torch.parallel.mesh import TENSOR_PARALLEL_ITEM

BATCH_KEYS = ("anchor_ids", "anchor_mask", "positive_ids", "positive_mask")


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]      # the encoder's parameters, live
    opt_state: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: Iterable[torch.Tensor],
                   learning_rate: float = 2e-5,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def contrastive_loss(encoder: UniXcoderEncoder,
                     batch: dict[str, torch.Tensor],
                     scale: float = 20.0) -> torch.Tensor:
    """Bidirectional InfoNCE with in-batch negatives."""
    _, anchor = encoder(batch["anchor_ids"], batch["anchor_mask"])
    _, positive = encoder(batch["positive_ids"], batch["positive_mask"])
    anchor = anchor / anchor.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    positive = positive / positive.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    # full f32 forward; the backward runs at the process's f32 matmul
    # precision (full f32 unless a caller turned TF32 on)
    with full_f32():
        logits = scale * (anchor @ positive.T)          # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2.0


class ContrastiveTrainer:
    def __init__(self, config: UniXcoderConfig | None = None,
                 mesh=None, learning_rate: float = 2e-5, seed: int = 0,
                 remat: bool = True, device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the trainer's mesh is not ported to lattice_tpu_torch yet: "
                "its data and tensor parallelism over a parallel/ mesh "
                f"come next ({TENSOR_PARALLEL_ITEM})")
        # per-layer rematerialization by default: the backward recomputes
        # each layer instead of holding every layer's activations. The
        # parameters are the same either way
        self.config = dataclasses.replace(config or UniXcoderConfig(),
                                          remat=remat, paired_attention=False)
        if self.config.fused_attention:
            raise ConfigurationError(
                "fused_attention (the JAX package's stock Pallas flash "
                "path) is not ported to lattice_tpu_torch")
        self.device = _device(device)
        self.module = UniXcoderEncoder(self.config)
        init_random_(self.module, seed)
        self.module.to(self.device).train()
        params = dict(self.module.named_parameters())
        self.optimizer = make_optimizer(params.values(), learning_rate)
        self.state = TrainState(params=params, opt_state=self.optimizer)

    def shard_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS}

    def train_step(self, batch: dict) -> float:
        batch = self.shard_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = contrastive_loss(self.module, batch)
        loss.backward()
        self.optimizer.step()
        self.state.step += 1
        return float(loss.detach())


def make_dummy_batch(batch_size: int = 8, length: int = 32,
                     vocab_size: int = 1000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, size=(batch_size, length))
    return {
        "anchor_ids": ids.astype(np.int32),
        "anchor_mask": np.ones((batch_size, length), dtype=np.int32),
        "positive_ids": (ids + 1).astype(np.int32) % vocab_size,
        "positive_mask": np.ones((batch_size, length), dtype=np.int32),
    }
