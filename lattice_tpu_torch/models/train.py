"""Contrastive fine-tuning of the UniXcoder encoder (training subsystem).

Port of `lattice_tpu/models/train.py`: the standard bi-encoder recipe,
InfoNCE over (anchor, positive) pairs mined from the index
(`models/data.py`) with in-batch negatives, bidirectional cross-entropy at
a fixed scale of 20.

Parallelism (`mesh=`, a `parallel/` mesh), the JAX trainer's data and
tensor parallelism in one process:
- each data row of the mesh encodes its slice of the batch; on a model
  axis of mp > 1 through `tensor_parallel_forward` over its positions,
  else the same function over one position (the encoder's own numerics);
- the pooled anchors and positives are gathered on the lead device with
  differentiable copies and the one loss is taken there over the global
  batch, so every row's negatives are the whole batch's, as in the JAX
  step's one [B, B] logits under GSPMD. A per-shard loss would change the
  negatives and is never formed;
- the parameters and the AdamW state live once: a weight the rules split
  over `model` as one slice a position on that position's device (on the
  mesh's first data row), every other one whole on the lead. The other
  rows reach them through `.to()`, whose backward adds their gradients
  into the one copy, so a step is the single-device step's mathematics
  (AdamW is elementwise). `state_dict()` assembles the whole weights.
Without a mesh the trainer is one data row of one position on its device:
one step, one forward (`tensor_parallel_forward`), whatever the layout.

The differences from the reference:
- the step runs eagerly on one explicit device (default "cuda", which
  raises without CUDA), or on the mesh's devices;
- the optimizer is `torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)`, optax's `adamw`: decoupled decay on every
  parameter, the same bias correction, eps outside the square root;
- the encoder's attention runs the einsum path (`paired_attention=False`)
  or, with `fused_attention=True` or LATTICE_FLASH_ATTN=1 at L >= 128,
  `scaled_dot_product_attention`, which has a backward. The paired-
  attention kernel has none in either package (`jax.grad` through the
  Pallas kernel fails), and its wrapper refuses grad mode: where
  LATTICE_PAIRED_ATTN=1 would send a step to it, the trainer raises
  `ConfigurationError` when it is made, not mid-step;
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
                                               _paired_applies,
                                               check_tensor_parallel,
                                               init_random_,
                                               tensor_parallel_forward)
from lattice_tpu_torch.ops.topk import full_f32
from lattice_tpu_torch.parallel.mesh import (MODEL_AXIS, DeviceMesh,
                                             param_sharding_rules)

BATCH_KEYS = ("anchor_ids", "anchor_mask", "positive_ids", "positive_mask")


@dataclasses.dataclass
class TrainState:
    # the encoder's parameters, live: each name's tensor of every model
    # position (one, whole, for a name that is not split)
    params: dict[str, list[torch.Tensor]]
    opt_state: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: Iterable[torch.Tensor],
                   learning_rate: float = 2e-5,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def info_nce(anchor: torch.Tensor, positive: torch.Tensor,
             scale: float = 20.0) -> torch.Tensor:
    """The loss of pooled [B, H] anchors and positives, every other row of
    the batch a negative."""
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
                 mesh: DeviceMesh | None = None,
                 learning_rate: float = 2e-5, seed: int = 0,
                 remat: bool = True, device: str | torch.device = "cuda"):
        # per-layer rematerialization by default: the backward recomputes
        # each layer instead of holding every layer's activations. The
        # parameters are the same either way
        self.config = dataclasses.replace(config or UniXcoderConfig(),
                                          remat=remat, paired_attention=False)
        self.mesh = mesh
        self.mp = mesh.shape.get(MODEL_AXIS, 1) if mesh is not None else 1
        check_tensor_parallel(self.config, self.mp)
        # the paired path applies at every L >= 8 or at none
        heads = self.config.num_heads // self.mp
        if _paired_applies(self.config, heads, 8):
            raise ConfigurationError(
                "LATTICE_PAIRED_ATTN=1 sends training through "
                "paired_attention, which has no backward in either package: "
                "unset it (or set LATTICE_FLASH_ATTN=1) to train")
        self.learning_rate = learning_rate
        self.device = mesh.lead if mesh is not None else _device(device)
        # without a mesh, one data row of one position: the same step
        self.rows = (mesh.model_rows if mesh is not None
                     else ((self.device,),))
        encoder = UniXcoderEncoder(self.config)
        init_random_(encoder, seed)
        self._split: dict[str, int] = {}     # name -> the dim split over mp
        params: dict[str, list[torch.Tensor]] = {}
        for name, param in encoder.named_parameters():
            spec = param_sharding_rules(name, param)
            if self.mp > 1 and MODEL_AXIS in spec:
                dim = self._split[name] = spec.index(MODEL_AXIS)
                parts = param.detach().chunk(self.mp, dim)
            else:
                parts = (param.detach(),)
            params[name] = [torch.nn.Parameter(part.to(d, copy=True))
                            for part, d in zip(parts, self.rows[0])]
        self.optimizer = make_optimizer(self._leaves(params), learning_rate)
        self.state = TrainState(params=params, opt_state=self.optimizer)

    @staticmethod
    def _leaves(params: dict[str, list[torch.Tensor]]) -> list[torch.Tensor]:
        return [p for parts in params.values() for p in parts]

    def _whole(self, pick) -> dict[str, torch.Tensor]:
        """`pick` of every name's tensors, a split name's slices joined on
        the trainer's (lead) device."""
        return {name: (torch.cat([pick(p).to(self.device) for p in parts],
                                 self._split[name])
                       if name in self._split else pick(parts[0]))
                for name, parts in self.state.params.items()}

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The encoder's whole weights on the trainer's (lead) device,
        under the encoder's state-dict names."""
        return self._whole(lambda p: p.detach())

    def grads(self) -> dict[str, torch.Tensor]:
        """The gradient of the last step (or of a `loss(...).backward()`)
        of every weight, whole, as `state_dict`."""
        return self._whole(lambda p: p.grad)

    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Start from `state` (whole weights, every name of the encoder):
        each copied into its place, the optimizer's moments reset."""
        with torch.no_grad():
            for name, parts in self.state.params.items():
                src = state[name]
                chunks = (src.chunk(len(parts), self._split[name])
                          if name in self._split else (src,))
                for p, c in zip(parts, chunks):
                    p.copy_(c)
        self.optimizer = make_optimizer(self._leaves(self.state.params),
                                        self.learning_rate)
        self.state.opt_state = self.optimizer

    def shard_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the trainer's (lead) device."""
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS}

    def _row_weights(self, devices: tuple[torch.device, ...]):
        """`tensor_parallel_forward`'s weights for a data row on `devices`:
        position p's part (a split weight's slice p, else the whole one)
        copied to `devices[p]`, once a step."""
        params, memo = self.state.params, {}

        def weight(name: str, p: int) -> torch.Tensor:
            key = (name, p)
            if key not in memo:
                parts = params[name]
                memo[key] = parts[p if name in self._split else 0].to(
                    devices[p])
            return memo[key]
        return weight

    def encode_pairs(self, batch: dict[str, torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The pooled anchors and positives of the whole batch on the lead:
        each data row encodes its slice over its model positions, and the
        rows are gathered with differentiable copies."""
        n = batch["anchor_ids"].shape[0]
        bounds = [n * r // len(self.rows) for r in range(len(self.rows) + 1)]
        pooled: dict[str, list[torch.Tensor]] = {"anchor": [],
                                                 "positive": []}
        for r, devices in enumerate(self.rows):
            lo, hi = bounds[r], bounds[r + 1]
            if lo == hi:
                continue
            weight = self._row_weights(devices)
            for side, out in pooled.items():
                ids = batch[f"{side}_ids"][lo:hi].to(devices[0])
                mask = batch[f"{side}_mask"][lo:hi].to(devices[0])
                out.append(tensor_parallel_forward(
                    self.config, weight, devices, ids, mask)[1].to(
                        self.device))
        return torch.cat(pooled["anchor"]), torch.cat(pooled["positive"])

    def loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Bidirectional InfoNCE over the global batch (every row's
        negatives are the whole batch's) on a `shard_batch` batch."""
        return info_nce(*self.encode_pairs(batch))

    def train_step(self, batch: dict) -> float:
        batch = self.shard_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch)
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
