"""UniXcoder embedding provider: tokenize on the host, encode on the device.

Port of `lattice_tpu/providers/unixcoder_provider.py`: mode-token framing
`<encoder-only>` with CLS/SEP, max_length 512 with padding, mask-weighted
mean-pool sentence embeddings, a cached model, and batched embedding. The
model lives on one explicit device; "cuda" without CUDA raises. The JAX
provider's mesh sharding and layout pinning are TPU work and are not
ported (multi-GPU embedding is ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import logging
import os
from functools import lru_cache

import numpy as np
import torch

from lattice_tpu_torch.models.unixcoder import UniXcoderConfig, UniXcoderModel
from lattice_tpu_torch.providers.base import (BaseEmbeddingProvider,
                                              ProviderConfig)
from lattice_tpu_torch.text.tokenizer import CodeTokenizer

logger = logging.getLogger(__name__)

EMBEDDING_DIM = 768          # reference `unixcoder_provider.py:229`
MAX_LENGTH = 512             # reference `unixcoder_provider.py:90`


@lru_cache(maxsize=2)
def _get_model(weights_dir: str | None, finetune_dir: str | None = None,
               seed: int = 0, device: str = "cuda") -> UniXcoderModel:
    """One model per (weights, fine-tune, seed, device)."""
    return UniXcoderModel(UniXcoderConfig(), weights_dir=weights_dir,
                          seed=seed, finetune_dir=finetune_dir, device=device)


class UniXcoderEmbedder:
    """Synchronous core satisfying the `Embedder` protocol."""

    def __init__(self, weights_dir: str | None = None,
                 max_length: int = MAX_LENGTH, batch_size: int = 128,
                 finetune_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.model = _get_model(weights_dir, finetune_dir,
                                device=str(torch.device(device)))
        # LATTICE_BF16_SERVE=1: the JAX package's switch to serve from bf16
        # matrix params (opt-in: near-tie orderings can shift)
        if (os.environ.get("LATTICE_BF16_SERVE") == "1"
                and "+bf16serve" not in self.model.weights_fingerprint):
            self.model.enable_bf16_inference()
        self.tokenizer = CodeTokenizer(
            vocab_size=self.model.config.vocab_size, vocab_dir=weights_dir)
        self.max_length = max_length
        self.batch_size = batch_size
        if not self.model.loaded_pretrained:
            logger.info(
                "UniXcoder running with random-init weights (no checkpoint "
                "at %r); use the hash provider for offline retrieval quality",
                weights_dir)

    @property
    def dimensions(self) -> int:
        return self.model.config.hidden_size

    def embed(self, text: str) -> list[float]:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: list[str]) -> list[list[float]]:
        out: list[list[float]] = []
        for start in range(0, len(texts), self.batch_size):
            group = texts[start:start + self.batch_size]
            ids, mask = self.tokenizer.encode_batch(group, self.max_length)
            pooled = self.model.encode(np.asarray(ids), np.asarray(mask))
            out.extend(pooled.astype(np.float32).tolist())
        return out

    def embed_batch_device(self, texts: list[str]) -> torch.Tensor:
        """[B, hidden] f32 pooled embeddings left on the model's device:
        bulk ingestion hands them to `ChunkStore.add` without a host copy."""
        parts = []
        for start in range(0, len(texts), self.batch_size):
            group = texts[start:start + self.batch_size]
            ids, mask = self.tokenizer.encode_batch(group, self.max_length)
            parts.append(self.model.encode_device(np.asarray(ids),
                                                  np.asarray(mask)))
        if not parts:
            return torch.zeros((0, self.dimensions), dtype=torch.float32,
                               device=self.model.device)
        return torch.cat(parts) if len(parts) > 1 else parts[0]


class UniXcoderEmbeddingProvider(BaseEmbeddingProvider):
    """Async provider seam (reference `:229-282`)."""

    def __init__(self, config: ProviderConfig | None = None,
                 weights_dir: str | None = None,
                 finetune_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        config = config or ProviderConfig(name="unixcoder",
                                          dimensions=EMBEDDING_DIM)
        config.dimensions = EMBEDDING_DIM
        super().__init__(config)
        self._impl = UniXcoderEmbedder(weights_dir=weights_dir,
                                       finetune_dir=finetune_dir,
                                       device=device)

    async def _embed(self, text: str) -> list[float]:
        return self._impl.embed(text)

    async def _embed_batch(self, texts: list[str]) -> list[list[float]]:
        return self._impl.embed_batch(texts)

    def embed_batch_device(self, texts: list[str]) -> torch.Tensor:
        """Sync device-resident bulk path (see UniXcoderEmbedder)."""
        return self._impl.embed_batch_device(texts)
