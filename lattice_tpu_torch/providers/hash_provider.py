"""Deterministic feature-hashing embedding provider (offline default).

SURVEY §7 step 2 calls for a "hash-based embedding stub" on the minimum
end-to-end slice; this is that component, built as a real lexical embedder
rather than a placeholder: token and character-3-gram features of the code
are feature-hashed (signed) into the embedding space, TF-weighted, and
L2-normalized. Cosine similarity between such vectors is a solid lexical
relevance signal for code search, fully deterministic, and needs no weights
or network — so the whole retrieval stack (index, kernels, ranking, CLI)
exercises end-to-end offline. A copy of `lattice_tpu/providers/hash_provider.py`
(numpy and hashlib only), so both packages embed a text to the same bits.
"""

from __future__ import annotations

import hashlib
import math
import re
from collections import Counter
from typing import Sequence

import numpy as np

from lattice_tpu_torch.providers.base import BaseEmbeddingProvider, ProviderConfig

_PIECES_RE = re.compile(
    r"[A-Z]+(?![a-z])|[A-Z][a-z]+|[a-z]+|[0-9]+|[^\sA-Za-z0-9_]"
)


def _stable_hash(data: str, salt: int) -> int:
    h = hashlib.blake2b(data.encode("utf-8"), digest_size=8,
                        salt=salt.to_bytes(4, "little")).digest()
    return int.from_bytes(h, "little")


class HashEmbedder:
    """Synchronous core; usable directly wherever an `Embedder` is needed."""

    def __init__(self, dimensions: int = 768, ngram: int = 3,
                 ngram_weight: float = 0.5):
        self.dims = dimensions
        self.ngram = ngram
        self.ngram_weight = ngram_weight

    @property
    def dimensions(self) -> int:
        return self.dims

    def _features(self, text: str) -> Counter:
        feats: Counter = Counter()
        pieces = [m.group().lower() for m in _PIECES_RE.finditer(text)]
        for p in pieces:
            feats[f"w:{p}"] += 1.0
        joined = " ".join(pieces)
        n = self.ngram
        for i in range(len(joined) - n + 1):
            feats[f"g:{joined[i:i + n]}"] += self.ngram_weight
        return feats

    def embed(self, text: str) -> list[float]:
        vec = np.zeros(self.dims, dtype=np.float32)
        feats = self._features(text)
        for feat, tf in feats.items():
            h = _stable_hash(feat, 0)
            idx = h % self.dims
            sign = 1.0 if (h >> 32) & 1 else -1.0
            vec[idx] += sign * math.sqrt(tf)
        norm = float(np.linalg.norm(vec))
        if norm > 0:
            vec /= norm
        return vec.tolist()

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        return [self.embed(t) for t in texts]


class HashEmbeddingProvider(BaseEmbeddingProvider):
    """Async provider wrapper over `HashEmbedder` (the seam used by the
    pipeline, analog of `providers/*_provider.py`)."""

    def __init__(self, config: ProviderConfig | None = None):
        config = config or ProviderConfig(name="hash", dimensions=768)
        super().__init__(config)
        self._impl = HashEmbedder(dimensions=config.dimensions)

    async def _embed(self, text: str) -> list[float]:
        return self._impl.embed(text)

    async def _embed_batch(self, texts: list[str]) -> list[list[float]]:
        return self._impl.embed_batch(texts)
