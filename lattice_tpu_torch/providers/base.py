"""Embedding provider base: bounded concurrency.

Port of the embedding half of `lattice_tpu/providers/base.py`
(`ProviderConfig`, `BaseEmbeddingProvider`). The JAX package wraps each
call in a tenacity retry for network providers; the only provider ported
so far is the hash provider, which computes locally and never fails, so
the port carries no retry and no tenacity. The LLM base comes with the
host stack.
"""

from __future__ import annotations

import abc
import asyncio
import os
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass
class ProviderConfig:
    """Reference: `providers/base.py:21-64`."""

    name: str
    model: str | None = None
    api_key: str | None = None
    base_url: str | None = None
    dimensions: int = 768
    max_concurrent: int = 5
    timeout_s: float = 60.0
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_env_prefix(cls, prefix: str, name: str, **overrides: Any) -> "ProviderConfig":
        """Build from `{PREFIX}_API_KEY` / `{PREFIX}_MODEL` / `{PREFIX}_BASE_URL`."""
        def g(suffix: str) -> str | None:
            return os.environ.get(f"{prefix}_{suffix}")
        cfg = cls(
            name=name,
            model=g("MODEL"),
            api_key=g("API_KEY"),
            base_url=g("BASE_URL"),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


class BaseEmbeddingProvider(abc.ABC):
    """Reference: `providers/base.py:138-225`, without the retry."""

    def __init__(self, config: ProviderConfig):
        self.config = config
        self._semaphore = asyncio.Semaphore(config.max_concurrent)

    @property
    def dimensions(self) -> int:
        return self.config.dimensions

    def set_concurrency(self, n: int) -> None:
        self._semaphore = asyncio.Semaphore(max(1, n))

    async def embed(self, text: str) -> list[float]:
        async with self._semaphore:
            return await self._embed(text)

    async def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        async with self._semaphore:
            return await self._embed_batch(list(texts))

    @abc.abstractmethod
    async def _embed(self, text: str) -> list[float]: ...

    async def _embed_batch(self, texts: list[str]) -> list[list[float]]:
        return [await self._embed(t) for t in texts]
