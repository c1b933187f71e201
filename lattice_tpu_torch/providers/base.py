"""Provider base classes: retry + bounded concurrency.

Port of `lattice_tpu/providers/base.py` (`ProviderConfig`,
`BaseLLMProvider`, `BaseEmbeddingProvider`). The JAX package wraps each
call in a tenacity retry; the machine with the card has no tenacity, so
`RETRY` is the same policy in the standard library: 5 attempts, waits of
1, 2, 4 and 8 s between them (exponential from 1 s, capped at 60 s), and
the last attempt's exception raised.
"""

from __future__ import annotations

import abc
import asyncio
import functools
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

RETRY_ATTEMPTS = 5
RETRY_WAIT_MIN_S = 1.0
RETRY_WAIT_MAX_S = 60.0


def RETRY(fn):
    """Retry an async call as tenacity's `retry(stop_after_attempt(5),
    wait_exponential(multiplier=1, min=1, max=60), reraise=True)` does."""
    @functools.wraps(fn)
    async def wrapper(*args: Any, **kwargs: Any):
        for attempt in range(1, RETRY_ATTEMPTS + 1):
            try:
                return await fn(*args, **kwargs)
            except Exception:
                if attempt == RETRY_ATTEMPTS:
                    raise
                await asyncio.sleep(min(max(2.0 ** (attempt - 1),
                                            RETRY_WAIT_MIN_S),
                                        RETRY_WAIT_MAX_S))
    return wrapper


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


class BaseLLMProvider(abc.ABC):
    """Reference: `providers/base.py:67-135`."""

    def __init__(self, config: ProviderConfig):
        self.config = config
        self._semaphore = asyncio.Semaphore(config.max_concurrent)

    def set_concurrency(self, n: int) -> None:
        self._semaphore = asyncio.Semaphore(max(1, n))

    async def complete(self, messages: Sequence[dict], **kwargs: Any) -> str:
        async with self._semaphore:
            return await self._complete_with_retry(messages, **kwargs)

    @RETRY
    async def _complete_with_retry(self, messages: Sequence[dict],
                                   **kwargs: Any) -> str:
        return await self._complete(messages, **kwargs)

    @abc.abstractmethod
    async def _complete(self, messages: Sequence[dict], **kwargs: Any) -> str: ...


class BaseEmbeddingProvider(abc.ABC):
    """Reference: `providers/base.py:138-225`."""

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
            return await self._embed_with_retry(text)

    async def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        async with self._semaphore:
            return await self._embed_batch_with_retry(list(texts))

    @RETRY
    async def _embed_with_retry(self, text: str) -> list[float]:
        return await self._embed(text)

    @RETRY
    async def _embed_batch_with_retry(self, texts: list[str]) -> list[list[float]]:
        return await self._embed_batch(texts)

    @abc.abstractmethod
    async def _embed(self, text: str) -> list[float]: ...

    async def _embed_batch(self, texts: list[str]) -> list[list[float]]:
        return [await self._embed(t) for t in texts]
