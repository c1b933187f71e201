"""Embedder facade over the provider factory.

Parity target: reference `src/lattice/embeddings/embedder.py:48-73`
(`embed`, `embed_batch`, `embed_with_progress` batching with callback).
Adds a synchronous path because the device index is synchronous; async
providers are bridged when used. Port of `lattice_tpu/embeddings/embedder.py`.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Sequence

import numpy as np


class Embedder:
    def __init__(self, provider, batch_size: int = 64):
        """`provider` is anything with embed/embed_batch (sync or async)."""
        self.provider = provider
        self.batch_size = batch_size

    @property
    def dimensions(self) -> int:
        return self.provider.dimensions

    def _call(self, fn, *args):
        result = fn(*args)
        if asyncio.iscoroutine(result):
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                return asyncio.run(result)
            raise RuntimeError(
                "sync Embedder called with async provider inside a running "
                "event loop; use embed_async instead")
        return result

    def embed(self, text: str) -> np.ndarray:
        return np.asarray(self._call(self.provider.embed, text), dtype=np.float32)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), dtype=np.float32)
        return np.asarray(self._call(self.provider.embed_batch, list(texts)),
                          dtype=np.float32)

    def embed_with_progress(
        self, texts: Sequence[str],
        callback: Callable[[int, int], None] | None = None,
    ):
        """Batched embedding with a progress callback.

        Reference: `embeddings/embedder.py:48-70`. When the provider
        exposes `embed_batch_device` (an on-device encoder), the result
        is a device tensor that `ChunkStore.add` consumes without a host
        round trip.
        """
        device_fn = getattr(self.provider, "embed_batch_device", None)
        out: list = []
        total = len(texts)
        for start in range(0, total, self.batch_size):
            batch = texts[start:start + self.batch_size]
            if device_fn is not None:
                out.append(device_fn(list(batch)))
            else:
                out.append(self.embed_batch(batch))
            if callback is not None:
                callback(min(start + self.batch_size, total), total)
        if not out:
            return np.zeros((0, self.dimensions), dtype=np.float32)
        if device_fn is not None:
            import torch
            return torch.cat(out) if len(out) > 1 else out[0]
        return np.concatenate(out, axis=0)

    async def embed_async(self, text: str) -> np.ndarray:
        result = self.provider.embed(text)
        if asyncio.iscoroutine(result):
            result = await result
        return np.asarray(result, dtype=np.float32)

    async def embed_batch_async(self, texts: Sequence[str]) -> np.ndarray:
        result = self.provider.embed_batch(list(texts))
        if asyncio.iscoroutine(result):
            result = await result
        return np.asarray(result, dtype=np.float32)
