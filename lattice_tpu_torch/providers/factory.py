"""Provider selection (a copy of `lattice_tpu/providers/factory.py`).

`get_llm_provider` / `get_embedding_provider` with per-provider default
models, key/base-url routing, lazy imports; Anthropic embeddings rejected.
The offline default is the hash embedder, which runs on the host;
`unixcoder` selects the torch encoder (`models/unixcoder.py`) on the
`device` it is given (default "cuda", which raises without CUDA). Network
providers exist behind the same factory but require keys + egress.
"""

from __future__ import annotations

import logging

import torch

from lattice_tpu_torch.config.settings import AISettings, get_settings
from lattice_tpu_torch.core.errors import ConfigurationError
from lattice_tpu_torch.providers.base import ProviderConfig

logger = logging.getLogger(__name__)

# Per-provider default models (reference `factory.py:100-125`).
DEFAULT_LLM_MODELS = {
    "openai": "gpt-4o-mini",
    "anthropic": "claude-sonnet-4-20250514",
    "google": "gemini-1.5-flash",
    "ollama": "llama3.2",
}
DEFAULT_EMBED_MODELS = {
    "openai": "text-embedding-3-small",
    "google": "text-embedding-004",
    "ollama": "nomic-embed-text",
    "unixcoder": "microsoft/unixcoder-base",
    "hash": "feature-hash-768",
}
EMBED_DIMS = {"openai": 1536, "google": 768, "ollama": 768,
              "unixcoder": 768, "hash": 768}


def get_embedding_provider(settings: AISettings | None = None,
                           finetune_dir=None,
                           device: str | torch.device = "cuda"):
    """Reference: `factory.py:61-98`.

    `finetune_dir`: project data dir checked for a `lattice train`
    checkpoint (unixcoder only). `device`: where the UniXcoder encoder
    lives; the hash and network providers ignore it."""
    settings = settings or get_settings().ai
    name = (settings.embedding_provider or "hash").lower()
    dims = settings.embedding_dimensions or EMBED_DIMS.get(name, 768)
    config = ProviderConfig(
        name=name,
        model=settings.embedding_model or DEFAULT_EMBED_MODELS.get(name),
        dimensions=dims,
    )
    if name == "hash":
        from lattice_tpu_torch.providers.hash_provider import HashEmbeddingProvider
        return HashEmbeddingProvider(config)
    if name == "unixcoder":
        from lattice_tpu_torch.providers.unixcoder_provider import (
            UniXcoderEmbeddingProvider,
        )
        config.dimensions = 768
        return UniXcoderEmbeddingProvider(
            config, weights_dir=settings.unixcoder_weights,
            finetune_dir=str(finetune_dir) if finetune_dir else None,
            device=device)
    if name == "openai":
        from lattice_tpu_torch.providers.http_providers import OpenAIEmbeddingProvider
        config.api_key = settings.openai_api_key
        return OpenAIEmbeddingProvider(config)
    if name == "google":
        from lattice_tpu_torch.providers.http_providers import GoogleEmbeddingProvider
        config.api_key = settings.google_api_key
        return GoogleEmbeddingProvider(config)
    if name == "ollama":
        from lattice_tpu_torch.providers.http_providers import OllamaEmbeddingProvider
        config.base_url = settings.ollama_base_url
        return OllamaEmbeddingProvider(config)
    if name == "anthropic":
        # Reference explicitly rejects Anthropic embeddings (`factory.py:232-236`).
        raise ConfigurationError("Anthropic does not provide an embeddings API")
    raise ConfigurationError(f"unknown embedding provider: {name}")


def get_llm_provider(settings: AISettings | None = None):
    """Reference: `factory.py:16-59`. Returns None when unset (offline)."""
    settings = settings or get_settings().ai
    name = (settings.llm_provider or "none").lower()
    if name in ("none", ""):
        return None
    config = ProviderConfig(
        name=name,
        model=settings.llm_model or DEFAULT_LLM_MODELS.get(name),
    )
    if name == "openai":
        from lattice_tpu_torch.providers.http_providers import OpenAILLMProvider
        config.api_key = settings.openai_api_key
        return OpenAILLMProvider(config)
    if name == "anthropic":
        from lattice_tpu_torch.providers.http_providers import AnthropicLLMProvider
        config.api_key = settings.anthropic_api_key
        return AnthropicLLMProvider(config)
    if name == "google":
        from lattice_tpu_torch.providers.http_providers import GoogleLLMProvider
        config.api_key = settings.google_api_key
        return GoogleLLMProvider(config)
    if name == "ollama":
        from lattice_tpu_torch.providers.http_providers import OllamaLLMProvider
        config.base_url = settings.ollama_base_url
        return OllamaLLMProvider(config)
    raise ConfigurationError(f"unknown LLM provider: {name}")
