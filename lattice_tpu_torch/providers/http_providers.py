"""HTTP API providers over the Python stdlib (no SDK dependencies); a copy
of `lattice_tpu/providers/http_providers.py`.

Parity targets:
- OpenAI chat + embeddings: reference `providers/openai_provider.py:32-101`
- Anthropic messages (system split from messages): `anthropic_provider.py:86-108`
- Google Gemini chat + embed_content: `google_provider.py:91-171`
- Ollama's OpenAI-compatible endpoint: `ollama_provider.py:28-117`

The reference uses the vendor SDKs; none are installed here, so requests are
built directly with `urllib` and executed in a worker thread (keeping the
async provider seam). Retry/backoff/concurrency come from `providers/base`.
"""

from __future__ import annotations

import asyncio
import json
import urllib.error
import urllib.request
from typing import Any, Sequence

from lattice_tpu_torch.core.errors import ConnectionError as LatticeConnectionError
from lattice_tpu_torch.providers.base import (
    BaseEmbeddingProvider,
    BaseLLMProvider,
)


def _post_json(url: str, payload: dict, headers: dict[str, str],
               timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **headers},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as exc:
        body = exc.read().decode("utf-8", errors="replace")[:500]
        raise LatticeConnectionError(
            f"HTTP {exc.code} from {url}: {body}", cause=exc) from exc
    except (urllib.error.URLError, TimeoutError) as exc:
        raise LatticeConnectionError(f"cannot reach {url}", cause=exc) from exc


async def _apost(url: str, payload: dict, headers: dict[str, str],
                 timeout: float) -> dict:
    return await asyncio.to_thread(_post_json, url, payload, headers, timeout)


# ---- OpenAI -------------------------------------------------------------


class OpenAILLMProvider(BaseLLMProvider):
    """Reference: `openai_provider.py:32-62`."""

    def _base(self) -> str:
        return (self.config.base_url or "https://api.openai.com/v1").rstrip("/")

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.config.api_key or ''}"}

    async def _complete(self, messages: Sequence[dict], **kwargs: Any) -> str:
        data = await _apost(
            f"{self._base()}/chat/completions",
            {"model": self.config.model, "messages": list(messages),
             **{k: v for k, v in kwargs.items() if k in
                ("temperature", "max_tokens", "top_p")}},
            self._headers(), self.config.timeout_s)
        return data["choices"][0]["message"]["content"]


class OpenAIEmbeddingProvider(BaseEmbeddingProvider):
    """Reference: `openai_provider.py:80-101`."""

    def _base(self) -> str:
        return (self.config.base_url or "https://api.openai.com/v1").rstrip("/")

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.config.api_key or ''}"}

    async def _embed(self, text: str) -> list[float]:
        return (await self._embed_batch([text]))[0]

    async def _embed_batch(self, texts: list[str]) -> list[list[float]]:
        data = await _apost(
            f"{self._base()}/embeddings",
            {"model": self.config.model, "input": texts},
            self._headers(), self.config.timeout_s)
        rows = sorted(data["data"], key=lambda r: r["index"])
        return [r["embedding"] for r in rows]


# ---- Anthropic ----------------------------------------------------------


class AnthropicLLMProvider(BaseLLMProvider):
    """Reference: `anthropic_provider.py:86-108` (system split + messages)."""

    API_VERSION = "2023-06-01"

    async def _complete(self, messages: Sequence[dict], **kwargs: Any) -> str:
        system_parts = [m["content"] for m in messages if m.get("role") == "system"]
        chat = [m for m in messages if m.get("role") != "system"]
        payload: dict[str, Any] = {
            "model": self.config.model,
            "max_tokens": kwargs.get("max_tokens", 2048),
            "messages": chat,
        }
        if system_parts:
            payload["system"] = "\n\n".join(system_parts)
        if "temperature" in kwargs:
            payload["temperature"] = kwargs["temperature"]
        base = (self.config.base_url or "https://api.anthropic.com").rstrip("/")
        data = await _apost(
            f"{base}/v1/messages", payload,
            {"x-api-key": self.config.api_key or "",
             "anthropic-version": self.API_VERSION},
            self.config.timeout_s)
        return "".join(block.get("text", "") for block in data.get("content", []))


# ---- Google Gemini ------------------------------------------------------


class GoogleLLMProvider(BaseLLMProvider):
    """Reference: `google_provider.py:91-119` (history conversion)."""

    def _base(self) -> str:
        return (self.config.base_url
                or "https://generativelanguage.googleapis.com/v1beta").rstrip("/")

    async def _complete(self, messages: Sequence[dict], **kwargs: Any) -> str:
        contents = []
        system_text = None
        for m in messages:
            role = m.get("role")
            if role == "system":
                system_text = m["content"]
                continue
            contents.append({
                "role": "user" if role == "user" else "model",
                "parts": [{"text": m["content"]}],
            })
        payload: dict[str, Any] = {"contents": contents}
        if system_text:
            payload["systemInstruction"] = {"parts": [{"text": system_text}]}
        url = (f"{self._base()}/models/{self.config.model}:generateContent"
               f"?key={self.config.api_key or ''}")
        data = await _apost(url, payload, {}, self.config.timeout_s)
        return data["candidates"][0]["content"]["parts"][0]["text"]


class GoogleEmbeddingProvider(BaseEmbeddingProvider):
    """Reference: `google_provider.py:146-171` (per-text loop,
    task_type retrieval_document)."""

    def _base(self) -> str:
        return (self.config.base_url
                or "https://generativelanguage.googleapis.com/v1beta").rstrip("/")

    async def _embed(self, text: str) -> list[float]:
        url = (f"{self._base()}/models/{self.config.model}:embedContent"
               f"?key={self.config.api_key or ''}")
        data = await _apost(
            url,
            {"model": f"models/{self.config.model}",
             "content": {"parts": [{"text": text}]},
             "taskType": "RETRIEVAL_DOCUMENT"},
            {}, self.config.timeout_s)
        return data["embedding"]["values"]


# ---- Ollama (OpenAI-compatible local endpoint) --------------------------


class OllamaLLMProvider(OpenAILLMProvider):
    """Reference: `ollama_provider.py:28-58`."""

    def _base(self) -> str:
        return (self.config.base_url or "http://localhost:11434").rstrip("/") + "/v1"

    def _headers(self) -> dict[str, str]:
        return {}


class OllamaEmbeddingProvider(OpenAIEmbeddingProvider):
    """Reference: `ollama_provider.py:112-117`."""

    def _base(self) -> str:
        return (self.config.base_url or "http://localhost:11434").rstrip("/") + "/v1"

    def _headers(self) -> dict[str, str]:
        return {}
