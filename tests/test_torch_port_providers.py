"""The port's HTTP providers and provider factory.

Mirror of `tests/test_http_providers.py` against
`lattice_tpu_torch.providers`: each vendor's wire format through a stub
transport (nothing reaches the network), and the factory's routing. Then
what the port adds or replaces: the factory hands `device` to the
UniXcoder provider (a tiny encoder stands in for the full-width one) and
its default "cuda" raises without CUDA, the hash provider ignores it; the
standard-library retry keeps tenacity's policy (5 attempts, waits 1, 2,
4, 8 s, the last error raised); and both packages' factories give
providers that embed a text to the same bits.
"""

import asyncio

import numpy as np
import pytest
import torch

import lattice_tpu_torch.providers.http_providers as hp
from lattice_tpu_torch.config.settings import AISettings
from lattice_tpu_torch.core.errors import ConfigurationError, EmbeddingError
from lattice_tpu_torch.providers import base
from lattice_tpu_torch.providers.base import ProviderConfig
from lattice_tpu_torch.providers.factory import (get_embedding_provider,
                                                 get_llm_provider)


@pytest.fixture()
def transport(monkeypatch):
    calls = []

    async def fake_apost(url, payload, headers, timeout):
        calls.append({"url": url, "payload": payload, "headers": headers})
        if "embeddings" in url:
            n = len(payload["input"])
            return {"data": [{"index": i, "embedding": [0.1 * i] * 4}
                             for i in reversed(range(n))]}
        if "chat/completions" in url:
            return {"choices": [{"message": {"content": "chat-reply"}}]}
        if "messages" in url:
            return {"content": [{"type": "text", "text": "messages-"},
                                {"type": "text", "text": "reply"}]}
        if "generateContent" in url:
            return {"candidates": [{"content": {"parts": [{"text": "gem"}]}}]}
        if "embedContent" in url:
            return {"embedding": {"values": [0.5] * 4}}
        raise AssertionError(f"unexpected url {url}")

    monkeypatch.setattr(hp, "_apost", fake_apost)
    return calls


class TestOpenAI:
    def test_chat_payload(self, transport):
        p = hp.OpenAILLMProvider(ProviderConfig(name="openai", model="gpt-x",
                                                api_key="sk-test"))
        out = asyncio.run(p.complete(
            [{"role": "user", "content": "hi"}], temperature=0.2))
        assert out == "chat-reply"
        call = transport[0]
        assert call["url"].endswith("/chat/completions")
        assert call["payload"]["model"] == "gpt-x"
        assert call["payload"]["temperature"] == 0.2
        assert call["headers"]["Authorization"] == "Bearer sk-test"

    def test_embeddings_order_restored(self, transport):
        p = hp.OpenAIEmbeddingProvider(ProviderConfig(
            name="openai", model="emb", api_key="k", dimensions=4))
        out = asyncio.run(p.embed_batch(["a", "b", "c"]))
        # the stub answers in reversed index order; sorted back
        assert out == [[0.0] * 4, [0.1] * 4, [0.2] * 4]
        assert transport[0]["payload"]["input"] == ["a", "b", "c"]


class TestAnthropic:
    def test_system_split(self, transport):
        p = hp.AnthropicLLMProvider(ProviderConfig(
            name="anthropic", model="model-x", api_key="ak"))
        out = asyncio.run(p.complete([
            {"role": "system", "content": "be terse"},
            {"role": "user", "content": "hi"},
        ]))
        assert out == "messages-reply"
        payload = transport[0]["payload"]
        assert payload["system"] == "be terse"
        assert all(m["role"] != "system" for m in payload["messages"])
        assert transport[0]["headers"]["x-api-key"] == "ak"
        assert "anthropic-version" in transport[0]["headers"]
        assert payload["max_tokens"] > 0


class TestGoogle:
    def test_contents_conversion(self, transport):
        p = hp.GoogleLLMProvider(ProviderConfig(
            name="google", model="gemini-x", api_key="gk"))
        out = asyncio.run(p.complete([
            {"role": "system", "content": "sys"},
            {"role": "user", "content": "q"},
            {"role": "assistant", "content": "a"},
        ]))
        assert out == "gem"
        payload = transport[0]["payload"]
        roles = [c["role"] for c in payload["contents"]]
        assert roles == ["user", "model"]
        assert payload["systemInstruction"]["parts"][0]["text"] == "sys"
        assert "key=gk" in transport[0]["url"]

    def test_embed_task_type(self, transport):
        p = hp.GoogleEmbeddingProvider(ProviderConfig(
            name="google", model="emb-x", api_key="gk", dimensions=4))
        out = asyncio.run(p.embed("text"))
        assert out == [0.5] * 4
        assert transport[0]["payload"]["taskType"] == "RETRIEVAL_DOCUMENT"


class TestOllama:
    def test_local_base_and_no_auth(self, transport):
        p = hp.OllamaLLMProvider(ProviderConfig(
            name="ollama", model="llama3.2",
            base_url="http://localhost:11434"))
        asyncio.run(p.complete([{"role": "user", "content": "hi"}]))
        assert transport[0]["url"].startswith("http://localhost:11434/v1/")
        assert transport[0]["headers"] == {}


class TestFactoryRouting:
    def test_anthropic_embeddings_rejected(self):
        with pytest.raises(ConfigurationError):
            get_embedding_provider(AISettings(embedding_provider="anthropic"))

    def test_unknown_provider_rejected(self):
        with pytest.raises(ConfigurationError):
            get_llm_provider(AISettings(llm_provider="skynet"))
        with pytest.raises(ConfigurationError):
            get_embedding_provider(AISettings(embedding_provider="skynet"))

    def test_none_llm_provider(self):
        assert get_llm_provider(AISettings(llm_provider="none")) is None

    @pytest.mark.parametrize("name,cls", [
        ("openai", "OpenAILLMProvider"),
        ("anthropic", "AnthropicLLMProvider"),
        ("google", "GoogleLLMProvider"),
        ("ollama", "OllamaLLMProvider"),
    ])
    def test_llm_routing_and_default_models(self, name, cls):
        from lattice_tpu.providers.factory import DEFAULT_LLM_MODELS
        p = get_llm_provider(AISettings(llm_provider=name))
        assert type(p).__name__ == cls
        assert p.config.model == DEFAULT_LLM_MODELS[name]

    @pytest.mark.parametrize("name,cls,dims", [
        ("openai", "OpenAIEmbeddingProvider", 1536),
        ("google", "GoogleEmbeddingProvider", 768),
        ("ollama", "OllamaEmbeddingProvider", 768),
        ("hash", "HashEmbeddingProvider", 768),
    ])
    def test_embedding_routing(self, name, cls, dims):
        p = get_embedding_provider(AISettings(embedding_provider=name,
                                              embedding_dimensions=dims))
        assert type(p).__name__ == cls and p.dimensions == dims


def test_hash_provider_embeds_as_the_jax_factorys():
    from lattice_tpu.config.settings import AISettings as JaxAISettings
    from lattice_tpu.providers.factory import (
        get_embedding_provider as jax_factory)
    texts = ["def drain(queue): pass", "class Retry", ""]
    mine = get_embedding_provider(AISettings(embedding_dimensions=64),
                                  device="cuda")   # ignored by hash
    ref = jax_factory(JaxAISettings(embedding_dimensions=64))
    a = np.asarray(asyncio.run(mine.embed_batch(texts)), np.float32)
    b = np.asarray(asyncio.run(ref.embed_batch(texts)), np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_unixcoder_provider_takes_the_device(monkeypatch):
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                    UniXcoderModel)
    from lattice_tpu_torch.providers import unixcoder_provider as up
    settings = AISettings(embedding_provider="unixcoder")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(EmbeddingError, match="CUDA is not available"):
            get_embedding_provider(settings)
    asked = []
    tiny = UniXcoderModel(UniXcoderConfig(
        vocab_size=512, hidden_size=128, num_layers=1, num_heads=2,
        intermediate_size=256, max_position_embeddings=130), seed=1,
        device="cpu")

    def fake_model(weights_dir, finetune_dir, seed=0, device="cuda"):
        asked.append((weights_dir, finetune_dir, device))
        return tiny
    monkeypatch.setattr(up, "_get_model", fake_model)
    p = get_embedding_provider(settings, finetune_dir="/data/ft",
                               device="cpu")
    assert asked == [(None, "/data/ft", "cpu")]
    assert type(p).__name__ == "UniXcoderEmbeddingProvider"
    vec = p.embed_batch_device(["def f(): pass"])
    assert vec.device.type == "cpu" and vec.shape == (1, 128)


class TestRetry:
    @pytest.fixture()
    def waits(self, monkeypatch):
        slept = []

        async def no_sleep(s):
            slept.append(s)
        monkeypatch.setattr(base.asyncio, "sleep", no_sleep)
        return slept

    def test_retries_then_succeeds(self, waits):
        class Flaky(base.BaseLLMProvider):
            calls = 0

            async def _complete(self, messages, **kwargs):
                Flaky.calls += 1
                if Flaky.calls < 3:
                    raise ConnectionError("transient")
                return "ok"
        p = Flaky(ProviderConfig(name="flaky"))
        assert asyncio.run(p.complete([])) == "ok"
        assert Flaky.calls == 3 and waits == [1.0, 2.0]

    def test_gives_up_after_five_attempts(self, waits):
        class Down(base.BaseEmbeddingProvider):
            calls = 0

            async def _embed(self, text):
                Down.calls += 1
                raise ConnectionError(f"down {Down.calls}")
        p = Down(ProviderConfig(name="down"))
        with pytest.raises(ConnectionError, match="down 5"):
            asyncio.run(p.embed("x"))
        assert Down.calls == 5 and waits == [1.0, 2.0, 4.0, 8.0]
