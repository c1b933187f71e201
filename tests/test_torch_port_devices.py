"""The port's entry points run on the card unless the caller asks for the
CPU: built with no `device` on a machine without CUDA, each one raises
rather than landing quietly on the CPU."""

import pytest
import torch

from lattice_tpu_torch.core.errors import EmbeddingError, VectorStoreError
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.models.unixcoder import UniXcoderConfig, UniXcoderModel
from lattice_tpu_torch.providers import unixcoder_provider as up
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

TINY = UniXcoderConfig(vocab_size=512, hidden_size=128, num_layers=1,
                       num_heads=2, intermediate_size=256,
                       max_position_embeddings=130)

ENTRY_POINTS = {
    "ChunkStore": (lambda: ChunkStore(dim=8), VectorStoreError),
    "VectorIndexer": (lambda: VectorIndexer(Embedder(HashEmbedder(
        dimensions=8))), VectorStoreError),
    "UniXcoderModel": (lambda: UniXcoderModel(TINY), EmbeddingError),
    "_get_model": (lambda: up._get_model(None), EmbeddingError),
    "UniXcoderEmbedder": (lambda: up.UniXcoderEmbedder(), EmbeddingError),
    "UniXcoderEmbeddingProvider": (lambda: up.UniXcoderEmbeddingProvider(),
                                   EmbeddingError),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make, error = ENTRY_POINTS[name]
    with pytest.raises(error, match="CUDA is not available"):
        make()


def test_cpu_is_asked_for_by_name():
    store = ChunkStore(dim=8, device="cpu")
    assert store.device.type == "cpu"
    model = UniXcoderModel(TINY, device="cpu")
    assert next(model.encoder.parameters()).device.type == "cpu"
