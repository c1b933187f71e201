"""The port runs with no jax, flax, optax, pydantic, tenacity or
transformers.

The machine with the card has none of them. A subprocess blocks their
import (`sys.modules[name] = None` makes `import name` raise), imports
`lattice_tpu_torch`, indexes and searches a small CPU store through the
hash embedder (every ported plan, and the int4 view in capacity mode) and
through a tiny UniXcoder encoder (tokenizer, paired
attention's plain version, the torch module, the provider), runs the
score probe's plain version, the span tracer and the dissection tool's
bounds (`ops/probe.py`, `utils/`, `tools/`), and checks that no kernel was
launched on the CPU and that asking for "cuda" without CUDA raises.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pydantic", "tenacity",
             "transformers"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import importlib, pkgutil
import torch
import lattice_tpu_torch
for mod in pkgutil.walk_packages(lattice_tpu_torch.__path__,
                                 "lattice_tpu_torch."):
    importlib.import_module(mod.name)
assert not any(m == "lattice_tpu" or m.startswith("lattice_tpu.")
               for m in sys.modules), "the port imported the JAX package"
from lattice_tpu_torch.core.errors import VectorStoreError
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.embeddings.indexer import VectorIndexer, VectorSearcher
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

emb = Embedder(HashEmbedder(dimensions=64))
indexer = VectorIndexer(emb, dtype="bfloat16", device="cpu")
names = ["DeliveryQueue.drain", "parse_config", "HttpClient.send",
         "retry_with_backoff", "TokenBucket.take"]
texts = [f"def {n}(): pass  # {n.lower()}" for n in names]
indexer.code.add(emb.embed_batch(texts), [
    {"file_path": f"src/m{i}.py", "name": n, "content": t,
     "entity_type": "function", "language": "python"}
    for i, (n, t) in enumerate(zip(names, texts))])
searcher = VectorSearcher(indexer)
hits = searcher.search_code("drain the delivery queue", limit=3)
assert len(hits) == 3 and hits[0].name == "DeliveryQueue.drain", hits
assert searcher.search_lexical("drain the delivery queue")[0].name == \
    "DeliveryQueue.drain"
for method in ("flat", "quantized", "pallas", "int4", "refined"):
    indexer.code.search_device(torch.from_numpy(emb.embed_batch(texts)), 2,
                               method=method)
from lattice_tpu_torch.ops.quant import Int4View
view = Int4View.from_packed(indexer.code._int4.values,
                            indexer.code._int4.scales)
s4, i4 = view.search_device(torch.from_numpy(emb.embed_batch(texts)),
                            indexer.code.device_arrays[1], 2,
                            dequant_rescore=True)
assert i4[:, 0].tolist() == list(range(5)), i4
from lattice_tpu_torch.core.errors import EmbeddingError
from lattice_tpu_torch.models.unixcoder import UniXcoderConfig, UniXcoderModel
from lattice_tpu_torch.ops.attention import paired_attention
from lattice_tpu_torch.providers import unixcoder_provider as up
from lattice_tpu_torch.text.tokenizer import CodeTokenizer

ids, mask = CodeTokenizer(vocab_size=512).encode_batch(texts, 64)
assert len({len(r) for r in ids}) == 1 and ids[0][:3] == [1, 5, 2], ids[0]
x = torch.randn(2, 16, 128)
ctx = paired_attention(x, x, x, torch.ones(2, 16, dtype=torch.int32), 0.125)
assert ctx.shape == (2, 16, 128) and bool(torch.isfinite(ctx).all())
try:
    up.UniXcoderEmbedder(device="cuda")
except EmbeddingError:
    pass
else:
    raise AssertionError("a cuda encoder was made without CUDA")
tiny = UniXcoderModel(UniXcoderConfig(
    vocab_size=512, hidden_size=128, num_layers=1, num_heads=2,
    intermediate_size=256, max_position_embeddings=130), seed=1, device="cpu")
up._get_model = lambda *a, **k: tiny
uemb = Embedder(up.UniXcoderEmbedder(batch_size=4, device="cpu"), batch_size=4)
vecs = uemb.embed_with_progress(texts)
assert isinstance(vecs, torch.Tensor) and vecs.shape == (5, 128), vecs.shape
assert bool(torch.isfinite(vecs).all())
uidx = VectorIndexer(uemb, dtype="float32", device="cpu")
uidx.code.add(vecs, [{"file_path": f"src/m{i}.py", "name": n}
                     for i, n in enumerate(names)])
hits = VectorSearcher(uidx).search_code(texts[2], limit=3)
assert hits[0].name == names[2], hits
from lattice_tpu_torch.ops.probe import score_probe
from lattice_tpu_torch.tools import dissect
from lattice_tpu_torch.utils.tracing import get_tracer
with get_tracer().span("probe"):
    p = score_probe(torch.randn(3, 64), torch.randn(300, 64).to(torch.bfloat16),
                    tile=128, mode="pack")
assert p.shape == (3, 256) and get_tracer().report()["probe"]["count"] == 1
assert dissect.probe_bound(1 << 20, 768, 256, 2048, 1536, "bf16")[1] == "bytes"
assert set(_build.launch_counts().values()) == {0}, _build.launch_counts()
assert not torch.cuda.is_available()
try:
    ChunkStore(64, device="cuda")
except VectorStoreError:
    pass
else:
    raise AssertionError("a cuda store was made without CUDA")
try:
    VectorIndexer(emb, device="cuda")
except VectorStoreError:
    pass
else:
    raise AssertionError("a cuda indexer was made without CUDA")
print("PORT-OK")
"""


def test_port_runs_without_jax_pydantic_tenacity():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "lattice_tpu_torch").rglob("*.py")))
def test_no_forbidden_import_in_source(path):
    text = (REPO / path).read_text()
    for name in ("jax", "flax", "optax", "pydantic", "tenacity",
                 "transformers", "lattice_tpu."):
        assert f"import {name}" not in text, (path, name)
        assert f"from {name}" not in text, (path, name)
