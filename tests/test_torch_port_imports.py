"""The port runs with no jax, flax, optax, pydantic, tenacity, rich or
transformers.

The machine with the card has none of them. A subprocess blocks their
import (`sys.modules[name] = None` makes `import name` raise), imports
`lattice_tpu_torch`, indexes and searches a small CPU store through the
hash embedder (every ported plan, the int4 view in capacity mode, and the
sharded plan and graph of `parallel/` on four logical shards) and
through a tiny UniXcoder encoder (tokenizer, paired
attention's plain version, the torch module, the provider), takes a
training step and validates a checkpoint of that encoder (the parity
check skipped for want of `transformers`), runs the dry run of
`graft_entry.py` on four logical shards and its `entry()`, runs the
score probe's plain version, the span tracer and the dissection tool's
bounds (`ops/probe.py`, `utils/`, `tools/`), checks that no kernel was
launched on the CPU and that asking for "cuda" without CUDA raises, then
indexes a three-file repository through the port's `PipelineOrchestrator`
on the CPU (the host stack: settings, scan, parse, graph, chunk, embed)
and asks it questions through the port's `QueryEngine` (`search_sync`,
`query_sync`, `deep_search`), then through the deep path's device branch
(forced: `deep_search`, `deep_search_batch`) and the graph store's device
traversal (`k_hop(device=True)`), with no kernel launched on the CPU;
then through the CLI (`lattice_tpu_torch.main`, every module of the port
imported): `--device cpu index` of that repository (metadata on), a
persisted index that `search --json` and `status` load, and `index`
without `--device` refused for want of CUDA.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pydantic", "tenacity",
             "transformers", "rich"):
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
# parallel/: the store's sharded plan at every tier, the sharded graph and
# deep rank, on four logical shards on the CPU
import os
import numpy as np
from lattice_tpu_torch.parallel.mesh import default_mesh, make_mesh
from lattice_tpu_torch.parallel.sharded_graph import ShardedGraph
with default_mesh(make_mesh(4, device="cpu")) as mesh:
    for bits in ("16", "8", "4"):
        os.environ["LATTICE_SHARDED_BITS"] = bits
        _, ish = indexer.code.search_device(
            torch.from_numpy(emb.embed_batch(texts)), 2, method="sharded")
        assert ish[:, 0].tolist() == list(range(5)), (bits, ish)
    del os.environ["LATTICE_SHARDED_BITS"]
    assert (indexer.code._sharded is not None
            and indexer.code._shardedq.bits == 4)
    assert ShardedGraph(np.array([0, 1]), np.array([1, 2]), 3,
                        mesh=mesh).k_hop([0], 2) == {1: 1, 2: 2}
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
# training: a trainer's step at a tiny width (the einsum path), and
# validate_weights on an HF-named checkpoint of the tiny encoder, whose
# parity check reports the reference's skip without transformers
import tempfile
from pathlib import Path
from lattice_tpu_torch.models.train import ContrastiveTrainer, make_dummy_batch
from lattice_tpu_torch.models.validate_weights import validate_weights
tiny_cfg = tiny.config
trainer = ContrastiveTrainer(tiny_cfg, device="cpu")
assert trainer.train_step(make_dummy_batch(2, 16, 512)) > 0
hf = {"embeddings.word_embeddings.weight": tiny.encoder.word_embeddings.weight,
      "embeddings.position_embeddings.weight":
          tiny.encoder.position_embeddings.weight,
      "embeddings.token_type_embeddings.weight": torch.zeros(10, 128),
      "embeddings.LayerNorm.weight": tiny.encoder.embeddings_norm.weight,
      "embeddings.LayerNorm.bias": tiny.encoder.embeddings_norm.bias}
for ours, theirs in (("attention.query", "attention.self.query"),
                     ("attention.key", "attention.self.key"),
                     ("attention.value", "attention.self.value"),
                     ("attention.output", "attention.output.dense"),
                     ("attention_norm", "attention.output.LayerNorm"),
                     ("intermediate", "intermediate.dense"),
                     ("output", "output.dense"),
                     ("output_norm", "output.LayerNorm")):
    for leaf in ("weight", "bias"):
        hf[f"encoder.layer.0.{theirs}.{leaf}"] = \
            tiny.encoder.state_dict()[f"layers.0.{ours}.{leaf}"]
ckpt = Path(tempfile.mkdtemp())
torch.save({k: v.detach().clone() for k, v in hf.items()},
           ckpt / "pytorch_model.bin")
import json
(ckpt / "config.json").write_text(json.dumps({
    "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 1,
    "num_attention_heads": 2, "intermediate_size": 256,
    "max_position_embeddings": 130}))
report = validate_weights(ckpt, device="cpu")
assert report["ok"], report
assert report["checks"]["torch_parity"]["ok"] is None, report
assert report["checks"]["state_dict"]["config"]["hidden_size"] == 128
# the dry run (graft_entry.py) on four logical CPU shards: the trainer's
# dp x tp step, the tensor-parallel encoder and every sharded search
from lattice_tpu_torch import graft_entry
graft_entry.dryrun_multichip(4, device="cpu", config=tiny_cfg)
fn, args = graft_entry.entry(device="cpu", config=tiny_cfg)
assert fn(*args).shape == (8, 128)
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
# the index side of the main path: a three-file repository through the
# port's orchestrator on the CPU (scan, parse, graph, chunk, embed, store)
import asyncio, tempfile
from pathlib import Path
from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
repo = Path(tempfile.mkdtemp()) / "three"
(repo / "pkg").mkdir(parents=True)
(repo / "pkg" / "base.py").write_text(
    "class Queue:\n    def drain(self):\n        return []\n")
(repo / "pkg" / "jobs.py").write_text(
    "from pkg.base import Queue\n\n\nclass Jobs(Queue):\n"
    "    def run(self):\n        return self.drain()\n")
(repo / "web.ts").write_text(
    "export function send(x: number): number {\n  return x + 1;\n}\n")
settings = Settings()
settings.metadata.enabled = False
orch = PipelineOrchestrator(repo, emb, settings=settings, device="cpu")
pctx = asyncio.run(orch.run())
assert pctx.errors == [] and len(pctx.parsed) == 3, pctx.errors
gstats = pctx.graph_builder.store.stats["edges"]
assert gstats[EdgeType.EXTENDS.value] == 1 and gstats[EdgeType.CALLS.value] >= 1
assert pctx.indexer.stats["files_indexed"] == 3, pctx.indexer.stats
hits = VectorSearcher(pctx.indexer).search_code("drain the queue", limit=3)
assert hits and hits[0].file_path.startswith(("pkg/", "web")), hits
# the query side over those CPU stores
from lattice_tpu_torch.query.engine import QueryEngine
qe = QueryEngine(pctx.graph_builder.store, pctx.indexer)
res = qe.search_sync("who calls drain?")
assert res.query_plan.intent.value == "find_usage" and res.results, res
assert any(r.qualified_name.endswith("Jobs.run") for r in res.results), res
ans = qe.query_sync("what does Jobs extend?")
assert ans.answer and ans.enriched_context is not None, ans
assert ans.query_plan.intent.value == "find_hierarchy", ans.query_plan
deep = qe.deep_search("who calls drain?")
assert deep.results and all(r.score > -1e29 for r in deep.results), deep
# the device branch, forced on these small CPU stores
qe.DEEP_DEVICE_THRESHOLD = 1
fdeep = qe.deep_search("who calls drain?")
assert any(r.qualified_name.endswith("Jobs.run") for r in fdeep.results), fdeep
fbatch = qe.deep_search_batch(["who calls drain?", "what does Jobs extend?"])
assert [r.query for r in fbatch] == ["who calls drain?",
                                     "what does Jobs extend?"]
assert [r.qualified_name for r in fbatch[0].results] == \
    [r.qualified_name for r in fdeep.results]
graph = pctx.graph_builder.store
drain = graph.find_by_name("drain")
assert graph.k_hop(drain, EdgeType.CALLS, 3, reverse=True, device=True) == \
    graph.k_hop(drain, EdgeType.CALLS, 3, reverse=True)
assert set(_build.launch_counts().values()) == {0}, _build.launch_counts()
# the CLI over that repository: index, then search and status from the
# persisted index
import contextlib, io, json
from lattice_tpu_torch import main as cli
cli.PROJECTS_REGISTRY = repo.parent / "registry.json"
env = repo.parent / "cli.env"
env.write_text("EMBEDDING_PROVIDER=hash\nEMBEDDING_DIMENSIONS=64\n")
def lattice(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--env", str(env)] + list(argv))
    return rc, out.getvalue(), err.getvalue()
rc, out, err = lattice("--device", "cpu", "index", str(repo))
assert rc == 0 and "indexed three" in out, (rc, out, err)
assert (repo / ".lattice" / "manifest.json").is_file()
assert (repo / ".lattice" / "metadata.sqlite3").is_file()
rc, out, err = lattice("--device", "cpu", "search", "who calls drain?",
                       "--path", str(repo), "--json")
assert rc == 0, err
assert any(r["name"].endswith("Jobs.run") for r in json.loads(out)), out
rc, out, err = lattice("--device", "cpu", "status", "--path", str(repo))
assert rc == 0 and "bfloat16" in out, (out, err)
rc, out, err = lattice("index", str(repo))
assert rc == 1 and "CUDA" in err, (rc, err)
assert sys.modules["rich"] is None
assert set(_build.launch_counts().values()) == {0}, _build.launch_counts()
assert not any(m == "lattice_tpu" or m.startswith("lattice_tpu.")
               for m in sys.modules), "the port imported the JAX package"
print("PORT-OK")
"""


SERVING_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "pydantic", "tenacity",
             "transformers", "rich", "lattice_tpu"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import asyncio, json, urllib.request
import numpy as np
import torch
from lattice_tpu_torch.index.chunk_store import ChunkStore
from lattice_tpu_torch.mcp.server import MCPServer
from lattice_tpu_torch.mcp.tools import TOOL_SCHEMAS
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops.pq import PQIndex
from lattice_tpu_torch.serving import (BatchingFrontend, FrontendRouter,
                                       ServingHTTPServer)
from lattice_tpu_torch.config.settings import Settings
rng = np.random.default_rng(0)
x = rng.standard_normal((300, 32)).astype(np.float32)
pq = PQIndex.build(x, np.ones(300, bool), m=8, ksub=16, device="cpu")
assert pq.codes.shape == (300, 8) and pq.codes.dtype == torch.uint8
store = ChunkStore(32, dtype="float32", device="cpu")
store.add(x, [{"file_path": f"f{i}.py"} for i in range(300)])
with ServingHTTPServer(store, max_wait_ms=2) as srv:
    host, port = srv.address
    for method in ("auto", "pq", "quantized"):
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/search_vector",
            data=json.dumps({"vector": x[7].tolist(), "k": 3,
                             "method": method}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            hits = json.loads(r.read())["hits"]
        assert hits[0]["row"] == 7, (method, hits)
with BatchingFrontend(store, method="pq") as fe:
    assert fe.search(x[9], 2)[1][0] == 9
server = MCPServer(".", Settings(), device="cpu")
resp = asyncio.run(server.handle_request(
    {"jsonrpc": "2.0", "id": 1, "method": "tools/list"}))
assert resp["result"]["tools"] == TOOL_SCHEMAS
assert set(_build.launch_counts().values()) == {0}, _build.launch_counts()
assert not any(m == "jax" or m.startswith(("jax.", "lattice_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("SERVING-OK")
"""


def test_serving_mcp_and_pq_run_without_jax_or_the_jax_package():
    """`serving/`, `mcp/` and `ops/pq` import and serve with `jax` and
    `lattice_tpu` blocked: a PQ build, HTTP searches through the "auto",
    "pq" and "quantized" plans, a frontend, the MCP tool list; no kernel
    launched on the CPU."""
    proc = subprocess.run([sys.executable, "-c", SERVING_SCRIPT, str(REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVING-OK" in proc.stdout


def test_port_runs_without_jax_pydantic_tenacity():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-OK" in proc.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "lattice_tpu_torch").rglob("*.py")))
def test_no_forbidden_import_in_source(path):
    """No module of the port imports these. One exception, the checkpoint
    validation's parity check, imports `transformers` inside the function,
    where it is there, and reports the reference's skip where it is not
    (`SCRIPT` above runs it with the import blocked)."""
    text = (REPO / path).read_text()
    for name in ("jax", "flax", "optax", "pydantic", "tenacity",
                 "transformers", "lattice_tpu."):
        if (path, name) == ("lattice_tpu_torch/models/validate_weights.py",
                            "transformers"):
            assert "\nimport transformers" not in text
            assert text.count(f"import {name}") == 1
            continue
        assert f"import {name}" not in text, (path, name)
        assert f"from {name}" not in text, (path, name)
