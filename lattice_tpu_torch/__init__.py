"""lattice_tpu_torch: the PyTorch/CUDA port of `lattice_tpu` for NVIDIA Hopper.

The JAX package `lattice_tpu` is the reference and stays as it is; this
package mirrors its module paths (`index/chunk_store.py` <->
`index/chunk_store.py`, ...), with one rename: `ops/pallas_topk.py`
becomes `ops/scan_topk.py`. It imports torch, numpy and the standard
library only. The hand-written CUDA kernels live in `csrc/` and are
compiled for `sm_90a` at first use (`ops/_build.py`).

Ported so far: the vector-search core of the main path
(ChunkStore -> int8 / bf16 / int4 scan kernels -> exact rescore), the IVF
tier, the hash embedding provider, the vector indexer/searcher, the
UniXcoder encoder's serving path (tokenizer -> RoBERTa-base module with
the paired-attention kernel -> provider), and the index side of the host
stack: settings, scan, parse, the graph, chunks, summaries and the C++
host library (`csrc/host/`, built with g++ at first use), driven by
`pipeline.orchestrator.PipelineOrchestrator(repo, embedder,
device="cuda").run()`, and the query side: the planner, graph reasoning,
the hybrid ranker, context, responder and `query.engine.QueryEngine`
(`search_sync`, `query_sync`, `deep_search`), which serves on the device
of the stores it is given, with the ranking fuse of `ops/ranking.py` and
the golden eval (`python -m lattice_tpu_torch.query.golden_eval --device
cuda`), the deep path's device branch, and the CLI (`main.py`: `index`,
`search`, `query`, `status`, `settings`, `projects`, `metadata`,
`watch`, `serve`, `mcp`) over an index persisted in the JAX package's
format (`storage/`), with the provider factory, metadata, projects, the
inotify watcher, the serving deployment (`serving/`: the batching
frontend, its router, the HTTP server; `mcp/`) and the PQ tier
(`ops/pq.py`, the store's "pq" plan).
"""

__version__ = "0.1.0"
