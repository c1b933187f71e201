"""Entry points of the port: a one-device forward and a multi-shard dry run.

The port's counterpart of the repository root's `__graft_entry__.py`.
`entry()` gives the encoder's pooled forward at B=8, L=128 as `(fn,
args)`, at full width unless a caller passes a config.
`dryrun_multichip(n)` runs, over a mesh of `n` logical shards
(`parallel/mesh.py`), what the JAX dry run compiles and runs, step by step:
a training step of a tiny encoder at model_parallel = 2; the dp x tp
forward of the full-width encoder; the sharded index and its quantized
tiers; the sharded hybrid rank and its int8 overlap; the multislice
merges; the sharded BFS against the oracle; and the serving frontend over
the store's sharded plan. The JAX dry run compiles the full-width forward
ahead of time without running it; the port has no AOT compile, so it runs
that forward (B=8, L=64), at `UniXcoderConfig()` by default and at
`config` where a caller (the CPU tests) asks for a small one.
"""

from __future__ import annotations

import numpy as np
import torch


def _require(cond, msg: str) -> None:
    """Raise `AssertionError(msg)` unless `cond` (kept under `python -O`,
    which strips `assert`)."""
    if not cond:
        raise AssertionError(msg)


def random_vectors_(encoder, seed: int = 1) -> None:
    """Draw every bias and LayerNorm parameter of `encoder` (its 1-D
    parameters) from one `torch.Generator(seed)`: biases normal(0, 0.1),
    scales 1 + normal(0, 0.1). The init makes them 0 and 1, as flax's does,
    and a forward compared on those cannot see a bias added once a partial
    or sliced from the wrong columns."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in encoder.named_parameters():
            if p.dim() == 1:
                draw = 0.1 * torch.randn(p.shape, generator=gen)
                p.copy_(draw + (0.0 if name.endswith("bias") else 1.0))


def entry(device: str | torch.device = "cuda", config=None):
    """(fn, example_args): the UniXcoder encoder's pooled forward, B=8,
    L=128, on `device`, at `config` (default `UniXcoderConfig()`, full
    width)."""
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                   UniXcoderModel)

    model = UniXcoderModel(config or UniXcoderConfig(), device=device)
    batch, length = 8, 128
    ids = torch.zeros((batch, length), dtype=torch.int64, device=model.device)
    mask = torch.ones((batch, length), dtype=torch.int64, device=model.device)

    def forward(input_ids, attention_mask):
        return model.encode_device(input_ids, attention_mask)

    return forward, (ids, mask)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     config=None) -> None:
    """Run one sharded training step, the dp x tp encoder forward and every
    sharded search of the port on an `n_devices`-shard mesh on `device`
    (logical shards: several may share one card); `AssertionError` on any
    disagreement. `config`: the dp x tp forward's encoder config
    (default `UniXcoderConfig()`, full width)."""
    from lattice_tpu_torch.models.train import (ContrastiveTrainer,
                                                make_dummy_batch)
    from lattice_tpu_torch.models.unixcoder import UniXcoderConfig
    from lattice_tpu_torch.parallel.mesh import make_mesh
    from lattice_tpu_torch.parallel.sharded_index import ShardedIndex

    def mesh_of(n: int, model_parallel: int = 1):
        return make_mesh(n, model_parallel=model_parallel, device=device)

    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = mesh_of(n_devices, model_parallel)

    # the tiny encoder: the same code path at dry-run shapes
    tiny = UniXcoderConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=128, dtype="float32")
    trainer = ContrastiveTrainer(tiny, mesh=mesh)
    batch = make_dummy_batch(batch_size=2 * max(n_devices, 1), length=16,
                             vocab_size=tiny.vocab_size)
    loss = trainer.train_step(batch)
    _require(np.isfinite(loss), f"non-finite loss {loss}")

    _run_encoder_sharded(mesh, config or UniXcoderConfig())

    # sharded retrieval: corpus rows over every shard, the merge on the lead
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(64 * n_devices, 32)).astype(np.float32)
    valid = np.ones(len(emb), dtype=bool)
    index = ShardedIndex(emb, valid, mesh=mesh_of(n_devices),
                         dtype="float32")
    queries = rng.normal(size=(3, 32))
    scores, idx = index.search(queries, k=5)
    _require(scores.shape == (3, 5) and idx.shape == (3, 5)
             and np.all(idx >= 0) and np.all(idx < len(emb)),
             "sharded search: shape or ids out of range")

    # the quantized tiers: int8 and packed int4 shards, the same merge;
    # int4 with bf16 rows kept beside it for the in-shard exact rescore
    from lattice_tpu_torch.parallel.sharded_index import ShardedQuantizedIndex
    for bits, keep_fp in ((8, False), (4, False), (4, True)):
        qidx = ShardedQuantizedIndex(emb, valid, mesh=mesh_of(n_devices),
                                     bits=bits, keep_full_precision=keep_fp)
        qs, qi = qidx.search(queries, k=5)
        _require(qs.shape == (3, 5) and np.all(qi >= 0)
                 and np.all(qi < len(emb)),
                 f"int{bits} search: shape or ids out of range")
        # the serving entry: queries and results stay on the device
        _, qi_d = qidx.search_device(
            torch.as_tensor(queries, dtype=torch.float32).to(
                qidx.mesh.lead), k=5)
        _require(np.array_equal(qi_d.cpu().numpy(), qi),
                 "device != host route")
        _require(qidx.update_rows(emb[:1], np.array([7])),
                 "update_rows refused a row")
        if keep_fp:
            overlap = np.mean([
                len(set(a.tolist()) & set(b.tolist())) / 5
                for a, b in zip(qi, idx)])
            _require(overlap >= 0.6, f"fp-rescored int4 overlap {overlap}")

    # the sharded hybrid deep rank: rows and rank columns sharded, each
    # query's packed evidence replicated; equal to the one-device rank
    from lattice_tpu_torch.ops.ranking import (FuseWeights,
                                               hybrid_rank_device_packed_batch,
                                               pack_reach, pack_weights)
    from lattice_tpu_torch.parallel.sharded_rank import ShardedHybridRank

    n_r = emb.shape[0]
    degree = rng.integers(0, 60, n_r).astype(np.int32)
    qual = rng.random(n_r).astype(np.float32)
    packed = np.stack([
        pack_reach(rng.choice(n_r, 40, replace=False).astype(np.int64),
                   rng.integers(0, 5, 40), rng.integers(0, 4, 40), 64)
        for _ in range(3)])
    match = np.full((3, 16), -1, np.int32)
    match[:, :4] = rng.choice(n_r, (3, 4))
    rel_t = np.asarray([1.0, 0.9, 0.7, 0.0], np.float32)
    w8 = pack_weights(FuseWeights())
    hview = ShardedHybridRank(emb, valid, degree, qual,
                              mesh=mesh_of(n_devices), dtype="float32")
    hs, hi = hview.rank(queries, packed, rel_t, match, w8, k=5)
    lead = hview.mesh.lead

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(lead)

    ws, wi = hybrid_rank_device_packed_batch(
        put(queries, torch.float32), put(emb, torch.float32),
        put(valid, torch.bool), put(packed, torch.int32),
        put(rel_t, torch.float32), put(match, torch.int32),
        put(degree, torch.int32), put(qual, torch.float32),
        put(w8, torch.float32), 5)
    _require(np.array_equal(hi, wi.cpu().numpy()),
             "sharded rank != one device")
    _require(np.allclose(hs, ws.cpu().numpy(), atol=1e-5),
             "sharded rank scores != one device")
    h8 = ShardedHybridRank(emb, valid, degree, qual,
                           mesh=mesh_of(n_devices), dtype="float32", bits=8)
    _, hi8 = h8.rank(queries, packed, rel_t, match, w8, k=5)
    overlap8 = np.mean([len(set(a.tolist()) & set(b.tolist())) / 5
                        for a, b in zip(hi8, hi)])
    _require(overlap8 >= 0.6, f"int8 deep-rank overlap {overlap8}")

    # multislice: rows over (dcn, data), merged within a slice first
    if n_devices % 2 == 0 and n_devices >= 4:
        from lattice_tpu_torch.parallel.mesh import make_multislice_mesh
        ms_mesh = make_multislice_mesh(2, n_devices, device=device)
        ms_index = ShardedIndex(emb, valid, mesh=ms_mesh, dtype="float32")
        _, ms_idx = ms_index.search(queries, k=5)
        _require(np.array_equal(np.sort(ms_idx, axis=1), np.sort(idx, axis=1)),
                 "multislice merge != single-level merge")
        msq = ShardedQuantizedIndex(emb, valid, mesh=ms_mesh, bits=8)
        sq = ShardedQuantizedIndex(emb, valid, mesh=mesh_of(n_devices),
                                   bits=8)
        _, msq_i = msq.search(queries, k=5)
        _, sq_i = sq.search(queries, k=5)
        _require(np.array_equal(np.sort(msq_i, axis=1), np.sort(sq_i, axis=1)),
                 "quantized multislice merge != single-level merge")

    # the sharded graph walk: edge-partitioned BFS against the host oracle
    from lattice_tpu_torch.ops.graph_kernels import bfs_oracle
    from lattice_tpu_torch.parallel.sharded_graph import ShardedGraph

    n_nodes = 64 * n_devices
    src = rng.integers(1, n_nodes, size=4 * n_nodes).astype(np.int32)
    dst = rng.integers(1, n_nodes, size=4 * n_nodes).astype(np.int32)
    seeds = np.zeros(n_nodes, dtype=bool)
    seeds[[1, 2]] = True
    graph = ShardedGraph(src, dst, n_nodes, mesh=mesh_of(n_devices))
    got = graph.bfs_distances(seeds, max_hops=4)
    want = bfs_oracle(src, dst, seeds, n_nodes, 4)
    _require(np.array_equal(got, want), "sharded BFS != oracle")

    # the serving frontend over the store's sharded plan: coalesced
    # batches take the sharded view, answers equal the flat plan's
    from lattice_tpu_torch.index.chunk_store import ChunkStore
    from lattice_tpu_torch.ops import topk as topk_ops
    from lattice_tpu_torch.parallel.mesh import default_mesh
    from lattice_tpu_torch.serving import BatchingFrontend

    store = ChunkStore(dim=32, dtype="float32", initial_capacity=128,
                       device=mesh.lead)
    rows = topk_ops.l2_normalize(emb[:96])
    store.add(rows, [{"file_path": f"f{i % 4}.py", "content_hash": "h"}
                     for i in range(96)])
    flat = store.search(queries, k=5, method="flat")
    with default_mesh(mesh_of(n_devices)):
        with BatchingFrontend(store, max_batch=8, max_wait_ms=100,
                              method="sharded") as fe:
            futs = [fe.submit(q, k=5)
                    for q in np.asarray(queries, np.float32)]
            served = [f.result(timeout=300) for f in futs]
    for qi, (_, ids) in enumerate(served):
        _require({int(i) for i in ids.tolist()} == {r for r, _, _ in flat[qi]},
                 "sharded serving != flat")


def _run_encoder_sharded(mesh, config) -> None:
    """The encoder at `config` under dp x tp over `mesh` (B=8, L=64, random
    weights from seed 0, the biases and LayerNorms from `random_vectors_`):
    its pooled rows against the unsharded forward's (cosine >= 0.999 a
    row), every row finite."""
    from lattice_tpu_torch.models.unixcoder import UniXcoderModel

    model = UniXcoderModel(config, seed=0, device=mesh.lead)
    random_vectors_(model.encoder)
    batch, length = 8, 64
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(5, config.vocab_size, (batch, length), generator=gen)
    mask = torch.ones((batch, length), dtype=torch.int64)
    mask[1, 40:] = 0
    ids[1, 40:] = config.pad_token_id
    ids, mask = ids.to(model.device), mask.to(model.device)
    whole = model.encode_device(ids, mask)
    model.use_mesh(mesh)
    sharded = model.encode_device(ids, mask)
    _require(sharded.shape == (batch, config.hidden_size),
             f"dp x tp forward: shape {tuple(sharded.shape)}")
    _require(bool(torch.isfinite(sharded).all()), "non-finite sharded rows")
    cos = torch.nn.functional.cosine_similarity(sharded, whole)
    _require(float(cos.min()) >= 0.999,
             f"dp x tp forward: cosine {cos.min()}")
