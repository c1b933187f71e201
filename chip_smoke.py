"""Drive the port's main paths (vector search, the encoder, indexing a
repository, answering questions about it, the CLI over a persisted index,
serving it over HTTP and MCP, fine-tuning the encoder, the sharded paths
over logical shards) once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. Device: require CUDA; print the card and its power limit; build the
   kernels of `lattice_tpu_torch/csrc/` and print the build time, and the
   registers and local memory per thread (`cuobjdump`) of kernel D's
   three wmma and three wgmma instances, of kernels A's and C's two wgmma
   instances each (no local memory allowed on any wgmma instance of A, C
   and D) and of their probes' four each and the int4 probe's two.
2. Kernels against their plain versions on the card, at N in {4099,
   1048576}, B in {1, 16, 256}, k in {1, 10, 64}, with masked rows.
   bf16 (kernel A + B) on A's wgmma route at the sweep of C's below (N in
   {4099, 1048576}, d in {256, 768, 1024}, B in {1, 63, ..., 300}, k1 in
   {1, 16, 33, 64, 128}), on its wmma route at d = 100 and with
   misaligned queries or rows, and on `bf16_cases` (ties across tile and
   chunk edges, invalid chunks, fewer live rows than k1) at B in {1, 130}:
   ids agree on >= 99.9% of each sweep's slots, every slot whose id
   differs a rounding tie (within 1e-5), scores within 1e-4; on the ties,
   ids equal and tied rows ranked by the lower id.
   int8 (kernel C + B): first-stage ids identical, scores bit-equal; the
   same on C's wgmma route at N in {4099, 1048576}, d in {256, 768,
   1024}, B in {1, 63, 64, 65, 127, 128, 129, 256, 300}, k1 in {1, 16,
   33, 64, 128} (both instances), on its wmma route at d = 100 and with
   misaligned queries or rows, and on `int8_cases` (ties across tile and
   chunk edges, invalid chunks, fewer live rows than k1) at B in {1, 130}.
   int4 (kernel D + B) at the `Int4View` widths (k1 = max(k, 16) and
   max(8k, 32): up to 512) and at d = 100: ids identical, scores
   bit-equal; kernel B alone on D's lists, bit-equal; the same on D's
   wgmma route at N in {4099, 1048576}, d in {256, 320, 768, 1024} (320:
   a partial last packed slab), B in {1, 63, ..., 300}, k1 in {1, 16, 24,
   32, 33, 80, 128} (both instances, serial and batched), on its wmma
   route at d = 100 and with misaligned queries or packed rows; and on
   `selection_cases` (the CPU tests' adversarial inputs of D's selection:
   ties across tile and chunk edges, scores rising and falling with the
   row id, whole chunks invalid, fewer live rows than k1) at 20,000 rows,
   B in {1, 70}, k1 in SELECTION_K1 (1 ... 512, both instances of D);
   k1 = 513 refused.
   `fused_topk` (A + B at k), `refined_topk` (A + B at 16 + rescore) and
   `fused_topk_int8` (C + B at k) against their plain chains.
   bf16 (kernel A + B): first-stage ids agree on >= 99.9% of slots and
   scores within 1e-4; after the rescore, final ids agree on >= 99.9% of
   slots, every mismatch within 1e-4 of rescored score. Kernel B alone: ids and
   scores identical to its plain version. `ivf_probe` + B against
   `ivf_search_batch`'s probe step, on buckets of S=1000 slots with -1
   holes and a filter mask: C in {7, 1024}, d in {100, 768}, bf16 and f32
   buckets, B in {1, 16, 256}, nprobe in {1, 8, C}, k in {1, 10, 64}; ids
   agree on >= 99.9% of slots, scores within 1e-4, no -1 among live
   results, and nprobe = C equal to the exact scan at storage precision.
   `paired_attention` at B in {1, 128}, L in {64, 128, 256, 512}, H=12,
   bf16 and f32, unit-normal q/k/v, sm_scale 0.125, mask lengths drawn
   from [1, L] and (B=128) one row fully masked: max abs error <= 1e-2
   (bf16) / 1e-4 (f32), all finite; moving the masked keys and values by
   +-100 changes no row with a live key by more than 1e-6; two calls on
   the same input bit-identical. The same at ragged (B, L, H) in {(3, 8,
   2), (3, 100, 2), (5, 333, 4)}, and at L in {100, 333, 512}, B in {1,
   5, 128}, H=12 on masks that are not prefixes: every key live, the first
   64 or 128 keys masked, Bernoulli(0.5) holes, one live key at L - 1.
   On the three column slices of one [B, L, 3 x 768] tensor (a fused
   QKV projection's output, row stride 3W, no copy) at (B, L) in {(128,
   512), (5, 333), (1, 64)}: bit-equal to the kernel on contiguous
   copies, and within the same bars of the plain version.
   Kernel B on `merge_cases` (the CPU tests' adversarial lists: ties,
   NEG_INF rows, pads past the live candidates, m = k1, k1 = 512, equal
   and signed-zero scores; and, split over blocks, pads, 600,000
   candidates with negative ids, B=200): ids equal and scores bit-equal
   to its plain version on CPU copies; k1 = 513 refused.
   `score_probe` at every type and mode on 64 queries x 262,144 rows (+ a
   ragged tail of 100) x 768 at tiles 2048 and 8192, 300 x 65,636 x 1024
   and 130 x 20,000 x 320 at tile 2048 (each type at kernel A's, C's and
   D's instances for k1 = 16 and 80), and 16 x 4,133 x 100 at tile 256
   (the wmma routes): int8 and int4 bit-equal,
   bf16 rawmax within 1e-4, bf16 pack within one score step of the key and
   equal on >= 99.9% of bins.
3a. The flat-tier path: 1,048,576 x 768 rows around 1024 centers at
   spread 0.35 (`bench.py`'s headline corpus, near-isotropic: the noise
   norm is ~9.7x the center's), from a seed, through `VectorIndexer` ->
   `ChunkStore.add` (batches of 65,536, with payloads). The first text
   query (B=1, the first batch the plan sees) builds the IVF partition,
   which measures its recall under `IVF_MIN_RECALL` and is left hollow
   while the plan serves "quantized". Then `search_device` at B=256, k=10,
   planned "quantized" (kernel C) and forced "pallas" (kernel A), each
   with recall@10 >= 0.99 against an exact f32 scan; text queries, a file
   filter, `delete_file` and `lexical_candidates`.
4a. Timings on that store (information only), CUDA events after warm-up:
   `search_device` QPS at B=256 and p50 latency at B=1 for "quantized"
   and "pallas"; each scan kernel beside its plain version, its bound and
   the bare PyTorch product at B in {1, 256}; kernel C's wmma route on the
   same inputs.
3d. The int4 tier on the same store: with `LATTICE_INT4=1` the auto plan
   serves "int4" (kernel D + B at 8k = 80 candidates + exact rescore) at
   B=1 and B=256 with recall@10 >= 0.98 against the exact f32 scan; a
   forced "refined" (kernel A + B at 16 + rescore) >= 0.99; a file filter
   through "int4"; `add` after the view exists updates it in place
   (`_int4_dirty` stays False) and the new rows are found.
4d. Timings: "int4" and "refined" QPS at B=256 and p50 at B=1; kernel D
   at B in {1, 256} beside its plain version, its bound and the bare int8
   product; kernel D (and C) at B in {256, 1} by list length, k1 in {16,
   32, 80, 128, 512}, beside the int4 floor (its probe at that B and at
   D's instance for that k1) and the selection share; D on rows whose
   scores rise with the row id (every tile beats every list), timed once.
3f. The dissection path on the same store, its int8 and int4 views and
   the 256 queries (`lattice_tpu_torch/tools/dissect.py`): `score_probe`
   at every (type, mode, tile) the round-2 scripts timed, each held to its
   plain version as in phase 2 on the same inputs; kernels A, C and
   D at k1 in {16, 80} beside their floors (the selection share is scan ms
   minus probe ms over scan ms; C's over the probe at the instance it
   ran); the library product of each type; `binned_topk`, and kernel C at
   k1 = 16 beside the int8 probe, at B in {1, 8, 32, 64, 128, 256}; one
   device-trace summary (torch.profiler) each of a "quantized", an "int4"
   and a forced "refined" `search_device` call.
3i. The deep path on the same store (BASELINE configs 4 and 5), after
   3f: a graph of its ~1M distinct `graph_node_id`s with 10,000,000
   power-law CALLS edges and an EXTENDS forest over 10% of the nodes,
   drawn by seed as `bench.py:234-257` draws them; the edges, degrees and
   liveness on the card; the store's rank columns. `QueryEngine.
   deep_search` on 16 questions ("who calls X?", "what does X call?", a
   free-text search) takes its device branch (kernel B's positional entry
   selects over the fused [Q, N] rows) and equals, bit for bit, the same
   calls with the selection forced to `stable_topk` on the same evidence;
   `deep_search_batch` at Q=16 and Q=130 (two chunks of 128; the 16
   questions and 114 free-text searches) equals the sequential calls
   (names in order but for near-tie swaps within 1e-6, scores within
   1e-5, equal sources); `k_hop(device=True)` and `k_hop_batch(device=
   True)` at Q=64, 5 hops, limit 50 (and unbounded at 3 hops, Q=8) equal
   the host walk's (depth, id) prefix; after `delete_file` of a first
   result's file the rank columns are rebuilt and none of its rows comes
   back. After the launch counts are read: kernel B against
   `stable_topk` on the same fused rows (Q in {1, 16, 128}, k in {10, 50,
   512}) and on the negated BFS distance rows (Q=64, k in {50, 512}): ids
   equal, scores bit-equal. Timings (information only): graph build,
   finalize, device upload and rank-column build; `deep_search` p50 and
   its parts (evidence: seeds, walks, row expansion, lexical; pack and
   upload; cosine; fuse and select); `deep_search_batch` ms a query at
   Q=16, 128 and 130; host and device `k_hop` p50 and `k_hop_batch` at
   Q=64; kernel B at m = 1,048,576 beside `torch.topk` and `torch.sort`.
3n. The sharded paths (cell K), after 3i with its store and graph still
   resident, over four logical shards on the card (`make_mesh(4)`; one
   shard a card where there are more; the mesh is printed): (a)
   `store.to_sharded(mesh)` (262,144 rows a shard) at B=256 and B=1, k=10:
   kernel A + B a shard and kernel B's merge equal one A + B over the
   whole store (scores within 1e-5; an id that differs is a live row whose
   exact score ties within 1e-5), recall@10
   >= 0.99 against the exact f32 scan, and kernel B's merge of the
   shards' lists bit-equal to its plain version; (b)
   `to_sharded_quantized` at bits 8 and 4 (kernel C at k1=40, kernel D's
   batched instance at k1=80, a rescore a shard): recall@10 >= 0.99 and
   0.98 against an exact f32 scan of the view's own dequantized rows (the
   capacity mode's rescore), and, with `keep_full_precision=True`, against
   the exact f32 scan of the store; then the store's "sharded" plan (the
   stores' one mesh, `default_mesh`, LATTICE_SHARDED=1) at
   LATTICE_SHARDED_BITS 16, 8 and 4: recall@10 >= 0.99, 0.99 and 0.98, a
   file filter's search within the file's rows, and an `add` and a
   `remove` that the live view takes in place and the next search sees;
   (c) `sharded_hybrid` at Q=1 and 16 on 3i's evidence equal to the
   single-device rank (scores within 1e-5; an id that differs is a live
   row whose fused score ties within 1e-5), and
   `deep_search` through the engine's sharded branch ranking as its
   unsharded branch (3h's rule) on 4 questions; (d)
   `GraphStore.to_sharded(CALLS)` over the 10,000,000 edges: `k_hop` at
   1-3 hops, forward and reverse, from 8 of 3i's seed sets, equal to the
   host walk; (e) a 2 x 2 multislice view bit-equal to the flat merge;
   (f) `UniXcoderModel.use_mesh` at `UniXcoderConfig()` (seed 0), B=128,
   L=512: every pooled cosine >= 0.999 against the unsplit forward.
   Timings (information only): each view and the store's sharded plan at
   B=256 and B=1 beside the store's single-device plan, the merge's share
   of a bf16 view call, view build seconds and GB, the sharded walk and
   the split encoder beside their unsharded counterparts. The store and
   the graph are freed after it.
3b. The IVF path, after the first store is freed: a second 1,048,576 x 768
   store at spread 0.06 from the same centers (`bench.py`'s clustered
   corpus), with payloads. The first B=1 text query builds the IVF
   partition (recall >= 0.9) and the auto plan serves "ivf"; forced "ivf"
   recall@10 at B=256 >= `IVF_MIN_RECALL` against an exact scan; a
   language filter (25% of rows) is served by IVF and a one-file filter
   by the flat tier; `delete_file` + `add` keep the partition fresh.
4b. Timings on that store: the IVF build, S and memory; `search_device`
   through "ivf" and "quantized" at B in {1, 8, 32, 64, 128, 256} (the
   crossover that sets `IVF_SMALL_BATCH`), B=1 p50 of each; `ivf_probe`
   beside its plain version at B in {1, 256}.
3j(c). Corpus B's store, still resident after 4b, through
   `persistence.save_chunks` / `load_chunks` on the card with its IVF
   partition, every row: the reloaded rows bit-equal in the compacted
   order, the partition and its verdict restored without k-means (a
   k-means build raises during the load), "ivf" at B=256 the same ids
   (mapped to the compacted rows) and scores; save and load seconds.
3k. Serving (cell I), corpus B's store still resident after 3j(c): a
   `ServingHTTPServer(store, warmup=True)` on port 0, warm by `/healthz`
   (every pad bucket 1 ... 256 through the auto plan, "ivf"); 64 client
   threads post 8 `/v1/search_vector` requests each (k=10, auto): every
   answer 200 and recall@10 >= `IVF_MIN_RECALL` against an exact scan;
   QPS, batches, mean batch and the frontend's p50 / p99 beside a direct
   `search_device` at B=256; one `/v1/search_vector_batch` of 256. Then
   `build_pq` at full width (m=192, ksub 256, 65,536 training rows, 8
   iterations; seconds, codes, its rescored self-measured recall, and the
   plan `LATTICE_PQ=1` takes). For each forced plan of "quantized", "ivf"
   and "pq": a `/v1/search_vector_batch` of 256 gives the rows of
   `search_device` on the batches the frontend dispatched (read from its
   stats, each padded to its bucket as the frontend pads), and their
   scores rounded as the server rounds; the same 256 through the server's
   router give those ids and bit-equal scores; a query's answer does not
   depend on its partners (the batch reversed, and with every other query
   replaced, bit-equal at B=256); every 8th query alone (B=1, another
   shape, whose reductions may order sums otherwise) gives the same ids,
   and the score bits that differ are printed; recall@10 printed; "pq" at
   B=256 and its B=1 p50. `/v1/stats` reports no error, `/metrics` the corpus.
   After its launch counts are read, kernel B is held to its plain
   versions at "pq"'s shapes: `PQIndex.search_device` at the store's
   k1 = 32 (`lt_merge_positions` on [B, 4096] block rows, the one-block
   route; `lt_merge_candidates` on [B, 64] running lists) at B = 256 and
   1, against the same call with `stable_topk` and
   `merge_candidates_plain` in their place on the same card tensors: ids
   equal, scores bit-equal. The store is freed after it.
3e. The capacity tier at the bench's shape (`bench.py:1071-1157`), after
   the second store is freed: 4,194,304 x 768 rows at spread 0.35 made on
   the card in blocks of 131,072, each scored exactly against the first
   256 of 1,024 queries, quantized to packed int4 and freed; an
   `Int4View.from_packed` of the blocks, under 3 GB allocated with no
   bf16 rows resident; `search_device` at B=1024, k=10, first stage only
   and `dequant_rescore=True`: ids live, distinct and in range, scores
   finite; recall printed (information: int4 at 4,096 rows per center is
   information-bound). Then, with the launch counts read, kernels D + B
   against their plain versions on all 1,024 of these queries at both
   widths the path ran (k1 = 16 and 80): ids identical, scores bit-equal.
   4e. Its QPS in both modes, kernel D at B=1024 and the int4 probe beside
   it (its floor), the probe equal to its plain version on these inputs.
3c. The encoder path, after the capacity view is freed: the UniXcoder
   encoder at `UniXcoderConfig()` (12 x 768, 12 heads, FFN 3072, vocab
   51416), random weights from seed 0, on the card. The corpus is this
   checkout's own code: 32-line windows at a stride of 8 lines over every
   `.py` file outside the directories `.gitignore` lists (~6,000, at
   least 4,096),
   through `Embedder.embed_with_progress` -> `UniXcoderEmbedder.
   embed_batch_device` (batch 128, max_length 512) -> `ChunkStore.add`
   (bf16); one forward a length bucket of a batch's rows, as many as
   the masks give, and `paired_attention` 12 times a forward. The
   first 256 chunks through the kernel path and the einsum path
   (`paired_attention=False`, same weights): every pooled cosine >= 0.999.
   256 chunks drawn by seed, encoded again as queries, through
   `search_device` at B=256, k=10: >= 99% find their own row in their top
   10; recall@10 against an exact f32 scan is printed (information). B=1
   `search_code` calls return hits with payloads.
3g. Indexing through the port, after 3c, with 3c's encoder; the C++ host
   library (`csrc/host/`, `utils/native.py`) must have built and loaded.
   (a) `tests/fixtures/golden_project` through `PipelineOrchestrator`
   (scan, parse, graph, chunk, embed, summarize, metadata: default
   settings, on a scratch copy) with the hash embedder at dim 256, on
   `device="cuda"` and again on "cpu": the same graph (nodes and the edges
   of every type), the same code and summary payloads in row order,
   bit-equal bf16 vectors, no errors, and both runs' metadata in the
   copy's `.lattice/metadata.sqlite3` (versions 1 and 2, completed). The
   104 golden query texts through `search_code` on the card (auto plan
   "quantized": kernels C + B) equal the CPU store's forced "quantized":
   rows in order, scores within 1e-5; the same vectors through a forced
   "pallas" (kernels A + B) against the CPU's under kernel A's bar (ids on
   >= 99.9% of slots, each differing slot a rounding tie within 1e-5).
   (b) A real repository, a copy of this checkout's `lattice_tpu/` (112
   files, ~21,900 lines) under a repository root, through the same
   orchestrator on the card with the UniXcoder provider: files, entities,
   graph, chunks, summaries and each stage's host-clock seconds printed;
   `paired_attention` launches 12 times a forward; 256 chunks drawn by
   seed, encoded again as queries, find their own text in their top 10
   through `search_device` at B=256 (>= 99%); a second run skips every
   file, and after one file is touched only that file is re-indexed.
3h. The query side, after 3g, over 3g's stores, through `QueryEngine`.
   (a) The golden eval (`query/golden_eval.evaluate`, 104 cases through
   `search_sync` or `deep_search`) on engines over 3g(a)'s card and CPU
   indexes. The CPU's, on its auto plan "flat", gives the reference's
   numbers (n 104, mrr 0.9148, hit@5 0.9904, hit@10 1.0, search mrr 0.92,
   deep mrr 0.875, no misses). The card's auto plan is "quantized", whose
   exact rescore scores the f32 query where "flat" scores it rounded to
   bf16 (as in the JAX package), so the card is held to the CPU engine
   with its stores served through "quantized": the same numbers, which
   are the JAX package's on that plan (`GOLDEN_EVAL`: mrr 0.9164, search
   0.9218, deep 0.875, no misses), and each case's top 10 equal in order,
   scores within 1e-5, except two neighbours within 1e-6 that swap
   (printed; one that moves a first hit is printed with both ranks and
   may move the card's numbers by that case alone); kernels C
   and B launch at least once per `search` case (counts and
   `search_summaries` calls printed); `query_sync`'s extractive answer on
   8 cases (4 `search`, 4 `deep`) equals the CPU's character for
   character; the 12 deep cases with `DEEP_DEVICE_THRESHOLD` forced to 1
   on both engines (the device branch) equal, by the same rule, with
   kernel B's positional entry launched for each. (b) An engine over 3g(b)'s index of `lattice_tpu/` (the
   UniXcoder encoder on the card): 8 function or method nodes drawn by
   seed, each with a bare name unique in the graph and >= 8 characters,
   rank in the top 10 of "where is `X` defined?" through `search_sync`; 8
   relation questions built from drawn nodes (3 "who calls", 2 "what does
   X extend", 3 "what methods does X have") through `search_sync`,
   `query_sync` and `deep_search` each return results that name a graph
   node or a payload of the index, with finite, sorted scores;
   `paired_attention` launches 12 times per query embedding; on the
   forced device branch, `deep_search_batch` of the 16 questions equals
   the sequential `deep_search` of each, both on each question's vector
   from one `embed_batch`.
4h. Query timings (information only), after 3h's launch counts are
   read: host-clock p50 of `search_sync`, `query_sync` and `deep_search`
   on the golden engine (the 104 query texts) and on the real
   repository's (its 16 questions), with the p50 of each `phase_times_ms`
   key, beside the card's name and power limit.
3j. The CLI, after 4h: `lattice_tpu_torch.main` on a copy of the golden
   fixture (hash embedder at dim 256 from an env file, the default bf16
   store, no `--device`: the card), each command a `python3 -c` process
   of its own that prints its kernel launches on its last line (added to
   this path's): `index` (metadata on, no file errors, the manifest's
   dtype "bfloat16"), `search --json` on 4 golden questions, `search
   --deep --json` on 2 of them, one `search --batch-file` of 16, `query`
   on 2, `status`, `projects list`, `projects show`, `metadata show` and
   `settings`. Each process exits 0 and answers as an in-process
   `QueryEngine` over the orchestrator's in-memory stores of a second
   copy: the same names in the same order (within a run of exactly equal
   scores, which both packages order by the process's string hash seed,
   in any order) and equal scores after a JSON round trip; `query` the
   same text (tied lines may be reordered); `status`, `projects`,
   `metadata` (up to the tie order of the diagram's edges) and `settings`
   what the in-process index and settings give. Kernels C and B must
   have launched in the processes. Each process's wall time beside the
   same call in-process, and `save_index` / `load_index` seconds.
3l. Serving the CLI's index, after 3j: `python -c main([... "serve",
   "--path", <3j's persisted copy of the fixture>, "--port", "0"])` with no
   `--device` (the card) as a process, its address read from its first
   line of output (start-up seconds). `/v1/search` (4 golden texts) and
   `/v1/search_batch` (16) give the rows of `search_device` on the same
   embedded texts in this process over the same index, loaded by the
   CLI's `_load_engine`, with scores rounded as the server rounds;
   `/v1/query` (4; its answer text too), `/v1/deep_search` (4) and
   `/v1/deep_search_batch` (16) give that engine's results (scores in
   order, each run of equal scores the same items); `/healthz`,
   `/v1/stats` (no error) and `/metrics`; SIGTERM ends it with exit 0.
   Then `... "mcp"` as a process over stdio: initialize, tools/list and
   tools/call of `semantic_search`, `query_code_graph`, `get_code_snippet`
   and `deep_search_batch`, each equal to an in-process `MCPServer` over
   the same index on the card (by the same rule; phase timings aside).
   Kernels C and B must have launched in those processes; their launches
   count with this path's.
   (b) `FileWatcher` (inotify) over the second copy's stores on the card:
   one file changed, one created, one deleted; after `process_events` the
   live graph (nodes, and the distinct edges of every type), the code
   store's payloads and bf16 rows equal a fresh index of the mutated tree
   (edges that repeat a pair are printed: the watch re-adds EXTENDS,
   IMPORTS and DEFINES_METHOD edges, as the JAX package's does), and the
   104 golden questions through `search_sync` (near-tie swaps as in 3h)
   and `search_code` answer alike.
3m. Training (cell J), after 3l, over 3g(b)'s stores (a copy of
   `lattice_tpu/`): (a) `ContrastiveTrainer` at `UniXcoderConfig()` from
   seed 0 on the card and on the CPU, 3 steps on the first 3 batches of
   `mine_pairs` + `PairBatcher` (batch 16, max_length 64): every loss
   within 1e-2 relative, every parameter within 3 x steps x lr, and no
   `paired_attention` launch (the trainer runs the einsum path); (b)
   `finetune_from_index` with the CLI's defaults (100 steps, batch 16,
   max_length 256, lr 2e-5, remat on): the report "completed", no
   `paired_attention` launch; step p50, padded and live tokens/s, the
   tokenizer's share of the loop, peak device memory, the checkpoint's
   write (`np.savez`); `np.savez` and `np.savez_compressed` on one
   layer's arrays; 5 steps with remat on and off on the same batches
   (step p50, peak memory); (c) the checkpoint through `finetune_dir` on
   the card (one forward a length bucket of the rows, 12
   `paired_attention` launches a forward) and on the CPU, 16
   chunks: every pooled cosine >= 0.999; (d) `enable_fused_qkv` at B=128,
   L=512 on this checkout's chunks: cosine >= 0.999 against unfused, 12
   launches a forward, one layer's fused q/k/v slices through the kernel
   bit-equal to the kernel on contiguous copies, chunks/s of unfused,
   fused, fused, unfused; (e) `lattice index` of a golden fixture copy,
   `lattice train --steps 4` over it and `lattice validate-weights` on a
   synthetic full-size checkpoint (HF layout, seed 0) as processes of the
   port's CLI, each exiting 0 with the reference's report (the parity
   check skipped where `transformers` does not import); their launches
   (the f32 entry's among them) count with this path's.
3o. The trainer's mesh and the tensor-parallel encoder (cell L), after
   3m, at `UniXcoderConfig()` (random weights, seed 0) on four logical
   shards of the card: (a) `ContrastiveTrainer` on a dp-4 mesh and on a
   dp-2 x tp-2 mesh, 3 steps each on 3m's batches from the single-device
   trainer's starting weights, against that trainer's steps: losses
   within 1e-2 relative, parameters within 3 x steps x lr, the first
   gradient within GRAD_RTOL of the single device's (relative L2 over
   every weight) while two planted faults, one data row's gradient
   dropped and per-shard losses, land beyond it; no `paired_attention`
   launch; step p50 and peak memory of each; (b) with every bias and
   LayerNorm parameter drawn at random (`graft_entry.random_vectors_`),
   `use_mesh(make_mesh(4, model_parallel=2))` at B=128, L=512 against the
   unsharded forward: every pooled cosine >= 0.999, 48 `paired_attention`
   launches a forward (2 rows x 2 positions x 12 layers, 6 heads a
   position); its time beside the unsharded forward and the dp-only split;
   (c) the flash option (`LATTICE_FLASH_ATTN=1`:
   `scaled_dot_product_attention`) against the einsum path over the live
   rows at B=128, L=512, cosine >= 0.999, and a training step with it
   beside the einsum step on the same weights (loss within 1e-2
   relative); (d) `paired_attention` launches a forward under
   `LATTICE_PAIRED_ATTN=0` / `=1` / `LATTICE_FLASH_ATTN=1`: 0 / 12 / 0;
   (e) `graft_entry.dryrun_multichip(4)`: the dry run's every step on the
   card, its dp x tp forward at full width.
4c. Encoder timings (information only): chunks/s at B=128, L=512 on
   device-resident ids (CUDA events) with the achieved TFLOP/s, the host
   tokenizer per batch, B=1 query encode and `search_code` p50 (host
   clock); a device trace of the encoder (`utils/tracing.py`): busy ms
   per batch, idle share, `paired_attention`'s share, time by kernel
   class; `paired_attention` beside its plain version at B=128, L=512 and
   beside `F.scaled_dot_product_attention` (same additive bias) there on
   the random-length and on an all-live mask, at B=128 for L in {64, 128,
   256} and at B=1, L=64, each with the bound of the key tiles its mask
   needs.
In 4a, 4d, 4b and after 3e, kernel B is held bit-equal to its plain
version on the lists each path gives it (A and C at k1=16, B in {1,
256}; D at k1 in {80, 512}, B in {1, 256}, and a shuffled copy; `ivf_probe`
at k=10; the capacity lists at k1 in {16, 80}, B=1024) and timed beside
`torch.topk` on them by device time (`device_ms`: a sleep kernel keeps
the queue full, so the host's issue is not counted) and back to back.
Launch counts are zeroed just before each of 3a, 3d, 3f, 3i, 3n, 3b, 3k,
3e, 3c, 3g, 3h, 3j, 3l, 3m and 3o and read just after it; each path's
kernels, and every registered kernel, must have launched, and the C
entries each path must have run with them (kernel A's and C's wgmma
routes on corpus A, D's in 3d and 3e, the bf16, int8 and int4 probes' in
3f, kernel B's positional entry in 3k's "pq"; A's, C's and D's wgmma
entries and B's positional entry in 3n; the bf16 attention entry in 3o).

The line before the last is the kernel table as JSON: per kernel its
launches on those paths (and by C entry; "routes": every C entry that
phase 2 or those paths launched, with its count on those paths alone, so a
route the main paths never took reads 0), its largest error
against its plain version, its time, its plain version's time, its bound
(the larger of its bytes over 3.35 TB/s and its operations over the
H100's dense peak for their type, from this run's shapes) and the time
of one PyTorch call computing the same function where one exists. The
last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lattice_tpu_torch.ops.topk import l2_normalize_t as normalize
from lattice_tpu_torch.tools.dissect import (bound, cluster_centers,
                                             cluster_rows, cuda_ms,
                                             scan_bound)

SEED = 0
N_ROWS = 1 << 20
CAP_ROWS = 1 << 22     # the capacity tier: 4,194,304 rows
CAP_BLOCK = 1 << 17    # made, scored and quantized 131,072 rows at a time
CAP_BATCH = 1024
CAP_TRUTH = 256        # queries scored exactly at 4M
CAP_MEMORY = 3e9       # bytes allocated at capacity search time
INT4_RECALL_MIN = 0.98
PROBE_ROWS = 1 << 18   # the probe's check: 262,144 rows (+ a ragged tail)
PROBE_QUERIES = 64
DIM = 768
N_CLUSTERS = 1024
SPREAD = 0.35          # the near-isotropic corpus: IVF must refuse it
IVF_SPREAD = 0.06      # the clustered corpus: IVF serves it
ADD_BATCH = 65_536
ROWS_PER_FILE = 50
K = 10
RECALL_MIN = 0.99
ATTN_LENGTHS = (64, 128, 256, 512)
ATTN_HEADS = 12
SM_SCALE = 0.125
ENC_BATCH = 128
ENC_LEN = 512
WINDOW, STRIDE = 32, 8     # the corpus: 32-line windows every 8 lines
N_PARITY = 256
N_SELF = 256
ENC_QUERIES = ["paired attention kernel for Hopper",
               "parse the vocab and merges files", "exact rescore of the "
               "candidates", "build the kernels with nvcc"]


def log(*args) -> None:
    print(*args, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---- data -------------------------------------------------------------------


_SYL = ("ba", "co", "de", "fi", "gu", "ka", "lo", "mi", "no", "pe", "ra",
        "si", "tu", "ve", "xo", "za")
_WORDS = [a + b for a in _SYL for b in _SYL]          # 256 words
_KINDS = ("function", "method", "class")
_LANGS = ("python", "typescript", "go", "rust")


def payloads(lo: int, hi: int) -> list[dict]:
    """Chunk payloads as the indexer writes them: ~50 chunks per file."""
    out = []
    for r in range(lo, hi):
        f = r // ROWS_PER_FILE
        a, b, c = _WORDS[r % 256], _WORDS[(r // 7) % 256], _WORDS[(r // 3) % 251]
        name = f"{a.title()}{b.title()}.{c}_{_WORDS[f % 256]}"
        start = (r % ROWS_PER_FILE) * 20 + 1
        out.append({
            "file_path": f"src/pkg{f // 100}/mod{f}.py",
            "name": name,
            "graph_node_id": f"pkg{f // 100}.mod{f}.{name}",
            "entity_type": _KINDS[r % 3],
            "language": _LANGS[f % 4],
            "project_name": "smoke",
            "content_hash": f"{f:08x}",
            "start_line": start,
            "end_line": start + 19,
        })
    return out


def exact_topk(q: torch.Tensor, emb: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Exact f32 top-k ids over the stored rows, in row blocks (TF32 off)."""
    from lattice_tpu_torch.ops import topk as topk_ops
    keep = valid.to(torch.bool)

    def block(lo, hi):
        with topk_ops.full_f32():
            s = q.to(torch.float32) @ emb[lo:hi].to(torch.float32).T
        return torch.where(keep[None, lo:hi], s,
                           torch.full_like(s, topk_ops.NEG_INF))

    return topk_ops.blocked_topk(block, emb.shape[0], k)[1]


def recall(got: torch.Tensor, truth: torch.Tensor) -> float:
    hit = (got[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    return hit / truth.numel()


def kernel_row(ms: float, plain_ms: float, bnd: tuple[float, str],
               library_ms: float | None, product_ms: float | None = None
               ) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms,
            "product_ms": product_ms}


# ---- phases -----------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    from lattice_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path()}, {lib._name})")
    log_scan_resources()
    return name, smi


def log_scan_resources() -> None:
    """Registers, stack and local memory (spills) per thread, as `cuobjdump
    --dump-resource-usage` reads them from the built library, of kernel D's
    three wmma instances (serial: 64 queries a block, lists <= 16; batched:
    64 queries, lists <= 128; 32 queries, <= 512) and its three wgmma
    instances (128 queries, serial; 64 queries, serial and batched), the
    two wgmma instances (128 and 64 queries a block) of kernels A and C,
    and the four of each of their probes (the same two, rawmax and pack)
    and two of the int4 probe's. The wgmma instances of A, C and D and the
    int4 probe's must use no local memory."""
    from lattice_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lines = subprocess.run(
        [str(tool), "--dump-resource-usage", str(_build.library_path())],
        capture_output=True, text=True, check=True, timeout=120
    ).stdout.splitlines()
    found = {"D": 0, "A": 0, "C": 0, "D (wgmma)": 0, "bf16 probe": 0,
             "int8 probe": 0, "int4 probe": 0}

    def no_local(usage: str, what: str, regs: str) -> None:
        require(re.search(r"LOCAL:0\b", usage) is not None,
                f"{what} uses local memory: {regs}")

    for name, usage in zip(lines, lines[1:]):
        regs = " ".join(usage.split()[:5])
        if inst := re.search(r"scan_topk_int4_wg_kernelILi(\d+)ELb(\d)E",
                             name):
            found["D (wgmma)"] += 1
            what = (f"kernel D (wgmma), {inst[1]} queries a block, "
                    f"{'batched' if inst[2] == '1' else 'serial'}")
            log(f"{what}: {regs}")
            no_local(usage, what, regs)
        elif inst := (re.search(r"scan_topk_int4_kernelILi(\d+)ELi(\d+)E",
                                name)
                      or re.search(r"scan_topk_kernelILi3ELi(\d+)ELi(\d+)E",
                                   name)):
            found["D"] += 1
            kind = ("batched, lists <= " + inst[2] if "int4" in name
                    else "serial")
            log(f"kernel D (wmma), {kind}, {inst[1]} queries a block: {regs}")
        elif inst := re.search(r"scan_topk_(bf16|int8)_wg_kernelILi(\d+)E",
                               name):
            kernel = "A" if inst[1] == "bf16" else "C"
            found[kernel] += 1
            log(f"kernel {kernel} (wgmma), {inst[2]} queries a block: {regs}")
            no_local(usage, f"kernel {kernel} ({inst[2]} queries)", regs)
        elif inst := re.search(
                r"score_probe_(bf16|int8)_wg_kernelILi(\d+)ELb(\d)E", name):
            found[f"{inst[1]} probe"] += 1
            log(f"{inst[1]} probe (wgmma), {inst[2]} queries a block, "
                f"{'pack' if inst[3] == '1' else 'rawmax'}: {regs}")
        elif inst := re.search(r"score_probe_int4_wg_kernelILi(\d+)E", name):
            found["int4 probe"] += 1
            what = f"int4 probe (wgmma), {inst[1]} queries a block"
            log(f"{what}: {regs}")
            no_local(usage, what, regs)
    require(found == {"D": 3, "A": 2, "C": 2, "D (wgmma)": 3,
                      "bf16 probe": 4, "int8 probe": 4, "int4 probe": 2},
            f"cuobjdump shows these instances: {found}")


def phase_kernels(err: dict) -> None:
    from lattice_tpu_torch.core.errors import KernelError
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for n in (4099, N_ROWS):
        emb = normalize(torch.randn(n, DIM, device="cuda", generator=gen))
        emb_bf16 = emb.to(torch.bfloat16)
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        ev, es = quant.quantize_rows_device(emb_bf16)
        ep, eps = quant.quantize_rows_int4_device(emb_bf16)
        del emb
        for b in (1, 16, 256):
            q = normalize(torch.randn(b, DIM, device="cuda", generator=gen))
            qv, qs = quant.quantize_rows_device(q)
            for k in (1, 10, 64):
                # kernel C + B: exact integer dot, identical selection
                k1 = scan.int8_first_stage_width(k, n)
                check_int8(qv, qs, ev, es, valid, (k1,), err,
                           f"n={n} b={b} k={k}")
                # kernel B alone on kernel C's lists
                cs, ci = scan.scan_blocks_int8(qv, qs, ev, es, valid, k1)
                ms_, mi = scan.merge_candidates(cs, ci, k1)
                torch.cuda.synchronize()
                ps_, pi_ = scan.merge_candidates_plain(cs, ci, k1)
                require(torch.equal(mi, pi_) and torch.equal(ms_, ps_),
                        f"merge differs n={n} b={b} k={k}")
                err["merge_candidates"] = max(err["merge_candidates"],
                                              (ms_ - ps_).abs().max().item())
                # kernel A + B: the first stage against its plain version
                k1 = scan.first_stage_width(k, n)
                ks1, ki1 = scan.scan_topk(q, emb_bf16, valid, k1)
                torch.cuda.synchronize()
                s1, c1 = scan.scan_topk_plain(q, emb_bf16, valid, k1)
                err1 = (ks1 - s1).abs().max().item()
                require((ki1 == c1).float().mean().item() >= 0.999
                        and err1 < 1e-4,
                        f"bf16 first stage: ids agree on "
                        f"{(ki1 == c1).float().mean().item():.4f}, max "
                        f"score error {err1:.3g} n={n} b={b} k={k}")
                err["scan_topk"] = max(err["scan_topk"], err1)
                # kernel A + B + rescore against the plain chain
                fs, fi = scan.binned_topk(q, emb_bf16, valid, k)
                torch.cuda.synchronize()
                ps, pi = scan._exact_rescore(q, emb_bf16, s1, c1, k)
                agree = fi == pi
                require(agree.float().mean().item() >= 0.999,
                        f"bf16 ids agree on {agree.float().mean().item():.4f} "
                        f"n={n} b={b} k={k}")
                require(bool(((fs - ps).abs()[~agree] < 1e-4).all()),
                        f"bf16 mismatch beyond 1e-4 n={n} b={b} k={k}")
                check_int4(qv, qs, ep, eps, valid, k, err, f"n={n} b={b}")
                check_entry_points(q, emb_bf16, qv, qs, ev, es, valid, k,
                                   f"n={n} b={b} k={k}")
                log(f"kernels ok: n={n} b={b} k={k} bf16 agree "
                    f"{agree.float().mean().item():.4f}")
    # the other instances and load paths: f32 rows (FMA), and a width
    # that is no multiple of 16 (scalar tile loads)
    for d, dtype in ((DIM, torch.float32), (100, torch.bfloat16),
                     (100, torch.float32)):
        n, b, k = 4099, 16, 10
        emb = normalize(torch.randn(n, d, device="cuda",
                                    generator=gen)).to(dtype)
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        q = normalize(torch.randn(b, d, device="cuda", generator=gen))
        k1 = scan.first_stage_width(k, n)
        s, i = scan.scan_topk(q, emb, valid, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_plain(q, emb, valid, k1)
        require((i == pi).float().mean().item() >= 0.999
                and (s - ps).abs().max().item() < 1e-4,
                f"scan_topk d={d} {dtype} differs from its plain version")
        ev, es = quant.quantize_rows_device(emb)
        qv, qs = quant.quantize_rows_device(q)
        s, i = scan.scan_topk_int8(qv, qs, ev, es, valid, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_int8_plain(qv, qs, ev, es, valid, k1)
        require(torch.equal(i, pi) and torch.equal(s, ps),
                f"scan_topk_int8 d={d} differs from its plain version")
        log(f"kernels ok: d={d} rows {dtype}")
    # kernel D where d/2 is no multiple of 16 (scalar loads and unpack)
    n, d = 4099, 100
    emb = normalize(torch.randn(n, d, device="cuda", generator=gen))
    valid = torch.rand(n, device="cuda", generator=gen) > 0.1
    ep, eps = quant.quantize_rows_int4_device(emb.to(torch.bfloat16))
    for b in (1, 16, 256):
        qv, qs = quant.quantize_rows_device(
            normalize(torch.randn(b, d, device="cuda", generator=gen)))
        for k in (1, 10, 64):
            check_int4(qv, qs, ep, eps, valid, k, err, f"d={d} b={b}")
    log(f"kernels ok: scan_topk_int4 d={d}")
    for name, *arrays in selection_cases(SEED + 9):
        qv, qs, ep, eps, valid = (torch.from_numpy(a).cuda() for a in arrays)
        for b in (1, qv.shape[0]):
            check_int4(qv[:b].contiguous(), qs[:b].contiguous(), ep, eps,
                       valid, K, err, f"{name} b={b}", SELECTION_K1)
        log(f"kernels ok: scan_topk_int4 on {name} (N={ep.shape[0]}, "
            f"k1 in {SELECTION_K1})")
    try:
        scan.scan_topk_int4(qv, qs, ep, eps, valid, scan.MAX_K1_LONG + 1)
    except KernelError as exc:
        log(f"scan_topk_int4 refuses k1 past MAX_K1_LONG: {exc}")
    else:
        raise AssertionError("scan_topk_int4 took k1 past MAX_K1_LONG")


INT8_BATCHES = (1, 63, 64, 65, 127, 128, 129, 256, 300)
INT8_K1 = (1, 16, 33, 64, 128)     # 1 ... 32: 128 queries a block past B=64
INT8_DIMS = (256, 768, 1024)


def check_int8(qv, qs, ev, es, valid, k1s: tuple[int, ...], err: dict,
               where: str) -> None:
    """Kernels C + B against the plain version at each k1 of `k1s`: ids
    equal and scores bit-equal (exact i32 sums, then the same two f32
    products in the same order)."""
    from lattice_tpu_torch.ops import scan_topk as scan
    for k1 in k1s:
        s, i = scan.scan_topk_int8(qv, qs, ev, es, valid, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_int8_plain(qv, qs, ev, es, valid, k1)
        require(torch.equal(i, pi) and same_bits(s, ps),
                f"scan_topk_int8 differs from its plain version ({where}, "
                f"k1={k1}): ids agree on {(i == pi).float().mean().item():.6f}"
                f", scores on {(s == ps).float().mean().item():.6f}")
        err["scan_topk_int8"] = max(err["scan_topk_int8"],
                                    (s - ps).abs().max().item())


def phase_int8_kernel(err: dict) -> None:
    """Kernel C + B bit-equal to its plain version on its wgmma route at
    n in {4099, 1048576}, d in INT8_DIMS, B in INT8_BATCHES, k1 in INT8_K1
    (both instances: 128 queries a block at B > 64 and k1 <= 32, else 64);
    on its wmma route at d = 100 and with 16-byte misaligned queries or
    rows; and on `int8_cases` (ties across tile and chunk edges, chunks
    entirely invalid, fewer live rows than k1) at B in {1, 130}."""
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for n in (4099, N_ROWS):
        for d in INT8_DIMS:
            ev, es = quant.quantize_rows_device(normalize(torch.randn(
                n, d, device="cuda", generator=gen)))
            valid = torch.rand(n, device="cuda", generator=gen) > 0.1
            for b in INT8_BATCHES:
                qv, qs = quant.quantize_rows_device(normalize(torch.randn(
                    b, d, device="cuda", generator=gen)))
                require(scan.int8_route(qv, ev) == "lt_scan_topk_int8",
                        f"kernel C took its wmma route at d={d}")
                check_int8(qv, qs, ev, es, valid, INT8_K1, err,
                           f"wgmma, n={n} d={d} b={b}")
            log(f"kernels ok: scan_topk_int8 (wgmma) n={n} d={d}, B in "
                f"{INT8_BATCHES}, k1 in {INT8_K1}: bit-equal")
            del ev, es, valid
    n = 4099
    for d, shift in ((100, 0), (DIM, 1), (DIM, 0)):
        ev, es = quant.quantize_rows_device(normalize(torch.randn(
            n, d, device="cuda", generator=gen)))
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        if d == DIM and not shift:  # rows 8 bytes past a 16-byte boundary
            buf = torch.empty(n * d + 16, dtype=torch.int8, device="cuda")
            ev = buf[8:8 + n * d].view(n, d).copy_(ev)
        for b in (1, 65, 256):
            qv, qs = quant.quantize_rows_device(normalize(torch.randn(
                b, d, device="cuda", generator=gen)))
            if shift:  # queries `shift` bytes past a 16-byte boundary
                buf = torch.empty(b * d + 16, dtype=torch.int8, device="cuda")
                qv = buf[shift:shift + b * d].view(b, d).copy_(qv)
            require(scan.int8_route(qv, ev) == "lt_scan_topk_int8_scalar",
                    f"kernel C took its wgmma route at d={d}, shift={shift}")
            check_int8(qv, qs, ev, es, valid, INT8_K1, err,
                       f"wmma route, d={d} b={b} shift={shift}")
        log(f"kernels ok: scan_topk_int8 (wmma route) d={d}"
            f"{' misaligned' if d == DIM else ''}: bit-equal")
    for name, *arrays in int8_cases(SEED + 11):
        qv, qs, ev, es, valid = (torch.from_numpy(a).cuda() for a in arrays)
        for b in (1, qv.shape[0]):
            check_int8(qv[:b].contiguous(), qs[:b].contiguous(), ev, es,
                       valid, INT8_K1, err, f"{name} b={b}")
        log(f"kernels ok: scan_topk_int8 on {name} (N={ev.shape[0]}, "
            f"k1 in {INT8_K1}): bit-equal")


INT4_K1 = (1, 16, 24, 32, 33, 80, 128)   # 1 ... 32: 128 queries past B=64
INT4_DIMS = (256, 320, 768, 1024)        # 320: a partial last packed slab


def phase_int4_kernel(err: dict) -> None:
    """Kernel D + B bit-equal to its plain version on its wgmma route at n
    in {4099, 1048576}, d in INT4_DIMS (d = 320 ends in a partial packed
    slab, whose fill bytes unpack to -8), B in INT8_BATCHES, k1 in INT4_K1
    (both instances: 128 queries a block at B > 64 and k1 <= 32, serial;
    else 64, batched past WG_SERIAL_K1); on its wmma route at d = 100 and
    with 16-byte misaligned queries or packed rows. `selection_cases` and
    the lists past MAX_K1 (the wmma route) are held in phase_kernels."""
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for n in (4099, N_ROWS):
        for d in INT4_DIMS:
            ep, eps = quant.quantize_rows_int4_device(normalize(torch.randn(
                n, d, device="cuda", generator=gen)).to(torch.bfloat16))
            valid = torch.rand(n, device="cuda", generator=gen) > 0.1
            for b in INT8_BATCHES:
                qv, qs = quant.quantize_rows_device(normalize(torch.randn(
                    b, d, device="cuda", generator=gen)))
                require(all(scan.int4_route(qv, ep, k1) == "lt_scan_topk_int4"
                            for k1 in INT4_K1),
                        f"kernel D took its wmma route at d={d}")
                check_int4(qv, qs, ep, eps, valid, K, err,
                           f"wgmma, n={n} d={d} b={b}", INT4_K1)
            log(f"kernels ok: scan_topk_int4 (wgmma) n={n} d={d}, B in "
                f"{INT8_BATCHES}, k1 in {INT4_K1}: bit-equal")
            del ep, eps, valid
    n = 4099
    for d, shift in ((100, 0), (DIM, 1), (DIM, 0)):
        ep, eps = quant.quantize_rows_int4_device(normalize(torch.randn(
            n, d, device="cuda", generator=gen)).to(torch.bfloat16))
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        if d == DIM and not shift:  # rows 8 bytes past a 16-byte boundary
            buf = torch.empty(n * d // 2 + 16, dtype=torch.int8, device="cuda")
            ep = buf[8:8 + n * d // 2].view(n, d // 2).copy_(ep)
        for b in (1, 65, 256):
            qv, qs = quant.quantize_rows_device(normalize(torch.randn(
                b, d, device="cuda", generator=gen)))
            if shift:  # queries `shift` bytes past a 16-byte boundary
                buf = torch.empty(b * d + 16, dtype=torch.int8, device="cuda")
                qv = buf[shift:shift + b * d].view(b, d).copy_(qv)
            require(scan.int4_route(qv, ep, 16) == "lt_scan_topk_int4_scalar",
                    f"kernel D took its wgmma route at d={d}, shift={shift}")
            check_int4(qv, qs, ep, eps, valid, K, err,
                       f"wmma route, d={d} b={b} shift={shift}", INT4_K1)
        log(f"kernels ok: scan_topk_int4 (wmma route) d={d}"
            f"{' misaligned' if d == DIM else ''}: bit-equal")


TIE_TOL = 1e-5     # two f32 sums of the same bf16 products, any order


def check_bf16(q, emb, valid, k1s: tuple[int, ...], err: dict, where: str,
               ties: bool = False) -> tuple[int, int]:
    """Kernels A + B against the plain version at each k1 of `k1s`: scores
    within 1e-4 (bf16 products summed in another order), and every slot
    whose id differs from the plain version's is a rounding tie: its row is
    live, its score is its exact score and the plain version's score at
    that slot within TIE_TOL. Returns (slots whose ids agree, slots), which
    the caller holds to >= 99.9% over its sweep (one swap is 0.2% of a
    list of 1,024). With `ties` (every row live, row r a copy of row
    r % 7), ids equal the plain version's and every run of equal scores
    holds one group's rows from its lowest id up, in steps of 7."""
    from lattice_tpu_torch.ops import scan_topk as scan
    same_ids = slots = 0
    for k1 in k1s:
        s, i = scan.scan_topk(q, emb, valid, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_plain(q, emb, valid, k1)
        e = (s - ps).abs().max().item()
        require(e < 1e-4, f"scan_topk differs from its plain version "
                f"({where}, k1={k1}): max score error {e:.3g}")
        off = i != pi
        if bool(off.any()):
            rows = i[off].long()
            qb = q.to(torch.bfloat16).float()[off.nonzero()[:, 0]]
            exact = (qb * emb[rows].float()).sum(dim=1)
            gap = torch.maximum((exact - s[off]).abs(), (s[off] - ps[off]).abs())
            require(bool(valid[rows].all()) and gap.max().item() <= TIE_TOL,
                    f"scan_topk ({where}, k1={k1}): {int(off.sum())} ids "
                    f"differ from the plain version's, not by rounding "
                    f"(largest gap {gap.max().item():.3g})")
        if ties:
            same = s[:, 1:] == s[:, :-1]
            lowest = torch.where(same, i[:, 1:] == i[:, :-1] + 7,
                                 i[:, 1:] < 7)
            require(torch.equal(i, pi) and bool(lowest.all())
                    and bool((i[:, 0] < 7).all()),
                    f"tied rows not ranked by the lower id ({where}, "
                    f"k1={k1})")
        err["scan_topk"] = max(err["scan_topk"], e)
        same_ids += int((~off).sum())
        slots += off.numel()
    return same_ids, slots


def require_agree(counts: tuple[int, int], where: str) -> None:
    """Ids agree with the plain version's on >= 99.9% of a sweep's slots."""
    require(counts[0] >= 0.999 * counts[1],
            f"scan_topk ids agree with the plain version on "
            f"{counts[0] / counts[1]:.6f} of the slots of {where}")


def phase_bf16_kernel(err: dict) -> None:
    """Kernel A + B against its plain version on its wgmma route at n in
    {4099, 1048576}, d in INT8_DIMS, B in INT8_BATCHES, k1 in INT8_K1
    (both instances: 128 queries a block at B > 64 and k1 <= 32, else 64);
    on its wmma route at d = 100 and with 16-byte misaligned queries or
    rows; and on `bf16_cases` (ties across tile and chunk edges, chunks
    entirely invalid, fewer live rows than k1) at B in {1, 130}, where
    tied rows rank by the lower id."""
    from lattice_tpu_torch.ops import scan_topk as scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for n in (4099, N_ROWS):
        for d in INT8_DIMS:
            emb = normalize(torch.randn(n, d, device="cuda", generator=gen)
                            ).to(torch.bfloat16)
            valid = torch.rand(n, device="cuda", generator=gen) > 0.1
            counts = [0, 0]
            for b in INT8_BATCHES:
                q = normalize(torch.randn(b, d, device="cuda", generator=gen))
                require(scan.bf16_route(q, emb) == "lt_scan_topk_bf16",
                        f"kernel A took its wgmma route at d={d}")
                c = check_bf16(q, emb, valid, INT8_K1, err,
                               f"wgmma, n={n} d={d} b={b}")
                counts = [counts[0] + c[0], counts[1] + c[1]]
            require_agree(counts, f"n={n} d={d}")
            log(f"kernels ok: scan_topk (wgmma) n={n} d={d}, B in "
                f"{INT8_BATCHES}, k1 in {INT8_K1}: ids agree on "
                f"{counts[0] / counts[1]:.6f} of {counts[1]} slots")
            del emb, valid
    n, counts = 4099, [0, 0]
    for d, shift in ((100, 0), (DIM, 1), (DIM, 0)):
        emb = normalize(torch.randn(n, d, device="cuda", generator=gen)
                        ).to(torch.bfloat16)
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        if d == DIM and not shift:  # rows 8 bytes past a 16-byte boundary
            buf = torch.empty(n * d + 8, dtype=torch.bfloat16, device="cuda")
            emb = buf[4:4 + n * d].view(n, d).copy_(emb)
        for b in (1, 65, 256):
            q = normalize(torch.randn(b, d, device="cuda", generator=gen))
            if shift:  # queries 4 bytes past a 16-byte boundary
                buf = torch.empty(b * d + 4, device="cuda")
                q = buf[shift:shift + b * d].view(b, d).copy_(q)
            require(scan.bf16_route(q, emb) == "lt_scan_topk_bf16_scalar",
                    f"kernel A took its wgmma route at d={d}, shift={shift}")
            c = check_bf16(q, emb, valid, INT8_K1, err,
                           f"wmma route, d={d} b={b} shift={shift}")
            counts = [counts[0] + c[0], counts[1] + c[1]]
        log(f"kernels ok: scan_topk (wmma route) d={d}"
            f"{' misaligned' if d == DIM else ''}")
    require_agree(counts, "the wmma route")
    counts = [0, 0]
    for name, *arrays in bf16_cases(SEED + 13):
        q, rows, valid = (torch.from_numpy(a).cuda() for a in arrays)
        emb = rows.to(torch.bfloat16)
        for b in (1, q.shape[0]):
            c = check_bf16(q[:b].contiguous(), emb, valid, INT8_K1, err,
                           f"{name} b={b}", ties=name.startswith("ties"))
            counts = [counts[0] + c[0], counts[1] + c[1]]
        log(f"kernels ok: scan_topk on {name} (N={emb.shape[0]}, k1 in "
            f"{INT8_K1})")
    require_agree(counts, "bf16_cases")


def check_int4(qv, qs, ep, eps, valid, k: int, err: dict, where: str,
               k1s: tuple[int, ...] = ()) -> None:
    """Kernel D + B against its plain version at the widths `Int4View`
    asks for k (the first stage alone, and 8k for a rescore), or at `k1s`:
    ids identical, scores bit-equal; kernel B alone on D's lists."""
    from lattice_tpu_torch.ops import scan_topk as scan
    n = ep.shape[0]
    for k1 in k1s or sorted({scan.first_stage_width(k, n),
                             scan.int4_first_stage_width(k, n)}):
        s, i = scan.scan_topk_int4(qv, qs, ep, eps, valid, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_int4_plain(qv, qs, ep, eps, valid, k1)
        require(torch.equal(i, pi) and torch.equal(s, ps),
                f"int4: ids agree on {(i == pi).float().mean().item():.4f}, "
                f"max score error {(s - ps).abs().max().item():.3g} {where} "
                f"k1={k1}")
        err["scan_topk_int4"] = max(err["scan_topk_int4"],
                                    (s - ps).abs().max().item())
        cs, ci = scan.scan_blocks_int4(qv, qs, ep, eps, valid, k1)
        ms_, mi = scan.merge_candidates(cs, ci, k1)
        torch.cuda.synchronize()
        ps_, pi_ = scan.merge_candidates_plain(cs, ci, k1)
        require(torch.equal(mi, pi_) and torch.equal(ms_, ps_),
                f"merge of int4 lists differs {where} k1={k1}")


def check_entry_points(q, emb, qv, qs, ev, es, valid, k: int,
                       where: str) -> None:
    """`fused_topk`, `refined_topk` and `fused_topk_int8` against their
    plain chains: A's products agree to >= 99.9% of ids and 1e-4 (bf16
    summed in another order), C's bit for bit."""
    from lattice_tpu_torch.ops import scan_topk as scan
    n = emb.shape[0]
    fs, fi = scan.fused_topk(q, emb, valid, k)
    torch.cuda.synchronize()
    ps, pi = scan.scan_topk_plain(q, emb, valid, k)
    require((fi == pi).float().mean().item() >= 0.999
            and (fs - ps).abs().max().item() < 1e-4,
            f"fused_topk differs from its plain chain {where}")
    rs, ri = scan.refined_topk(q, emb, valid, k)
    torch.cuda.synchronize()
    k1 = min(max(k, 16), n)
    s1, c1 = scan.scan_topk_plain(q, emb, valid, k1)
    ps, pi = ((s1, c1) if k1 <= k
              else scan._exact_rescore(q, emb, s1, c1, k))
    agree = ri == pi
    require(agree.float().mean().item() >= 0.999
            and bool(((rs - ps).abs()[~agree] < 1e-4).all()),
            f"refined_topk differs from its plain chain {where}")
    s8, i8 = scan.fused_topk_int8(qv, qs, ev, es, valid, k)
    torch.cuda.synchronize()
    ps, pi = scan.scan_topk_int8_plain(qv, qs, ev, es, valid, k)
    require(torch.equal(i8, pi) and torch.equal(s8, ps),
            f"fused_topk_int8 differs from its plain chain {where}")


def merge_cases(seed: int, large: bool = False
                ) -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """Adversarial inputs of kernel B, (name, scores [B, m] f32, ids [B, m]
    i32, k1), from a seed with numpy: the CPU tests hold the plain version
    to `lax.top_k` on the small ones, the card holds the kernel to the
    plain version on all. `large` adds three shapes only the card runs,
    each split over blocks: pads past the live candidates, a list long
    enough for three passes, and a batch with two blocks a query."""
    rng = np.random.default_rng(seed)
    neg, empty = np.float32(-1e30), np.int32(0x7fffffff)

    def ids(b, m, lo=0):  # distinct ids, in no order
        return np.stack([rng.permutation(m) + lo for _ in range(b)]
                        ).astype(np.int32)

    # 8 lists of 16, each sorted as a scan writes it, few distinct scores
    s = (rng.integers(0, 6, size=(4, 128)) / 8).astype(np.float32)
    i = ids(4, 128, 1000)
    for q in range(4):
        for lo in range(0, 128, 16):
            o = np.lexsort((i[q, lo:lo + 16], -s[q, lo:lo + 16]))
            s[q, lo:lo + 16], i[q, lo:lo + 16] = (s[q, lo + o],
                                                  i[q, lo + o])
    cases = [("ties across sorted lists", s, i, 16)]
    s = rng.normal(size=(3, 200)).astype(np.float32)
    s[:, 50:] = neg
    cases.append(("NEG_INF rows among the winners", s, ids(3, 200), 64))
    s = rng.normal(size=(3, 96)).astype(np.float32)
    i = ids(3, 96)
    s[:, 10:30] = neg
    s[:, 30:], i[:, 30:] = -np.inf, empty
    cases.append(("k1 above the live candidates (pads)", s, i, 80))
    cases.append(("unsorted, m no multiple of k1 or 4",
                  rng.normal(size=(5, 1001)).astype(np.float32),
                  ids(5, 1001), 48))
    cases.append(("m = k1", rng.normal(size=(2, 37)).astype(np.float32),
                  ids(2, 37), 37))
    cases.append(("k1 = 512 with ties",
                  (np.round(rng.normal(size=(2, 5000)) * 64) / 64
                   ).astype(np.float32), ids(2, 5000), 512))
    cases.append(("all scores equal", np.full((2, 3000), 0.25, np.float32),
                  ids(2, 3000), 100))
    s = rng.choice(np.array([-0.0, 0.0, 0.5, -0.5], np.float32),
                   size=(2, 64))
    cases.append(("signed zeros", s, ids(2, 64), 40))
    if large:
        s = rng.normal(size=(1, 20_000)).astype(np.float32)
        i = ids(1, 20_000)
        s[:, 100:200] = neg
        s[:, 200:], i[:, 200:] = -np.inf, empty
        cases.append(("pads through a split", s, i, 300))
        cases.append(("three passes, negative ids",
                      (np.round(rng.normal(size=(1, 600_000)) * 4096) / 4096
                       ).astype(np.float32), ids(1, 600_000, -300_000), 512))
        cases.append(("B=200, two blocks a query",
                      rng.normal(size=(200, 20_000)).astype(np.float32),
                      ids(200, 20_000), 80))
    return cases


SELECTION_K1 = (1, 16, 31, 32, 33, 80, 128, 129, 200, 512)


def selection_cases(seed: int, n: int = 20_000, b: int = 70, d: int = 256
                    ) -> list[tuple]:
    """Adversarial inputs of kernel D's selection, (name, q values [b, d]
    i8, q scales [b] f32, packed rows [n, d/2] i8, row scales [n] f32,
    valid [n] bool), made from a seed with numpy: the CPU tests hold the
    plain version to JAX's `int4_topk` on small ones, the card holds
    kernels D + B to the plain version at every k1 of SELECTION_K1 (both
    instances of D; at these n every block's chunk is a few tiles)."""
    rng = np.random.default_rng(seed)
    qv = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
    qs = rng.uniform(0.5, 1.5, size=b).astype(np.float32) / 127
    ep = rng.integers(-128, 128, size=(n, d // 2)).astype(np.int8)
    es = rng.uniform(0.01, 0.02, size=n).astype(np.float32)
    live = np.ones(n, bool)
    rows = np.arange(n)
    # every row a copy of one of 7 (equal bytes and scales): each score
    # recurs every 7 rows, across every tile and chunk edge
    cases = [("ties across tile and chunk edges", qv, qs, ep[rows % 7],
              es[rows % 7], live)]
    # every dimension +1 (bytes 0x19), queries positive: the score follows
    # the row scale, so each tile beats the list (the gate's worst case)
    ones = np.full((n, d // 2), 0x19, np.int8)
    qpos = np.abs(qv).clip(1).astype(np.int8)
    rise = (0.01 * (1 + rows / n)).astype(np.float32)
    cases.append(("scores rising with row id", qpos, qs, ones, rise, live))
    cases.append(("scores falling with row id", qpos, qs, ones, rise[::-1]
                  .copy(), live))
    # long invalid runs (whole chunks), the tail included
    holes = ~((rows >= n // 8) & (rows < n // 2)) & (rows < n - 700)
    cases.append(("chunks entirely invalid", qv, qs, ep, es, holes))
    few = np.zeros(n, bool)
    few[rng.choice(n, 20, replace=False)] = True
    cases.append(("fewer live rows than k1", qv, qs, ep, es, few))
    return cases


def int8_cases(seed: int, n: int = 20_000, b: int = 130, d: int = 768
               ) -> list[tuple]:
    """Adversarial inputs of kernel C, (name, q values [b, d] i8, q scales
    [b] f32, rows [n, d] i8, row scales [n] f32, valid [n] bool), made from
    a seed with numpy: the CPU tests hold the plain version and the
    emulated chunking to JAX's `int8_topk` on small ones, the card holds
    kernels C + B to the plain version (both instances of C)."""
    rng = np.random.default_rng(seed)
    qv = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
    qs = rng.uniform(0.5, 1.5, size=b).astype(np.float32) / 127
    ev = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    es = rng.uniform(0.5, 1.5, size=n).astype(np.float32) / 127
    live = np.ones(n, bool)
    rows = np.arange(n)
    # every row a copy of one of 7 (equal bytes and scales): each score
    # recurs every 7 rows, across every tile and chunk edge
    cases = [("ties across tile and chunk edges", qv, qs, ev[rows % 7],
              es[rows % 7], live)]
    # long invalid runs (whole chunks), the tail included
    holes = ~((rows >= n // 8) & (rows < n // 2)) & (rows < n - 700)
    cases.append(("chunks entirely invalid", qv, qs, ev, es, holes))
    few = np.zeros(n, bool)
    few[rng.choice(n, 20, replace=False)] = True
    cases.append(("fewer live rows than k1", qv, qs, ev, es, few))
    return cases


def bf16_values(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even), kept as f32: each
    converts to bf16 exactly."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def bf16_cases(seed: int, n: int = 20_000, b: int = 130, d: int = 768
               ) -> list[tuple]:
    """Adversarial inputs of kernel A, (name, queries [b, d] f32 of unit
    norm, rows [n, d] f32 holding bf16 values of unit norm, valid [n]
    bool), made from a seed with numpy: the CPU tests hold the emulated
    chunking to JAX's exact scan and to the Pallas `binned_topk` on small
    ones, the card holds kernels A + B to the plain version (both
    instances of A)."""
    rng = np.random.default_rng(seed)

    def unit(m):
        x = rng.normal(size=(m, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    q, e = unit(b), bf16_values(unit(n))
    live = np.ones(n, bool)
    rows = np.arange(n)
    # every row a copy of one of 7: each score recurs every 7 rows, across
    # every 64-row tile and chunk edge
    cases = [("ties across tile and chunk edges", q, e[rows % 7], live)]
    # long invalid runs (whole chunks), the tail included
    holes = ~((rows >= n // 8) & (rows < n // 2)) & (rows < n - 700)
    cases.append(("chunks entirely invalid", q, e, holes))
    few = np.zeros(n, bool)
    few[rng.choice(n, 20, replace=False)] = True
    cases.append(("fewer live rows than k1", q, e, few))
    return cases


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal f32 tensors bit for bit (-0.0 is not +0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_merge(cs: torch.Tensor, ci: torch.Tensor, k1: int, where: str,
                err: dict, on_cpu: bool = False) -> None:
    """Kernel B against its plain version on the same lists: ids equal,
    scores bit-equal. `on_cpu` takes the plain version on CPU copies (the
    semantics the CPU tests pin, signed zeros included)."""
    from lattice_tpu_torch.ops import scan_topk as scan
    ks, ki = scan.merge_candidates(cs, ci, k1)
    torch.cuda.synchronize()
    ps, pi = (scan.merge_candidates_plain(cs.cpu(), ci.cpu(), k1) if on_cpu
              else scan.merge_candidates_plain(cs, ci, k1))
    ks, ki = ks.cpu(), ki.cpu()
    ps, pi = ps.cpu(), pi.cpu()
    require(torch.equal(ki, pi) and same_bits(ks, ps),
            f"merge_candidates differs from its plain version ({where}, "
            f"B={cs.shape[0]}, m={cs.shape[1]}, k1={k1}): ids agree on "
            f"{(ki == pi).float().mean().item():.6f}")
    finite = torch.isfinite(ps)
    if bool(finite.any()):
        err["merge_candidates"] = max(err["merge_candidates"],
                                      (ks - ps)[finite].abs().max().item())


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn()` in ms with the queue kept full: a sleep
    kernel (~10 ms) holds the card while the host enqueues every call, so
    the host's issue time, which bounds back-to-back timing of a kernel of
    a few microseconds, is not counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def merge_timing(cs: torch.Tensor, ci: torch.Tensor, k1: int, where: str,
                 smi: str) -> dict:
    """Kernel B's device time beside `torch.topk`'s on the same lists, its
    plain version's and its bound (each candidate read once, B x k1
    written); back-to-back time per call (the host's issue included) as
    information."""
    from lattice_tpu_torch.ops import scan_topk as scan
    b, m = cs.shape
    row = kernel_row(
        device_ms(lambda: scan.merge_candidates(cs, ci, k1)),
        device_ms(lambda: scan.merge_candidates_plain(cs, ci, k1), 5),
        bound(b * m * 8 + b * k1 * 8, 0, "f32"),
        device_ms(lambda: torch.topk(cs, k1)))
    per_call = cuda_ms(lambda: scan.merge_candidates(cs, ci, k1), 20)
    topk_call = cuda_ms(lambda: torch.topk(cs, k1), 20)
    log(f"kernel merge_candidates {where} B={b} m={m} k1={k1}: "
        f"{row['ms']:.4f} ms, torch.topk {row['library_ms']:.4f} ms "
        f"({row['ms'] / row['library_ms']:.2f}x), plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}); back to back {per_call:.4f} ms a call, "
        f"torch.topk {topk_call:.4f} ({smi})")
    return row


def phase_merge_kernel(err: dict) -> None:
    """Kernel B on `merge_cases`, the CPU tests' adversarial inputs and two
    larger shapes: bit-equal to its plain version on CPU copies; a k1 it
    cannot take is refused."""
    from lattice_tpu_torch.core.errors import KernelError
    from lattice_tpu_torch.ops import scan_topk as scan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, s, i, k1 in merge_cases(SEED + 7, large=True):
        cs = torch.from_numpy(s).cuda()
        ci = torch.from_numpy(i).cuda()
        check_merge(cs, ci, k1, name, err, on_cpu=True)
        b, m = s.shape
        log(f"kernels ok: merge_candidates {name} (B={b}, m={m}, k1={k1}, "
            f"{scan.merge_splits(b, m, k1, sms)} blocks a query)")
    try:
        scan.merge_candidates(cs, ci, scan.MAX_K1_LONG + 1)
    except KernelError as exc:
        log(f"merge_candidates refuses k1 past MAX_K1_LONG: {exc}")
    else:
        raise AssertionError("merge_candidates took k1 past MAX_K1_LONG")


def attention_mask(b: int, ln: int, kind: str, gen: torch.Generator
                   ) -> torch.Tensor:
    """A [b, ln] int32 key mask: "prefix" (a length drawn from [1, ln] per
    row), "live" (every key), "first64" / "first128" (the first 64 / 128
    keys masked, the rest live), "holes" (each key live with probability
    0.5) or "last" (only key ln - 1 live)."""
    pos = torch.arange(ln, device="cuda")[None, :]
    if kind == "prefix":
        lengths = torch.randint(1, ln + 1, (b,), device="cuda", generator=gen)
        mask = pos < lengths[:, None]
    elif kind == "holes":
        mask = torch.rand((b, ln), device="cuda", generator=gen) < 0.5
    else:
        mask = {"live": pos >= 0, "first64": pos >= 64, "first128": pos >= 128,
                "last": pos == ln - 1}[kind].expand(b, ln)
    return mask.to(torch.int32).contiguous()


ATTN_MASKS = ("live", "first64", "first128", "holes", "last")


def attention_inputs(b: int, ln: int, dtype: torch.dtype,
                     gen: torch.Generator, fully_masked: bool,
                     heads: int = ATTN_HEADS, kind: str = "prefix"):
    """Unit-normal q/k/v [b, ln, heads * 64] and a mask of `kind`
    (`attention_mask`); the last row is fully masked if asked."""
    shape = (b, ln, heads * 64)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    mask = attention_mask(b, ln, kind, gen)
    if fully_masked:
        mask[-1] = 0
    return q, k, v, mask


def check_attention(b: int, ln: int, heads: int, dtype: torch.dtype,
                    tol: float, gen: torch.Generator,
                    kind: str = "prefix") -> float:
    """One `paired_attention` call against its plain version (max abs
    error <= tol, all finite), a second call bit-identical to the first;
    then the masked keys and values move by +-100 and no row with a live
    key may change by more than 1e-6."""
    from lattice_tpu_torch.ops import attention as attn
    q, k, v, mask = attention_inputs(b, ln, dtype, gen, b > 1, heads, kind)
    out = attn.paired_attention(q, k, v, mask, SM_SCALE)
    torch.cuda.synchronize()
    ref = attn.paired_attention_plain(q, k, v, mask, SM_SCALE)
    e = (out - ref).abs().max().item()
    where = f"{dtype} B={b} L={ln} H={heads} mask {kind}"
    require(out.shape == ref.shape and out.dtype == torch.float32
            and bool(torch.isfinite(out).all()),
            f"paired_attention: bad output {where}")
    require(e <= tol, f"paired_attention: max abs error {e:.3g} > {tol} "
            f"{where}")
    require(torch.equal(attn.paired_attention(q, k, v, mask, SM_SCALE), out),
            f"paired_attention: two calls differ {where}")
    dead = mask == 0
    k[dead] += 100.0
    v[dead] -= 100.0
    out2 = attn.paired_attention(q, k, v, mask, SM_SCALE)
    live = mask.sum(1) > 0
    moved = (out2[live] - out[live]).abs().max().item() if live.any() else 0.0
    require(moved <= 1e-6, f"paired_attention: masked keys moved a live "
            f"row by {moved:.3g} {where}")
    require(bool(torch.isfinite(out2).all()),
            f"paired_attention: non-finite after the move {where}")
    return e


def check_fused_slices(b: int, ln: int, dtype: torch.dtype, tol: float,
                       gen: torch.Generator) -> float:
    """`paired_attention` on the three column slices of one [B, L, 3W]
    tensor (the fused QKV projection's layout: row stride 3W, no copy)
    bit-equal to the kernel on contiguous copies, and within `tol` of the
    plain version."""
    from lattice_tpu_torch.ops import attention as attn
    width = ATTN_HEADS * 64
    qkv = torch.randn((b, ln, 3 * width), device="cuda",
                      generator=gen).to(dtype)
    q, k, v = qkv.split(width, dim=-1)
    mask = attention_mask(b, ln, "prefix", gen)
    out = attn.paired_attention(q, k, v, mask, SM_SCALE)
    copies = attn.paired_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), mask, SM_SCALE)
    where = f"{dtype} B={b} L={ln} fused slices"
    require(torch.equal(out, copies), f"paired_attention: strided slices "
            f"differ from contiguous copies {where}")
    e = (out - attn.paired_attention_plain(q, k, v, mask, SM_SCALE)
         ).abs().max().item()
    require(e <= tol, f"paired_attention: max abs error {e:.3g} {where}")
    return e


def phase_attention_kernel(err: dict) -> None:
    """`paired_attention` against its plain version, bf16 and f32, at the
    encoder's widths (H=12, every length bucket), and at ragged lengths
    and fewer heads (partial key and query tiles); then every mask of
    ATTN_MASKS (non-prefix masks: whole key tiles masked ahead of live
    ones, holes, one live key in a partial last tile) at L in {100, 333,
    512}, B in {1, 5, 128}, H=12, the last row fully masked where B > 1."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        for b in (1, 128):
            worst = max(check_attention(b, ln, ATTN_HEADS, dtype, tol, gen)
                        for ln in ATTN_LENGTHS)
            err["paired_attention"] = max(err["paired_attention"], worst)
            log(f"kernels ok: paired_attention {dtype} B={b} L in "
                f"{ATTN_LENGTHS} H={ATTN_HEADS}, max abs error {worst:.3g}")
        ragged = ((3, 8, 2), (3, 100, 2), (5, 333, 4))
        worst = max(check_attention(b, ln, h, dtype, tol, gen)
                    for b, ln, h in ragged)
        err["paired_attention"] = max(err["paired_attention"], worst)
        log(f"kernels ok: paired_attention {dtype} (B, L, H) in {ragged}, "
            f"max abs error {worst:.3g}")
        worst = max(check_fused_slices(b, ln, dtype, tol, gen)
                    for b, ln in ((128, 512), (5, 333), (1, 64)))
        err["paired_attention"] = max(err["paired_attention"], worst)
        log(f"kernels ok: paired_attention {dtype} on the column slices of "
            f"a fused [B, L, 3W] projection (B, L) in ((128, 512), (5, 333), "
            f"(1, 64)), bit-equal to contiguous copies, max abs error "
            f"{worst:.3g}")
        for kind in ATTN_MASKS:
            worst = max(check_attention(b, ln, ATTN_HEADS, dtype, tol, gen,
                                        kind)
                        for b in (1, 5, 128) for ln in (100, 333, 512))
            err["paired_attention"] = max(err["paired_attention"], worst)
            log(f"kernels ok: paired_attention {dtype} mask {kind}, B in "
                f"(1, 5, 128), L in (100, 333, 512), H={ATTN_HEADS}: max abs "
                f"error {worst:.3g}, two calls bit-identical, masked-key "
                f"move <= 1e-6")


def phase_probe_kernel(err: dict) -> None:
    """`score_probe` against its plain version on the card, at every type
    and mode, by `dissect.check_probe`: 64 queries x 262,144 + 100 rows x
    768 at tiles 2048 and 8192 (the 100 tail rows must be dropped), 300
    queries x 65,636 rows x 1024 and 130 x 20,000 x 320 (a partial last
    packed slab) at tile 2048 (query tiles, the last partial; each type at
    kernel A's, C's and D's instances for k1 = 16 and 80), and 16 queries
    x 4,133 rows x 100 at tile 256 (scalar loads, a partial query tile; on
    kernel A's, C's and D's wmma routes).
    int8 and int4 bit-equal (exact integer sums); bf16 rawmax within
    1e-4, as kernel A's scores are held; bf16 pack within one score step of
    the key and equal on >= 99.9% of bins. The dissection path holds the
    probe again at its own shapes (several tiles per block, four query
    blocks), and the capacity timings at 4M x 768, B=1024."""
    from lattice_tpu_torch.ops import probe, quant
    from lattice_tpu_torch.tools.dissect import check_probe
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for b, n, d, tiles in ((PROBE_QUERIES, PROBE_ROWS + 100, DIM,
                            (2048, 8192)), (300, (1 << 16) + 100, 1024,
                                            (2048,)),
                           (130, 20_000, 320, (2048,)),
                           (16, 4133, 100, (256,))):
        emb = normalize(torch.randn(n, d, device="cuda", generator=gen)
                        ).to(torch.bfloat16)
        q = normalize(torch.randn(b, d, device="cuda", generator=gen))
        qv, _ = quant.quantize_rows_device(q)
        cases = (("bf16", q, emb),
                 ("int8", qv, quant.quantize_rows_device(emb)[0]),
                 ("int4", qv, quant.quantize_rows_int4_device(emb)[0]))
        for tile in tiles:
            for kind, qq, rows in cases:
                modes = ("rawmax",) if kind == "int4" else probe.MODES
                k1s = (16, 80) if b > 64 else (16,)
                for mode, k1 in ((m, k) for m in modes for k in k1s):
                    out = probe.score_probe(qq, rows, tile=tile, mode=mode,
                                            k1=k1)
                    torch.cuda.synchronize()
                    ref = probe.score_probe_plain(qq, rows, tile=tile,
                                                  mode=mode)
                    where = (f"{kind} {mode} B={b} N={n} d={d} tile={tile}"
                             + (f" as for k1={k1}" if len(k1s) > 1 else ""))
                    require(out.shape == (b, n // tile * 128),
                            f"score_probe: shape {tuple(out.shape)} {where}")
                    e, same = check_probe(out, ref, kind, mode, tile, where)
                    if mode == "rawmax":
                        err["score_probe"] = max(err["score_probe"], e)
                    log(f"kernels ok: score_probe {where}: max abs error "
                        f"{e:.3g}, {same:.6f} of bins equal")


def repo_chunks() -> tuple[list[str], list[dict]]:
    """The repo's own code as the encoder's corpus: 32-line windows at a
    stride of 8 lines over every `.py` file of the checkout this script
    runs in, outside the directories `.gitignore` lists (build/ among
    them), with payloads."""
    root = Path(__file__).resolve().parent
    ignored = {line.strip().rstrip("/") for line in
               (root / ".gitignore").read_text().splitlines()
               if line.strip().endswith("/")}
    texts, out = [], []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if ignored & set(rel.parts[:-1]):
            continue
        rows = path.read_text(encoding="utf-8", errors="replace").splitlines()
        for lo in range(0, max(len(rows) - WINDOW, 0) + 1, STRIDE):
            texts.append("\n".join(rows[lo:lo + WINDOW]))
            out.append({"file_path": str(rel), "name": f"{rel}:{lo + 1}",
                        "entity_type": "chunk", "language": "python",
                        "start_line": lo + 1,
                        "end_line": min(lo + WINDOW, len(rows))})
    return texts, out


@contextlib.contextmanager
def counted_forwards(model):
    """Counts `model._forward` calls (`seen["forwards"]`) and the groups
    that the masks handed to the host pad path give (`seen["groups"]`: the
    distinct length buckets of the rows' own lengths, the last live token
    + 1, so one a batch of rows in one bucket)."""
    seen = {"forwards": 0, "groups": 0}
    forward, host = model._forward, model._encode_device_host

    def counted(*args):
        seen["forwards"] += 1
        return forward(*args)

    def grouped(ids, mask):
        host_mask = mask.cpu() if isinstance(mask, torch.Tensor) else mask
        live = np.atleast_2d(np.asarray(host_mask)) != 0
        ends = np.where(live.any(1),
                        live.shape[1] - np.argmax(live[:, ::-1], 1), 0)
        seen["groups"] += max(len({model.bucket_length(int(e))
                                   for e in ends}), 1)
        return host(ids, mask)

    model._forward, model._encode_device_host = counted, grouped
    try:
        yield seen
    finally:
        del model._forward, model._encode_device_host


def require_forwards(seen: dict, launched: int, per_forward: int,
                     where: str) -> int:
    """`counted_forwards`' count: one forward a group of the host path's
    masks (one where the device fast path takes the batch whole), and
    `per_forward` `paired_attention` launches each. Returns the forwards."""
    forwards = seen["forwards"]
    require(forwards == (seen["groups"] or 1),
            f"{where}: {forwards} forwards where the masks give "
            f"{seen['groups']} groups")
    require(launched == per_forward * forwards,
            f"{where}: paired_attention launched {launched} times in "
            f"{forwards} forwards, want {per_forward} a forward")
    return forwards


def phase_encoder_path(ctx: dict) -> None:
    """The encoder's serving path at full width: the repo's code through
    `Embedder.embed_with_progress` -> `UniXcoderEmbedder.embed_batch_device`
    -> `ChunkStore.add`; the kernel path against the einsum path; chunks
    retrieving themselves through `search_device` and `search_code`."""
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.embeddings.indexer import (VectorIndexer,
                                                      VectorSearcher)
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                    UniXcoderModel)
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.providers.unixcoder_provider import (
        UniXcoderEmbedder)
    texts, chunk_payloads = repo_chunks()
    n = len(texts)
    require(n >= 4096, f"only {n} chunks of code in the checkout")
    t0 = time.perf_counter()
    provider = UniXcoderEmbedder(batch_size=ENC_BATCH, max_length=ENC_LEN,
                                 device="cuda")
    model = provider.model
    require(model.config == UniXcoderConfig() and model.device.type == "cuda",
            f"encoder config {model.config} on {model.device}")
    log(f"encoder: UniXcoderConfig() ({model.config.num_layers} x "
        f"{model.config.hidden_size}, {model.config.num_heads} heads, FFN "
        f"{model.config.intermediate_size}, vocab {model.config.vocab_size}), "
        f"{sum(p.numel() for p in model.encoder.parameters()) / 1e6:.1f} M "
        f"params, weights {model.weights_fingerprint!r}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    embedder = Embedder(provider, batch_size=ENC_BATCH)
    indexer = VectorIndexer(embedder, dtype="bfloat16", initial_capacity=n,
                            device="cuda")
    store = indexer.code
    before = _build.launch_counts()["paired_attention"]
    with counted_forwards(model) as seen:
        t0 = time.perf_counter()
        vectors = embedder.embed_with_progress(texts)
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
    batches = -(-n // ENC_BATCH)
    launched = _build.launch_counts()["paired_attention"] - before
    # one forward a length bucket of a batch's rows, one launch a layer
    forwards = require_forwards(seen, launched, model.config.num_layers,
                                "embed_with_progress")
    require(batches <= forwards <= len(model.LENGTH_BUCKETS) * batches,
            f"{forwards} forwards for {batches} batches")
    require(isinstance(vectors, torch.Tensor) and vectors.is_cuda
            and vectors.shape == (n, DIM) and vectors.dtype == torch.float32
            and bool(torch.isfinite(vectors).all()),
            f"embed_with_progress gave {type(vectors)} {vectors.shape}")
    rows = store.add(vectors, chunk_payloads)
    torch.cuda.synchronize()
    require(rows == list(range(n)), "add assigned unexpected rows")
    ctx["ingest_chunks_s"] = n / embed_s
    log(f"embedded {n} chunks of this checkout's code (32-line windows, "
        f"stride 8) in {batches} batches of {ENC_BATCH}: {embed_s:.2f} s = "
        f"{n / embed_s:.0f} chunks/s through embed_with_progress (host "
        f"tokenizer included); {forwards} forwards (one a length bucket "
        f"of a batch's rows); paired_attention launches {launched} = "
        f"{model.config.num_layers} x {forwards}; store {store.stats}")

    # the kernel path against the einsum path, same weights and batches
    einsum = UniXcoderModel(dataclasses.replace(model.config,
                                                paired_attention=False),
                            device="cuda")
    einsum.encoder.load_state_dict(model.encoder.state_dict())
    cos = []
    for lo in range(0, N_PARITY, ENC_BATCH):
        ids, mask = provider.tokenizer.encode_batch(texts[lo:lo + ENC_BATCH],
                                                    ENC_LEN)
        a = model.encode_device(ids, mask)
        b = einsum.encode_device(ids, mask)
        cos.append(torch.nn.functional.cosine_similarity(a, b))
    cos = torch.cat(cos)
    del einsum, a, b
    torch.cuda.empty_cache()
    ctx["parity_cos_min"] = cos.min().item()
    log(f"kernel path against einsum path, first {N_PARITY} chunks: pooled "
        f"cosine mean {cos.mean().item():.7f}, min {cos.min().item():.7f}")
    require(cos.min().item() >= 0.999, "the kernel path disagrees with the "
            "einsum path")

    # chunks find themselves
    gen = torch.Generator().manual_seed(SEED)
    picks = torch.randperm(n, generator=gen)[:N_SELF].tolist()
    qv = provider.embed_batch_device([texts[i] for i in picks])
    plan = store._plan_search(N_SELF, K, None, "auto")
    s, i = store.search_device(qv, K)
    torch.cuda.synchronize()
    require(s.shape == (N_SELF, K) and bool(torch.isfinite(s).all())
            and bool((s[:, :-1] >= s[:, 1:]).all()), "search_device output")
    # a text that occurs more than once (an empty __init__.py, a copied
    # file) has no single own row: any row with the same text is a hit
    top = i.tolist()
    self_hit = sum(any(texts[r] == texts[j] for r in row)
                   for j, row in zip(picks, top)) / N_SELF
    copies = sum(texts.count(texts[j]) > 1 for j in picks)
    emb, valid = store.device_arrays
    r = recall(i, exact_topk(qv, emb, valid, K))
    ctx["self_hit"], ctx["recall_encoder"] = self_hit, r
    log(f"self-retrieval: {self_hit:.4f} of {N_SELF} chunks ({copies} of "
        f"them with copies of their text in the corpus) have their own text "
        f"in their top {K} (search_device, B={N_SELF}, plan {plan!r}); "
        f"recall@{K} against an exact f32 scan {r:.4f} (information)")
    require(self_hit >= 0.99, f"self-retrieval {self_hit:.4f} < 0.99")
    searcher = VectorSearcher(indexer)
    for j in picks[:4]:
        hits = searcher.search_code(texts[j], limit=K)
        require(len(hits) == K and all(h.file_path and h.start_line >= 1
                                       for h in hits),
                f"search_code gave {len(hits)} hits")
        require(any(texts[h.row] == texts[j] for h in hits),
                f"chunk {j} is not in its own top {K} through search_code")
    for text in ENC_QUERIES:
        hits = searcher.search_code(text, limit=K)
        require(len(hits) == K and all(h.file_path and h.start_line >= 1
                                       for h in hits),
                f"search_code({text!r}) gave {len(hits)} hits")
    log(f"search_code (B=1): {len(ENC_QUERIES) + 4} queries, top hit of "
        f"{ENC_QUERIES[0]!r}: {hits[0].file_path}:{hits[0].start_line}")
    ctx.update(provider=provider, searcher=searcher, enc_texts=texts)


def phase_encoder_timings(ctx: dict, kernels_ms: dict, smi: str) -> None:
    """Encoder throughput at B=128, L=512 on device-resident ids (CUDA
    events), the host tokenizer per batch, B=1 query encode and
    `search_code` p50 (host clock), and `paired_attention` beside its plain
    version at one layer's call."""
    from lattice_tpu_torch.ops import attention as attn
    provider, searcher = ctx["provider"], ctx["searcher"]
    model, tok, texts = provider.model, provider.tokenizer, ctx["enc_texts"]
    cfg = model.config
    tok_ms = []
    for lo in range(0, 5 * ENC_BATCH, ENC_BATCH):
        t0 = time.perf_counter()
        ids, mask = tok.encode_batch(texts[lo:lo + ENC_BATCH], ENC_LEN)
        tok_ms.append((time.perf_counter() - t0) * 1e3)
    pad = ENC_LEN - len(ids[0])
    ids = torch.tensor([r + [tok.PAD] * pad for r in ids], device="cuda")
    mask = torch.tensor([r + [0] * pad for r in mask], device="cuda")
    ms = cuda_ms(lambda: model.encode_device(ids, mask), 5, 2)
    dense = sum(p.numel() for name, p in model.encoder.named_parameters()
                if not name.startswith(("word_", "position_")))
    tokens = ENC_BATCH * ENC_LEN
    flop = (2 * dense * tokens + 4 * ENC_BATCH * cfg.hidden_size
            * ENC_LEN ** 2 * cfg.num_layers)
    ctx["enc_chunks_s"] = ENC_BATCH / ms * 1e3
    log(f"encoder B={ENC_BATCH} L={ENC_LEN} device-resident: {ms:.2f} ms/batch"
        f" = {ENC_BATCH / ms * 1e3:.0f} chunks/s, {flop / ms / 1e9:.1f} "
        f"TFLOP/s ({flop / 1e12:.2f} TFLOP/batch); tokenizer "
        f"{statistics.median(tok_ms):.1f} ms/batch on the host ({smi})")
    q1 = [" ".join(t.split()[:8]) for t in texts[:50]]
    enc_p50 = p50_ms(lambda j: provider.embed_batch_device([q1[j]]))
    lengths = {model.bucket_length(len(tok.encode(t, ENC_LEN)[0]))
               for t in q1}
    search_p50 = p50_ms(lambda j: searcher.search_code(q1[j], limit=K))
    ctx["enc_p50"], ctx["search_code_p50"] = enc_p50, search_p50
    log(f"B=1 query encode p50 {enc_p50:.3f} ms (L buckets {sorted(lengths)})"
        f"; B=1 search_code p50 {search_p50:.3f} ms ({smi})")
    phase_encoder_trace(model, ids, mask, smi)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    # the timing input of the table (mask lengths drawn from [1, L], the
    # last row fully masked), then every key live, then the other length
    # buckets and the query encode's (B=1, L=64)
    for b, ln, kind in ((ENC_BATCH, ENC_LEN, "prefix"),
                        (ENC_BATCH, ENC_LEN, "live"), (ENC_BATCH, 64, "prefix"),
                        (ENC_BATCH, 128, "prefix"), (ENC_BATCH, 256, "prefix"),
                        (1, 64, "prefix")):
        q, k, v, m = attention_inputs(b, ln, torch.bfloat16, gen,
                                      kind == "prefix" and b > 1, kind=kind)
        # the library's fused attention on the same function: heads split
        # out, the key mask as the additive -1e9 bias the kernel applies
        split = [x.view(b, ln, ATTN_HEADS, 64).transpose(1, 2)
                 for x in (q, k, v)]
        bias = ((1.0 - m.to(torch.bfloat16)) * -1e9)[:, None, None, :]
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *split, attn_mask=bias, scale=SM_SCALE), 20)
        attn_bytes, attn_flop = attention_work(m, ATTN_HEADS)
        main = (b, ln, kind) == (ENC_BATCH, ENC_LEN, "prefix")
        row = kernel_row(
            cuda_ms(lambda: attn.paired_attention(q, k, v, m, SM_SCALE), 20),
            cuda_ms(lambda: attn.paired_attention_plain(q, k, v, m, SM_SCALE),
                    3, 1) if main else None,
            bound(attn_bytes, attn_flop, "bf16"), lib)
        plain = f"plain {row['plain_ms']:.4f} ms, " if main else ""
        log(f"kernel paired_attention bf16 B={b} L={ln} H={ATTN_HEADS} mask "
            f"{kind}: {row['ms']:.4f} ms ({attn_flop / row['ms'] / 1e9:.1f} "
            f"TFLOP/s of the products its mask needs), {plain}bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{attn_bytes / 1e9:.4f} GB, {attn_flop / 1e9:.2f} GFLOP), "
            f"scaled_dot_product_attention {lib:.4f} ms ({smi})")
        if main:
            kernels_ms["paired_attention"] = row


def attention_work(mask: torch.Tensor, heads: int) -> tuple[float, float]:
    """Bytes and operations that bf16 `paired_attention` needs on `mask`:
    q and the mask read once, the K and V rows of every 64-key tile that
    holds a live key (of every tile, for a row without one), the f32
    context written once; both products over the keys of those tiles."""
    b, ln = mask.shape
    tiles = -(-ln // 64)
    live = torch.zeros((b, tiles * 64), dtype=torch.bool, device=mask.device)
    live[:, :ln] = mask > 0
    live = live.view(b, tiles, 64).any(-1)
    run = live | ~live.any(1, keepdim=True)
    width = (ln - 64 * torch.arange(tiles, device=mask.device)).clamp(max=64)
    keys = (run * width).sum().item()
    w = heads * 64
    n_bytes = 2 * b * ln * w + 2 * 2 * keys * w + 4 * b * ln + 4 * b * ln * w
    return n_bytes, 4 * w * ln * keys


def top_kernels(summary: dict, n: int = 6) -> list[tuple[str, float]]:
    """The `n` kernels of a `summarize_device_trace` summary that took the
    most device time, names cut to 60 characters, in ms."""
    return [(name[:60], round(ms, 3)) for name, ms, _ in summary["ops"][:n]]


def phase_encoder_trace(model, ids: torch.Tensor, mask: torch.Tensor,
                        smi: str, n: int = 4) -> None:
    """A `utils/tracing.py` device trace of `n` encoder forwards on
    device-resident ids: busy ms per batch, the idle share of the traced
    window, `paired_attention`'s share of busy time, and the kernels that
    took the most time."""
    from lattice_tpu_torch.utils.tracing import (device_trace,
                                                 summarize_device_trace)
    where = str(Path(__file__).resolve().parent / "build" / "traces"
                / "encoder")
    model.encode_device(ids, mask)
    torch.cuda.synchronize()
    with device_trace(where):
        t0 = time.perf_counter()
        for _ in range(n):
            model.encode_device(ids, mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    summ = summarize_device_trace(where, "GPU", top=1 << 20)
    require("error" not in summ and summ["total_ms"] > 0,
            f"encoder trace: {summ.get('error', 'no device time')}")
    busy = summ["total_ms"]
    attn_ms = sum(ms for name, ms, _ in summ["ops"] if "paired_attn_" in name)
    log(f"encoder trace, {n} forwards B={ENC_BATCH} L={ENC_LEN}: device busy "
        f"{busy / n:.3f} ms per batch, idle {1 - busy / wall:.4f} of the "
        f"traced window ({wall / n:.3f} ms per batch under the profiler); "
        f"paired_attention {attn_ms / n:.4f} ms per batch = "
        f"{attn_ms / busy:.4f} of busy time; top kernels (ms over {n} "
        f"batches): {top_kernels(summ)} ({smi})")


ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "golden_project"
GOLDEN_CASES = ROOT / "tests" / "fixtures" / "golden_eval.jsonl"
GOLDEN_DIM = 256           # the golden engine's hash width
GOLDEN_LIMIT = 20          # its vector limit: min(2 * 10, max_vector_results)
REAL_REPO = "lattice_tpu"  # 3g(b): a copy of the JAX package, a real repo
TOUCHED = "lattice_tpu/parsing/scanner.py"
STAGES = ("scanning", "parsing", "graph_building", "embedding",
          "summarizing")


def index_repo(repo: Path, embedder, device: str, project: str,
               indexer=None):
    """One `PipelineOrchestrator.run()` with default settings: its metadata
    stage writes `<repo>/.lattice/metadata.sqlite3`, so `repo` is a
    scratch copy."""
    import asyncio
    from lattice_tpu_torch.config.settings import Settings
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    settings = Settings()
    require(settings.metadata.enabled, "metadata is off by default")
    orch = PipelineOrchestrator(repo, embedder, project_name=project,
                                settings=settings, indexer=indexer,
                                device=device)
    run = asyncio.run(orch.run())
    require(run.errors == [], f"indexing {repo.name}: {run.errors[:3]}")
    return run


def graph_signature(store) -> tuple:
    """Every node (qualified name, type, file, lines, alive) and the edges
    of every `EdgeType`, in id order."""
    nodes = [(r.qualified_name, r.entity_type.value, r.file_path,
              r.start_line, r.end_line, bool(store._alive[r.node_id]))
             for r in map(store.node, range(store.n_nodes()))]
    edges = {et.value: [a.tolist() for a in store.edges(et)]
             for et in store._edges}
    return nodes, edges


def stage_seconds(run) -> dict:
    """Host-clock seconds of each stage of one run (its progress tracker)."""
    stages = run.tracker._stages
    return {s.value: stages[s].finished_at - stages[s].started_at
            for s in stages if s.value in STAGES}


def phase_index_path(ctx: dict) -> None:
    """3g: indexing through the port: (a) the golden fixture, (b) a real
    repository through 3c's encoder."""
    from lattice_tpu_torch.utils import native
    lib = native.get_lib()
    require(lib is not None, "the C++ host library (csrc/host/) did not "
            "build or load")
    log(f"native host library: {native.library_path()}; OpenMP batch BFS "
        f"{hasattr(lib, 'lattice_bfs_khop_batch')}")
    t0 = time.perf_counter()
    phase_index_golden(ctx)
    phase_index_real_repo(ctx)
    log(f"phase 3g took {time.perf_counter() - t0:.2f} s")


def phase_index_golden(ctx: dict) -> None:
    """3g(a): the golden fixture through `PipelineOrchestrator` with the
    hash embedder on the card and on the CPU: the same graph, payloads and
    bf16 vector bits; the 104 golden queries through `search_code` on the
    card ("quantized": kernels C + B) held to the CPU store's forced
    "quantized", and through a forced "pallas" (kernels A + B) held to the
    CPU's under kernel A's bar."""
    import shutil
    import tempfile
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.embeddings.indexer import VectorSearcher
    from lattice_tpu_torch.metadata.repository import MetadataRepository
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.providers.hash_provider import HashEmbedder
    embedder = Embedder(HashEmbedder(dimensions=GOLDEN_DIM))
    with tempfile.TemporaryDirectory() as tmp:
        repo = Path(tmp) / "golden"
        shutil.copytree(GOLDEN, repo)
        t0 = time.perf_counter()
        card = index_repo(repo, embedder, "cuda", "golden_eval")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = index_repo(repo, embedder, "cpu", "golden_eval")
        host_s = time.perf_counter() - t0
        meta = MetadataRepository(repo / ".lattice").list_versions(
            "golden_eval")
        require([(v, st) for v, st, _ in meta] == [(2, "completed"),
                                                    (1, "completed")],
                 f"metadata versions {meta}")
    require(graph_signature(card.graph_builder.store)
            == graph_signature(host.graph_builder.store),
            "the card's and the CPU's runs built different graphs")
    for name in ("code", "summaries"):
        a, b = getattr(card.indexer, name), getattr(host.indexer, name)
        require(a._payloads == b._payloads, f"{name} payloads differ")
        (ea, va), (eb, vb) = a.device_arrays, b.device_arrays
        require(ea.dtype == eb.dtype == torch.bfloat16
                and torch.equal(ea.cpu().view(torch.int16),
                                eb.view(torch.int16))
                and torch.equal(va.cpu(), vb),
                f"{name} vectors differ between the card and the CPU")
    require(card.indexer.stats == host.indexer.stats,
            f"indexer stats {card.indexer.stats} / {host.indexer.stats}")
    gstats = card.graph_builder.store.stats
    ctx["golden_runs"] = card, host   # 3h's stores
    log(f"golden fixture indexed on the card in {card_s:.2f} s, on the CPU "
        f"in {host_s:.2f} s: {len(card.files)} files, graph {gstats['nodes']}"
        f" nodes, edges {gstats['edges']}; {card.indexer.stats}; graphs, "
        f"payloads and bf16 vector bits equal; metadata written by both "
        f"runs (versions 1 and 2, completed)")

    cases = golden_cases()
    store, cpu_store = card.indexer.code, host.indexer.code
    plan = store._plan_search(1, GOLDEN_LIMIT, None, "auto")
    require(plan == "quantized", f"the auto plan at B=1 is {plan!r}")
    searcher = VectorSearcher(card.indexer)
    before = _build.launch_counts()
    worst = 0.0
    for case in cases:
        got = searcher.search_code(case["query"], limit=GOLDEN_LIMIT)
        qv = embedder.embed(case["query"])
        want = cpu_store.search(qv[None, :], GOLDEN_LIMIT,
                                method="quantized")[0]
        require([h.row for h in got] == [r for r, _, _ in want],
                f"search_code({case['query']!r}) rows differ from the CPU's")
        gap = max((abs(h.score - s) for h, (_, s, _) in zip(got, want)),
                  default=0.0)
        require(gap <= 1e-5, f"search_code({case['query']!r}) scores differ "
                f"by {gap:.3g}")
        worst = max(worst, gap)
    after = _build.launch_counts()
    ran = {k: after[k] - before[k] for k in ("scan_topk_int8",
                                             "merge_candidates")}
    require(all(v >= len(cases) for v in ran.values()),
            f"search_code launched {ran} for {len(cases)} queries")
    log(f"golden queries: {len(cases)} through search_code on the card (plan "
        f"{plan!r}, launches {ran}) equal the CPU's forced 'quantized': rows "
        f"in order, scores within {worst:.3g}")

    q = torch.from_numpy(np.stack([embedder.embed(c["query"])
                                   for c in cases]))
    s, i = store.search_device(q.cuda(), GOLDEN_LIMIT, method="pallas")
    ps, pi = cpu_store.search_device(q, GOLDEN_LIMIT, method="pallas")
    s, i = s.cpu(), i.cpu()
    off = i != pi
    same = int((~off).sum())
    require(same >= 0.999 * i.numel(), f"forced 'pallas': ids agree on "
            f"{same / i.numel():.6f} of the slots")
    gap = (s[off] - ps[off]).abs().max().item() if bool(off.any()) else 0.0
    require(gap <= TIE_TOL, f"forced 'pallas': slots whose ids differ are not "
            f"rounding ties (gap {gap:.3g})")
    log(f"golden queries, forced 'pallas' (kernels A + B) at B={len(cases)}: "
        f"ids agree with the CPU's on {same} of {i.numel()} slots, differing "
        f"slots within {gap:.3g}; scores within "
        f"{(s - ps).abs().max().item():.3g}")


def phase_index_real_repo(ctx: dict) -> None:
    """3g(b): a copy of `lattice_tpu/` through `PipelineOrchestrator` on the
    card with 3c's UniXcoder provider (random weights, seed 0):
    `paired_attention` 12 times a forward, chunks finding themselves, then
    a second run that skips every file and, after one file is touched, a
    run that re-indexes that file only."""
    import shutil
    import tempfile
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.ops import _build
    provider = ctx["provider"]
    model = provider.model
    forwards = [0]

    def counted(*args, _forward=model._forward):
        forwards[0] += 1
        return _forward(*args)

    embedder = Embedder(provider, batch_size=ENC_BATCH)
    model._forward = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # a repository whose root holds the package, as the checkout's
            # does: module names and imports resolve as `lattice_tpu.*`
            repo = Path(tmp) / "repo"
            shutil.copytree(ROOT / REAL_REPO, repo / REAL_REPO,
                            ignore=shutil.ignore_patterns("__pycache__"))
            before = _build.launch_counts()["paired_attention"]
            t0 = time.perf_counter()
            run = index_repo(repo, embedder, "cuda", REAL_REPO)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launched = _build.launch_counts()["paired_attention"] - before
            require(launched == model.config.num_layers * forwards[0],
                    f"paired_attention launched {launched} times in "
                    f"{forwards[0]} forwards")
            check_real_repo(run, provider, total_s, forwards[0], launched)
            ctx["real_run"] = run   # 3h's stores
            n_files = run.indexer.stats["files_indexed"]
            t0 = time.perf_counter()
            again = index_repo(repo, embedder, "cuda", REAL_REPO,
                               indexer=run.indexer)
            again_s = time.perf_counter() - t0
            require(again.changed == [] and again.indexer.stats[
                "files_skipped"] == n_files, f"a second run re-indexed "
                f"{[p.file_info.relative_path for p in again.changed]}")
            path = repo / TOUCHED
            path.write_text(path.read_text() + "\n\ndef touched_after_index("
                            "x):\n    return x\n")
            t0 = time.perf_counter()
            touched = index_repo(repo, embedder, "cuda", REAL_REPO,
                                 indexer=run.indexer)
            touched_s = time.perf_counter() - t0
            changed = [p.file_info.relative_path for p in touched.changed]
            require(changed == [TOUCHED]
                    and touched.indexer.stats["files_indexed"] == n_files + 1,
                    f"touching {TOUCHED} re-indexed {changed}")
            check_touched_store(run.indexer.code, provider)
            log(f"second run: every one of {n_files} files skipped in "
                f"{again_s:.2f} s; after touching {TOUCHED}: {changed} "
                f"re-indexed in {touched_s:.2f} s; store "
                f"{run.indexer.code.stats}")
    finally:
        del model._forward


def check_touched_store(store, provider) -> None:
    """After the touched file's `delete_file` + `add` on the card, the int8
    shadow (built by the self-retrieval search) was updated in place, the
    file's chunks, the new function's among them, find themselves through
    the auto plan, and its rows agree with an exact f32 scan."""
    rows = [r for r, p in enumerate(store._payloads)
            if p and p["file_path"] == TOUCHED]
    texts = [store._payloads[r]["content"] for r in rows]
    require(any(store._payloads[r]["name"].endswith(".touched_after_index")
                for r in rows),
            "the touched file's new function is not in the store")
    require(store._quant is not None and not store._quant_dirty,
            "the int8 shadow was not updated in place")
    qv = provider.embed_batch_device(texts)
    plan = store._plan_search(len(rows), K, None, "auto")
    s, i = store.search_device(qv, K)
    emb, valid = store.device_arrays
    r = recall(i, exact_topk(qv, emb, valid, K))
    hit = sum(any(store._payloads[j]["content"] == t for j in row)
              for t, row in zip(texts, i.tolist())) / len(rows)
    log(f"touched file's {len(rows)} chunks: {hit:.4f} find their own text "
        f"in their top {K} (plan {plan!r}, int8 shadow updated in place); "
        f"recall@{K} against an exact f32 scan {r:.4f}")
    require(plan == "quantized" and hit == 1.0 and r >= RECALL_MIN,
            f"after the touched re-index: plan {plan!r}, self-hit {hit}, "
            f"recall {r}")


def check_real_repo(run, provider, total_s: float, forwards: int,
                    launched: int) -> None:
    """Print what 3g(b) indexed and its stage times; hold 256 chunks drawn
    by seed, encoded again as queries, to finding their own text in their
    top 10 through `search_device` at B=256."""
    store = run.indexer.code
    gstats = run.graph_builder.store.stats
    secs = stage_seconds(run)
    n_chunks = run.indexer.stats["chunks_indexed"]
    n_entities = sum(len(p.all_entities) for p in run.parsed)
    log(f"{REAL_REPO}/ indexed on the card through UniXcoder in "
        f"{total_s:.2f} s: {len(run.files)} files, {len(run.parsed)} parsed, "
        f"{n_entities} entities, graph {gstats['nodes']} nodes, edges "
        f"{gstats['edges']}; {n_chunks} chunks, "
        f"{run.indexer.stats['summaries_indexed']} summaries; "
        f"{forwards} forwards, paired_attention {launched} launches "
        f"(12 a forward)")
    log(f"stage seconds (host clock): "
        f"{ {k: round(v, 3) for k, v in secs.items()} }; "
        f"{n_chunks / secs['embedding']:.1f} chunks/s through the chunker "
        f"and the encoder (embed stage)")
    texts = [p and p["content"] for p in store._payloads]
    rows = [r for r, t in enumerate(texts) if t is not None]
    require(len(rows) == n_chunks, f"{len(rows)} live rows for {n_chunks} "
            f"chunks")
    gen = torch.Generator().manual_seed(SEED)
    picks = [rows[j] for j in torch.randperm(len(rows), generator=gen)[
        :N_SELF].tolist()]
    qv = provider.embed_batch_device([texts[j] for j in picks])
    plan = store._plan_search(len(picks), K, None, "auto")
    s, i = store.search_device(qv, K)
    torch.cuda.synchronize()
    require(s.shape == (len(picks), K) and bool(torch.isfinite(s).all()),
            "search_device output")
    hit = sum(any(texts[r] == texts[j] for r in row)
              for j, row in zip(picks, i.tolist())) / len(picks)
    log(f"self-retrieval on {REAL_REPO}/: {hit:.4f} of {len(picks)} chunks "
        f"have their own text in their top {K} (search_device, B="
        f"{len(picks)}, plan {plan!r})")
    require(hit >= 0.99, f"self-retrieval {hit:.4f} < 0.99")


# the golden eval's numbers (`query/golden_eval.evaluate`) in both packages
# on the CPU: through the auto plan there ("flat", the reference's
# published numbers) and with both stores served through "quantized", the
# card's auto plan (held in tests/test_torch_port_golden_eval.py)
GOLDEN_EVAL = {
    "flat": {"n": 104, "mrr": 0.9148, "hit_at_5": 0.9904, "hit_at_10": 1.0,
             "per_path": {"search": {"n": 92, "mrr": 0.92,
                                     "hit_at_5": 0.9891},
                          "deep": {"n": 12, "mrr": 0.875, "hit_at_5": 1.0}},
             "misses": []},
    "quantized": {"n": 104, "mrr": 0.9164, "hit_at_5": 0.9904,
                  "hit_at_10": 1.0,
                  "per_path": {"search": {"n": 92, "mrr": 0.9218,
                                          "hit_at_5": 0.9891},
                               "deep": {"n": 12, "mrr": 0.875,
                                        "hit_at_5": 1.0}},
                  "misses": []},
}
QUERY_NEAR_TIE = 1e-6      # 3h: two results this close may swap places
QUERY_SCORE_TOL = 1e-5     # 3h: card and CPU scores of the same result
N_ANSWERS = 8              # 3h(a): query_sync answers held to the CPU's
N_DEFINED = 8              # 3h(b): "where is X defined?" questions
QUERY_PATHS = ("search_sync", "query_sync", "deep_search")
PHASE_KEYS = ("planning_ms", "graph_ms", "centrality_ms", "ranking_ms",
              "context_ms", "response_ms", "deep_fuse_ms")


def golden_cases() -> list[dict]:
    from lattice_tpu_torch.query.golden_eval import load_cases
    cases = load_cases(GOLDEN_CASES)
    require(len(cases) == 104, f"{len(cases)} golden cases")
    return cases


def answer_cases(cases: list[dict]) -> list[int]:
    """4 `search` and 4 `deep` cases spread over the golden set (also the
    CPU test's, `tests/test_torch_port_golden_eval.py`)."""
    return ([i for i, c in enumerate(cases) if c["path"] == "search"][::23]
            + [i for i, c in enumerate(cases) if c["path"] == "deep"][::3])


def engine_call(engine, path: str, text: str, limit: int = K):
    return getattr(engine, path)(text, limit=limit)


def compare_top(card: list, host: list, where: str) -> list[str]:
    """The card's top-10 against the CPU's: the same qualified names in
    order, except where two neighbours whose scores lie within
    QUERY_NEAR_TIE swap places; scores within QUERY_SCORE_TOL. Returns the
    swaps, printed."""
    a, b = card[:K], host[:K]
    require(len(a) == len(b), f"{where}: {len(a)} results on the card, "
            f"{len(b)} on the CPU")
    swaps = []
    for i, (x, y) in enumerate(zip(a, b)):
        require(abs(x.score - y.score) <= QUERY_SCORE_TOL,
                f"{where}: slot {i} scores {x.score} / {y.score}")
        if x.qualified_name != y.qualified_name:
            require(abs(x.score - y.score) < QUERY_NEAR_TIE,
                    f"{where}: slot {i} holds {x.qualified_name} on the "
                    f"card and {y.qualified_name} on the CPU (scores "
                    f"{x.score!r} / {y.score!r})")
            swaps.append(f"{where}: slot {i}: {x.qualified_name} "
                         f"({x.score!r}) / {y.qualified_name} ({y.score!r})")
    for line in swaps:
        log(f"near-tie swap {line}")
    return swaps


def check_results(engine, res, where: str) -> None:
    """At least one result; each names a graph node or a payload of the
    index; scores finite and sorted."""
    graph, store = engine.graph_store, engine.indexer.code
    require(res.results, f"{where}: no results")
    for r in res.results:
        require(graph.id_of(r.qualified_name) is not None
                or r.qualified_name in store._inverted["graph_node_id"],
                f"{where}: {r.qualified_name!r} is neither a graph node nor "
                f"a payload of the index")
    scores = [r.score for r in res.results]
    require(all(math.isfinite(v) for v in scores), f"{where}: scores {scores}")
    require(scores == sorted(scores, reverse=True),
            f"{where}: scores not sorted: {scores}")


def phase_query_path(ctx: dict) -> None:
    """3h: the query side on the card, over 3g's stores: (a) the golden
    eval through `QueryEngine` on the card and on the CPU, (b) questions
    about the real repository indexed through the encoder."""
    t0 = time.perf_counter()
    phase_query_golden(ctx)
    phase_query_real_repo(ctx)
    log(f"phase 3h took {time.perf_counter() - t0:.2f} s")


def serve_through(engine, method: str) -> None:
    """Have the engine's two stores serve every `search` through `method`
    (the card's auto plan, forced on a CPU store: the kernels' plain
    versions)."""
    for store in (engine.indexer.code, engine.indexer.summaries):
        store.search = functools.partial(store.search, method=method)


def phase_query_golden(ctx: dict) -> None:
    """3h(a): `evaluate` through engines over 3g(a)'s card and CPU
    indexes. The CPU engine on its auto plan ("flat") gives the
    reference's numbers. The card's auto plan is "quantized" (kernels C +
    B, then the exact rescore with the f32 query, where "flat" scores the
    query rounded to bf16, as in the reference), so the card is held to
    the CPU engine served through "quantized": each case's top 10 equal
    (near-tie swaps printed) and the same numbers, which are the JAX
    package's on that plan (`GOLDEN_EVAL`); `query_sync` answers equal;
    kernels C and B at least once a `search` case."""
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.query.engine import QueryEngine
    from lattice_tpu_torch.query.golden_eval import (_rank_of_first_hit,
                                                     evaluate)
    card_run, host_run = ctx["golden_runs"]
    card = QueryEngine(card_run.graph_builder.store, card_run.indexer)
    host = QueryEngine(host_run.graph_builder.store, host_run.indexer)
    require(card.indexer.code.device.type == "cuda"
            and host.indexer.code.device.type == "cpu", "engine devices")
    plan = card.indexer.code._plan_search(1, GOLDEN_LIMIT, None, "auto")
    require(plan == "quantized", f"the card's auto plan is {plan!r}")
    cases = golden_cases()
    summaries = [0]
    search_summaries = card.vector_searcher.search_summaries

    def counted(*args, **kwargs):
        summaries[0] += 1
        return search_summaries(*args, **kwargs)

    card.vector_searcher.search_summaries = counted
    before = _build.launch_counts()
    t0 = time.perf_counter()
    got = evaluate(card, cases)
    card_s = time.perf_counter() - t0
    after = _build.launch_counts()
    ran = {k: after[k] - before[k] for k in ("scan_topk_int8",
                                             "merge_candidates")}
    t0 = time.perf_counter()
    flat = evaluate(host, cases)
    host_s = time.perf_counter() - t0
    flat_tops = [engine_call(host, "deep_search" if c["path"] == "deep"
                             else "search_sync", c["query"]).results
                 for c in cases]
    serve_through(host, plan)
    want = evaluate(host, cases)

    def line(e: dict) -> str:
        return (f"{json.dumps({k: v for k, v in e.items() if k != 'misses'})}"
                f", {len(e['misses'])} misses")

    n_search = sum(c["path"] == "search" for c in cases)
    log(f"golden eval through QueryEngine on the card ({card_s:.2f} s, plan "
        f"{plan!r}): {line(got)}; on the CPU, plan 'flat' ({host_s:.2f} s): "
        f"{line(flat)}; on the CPU through {plan!r}: {line(want)}")
    log(f"golden eval launches on the card: {ran} for {n_search} search and "
        f"{len(cases) - n_search} deep cases; search_summaries called "
        f"{summaries[0]} times among them")
    require(all(v >= n_search for v in ran.values()),
            f"kernels C and B launched {ran} for {n_search} search cases")
    require(flat == GOLDEN_EVAL["flat"], f"the CPU engine's eval {flat}")
    require(want == GOLDEN_EVAL[plan], f"the CPU engine's eval through "
            f"{plan!r}: {want}")

    swaps, moved, by_plan = [], [], 0
    for i, case in enumerate(cases):
        path = "deep_search" if case["path"] == "deep" else "search_sync"
        a = engine_call(card, path, case["query"]).results
        b = engine_call(host, path, case["query"]).results
        case_swaps = compare_top(a, b, f"case {i} ({path})")
        swaps += case_swaps
        by_plan += ([r.qualified_name for r in b[:K]]
                    != [r.qualified_name for r in flat_tops[i][:K]])
        expect = set(case["expect"])
        ra, rb = (_rank_of_first_hit(a, expect, K),
                  _rank_of_first_hit(b, expect, K))
        if ra != rb:
            require(bool(case_swaps), f"case {i}: first hit at {ra} on the "
                    f"card, {rb} on the CPU, with no near-tie swap")
            moved.append(i)
            log(f"case {i} {case['query']!r}: a near-tie swap moves its "
                f"first hit from {rb} (CPU) to {ra} (card)")
    if not moved:
        require(got == want, f"the card's eval {got} differs from the CPU's")
    log(f"golden cases: each top {K} on the card equals the CPU's through "
        f"{plan!r} ({len(swaps)} near-tie swaps, {len(moved)} first hits "
        f"moved); {by_plan} cases have another top {K} on the CPU's 'flat'")
    picked = answer_cases(cases)
    require(len(picked) == N_ANSWERS, f"{len(picked)} answer cases")
    for i in picked:
        text = cases[i]["query"]
        a = card.query_sync(text, limit=K)
        b = host.query_sync(text, limit=K)
        require(a.answer == b.answer, f"query_sync({text!r}): the card's "
                f"answer differs from the CPU's")
    log(f"query_sync: {N_ANSWERS} answers on the card equal the CPU's "
        f"character for character")
    # the deep cases through the device branch, forced on both engines
    deep = [c["query"] for c in cases if c["path"] == "deep"]
    card.DEEP_DEVICE_THRESHOLD = host.DEEP_DEVICE_THRESHOLD = 1
    before = _build.entry_launch_counts().get("lt_merge_positions", 0)
    try:
        swaps = sum(len(compare_top(
            card.deep_search(text, limit=K).results,
            host.deep_search(text, limit=K).results,
            f"forced device branch {text!r}")) for text in deep)
    finally:
        del card.DEEP_DEVICE_THRESHOLD, host.DEEP_DEVICE_THRESHOLD
    ran = _build.entry_launch_counts().get("lt_merge_positions", 0) - before
    require(ran >= len(deep), f"kernel B's positional entry launched {ran} "
            f"times for {len(deep)} forced deep cases")
    log(f"golden deep cases on the forced device branch: the card's top "
        f"{K} equals the CPU's in all {len(deep)} ({swaps} near-tie swaps; "
        f"kernel B {ran} launches)")
    ctx["golden_engine"] = card


def defined_nodes(graph, n: int, seed: int) -> list:
    """`n` function or method nodes drawn by seed whose bare name is
    unique in the graph and at least 8 characters long."""
    from lattice_tpu_torch.core.types import EntityType
    nodes = [graph.node(i) for i in range(graph.n_nodes())
             if graph._alive[i]]
    bare = [r.qualified_name.rsplit(".", 1)[-1] for r in nodes]
    count: dict[str, int] = {}
    for b in bare:
        count[b] = count.get(b, 0) + 1
    pool = [r for r, b in zip(nodes, bare)
            if r.entity_type in (EntityType.FUNCTION, EntityType.METHOD)
            and count[b] == 1 and len(b) >= 8]
    gen = torch.Generator().manual_seed(seed)
    return [pool[j] for j in torch.randperm(len(pool), generator=gen)[:n]
            .tolist()]


def relation_questions(graph, seed: int) -> list[str]:
    """8 relation questions about nodes drawn by seed, each named by a bare
    name unique in the graph: 3 "who calls X?" (X has callers), 2 "what
    does X extend?" (X extends a class), 3 "what methods does X have?"
    (X is a class with methods)."""
    from lattice_tpu_torch.core.types import EdgeType, EntityType
    gen = torch.Generator().manual_seed(seed)
    alive = [i for i in range(graph.n_nodes()) if graph._alive[i]]
    bare = {i: graph.node(i).qualified_name.rsplit(".", 1)[-1]
            for i in alive}
    count: dict[str, int] = {}
    for b in bare.values():
        count[b] = count.get(b, 0) + 1

    def draw(ids, n: int) -> list[str]:
        ids = sorted(i for i in set(map(int, ids))
                     if i in bare and count[bare[i]] == 1)
        order = torch.randperm(len(ids), generator=gen)[:n].tolist()
        return [bare[ids[j]] for j in order]

    classes = [i for i in alive
               if graph.node(i).entity_type == EntityType.CLASS
               and graph.methods_of_class(i)]
    return ([f"who calls `{n}`?"
             for n in draw(graph.edges(EdgeType.CALLS)[1], 3)]
            + [f"what does `{n}` extend?"
               for n in draw(graph.edges(EdgeType.EXTENDS)[0], 2)]
            + [f"what methods does `{n}` have?" for n in draw(classes, 3)])


def phase_query_real_repo(ctx: dict) -> None:
    """3h(b): `QueryEngine` over 3g(b)'s index of `lattice_tpu/` (the
    UniXcoder encoder on the card): 8 drawn functions found by "where is X
    defined?", 8 relation questions answered through every path, 12
    `paired_attention` launches per query embedding."""
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.query.engine import QueryEngine
    run = ctx["real_run"]
    engine = QueryEngine(run.graph_builder.store, run.indexer)
    graph = engine.graph_store
    model = ctx["provider"].model
    forwards = [0]

    def counted(*args, _forward=model._forward):
        forwards[0] += 1
        return _forward(*args)

    model._forward = counted
    before = _build.launch_counts()["paired_attention"]
    try:
        drawn = defined_nodes(graph, N_DEFINED, SEED)
        require(len(drawn) == N_DEFINED, f"{len(drawn)} unique names drawn")
        ranks, asked = [], []
        for node in drawn:
            bare = node.qualified_name.rsplit(".", 1)[-1]
            asked.append(f"where is `{bare}` defined?")
            res = engine.search_sync(asked[-1])
            check_results(engine, res, asked[-1])
            names = [r.qualified_name for r in res.results[:K]]
            require(node.qualified_name in names, f"{node.qualified_name} is "
                    f"not in the top {K} of 'where is {bare} defined?': "
                    f"{names}")
            ranks.append(names.index(node.qualified_name) + 1)
        log(f"{REAL_REPO}/: {N_DEFINED} drawn functions found by 'where is X "
            f"defined?' at ranks {ranks}: "
            f"{[n.qualified_name for n in drawn]}")
        questions = relation_questions(graph, SEED)
        require(len(questions) == 8, f"{len(questions)} relation questions")
        for q in questions:
            tops = {}
            for path in QUERY_PATHS:
                res = engine_call(engine, path, q)
                check_results(engine, res, f"{path}({q!r})")
                if path == "query_sync":
                    require(bool(res.answer), f"query_sync({q!r}): no answer")
                tops[path] = res.results[0].qualified_name
            log(f"{q!r} ({res.query_plan.intent.value}): top result {tops}")
        ctx["real_questions"] = asked + questions
        phase_real_repo_deep_batch(engine, asked + questions)
        torch.cuda.synchronize()
    finally:
        del model._forward
    launched = _build.launch_counts()["paired_attention"] - before
    require(forwards[0] > 0
            and launched == model.config.num_layers * forwards[0],
            f"paired_attention launched {launched} times in {forwards[0]} "
            f"query embeddings")
    log(f"{REAL_REPO}/ questions: {forwards[0]} query embeddings, "
        f"paired_attention {launched} launches (12 a forward)")
    ctx["real_engine"] = engine


def phase_real_repo_deep_batch(engine, texts: list[str]) -> None:
    """3h(b): on the forced device branch, `deep_search_batch` over the 16
    questions equals the sequential `deep_search` of each. Both take each
    question's vector from one `embed_batch` of the 16 (the encoder pads
    a batch to its longest text, so a B=1 forward rounds differently in
    bf16; the rank path is what is compared)."""
    embedder = engine.vector_searcher.embedder
    vecs = dict(zip(texts, embedder.embed_batch(texts)))
    engine.DEEP_DEVICE_THRESHOLD = 1
    embedder.embed = vecs.__getitem__
    try:
        batch = engine.deep_search_batch(texts, limit=K)
        swaps = 0
        for text, b in zip(texts, batch):
            one = engine.deep_search(text, limit=K)
            check_results(engine, b, f"deep_search_batch {text!r}")
            swaps += len(compare_top(b.results, one.results,
                                     f"{REAL_REPO}/ deep batch {text!r}"))
    finally:
        del engine.DEEP_DEVICE_THRESHOLD, embedder.embed
    log(f"{REAL_REPO}/: deep_search_batch of {len(texts)} questions on the "
        f"forced device branch equals the sequential calls ({swaps} near-tie "
        f"swaps)")


def phase_query_timings(ctx: dict, smi: str) -> None:
    """3h(c), for information: host-clock p50 of each engine path and of
    each `phase_times_ms` key on the golden engine (the 104 golden query
    texts) and on the real repository's (its 16 questions)."""
    for label, engine, texts in (
            ("golden", ctx.pop("golden_engine"),
             [c["query"] for c in golden_cases()]),
            (REAL_REPO, ctx.pop("real_engine"), ctx.pop("real_questions"))):
        for path in QUERY_PATHS:
            engine_call(engine, path, texts[0])   # warm-up
            lat, phases = [], {}
            for text in texts:
                t0 = time.perf_counter()
                res = engine_call(engine, path, text)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                for key, v in res.phase_times_ms.items():
                    phases.setdefault(key, []).append(v)
            keys = {("retrieve" if k == "graph_ms" else k.removesuffix("_ms")):
                    round(statistics.median(phases[k]), 3)
                    for k in PHASE_KEYS if k in phases}
            log(f"3h timing, {label}, {path}: p50 "
                f"{statistics.median(lat):.3f} ms over {len(texts)} queries "
                f"(host clock); phase p50 ms {keys}; {smi}")


# ---- 3j: the CLI, as separate processes over one persisted index ----------

CLI_PROJECT = "golden_cli"
CLI_SEARCH = 4             # `search --json` processes, one question each
CLI_DEEP = 2               # `search --deep --json` processes (of those 4)
CLI_BATCH = 16             # questions of the one `search --batch-file`
CLI_QUERY = 2              # `query` processes (of those 4)
WATCH_CHANGED = "app/utils/textdiff.py"
WATCH_CREATED = "app/utils/slug.py"
WATCH_DELETED = "app/importers/csv_import.py"

# one CLI process: `main(argv)` of the port, then, on its last line, the
# kernel launches it made (by kernel, by C entry) and its timings
CLI_SCRIPT = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
from lattice_tpu_torch import main as cli
from lattice_tpu_torch.ops import _build
t1 = time.perf_counter()
rc = cli.main(sys.argv[2:])
t2 = time.perf_counter()
cuda = torch.cuda.is_available()
print(json.dumps({
    "rc": rc, "import_s": t1 - t0, "main_s": t2 - t1,
    "cuda_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
    "launches": _build.launch_counts(),
    "entries": _build.entry_launch_counts(),
    "by_kernel": {k.name: k.entry_launches for k in _build.KERNELS}}),
    flush=True)
"""


class CliProcesses:
    """Runs `lattice <argv>` of the port, each call in a process of its own
    (`python3 -c CLI_SCRIPT`), with HOME (the projects registry) in a
    scratch directory; keeps each process's wall time and launches."""

    def __init__(self, env_file: Path, home: Path, device: str):
        import os
        self.head = ["--env", str(env_file)] + (
            [] if device == "cuda" else ["--device", device])
        self.env = {**os.environ, "HOME": str(home)}
        self.cwd = home
        self.launches: dict[str, int] = {}
        self.by_kernel: dict[str, dict[str, int]] = {}
        self.times: list[tuple[str, float, float, float]] = []

    def __call__(self, label: str, *argv: str) -> tuple[str, dict]:
        cmd = [sys.executable, "-c", CLI_SCRIPT, str(ROOT), *self.head, *argv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=self.env, cwd=self.cwd, timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"`lattice {' '.join(argv)}` exited "
                f"{proc.returncode}: {proc.stderr[-3000:]}")
        out, _, last = proc.stdout.rstrip("\n").rpartition("\n")
        tail = json.loads(last)
        require(tail["rc"] == 0, f"`lattice {' '.join(argv)}` returned "
                f"{tail['rc']}: {proc.stderr[-3000:]}")
        for name, n in tail["launches"].items():
            self.launches[name] = self.launches.get(name, 0) + n
        for name, entries in tail["by_kernel"].items():
            mine = self.by_kernel.setdefault(name, {})
            for e, n in entries.items():
                mine[e] = mine.get(e, 0) + n
        self.times.append((label, wall, tail["import_s"], tail["main_s"]))
        return out, tail


def cli_texts(cases: list[dict]) -> tuple[list[str], list[str], list[str]]:
    """The golden questions of 3j: CLI_SEARCH spread over the set (each
    through `search --json`; the first CLI_DEEP and CLI_QUERY of them also
    through `search --deep` and `query`), and CLI_BATCH for the batch."""
    texts = list(dict.fromkeys(c["query"] for c in cases))
    search = texts[::len(texts) // CLI_SEARCH][:CLI_SEARCH]
    batch = texts[3::len(texts) // CLI_BATCH][:CLI_BATCH]
    return search, batch, texts


def json_round_trip(results) -> list[dict]:
    from lattice_tpu_torch.query.ranking.utils import (
        ranked_results_to_search_results)
    return json.loads(json.dumps(ranked_results_to_search_results(results)))


def tie_groups(results) -> list[tuple[int, int]]:
    """[lo, hi) runs of results whose scores are exactly equal. Both
    packages order such ties by the iteration order of sets of strings,
    which follows the process's string hash seed: two processes may order
    them differently."""
    groups, lo = [], 0
    for i in range(1, len(results) + 1):
        if i == len(results) or results[i].score != results[lo].score:
            groups.append((lo, i))
            lo = i
    return groups


def same_cli_results(got: list[dict], results, where: str
                     ) -> tuple[int, set[str]]:
    """A process's `--json` results against the in-process engine's
    `results` after the same JSON round trip: the same names in the same
    order (but within a run of exactly equal scores, where the same names
    in any order) and equal scores. Returns (tie runs ordered otherwise,
    the other fields that differ somewhere, `metadata.*` by subkey)."""
    want = json_round_trip(results)
    require(len(got) == len(want) > 0, f"{where}: {len(got)} results from "
            f"the process, {len(want)} in-process")
    require([r["score"] for r in got] == [r["score"] for r in want],
            f"{where}: scores {[r['score'] for r in got]} / "
            f"{[r['score'] for r in want]}")
    permuted = 0
    for lo, hi in tie_groups(results):
        a = [r["name"] for r in got[lo:hi]]
        b = [r["name"] for r in want[lo:hi]]
        require(a == b or (hi - lo > 1 and sorted(a) == sorted(b)),
                f"{where}: names {[r['name'] for r in got]} / "
                f"{[r['name'] for r in want]}")
        permuted += a != b
    # compared as JSON text: a NaN signal equals itself there
    same = functools.partial(json.dumps, sort_keys=True)
    other = set()
    for lo, hi in tie_groups(results):
        if hi - lo == 1:
            a, b = got[lo], want[lo]
            other |= {k for k in a if k != "metadata"
                      and same(a[k]) != same(b.get(k))}
            other |= {f"metadata.{k}" for k in a["metadata"]
                      if same(a["metadata"][k])
                      != same(b["metadata"].get(k))}
    return permuted, other


def same_query_text(out: str, res, where: str) -> int:
    """`lattice query`'s output against the in-process answer: the same
    text, or, where the top 8 results hold exact ties, the same lines in
    an order that differs only there. Returns 1 if it differs."""
    want = query_text(res)
    if out == want:
        return 0
    tied = [g for g in tie_groups(res.results[:8]) if g[1] - g[0] > 1]
    require(tied and sorted(out.splitlines()) == sorted(want.splitlines()),
            f"{where}: the process printed {out[:400]!r}, the engine "
            f"{want[:400]!r}")
    return 1


def diagram_key(mermaid: str) -> tuple:
    """A metadata architecture diagram up to the order of its edges of
    equal weight, which follows the string hash order of the process that
    drew it: its header, its weights in order, and its lines above the
    last weight (lines of the last weight may be cut at the 30th edge)."""
    lines = mermaid.splitlines()
    weights = [int(m.group(1)) for m in map(
        re.compile(r".*-->\|(\d+)\|").match, lines[1:]) if m]
    last = min(weights, default=0)
    return lines[0], len(lines), weights, sorted(
        ln for ln, w in zip(lines[1:], weights) if w > last)


def query_text(res) -> str:
    """What `lattice query` prints for one result (`main.run_query`)."""
    lines = [res.answer]
    if res.results:
        lines.append("\nsources:")
        lines += [f"  {r.file_path}:{r.start_line} "
                  f"({r.qualified_name or r.name})" for r in res.results[:5]]
    return "\n".join(lines)


def live_graph(store) -> tuple:
    """A graph as a set: its live nodes (qualified name, type, file, lines)
    and each edge type's distinct (source, target) qualified-name pairs;
    with the number of edges that repeat a pair."""
    nodes = sorted((r.qualified_name, r.entity_type.value, r.file_path,
                    r.start_line, r.end_line)
                   for r in map(store.node, range(store.n_nodes()))
                   if store._alive[r.node_id])
    edges, repeats = {}, {}
    for et in store._edges:
        src, dst = store.edges(et)
        pairs = [(store._qns[a], store._qns[b])
                 for a, b in zip(src.tolist(), dst.tolist())]
        edges[et.value] = sorted(set(pairs))
        repeats[et.value] = len(pairs) - len(edges[et.value])
    return (nodes, edges), repeats


def row_bits(store) -> dict[str, bytes]:
    """Each live row's bf16 bits, keyed by its payload."""
    live = [r for r, p in enumerate(store._payloads) if p is not None]
    bits = store._emb[torch.as_tensor(live, device=store.device)].view(
        torch.int16).cpu().numpy()
    return {json.dumps(store._payloads[r], sort_keys=True): bits[i].tobytes()
            for i, r in enumerate(live)}


def phase_cli_path(ctx: dict, device: str = "cuda") -> None:
    """3j: the port's CLI on a copy of the golden fixture, each command a
    process of its own over one persisted index, against an in-process
    `QueryEngine` over the orchestrator's in-memory stores of another
    copy; then `FileWatcher` on that copy against a fresh index."""
    import asyncio
    import shutil
    import tempfile
    from lattice_tpu_torch.config.settings import Settings
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.metadata.repository import MetadataRepository
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.providers.factory import get_embedding_provider
    from lattice_tpu_torch.query.engine import QueryEngine
    from lattice_tpu_torch.storage import persistence
    t_phase = time.perf_counter()
    search, batch, _ = cli_texts(golden_cases())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cli_repo, own_repo = tmp / "cli" / "golden", tmp / "own" / "golden"
        shutil.copytree(GOLDEN, cli_repo)
        shutil.copytree(GOLDEN, own_repo)
        env_file = tmp / "cli.env"
        env_file.write_text("EMBEDDING_PROVIDER=hash\n"
                            f"EMBEDDING_DIMENSIONS={GOLDEN_DIM}\n")
        (tmp / "home").mkdir()
        lattice = CliProcesses(env_file, tmp / "home", device)
        settings = Settings.from_env(env_file)
        path = ["--path", str(cli_repo)]
        inproc: dict[str, float] = {}

        out, tail = lattice("index", "index", str(cli_repo), "--project",
                            CLI_PROJECT)
        require(f"indexed {CLI_PROJECT}:" in out and "file errors" not in out,
                f"index: {out[-500:]}")
        manifest = persistence.read_manifest(cli_repo / ".lattice")
        require(manifest["dtype"] == "bfloat16"
                and manifest["dims"] == GOLDEN_DIM, f"manifest {manifest}")
        if device == "cuda":
            require(tail["cuda_bytes"] > 0, "index held nothing on the card")

        embedder = Embedder(get_embedding_provider(
            settings.ai, finetune_dir=own_repo / settings.storage.data_dir,
            device=device), batch_size=settings.indexing.embed_batch_size)
        t0 = time.perf_counter()
        run = asyncio.run(PipelineOrchestrator(
            own_repo, embedder, project_name=CLI_PROJECT, settings=settings,
            device=device).run())
        inproc["index"] = time.perf_counter() - t0
        require(run.errors == [], f"in-process index: {run.errors[:3]}")
        engine = QueryEngine(run.graph_builder.store, run.indexer, None,
                             settings.query)
        plan = run.indexer.code._plan_search(1, GOLDEN_LIMIT, None, "auto")
        log(f"3j: in-process index of the second copy in "
            f"{inproc['index']:.3f} s; the store's B=1 auto plan {plan!r}")

        permuted, other = 0, set()

        def compare(got, results, where):
            nonlocal permuted
            a, b = same_cli_results(got, results, where)
            permuted += a
            other.update(b)

        for i, text in enumerate(search):
            out, _ = lattice(f"search {i}", "search", text, *path, "--json")
            t0 = time.perf_counter()
            res = engine.search_sync(text)
            inproc[f"search {i}"] = time.perf_counter() - t0
            compare(json.loads(out), res.results, f"search {text!r}")
        for i, text in enumerate(search[:CLI_DEEP]):
            out, _ = lattice(f"deep {i}", "search", text, *path, "--deep",
                             "--json")
            t0 = time.perf_counter()
            res = engine.deep_search(text)
            inproc[f"deep {i}"] = time.perf_counter() - t0
            compare(json.loads(out), res.results, f"search --deep {text!r}")
        batch_file = tmp / "questions.txt"
        batch_file.write_text("\n".join(batch) + "\n")
        out, _ = lattice("batch", "search", *path, "--json", "--batch-file",
                         str(batch_file))
        t0 = time.perf_counter()
        want = engine.deep_search_batch(batch)
        inproc["batch"] = time.perf_counter() - t0
        got = json.loads(out)
        require([g["query"] for g in got] == batch, "batch: queries")
        for g, w in zip(got, want):
            require(g["intent"] == w.query_plan.intent.value,
                    f"batch {w.query!r}: intent")
            compare(g["results"], w.results, f"--batch-file {w.query!r}")
        reordered = 0
        for i, text in enumerate(search[:CLI_QUERY]):
            out, _ = lattice(f"query {i}", "query", text, *path)
            t0 = time.perf_counter()
            res = engine.query_sync(text)
            inproc[f"query {i}"] = time.perf_counter() - t0
            reordered += same_query_text(out, res, f"query {text!r}")
        log(f"3j: search x{CLI_SEARCH}, --deep x{CLI_DEEP}, --batch-file of "
            f"{CLI_BATCH}: names and scores equal to the in-process engine's "
            f"({permuted} runs of exactly tied scores in another order; "
            f"other fields that differ somewhere: {sorted(other)}); query "
            f"x{CLI_QUERY}: the same text ({reordered} with tied lines in "
            f"another order)")

        out, _ = lattice("status", "status", *path)
        stats = engine.get_statistics()
        for line in (f"project: {CLI_PROJECT}",
                     f"provider: hash ({GOLDEN_DIM}d, bfloat16)",
                     f"files indexed: {len(run.files)}",
                     f"graph: {stats['graph']['nodes']} nodes, "
                     f"edges={stats['graph']['edges']}",
                     f"vectors: code={len(run.indexer.code)}, "
                     f"summaries={len(run.indexer.summaries)}"):
            require(line in out.splitlines(), f"status lacks {line!r}: {out}")
        out, _ = lattice("projects list", "projects", "list")
        require(out.split() == [CLI_PROJECT, str(cli_repo),
                                f"({len(run.files)}", "files)"],
                f"projects list: {out!r}")
        out, _ = lattice("projects show", "projects", "show", CLI_PROJECT)
        require(json.loads(out) == {**manifest, "file_hashes": len(
            manifest["file_hashes"])}, f"projects show: {out[:300]}")
        out, _ = lattice("metadata show", "metadata", "show", *path,
                         "--project", CLI_PROJECT)
        shown = json.loads(out)
        mine = MetadataRepository(own_repo / settings.storage.data_dir
                                  ).get_latest(CLI_PROJECT)
        differ = sorted(k for k in shown.keys() | mine.keys()
                        if k not in ("field_timings_ms",
                                     "architecture_diagram")
                        and shown.get(k) != mine.get(k))
        if diagram_key(shown["architecture_diagram"]) != diagram_key(
                mine["architecture_diagram"]):
            differ.append("architecture_diagram")
        require(shown["status"] == "completed" and shown["version"] == 1
                and not differ, f"metadata show: fields {differ} differ "
                f"from the in-process index's: "
                f"{[(shown.get(k), mine.get(k)) for k in differ][:2]}")
        out, _ = lattice("settings", "settings")
        require(json.loads(out) == json.loads(json.dumps(
            dataclasses.asdict(settings))), "settings")

        t0 = time.perf_counter()
        persistence.save_index(tmp / "saved", run.graph_builder.store,
                               run.indexer, project=CLI_PROJECT,
                               provider="hash", file_hashes={})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        persistence.load_index(tmp / "saved", embedder, device=device)
        load_s = time.perf_counter() - t0
        for label, wall, import_s, main_s in lattice.times:
            own = inproc.get(label)
            log(f"3j process `{label}`: {wall:.3f} s start to exit (imports "
                f"{import_s:.3f} s, main() {main_s:.3f} s)"
                + (f"; the same call in-process {own * 1e3:.3f} ms"
                   if own is not None else "") + f"; {ctx.get('smi', '')}")
        log(f"3j: golden index save_index {save_s:.3f} s, load_index "
            f"{load_s:.3f} s (in-process, {device}); {ctx.get('smi', '')}")

        if device == "cuda":
            for name in ("scan_topk_int8", "merge_candidates"):
                require(lattice.launches.get(name, 0) > 0,
                        f"{name} never ran in a CLI process")
        # the processes' launches count with this process's own
        for k in _build.KERNELS:
            k.launches += lattice.launches.get(k.name, 0)
            for e, n in lattice.by_kernel.get(k.name, {}).items():
                k.entry_launches[e] = k.entry_launches.get(e, 0) + n
        log(f"3j: launches in the CLI processes {lattice.launches}, by C "
            f"entry {lattice.by_kernel}")
        # 3l serves the persisted index (its copy outlives this directory)
        keep = Path(tempfile.mkdtemp(prefix="lattice_serve_"))
        shutil.copytree(cli_repo, keep / "golden")
        shutil.copy(env_file, keep / "cli.env")
        ctx["cli_index"] = keep
        phase_cli_watch(own_repo, run, embedder, settings, device)
    log(f"phase 3j took {time.perf_counter() - t_phase:.2f} s")


def phase_cli_watch(repo: Path, run, embedder, settings, device: str) -> None:
    """3j(b): `FileWatcher` (inotify) over the in-process index: one file
    changed, one created, one deleted; the stores then hold what a fresh
    index of the mutated tree holds, and answer alike."""
    import asyncio
    from lattice_tpu_torch.embeddings.indexer import VectorSearcher
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.pipeline.watcher import FileWatcher
    from lattice_tpu_torch.query.engine import QueryEngine
    watcher = FileWatcher(repo, run.graph_builder, run.indexer, run.parser,
                          settings, CLI_PROJECT, backend="inotify")
    try:
        watcher.prime(run.parsed)
        changed = repo / WATCH_CHANGED
        changed.write_text(changed.read_text() + "\n\ndef watched_helper("
                           "text):\n    return changed_ratio(text, text)\n")
        (repo / WATCH_CREATED).write_text("def created_by_watch(x):\n"
                                          "    return x + 1\n")
        (repo / WATCH_DELETED).unlink()
        events = watcher.detect_once()
        kinds = sorted((e.kind, e.relative_path) for e in events)
        require(kinds == [("changed", WATCH_CHANGED),
                          ("created", WATCH_CREATED),
                          ("deleted", WATCH_DELETED)], f"events {kinds}")
        t0 = time.perf_counter()
        asyncio.run(watcher.process_events(events))
        if device == "cuda":
            torch.cuda.synchronize()
        watch_s = time.perf_counter() - t0
        require(watcher.stats.updated == 2 and watcher.stats.deleted == 1
                and watcher.stats.errors == 0, f"watch {watcher.stats}")
        backend = watcher.backend_name
    finally:
        watcher.close()
    t0 = time.perf_counter()
    fresh = asyncio.run(PipelineOrchestrator(
        repo, embedder, project_name=CLI_PROJECT, settings=settings,
        device=device).run())
    fresh_s = time.perf_counter() - t0
    require(fresh.errors == [], f"fresh index: {fresh.errors[:3]}")
    (graph_w, rep_w), (graph_f, rep_f) = (
        live_graph(run.graph_builder.store),
        live_graph(fresh.graph_builder.store))
    require(graph_w == graph_f, "the watched graph differs from a fresh "
            "index of the mutated tree")
    a, b = run.indexer.code, fresh.indexer.code
    require(a.device.type == b.device.type == torch.device(device).type,
            "stores off the device")
    require(row_bits(a) == row_bits(b), "the watched code store's payloads "
            "and bf16 rows differ from a fresh index's")
    watched, new = QueryEngine(run.graph_builder.store, run.indexer), \
        QueryEngine(fresh.graph_builder.store, fresh.indexer)
    swaps = 0
    for case in golden_cases():
        text = case["query"]
        swaps += len(compare_top(watched.search_sync(text, limit=K).results,
                                 new.search_sync(text, limit=K).results,
                                 f"watched vs fresh {text!r}"))
        got = VectorSearcher(run.indexer).search_code(text, GOLDEN_LIMIT)
        want = VectorSearcher(fresh.indexer).search_code(text, GOLDEN_LIMIT)
        # row ids differ, so rows of exactly equal scores may swap
        require([h.score for h in got] == [h.score for h in want]
                and sorted((h.score, h.graph_node_id, h.start_line)
                           for h in got)
                == sorted((h.score, h.graph_node_id, h.start_line)
                          for h in want),
                f"search_code({text!r}) differs after the watch")
    log(f"3j(b): FileWatcher ({backend}) applied "
        f"{len(events)} events in {watch_s:.3f} s (a fresh index took "
        f"{fresh_s:.3f} s): live graph ({len(graph_w[0])} nodes), code "
        f"payloads and bf16 rows ({len(a)}) equal a fresh index's; edges "
        f"that repeat a pair: watched {rep_w}, fresh {rep_f} (the JAX "
        f"package's `rebuild_file` re-adds the others too); 104 golden "
        f"questions through "
        f"search_sync ({swaps} near-tie swaps) and search_code equal")


def phase_cli_roundtrip(ctx: dict) -> None:
    """3j(c), on corpus B while it is resident (after 4b): its store
    through `save_chunks` / `load_chunks` on the card with its IVF
    partition. The rows come back bit-equal in the compacted order, the
    partition and its verdict without k-means, and "ivf" searches give
    the same ids (mapped to the compacted rows) and scores."""
    import tempfile
    from lattice_tpu_torch.ops.ivf import IVFIndex
    from lattice_tpu_torch.storage import persistence
    store, q = ctx["store2"], ctx["queries2"]
    dev = store.device
    ivf_ = store._ivf
    require(ivf_ is not None and not store._ivf_dirty and not ivf_.hollow,
            "corpus B has no fresh partition to save")
    live = persistence.live_rows(store)

    def no_kmeans(*args, **kwargs):
        raise AssertionError("load_chunks ran k-means")
    with tempfile.TemporaryDirectory() as tmp:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        persistence.save_chunks(store, Path(tmp), "corpus_b")
        save_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in Path(tmp).iterdir())
        build = IVFIndex.build_from_device
        IVFIndex.build_from_device = no_kmeans
        try:
            t0 = time.perf_counter()
            loaded = persistence.load_chunks(Path(tmp), "corpus_b",
                                             store.dim, "bfloat16", device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            IVFIndex.build_from_device = build
    n = len(live)
    idx = torch.as_tensor(live, device=dev)
    require(len(loaded) == n and torch.equal(
        loaded._emb[:n].view(torch.int16), store._emb[idx].view(torch.int16)),
        "reloaded rows are not bit-equal")
    require(loaded._payloads[:n] == [store._payloads[r] for r in live],
            "reloaded payloads differ")
    got = loaded._ivf
    require(got is not None and not loaded._ivf_dirty and not got.hollow
            and got.measured_recall == ivf_.measured_recall
            and got.measured_nprobe == ivf_.measured_nprobe
            and torch.equal(got.centroids, ivf_.centroids),
            "the partition or its verdict was not restored")
    s, i = store.search_device(q, K, method="ivf")
    s2, i2 = loaded.search_device(q, K, method="ivf")
    require(bool((i >= 0).all()), "'ivf' gave empty slots")
    remap = torch.full((store.capacity,), -1, dtype=torch.int64, device=dev)
    remap[idx] = torch.arange(n, device=dev)
    require(torch.equal(remap[i.long()], i2.long()) and torch.equal(s, s2),
            "'ivf' searches differ after the reload")
    log(f"3j(c): corpus B, {n} rows x {store.dim} bf16 and its partition (C="
        f"{got.n_clusters}, "
        f"recall {got.measured_recall:.4f} at nprobe {got.measured_nprobe}): "
        f"save_chunks {save_s:.3f} s ({size / 1e9:.3f} GB on disk), "
        f"load_chunks {load_s:.3f} s without k-means; rows bit-equal, 'ivf' "
        f"at B={q.shape[0]} the same ids and scores; {ctx.get('smi', '')}")
    del loaded


def probe_plain_chunked(q, probe, data, ids, k, max_batch=32):
    """`ivf_search_batch`'s probe step, `max_batch` queries at a time (as
    `IVFIndex.search` chunks it)."""
    from lattice_tpu_torch.ops import ivf
    outs = [ivf.probe_topk_plain(q[lo:lo + max_batch],
                                 probe[lo:lo + max_batch], data, ids, k)
            for lo in range(0, q.shape[0], max_batch)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def phase_ivf_kernels(err: dict) -> None:
    """`ivf_probe` + kernel B against the plain probe step on buckets of
    S=1000 slots: 90% of the slots hold rows, the rest are -1 holes, and a
    filter mask drops a fifth of the rows."""
    from lattice_tpu_torch.core.errors import KernelError
    from lattice_tpu_torch.ops import ivf, scan_topk as scan
    from lattice_tpu_torch.ops.topk import NEG_INF
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    s_slots = 1000
    cases = ((1024, DIM, torch.bfloat16), (7, DIM, torch.float32),
             (7, 100, torch.bfloat16), (7, 100, torch.float32))
    for c, d, dtype in cases:
        n = c * s_slots * 9 // 10
        emb = normalize(torch.randn(n, d, device="cuda", generator=gen)
                        ).to(dtype)
        slots = torch.randperm(c * s_slots, device="cuda", generator=gen)
        ids = torch.full((c * s_slots,), -1, dtype=torch.int32, device="cuda")
        ids[slots[:n]] = torch.arange(n, dtype=torch.int32, device="cuda")
        ids = ids.view(c, s_slots)
        data = emb[ids.clamp(min=0).long()] * (ids >= 0)[..., None].to(dtype)
        mask = torch.rand(n, device="cuda", generator=gen) > 0.2
        masked = ivf._mask_bucket_ids(ids, mask)
        cent = normalize(torch.randn(c, d, device="cuda", generator=gen))
        for b in (1, 16, 256):
            q = normalize(torch.randn(b, d, device="cuda", generator=gen))
            for nprobe in sorted({1, min(8, c), c}):
                probe = ivf.probe_table(q, cent, nprobe)
                for k in (1, 10, 64):
                    ks, ki = ivf.probe_topk(q, probe, data, masked, k)
                    torch.cuda.synchronize()
                    ps, pi = probe_plain_chunked(q, probe, data, masked, k)
                    agree = (ki == pi).float().mean().item()
                    e = (ks - ps).abs().max().item()
                    where = f"C={c} d={d} {dtype} B={b} nprobe={nprobe} k={k}"
                    k_eff = min(k, nprobe * s_slots)
                    require(ks.shape == ps.shape == (b, k_eff),
                            f"ivf_probe shape {tuple(ks.shape)} {where}")
                    require(agree >= 0.999 and e < 1e-4,
                            f"ivf_probe: ids agree on {agree:.4f}, max score "
                            f"error {e:.3g} {where}")
                    require(bool((ki[ks > NEG_INF / 2] >= 0).all()),
                            f"ivf_probe: -1 among live results {where}")
                    err["ivf_probe"] = max(err["ivf_probe"], e)
                    if nprobe == c:  # every bucket: the exact scan
                        live = torch.zeros(n, dtype=torch.bool, device="cuda")
                        live[masked[masked >= 0].long()] = True
                        es, ei = scan.scan_topk_plain(q, emb, live, k)
                        ea = (ki == ei).float().mean().item()
                        require(ea >= 0.999
                                and (ks - es).abs().max().item() < 1e-4,
                                f"ivf_probe at nprobe=C against the exact "
                                f"scan: ids agree on {ea:.4f} {where}")
            log(f"kernels ok: ivf_probe C={c} S={s_slots} d={d} {dtype} B={b}")
        # the fused entry (probe table + kernel) against ivf_search_batch
        q = normalize(torch.randn(16, d, device="cuda", generator=gen))
        fs, fi = ivf.ivf_search_fused(q, cent, data, masked, min(8, c), 10)
        bs, bi = ivf.ivf_search_batch(q, cent, data, masked, 10, min(8, c))
        require((fi == bi).float().mean().item() >= 0.999
                and (fs - bs).abs().max().item() < 1e-4,
                f"ivf_search_fused differs from ivf_search_batch C={c} d={d}")
        del emb, data, ids, masked
    try:
        ivf.probe_topk(q, ivf.probe_table(q, cent, 1), torch.zeros(
            (7, 200, d), dtype=torch.bfloat16, device="cuda"),
            torch.zeros((7, 200), dtype=torch.int32, device="cuda"),
            scan.MAX_K1 + 1)
    except KernelError as exc:
        log(f"ivf_probe refuses k past MAX_K1: {exc}")
    else:
        raise AssertionError("ivf_probe took k past MAX_K1")


def index_store(centers: torch.Tensor, gen: torch.Generator, spread: float):
    """A VectorIndexer whose code store holds N_ROWS rows around `centers`
    at `spread`, added in batches with payloads."""
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.embeddings.indexer import VectorIndexer
    from lattice_tpu_torch.providers.hash_provider import HashEmbedder
    t0 = time.perf_counter()
    indexer = VectorIndexer(Embedder(HashEmbedder(dimensions=DIM)),
                            dtype="bfloat16", initial_capacity=N_ROWS,
                            device="cuda")
    store = indexer.code
    for lo in range(0, N_ROWS, ADD_BATCH):
        hi = min(lo + ADD_BATCH, N_ROWS)
        rows = store.add(cluster_rows(centers, hi - lo, gen, spread),
                         payloads(lo, hi))
        require(rows == list(range(lo, hi)), "add assigned unexpected rows")
    torch.cuda.synchronize()
    log(f"indexed {len(store)} rows x {DIM} (bf16, spread {spread}) in "
        f"{time.perf_counter() - t0:.1f} s; store {store.stats}")
    require(len(store) == N_ROWS and store.capacity == N_ROWS,
            f"store holds {len(store)} rows, capacity {store.capacity}")
    return indexer, store


TEXTS = ["drain the webhook delivery queue", "parse config file",
         "retry with exponential backoff", "bakoco handler"]


def phase_main_path(ctx: dict) -> None:
    from lattice_tpu_torch.embeddings.indexer import VectorSearcher
    from lattice_tpu_torch.index import chunk_store as cs
    from lattice_tpu_torch.index.chunk_store import name_token_set

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    centers = cluster_centers(gen, N_CLUSTERS, DIM)
    ctx["centers"], ctx["gen"] = centers, gen
    indexer, store = index_store(centers, gen, SPREAD)
    searcher = VectorSearcher(indexer)
    texts = TEXTS
    # the first small-batch auto call: on this near-isotropic corpus the IVF
    # partition is built, measures its recall under the bar, releases its
    # buckets and the plan serves the flat tier
    require(store._ivf is None, "an IVF partition exists before any small "
            "batch was planned")
    t0 = time.perf_counter()
    hits = searcher.search_code(texts[0], limit=15)
    first_s = time.perf_counter() - t0
    if cs.IVF_SMALL_BATCH >= 1:
        ivf_ = store._ivf
        require(ivf_ is not None and ivf_.hollow and not store._ivf_dirty,
                "the first B=1 auto call did not build and release the IVF")
        require(ivf_.measured_recall < cs.IVF_MIN_RECALL,
                f"IVF recall {ivf_.measured_recall} on the isotropic corpus")
        log(f"IVF refused on spread {SPREAD}: built in "
            f"{ivf_.build_seconds:.2f} s, recall@{K} at nprobe "
            f"{ivf_.measured_nprobe} {ivf_.measured_recall:.4f} < "
            f"{cs.IVF_MIN_RECALL}; first search_code {first_s:.2f} s; "
            f"now {ivf_.memory_bytes()} bytes (hollow)")
    else:
        require(store._ivf is None, "auto planned IVF at IVF_SMALL_BATCH=0")
    require(store._plan_search(1, 15, None, "auto") == "quantized",
            "the B=1 auto plan on the isotropic corpus is not 'quantized'")

    q = cluster_rows(centers, 256, gen)
    emb, valid = store.device_arrays
    truth = exact_topk(q, emb, valid, K)
    plan = store._plan_search(256, K, None, "auto")
    require(plan == "quantized", f"auto plan at B=256 is {plan!r}")
    ctx["queries"] = q
    for method, kernel in (("quantized", "scan_topk_int8"),
                           ("pallas", "scan_topk")):
        from lattice_tpu_torch.ops import _build
        before = _build.launch_counts()[kernel]
        s, i = store.search_device(q, K, method="auto" if method ==
                                   "quantized" else method)
        torch.cuda.synchronize()
        require(_build.launch_counts()[kernel] > before,
                f"{method}: {kernel} was not launched")
        require(s.shape == (256, K) and i.shape == (256, K)
                and bool(torch.isfinite(s).all()), f"{method}: bad output")
        require(bool((s[:, :-1] >= s[:, 1:]).all()), f"{method}: unsorted")
        r = recall(i, truth)
        ctx[f"recall_{method}"] = r
        log(f"search_device plan {method!r}: recall@{K} {r:.4f}")
        require(r >= RECALL_MIN, f"{method}: recall@{K} {r:.4f} < {RECALL_MIN}")
    resident = store._quant.memory_bytes() + emb.numel() * emb.element_size()
    log(f"resident: rows {emb.numel() * emb.element_size() / 1e9:.2f} GB "
        f"+ int8 shadow {store._quant.memory_bytes() / 1e9:.2f} GB "
        f"= {resident / 1e9:.2f} GB")

    sm, _ = store.search_device(q[:8], K)
    require(bool(torch.isfinite(sm).all()), "bad scores")
    for text in texts:
        hits = searcher.search_code(text, limit=15)
        require(len(hits) == 15 and all(h.file_path and h.name for h in hits),
                f"search_code({text!r}) gave {len(hits)} hits")
    hits = searcher.search_code(texts[0], limit=15)
    target = hits[3].file_path
    filtered = searcher.search_code(texts[0], limit=15,
                                    filters={"file_path": target})
    require(0 < len(filtered) <= ROWS_PER_FILE
            and all(h.file_path == target for h in filtered),
            f"file filter returned {[h.file_path for h in filtered]}")
    n_del = indexer.delete_file(target)
    require(n_del == ROWS_PER_FILE, f"delete_file removed {n_del} rows")
    after = searcher.search_code(texts[0], limit=15)
    gone = {h.row for h in filtered}
    require(all(h.file_path != target and h.row not in gone for h in after),
            "deleted rows came back")
    require(searcher.search_code(texts[0], limit=15,
                                 filters={"file_path": target}) == [],
            "a deleted file still matches its filter")
    s_after, i_after = store.search_device(q, K)
    require(not bool(torch.isin(i_after, torch.as_tensor(
        sorted(gone), device="cuda", dtype=torch.int32)).any()),
        "deleted rows came back on the device path")
    token = sorted(name_token_set(hits[0].name))[0]
    t0 = time.perf_counter()
    lex = store.lexical_candidates({token}, limit=10)
    require(len(lex) == 10 and all(
        token in name_token_set(store.payload(r)["name"]) for r, _ in lex),
        f"lexical_candidates({token!r}) gave {lex}")
    log(f"search_code / filter / delete_file ({n_del} rows) / "
        f"lexical_candidates({token!r}, {time.perf_counter() - t0:.1f} s) ok")
    ctx["store"], ctx["indexer"] = store, indexer


def phase_int4_path(ctx: dict) -> None:
    """3d: the int4 tier and the refined scan on corpus A's store."""
    import os
    from lattice_tpu_torch.embeddings.indexer import VectorSearcher
    store, q = ctx["store"], ctx["queries"]
    searcher = VectorSearcher(ctx["indexer"])
    require(store._int4 is None, "an int4 view exists before LATTICE_INT4")
    os.environ["LATTICE_INT4"] = "1"
    for b in (1, 256):
        plan = store._plan_search(b, K, None, "auto")
        require(plan == "int4", f"LATTICE_INT4=1: the B={b} plan is {plan!r}")
    emb, valid = store.device_arrays
    truth = exact_topk(q, emb, valid, K)   # after phase 3a's deletions
    s, i = store.search_device(q, K)
    torch.cuda.synchronize()
    require(s.shape == (256, K) and bool(torch.isfinite(s).all())
            and bool((s[:, :-1] >= s[:, 1:]).all()), "int4: bad output")
    r256 = recall(i, truth)
    ones = torch.cat([store.search_device(q[j:j + 1], K)[1]
                      for j in range(64)])
    r1 = recall(ones, truth[:64])
    view = store._int4
    log(f"LATTICE_INT4=1: plan 'int4' recall@{K} {r256:.4f} at B=256, "
        f"{r1:.4f} over 64 calls at B=1; int4 view "
        f"{view.memory_bytes() / 1e9:.3f} GB beside the bf16 rows")
    require(min(r256, r1) >= INT4_RECALL_MIN,
            f"int4 recall@{K} {r256:.4f} / {r1:.4f} < {INT4_RECALL_MIN}")
    ctx["recall_int4"], ctx["recall_int4_b1"] = r256, r1
    s, i = store.search_device(q, K, method="refined")
    torch.cuda.synchronize()
    r = recall(i, truth)
    ctx["recall_refined"] = r
    log(f"forced 'refined': recall@{K} {r:.4f}")
    require(r >= RECALL_MIN, f"refined recall@{K} {r:.4f} < {RECALL_MIN}")
    hits = searcher.search_code(TEXTS[2], limit=15)
    one_file = {"file_path": hits[0].file_path}
    require(store._plan_search(1, 15, one_file, "auto") == "int4",
            "a file filter is not served through 'int4'")
    got = searcher.search_code(TEXTS[2], limit=15, filters=one_file)
    require(0 < len(got) <= ROWS_PER_FILE
            and all(h.file_path == one_file["file_path"] for h in got),
            f"file filter through int4 gave {[h.file_path for h in got]}")
    new = cluster_rows(ctx["centers"], 10, ctx["gen"])
    rows = store.add(new, payloads(N_ROWS, N_ROWS + 10))
    require(store._int4 is view and not store._int4_dirty,
            "add rebuilt or dirtied the int4 view")
    _, i_new = store.search_device(new, 1)
    require(i_new[:, 0].tolist() == rows,
            f"added rows not found through int4: {i_new[:, 0].tolist()} vs "
            f"{rows}")
    del os.environ["LATTICE_INT4"]
    log(f"int4: file filter ({len(got)} hits), add of 10 rows in place "
        f"found ok")


def phase_ivf_path(ctx: dict) -> None:
    """The IVF path on the clustered corpus (the first store is freed)."""
    from lattice_tpu_torch.embeddings.indexer import VectorSearcher
    from lattice_tpu_torch.index import chunk_store as cs
    centers, gen = ctx["centers"], ctx["gen"]
    indexer, store = index_store(centers, gen, IVF_SPREAD)
    searcher = VectorSearcher(indexer)
    t0 = time.perf_counter()
    hits = searcher.search_code(TEXTS[0], limit=15)
    first_s = time.perf_counter() - t0
    require(len(hits) == 15, f"search_code gave {len(hits)} hits")
    plan1 = store._plan_search(1, K, None, "auto")
    if cs.IVF_SMALL_BATCH >= 1:
        ivf_ = store._ivf
        require(plan1 == "ivf" and ivf_ is not None and not ivf_.hollow,
                f"the B=1 auto plan on the clustered corpus is {plan1!r}")
        require(ivf_.measured_recall >= cs.IVF_MIN_RECALL,
                f"IVF self-measured recall {ivf_.measured_recall}")
    else:
        require(plan1 != "ivf", "auto took IVF at IVF_SMALL_BATCH=0")
        store.build_ivf()
        ivf_ = store._ivf
    log(f"IVF on spread {IVF_SPREAD}: built in {ivf_.build_seconds:.2f} s "
        f"(first search_code {first_s:.2f} s, recall self-measure "
        f"included); C={ivf_.n_clusters} S={ivf_.bucket_size}; "
        f"{ivf_.memory_bytes() / 1e9:.3f} GB; recall@{K} at nprobe "
        f"{ivf_.measured_nprobe} {ivf_.measured_recall:.4f}; B=1 auto plan "
        f"{plan1!r}")
    for text in TEXTS[1:]:
        hits = searcher.search_code(text, limit=15)
        require(len(hits) == 15 and all(h.file_path and h.name for h in hits),
                f"search_code({text!r}) gave {len(hits)} hits")

    q = cluster_rows(centers, 256, gen, IVF_SPREAD)
    emb, valid = store.device_arrays
    truth = exact_topk(q, emb, valid, K)
    s, i = store.search_device(q, K, method="ivf")
    torch.cuda.synchronize()
    require(s.shape == (256, K) and bool(torch.isfinite(s).all())
            and bool((s[:, :-1] >= s[:, 1:]).all()), "ivf: bad output")
    r = recall(i, truth)
    ctx["recall_ivf"] = r
    require(r >= cs.IVF_MIN_RECALL, f"ivf recall@{K} {r:.4f}")
    _, iq = store.search_device(q, K, method="quantized")
    ctx["recall_quantized_clustered"] = recall(iq, truth)
    log(f"search_device at B=256: recall@{K} plan 'ivf' {r:.4f}, plan "
        f"'quantized' {ctx['recall_quantized_clustered']:.4f} (information)")

    lang = {"language": "go"}
    require(store._plan_search(1, 15, lang, "auto")
            == ("ivf" if cs.IVF_SMALL_BATCH >= 1 else "quantized"),
            "a 25% filter is not served by IVF")
    hits = searcher.search_code(TEXTS[1], limit=15, filters=lang)
    require(len(hits) == 15 and all(h.language == "go" for h in hits),
            "language filter through IVF")
    one_file = {"file_path": hits[0].file_path}
    require(store._plan_search(1, 15, one_file, "auto") == "quantized",
            "a one-file filter is served by IVF")
    got = searcher.search_code(TEXTS[1], limit=15, filters=one_file)
    require(0 < len(got) <= ROWS_PER_FILE
            and all(h.file_path == one_file["file_path"] for h in got),
            "one-file filter")

    target = hits[1].file_path
    dead = sorted(store._filter_rows({"file_path": target}))
    before = store._ivf
    require(indexer.delete_file(target) == ROWS_PER_FILE, "delete_file")
    new = cluster_rows(centers, 10, gen, IVF_SPREAD)
    lo = N_ROWS
    rows = store.add(new, payloads(lo, lo + 10))
    require(set(rows) <= set(dead) and len(store) == N_ROWS - 40
            and store.capacity == N_ROWS, f"add reused {rows}")
    require(store._ivf is before and not store._ivf_dirty,
            "delete_file + add rebuilt or dirtied the IVF partition")
    s_new, i_new = store.search_device(new, 1, method="ivf")
    require(i_new[:, 0].tolist() == rows, f"added rows not found: "
            f"{i_new[:, 0].tolist()} vs {rows}")
    gone = torch.as_tensor(sorted(set(dead) - set(rows)), device="cuda",
                           dtype=torch.int32)
    _, i_after = store.search_device(q, K, method="ivf")
    require(not bool(torch.isin(i_after, gone).any()),
            "deleted rows came back through IVF")
    require(searcher.search_code(TEXTS[0], limit=15,
                                 filters={"file_path": target}) == [],
            "a deleted file still matches its filter")
    log(f"IVF: 25% filter served, one-file filter to 'quantized', "
        f"delete_file ({ROWS_PER_FILE}) + add (10 into freed rows) without "
        f"a rebuild ok")
    ctx["store2"], ctx["queries2"] = store, q


def phase_timings(ctx: dict, kernels_ms: dict, err: dict, smi: str) -> None:
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    store, q256 = ctx["store"], ctx["queries"]
    for method in ("quantized", "pallas"):
        ms = cuda_ms(lambda: store.search_device(q256, K, method=method), 20)
        lat = []
        for j in range(50):
            t0 = time.perf_counter()
            store.search_device(q256[j:j + 1], K, method=method)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        log(f"search_device {method}: B=256 {ms:.3f} ms/batch = "
            f"{256 / ms * 1e3:.0f} QPS; B=1 p50 "
            f"{statistics.median(lat):.3f} ms")
        ctx[f"qps_{method}"] = 256 / ms * 1e3
        ctx[f"p50_{method}"] = statistics.median(lat)
    emb, valid = store.device_arrays
    view = store._quant
    n = emb.shape[0]
    k1 = scan.first_stage_width(K, n)
    for b in (1, 256):
        q = q256[:b].contiguous()
        qv, qs = quant.quantize_rows_device(q)
        cs, ci = scan.scan_blocks(q, emb, valid, k1)
        m = cs.shape[1]
        rows = {
            "scan_topk": kernel_row(
                cuda_ms(lambda: scan.scan_blocks(q, emb, valid, k1), 10),
                cuda_ms(lambda: scan.scan_topk_plain(q, emb, valid, k1), 3, 1),
                scan_bound(n, DIM, b, k1, 2 * DIM, "bf16"), None,
                cuda_ms(lambda: q.to(torch.bfloat16) @ emb.T, 10)),
            "merge_candidates": merge_timing(cs, ci, k1, "kernel A lists",
                                             smi),
            "scan_topk_int8": kernel_row(
                cuda_ms(lambda: scan.scan_blocks_int8(
                    qv, qs, view.values, view.scales, valid, k1), 10),
                cuda_ms(lambda: scan.scan_topk_int8_plain(
                    qv, qs, view.values, view.scales, valid, k1), 3, 1),
                scan_bound(n, DIM, b, k1, DIM, "int8"), None,
                cuda_ms(lambda: torch._int_mm(qv, view.values.T), 10)
                if b > 16 else None),
        }
        # kernels A's and C's wmma routes (the tile loops they ran before
        # wgmma, which now serve only shapes TMA cannot read) on the same
        # inputs
        for name, kernel, entry, ptrs in (
                ("scan_topk", scan.SCAN_TOPK, "lt_scan_topk_bf16_scalar",
                 (q.data_ptr(), emb.data_ptr(), valid.data_ptr())),
                ("scan_topk_int8", scan.SCAN_TOPK_INT8,
                 "lt_scan_topk_int8_scalar",
                 (qv.data_ptr(), qs.data_ptr(), view.values.data_ptr(),
                  view.scales.data_ptr(), valid.data_ptr()))):
            wmma_ms = cuda_ms(lambda: scan._launch_scan(
                kernel, entry, k1, b, n, DIM, 1, ptrs, valid.device), 10)
            log(f"kernel {name} B={b} k1={k1}: wgmma route "
                f"{rows[name]['ms']:.4f} ms, wmma route on the same inputs "
                f"{wmma_ms:.4f} ms ({smi})")
        # kernel B on the lists of the "pallas" / "refined" (A) and the
        # "quantized" (C) plans
        check_merge(cs, ci, k1, "kernel A lists", err)
        c_cs, c_ci = scan.scan_blocks_int8(qv, qs, view.values, view.scales,
                                           valid, k1)
        check_merge(c_cs, c_ci, k1, "kernel C lists", err)
        merge_timing(c_cs, c_ci, k1, "kernel C lists", smi)
        log(f"kernel B lists at B={b}: m={m} candidates per query")
        for name, row in rows.items():
            log(f"kernel {name} B={b} N={n} d={DIM} k1={k1}: "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
                f"{row['library_ms']}, product only {row['product_ms']}")
            if b == 256:
                kernels_ms[name] = row


def phase_int4_timings(ctx: dict, kernels_ms: dict, err: dict,
                       smi: str) -> None:
    """"int4" and "refined" through `search_device` on corpus A's store,
    and kernel D beside its plain version, its bound and the bare int8
    product over the unpacked rows."""
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    store, q256 = ctx["store"], ctx["queries"]
    for method in ("int4", "refined"):
        ms = cuda_ms(lambda: store.search_device(q256, K, method=method), 10)
        p50 = p50_ms(lambda j: store.search_device(q256[j:j + 1], K,
                                                   method=method))
        ctx[f"qps_{method}"], ctx[f"p50_{method}"] = 256 / ms * 1e3, p50
        log(f"search_device {method}: B=256 {ms:.3f} ms/batch = "
            f"{256 / ms * 1e3:.0f} QPS; B=1 p50 {p50:.3f} ms ({smi})")
    emb, valid = store.device_arrays
    view = store._int4
    n = view.n
    k1 = scan.int4_first_stage_width(K, n)
    for b in (1, 256):
        q = q256[:b].contiguous()
        qv, qs = quant.quantize_rows_device(q)
        product = None
        if b > 16:
            rows = quant.unpack_int4(view.values)
            product = cuda_ms(lambda: torch._int_mm(qv, rows.T), 10)
            del rows
        row = kernel_row(
            cuda_ms(lambda: scan.scan_blocks_int4(
                qv, qs, view.values, view.scales, valid, k1), 10),
            cuda_ms(lambda: scan.scan_topk_int4_plain(
                qv, qs, view.values, view.scales, valid, k1), 3, 1),
            scan_bound(n, DIM, b, k1, DIM / 2, "int8"), None, product)
        log(f"kernel scan_topk_int4 B={b} N={n} d={DIM} k1={k1}: "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), product only "
            f"{product} ({smi})")
        if b == 256:
            kernels_ms["scan_topk_int4"] = row
    # kernel B on kernel D's lists: the "int4" plan's k1 = 80 and the
    # longest lists (k1 = 512), at B = 1 and 256, and a shuffled copy
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for b, kk in ((1, k1), (256, k1), (1, scan.MAX_K1_LONG),
                  (256, scan.MAX_K1_LONG)):
        q = q256[:b].contiguous()
        qv, qs = quant.quantize_rows_device(q)
        cs, ci = scan.scan_blocks_int4(qv, qs, view.values, view.scales,
                                       valid, kk)
        check_merge(cs, ci, kk, "kernel D lists", err)
        merge_timing(cs, ci, kk, "kernel D lists", smi)
        if b == 256 and kk == k1:
            mix = torch.argsort(torch.rand(cs.shape, device="cuda",
                                           generator=gen), dim=1)
            check_merge(torch.gather(cs, 1, mix), torch.gather(ci, 1, mix),
                        kk, "shuffled kernel D lists", err)
        del cs, ci
    # what the list length costs: kernel D, and kernel C on the int8 view,
    # at B=256 and B=1 over k1 = 16 (the first stage alone), 32 (8k at
    # k <= 4), 80 (8k at k=10), 128 (8k at k=16) and 512 (8k at k=64, D
    # only, on its wmma route), beside the int4 floor (its probe at the
    # same B, at the instance and route D takes at that k1) and the
    # selection share (D ms - floor ms) / D ms
    from lattice_tpu_torch.ops.probe import score_probe
    from lattice_tpu_torch.tools.dissect import FLOOR_TILE
    i8 = store._quant
    for b in (256, 1):
        qv, qs = quant.quantize_rows_device(q256[:b].contiguous())
        sweep = {k1: (cuda_ms(lambda: scan.scan_blocks_int4(
            qv, qs, view.values, view.scales, valid, k1), 3, 1),
                      cuda_ms(lambda: score_probe(
            qv, view.values, tile=FLOOR_TILE, k1=k1), 3, 1),
                      cuda_ms(lambda: scan.scan_blocks_int8(
            qv, qs, i8.values, i8.scales, valid, k1), 3, 1)
                      if k1 <= scan.MAX_K1 else None)
                 for k1 in (16, 32, 80, 128, 512)}
        log(f"kernel D (C) at B={b} by list length: " + ", ".join(
                f"k1={k1} ({scan.int4_route(qv, view.values, k1)}): "
                f"{d_ms:.4f} ms, int4 floor {f_ms:.4f} ms, selection "
                f"{(d_ms - f_ms) / d_ms:.1%} ({c_ms})"
                for k1, (d_ms, f_ms, c_ms) in sweep.items()) + f" ({smi})")
    # the gate's worst case, timed once: every dimension +1 and positive
    # queries, row scales rising with the row id, so every tile beats
    # every list (kernel D at B=256, k1=80)
    qv, qs = quant.quantize_rows_device(q256)
    qpos = qv.abs().clamp(min=1).to(torch.int8)
    ones = torch.full_like(view.values, 0x19)
    rise = torch.linspace(0.01, 0.02, n, device="cuda")
    live = torch.ones_like(valid)
    ms = cuda_ms(lambda: scan.scan_blocks_int4(qpos, qs, ones, rise, live,
                                               k1), 3, 1)
    log(f"kernel D on rows whose scores rise with the row id, B=256 "
        f"k1={k1}: {ms:.4f} ms ({smi})")
    del ones, rise, live


def phase_dissect_path(ctx: dict) -> None:
    """3f: the dissection path on corpus A's store, its int8 and int4 views
    and the path's 256 queries (`tools/dissect.py`): every probe the
    round-2 scripts timed, kernels A, C and D at k1 = 16 and 80 beside
    their floors, the library products, `binned_topk` by batch, and a
    device-trace summary of a "quantized", an "int4" and a forced "refined"
    `search_device` call."""
    from lattice_tpu_torch.tools import dissect
    ctx["dissect"] = dissect.dissect(
        ctx["store"], ctx["queries"],
        str(Path(__file__).resolve().parent / "build" / "traces"), log)


# ---- 3i: the deep path at corpus scale -------------------------------------

DEEP_EDGES = 10_000_000    # power-law CALLS edges (BASELINE configs 4 and 5)
DEEP_HOPS = 5
DEEP_LIMIT = 50
DEEP_WALKS = 64            # k_hop_batch's queries
DEEP_TEXTS = 16            # deep_search's texts; the small batch
DEEP_BIG_BATCH = 130       # two chunks of DEEP_BATCH_CHUNK = 128
FUSED_Q = (1, 16, 128)     # kernel B on fused rows: queries ...
FUSED_K = (10, 50, 512)    # ... and widths


def deep_graph(store, seed: int):
    """The graph of the deep cell: a node for each distinct `graph_node_id`
    of the store's payloads (row order), 10,000,000 CALLS edges from
    uniform callers to power-law callees (u^4: a few hubs called from
    everywhere, a long tail of leaves) and an EXTENDS forest over 10% of
    the nodes, drawn as `bench.py:234-257` draws them. Returns the graph
    and its host build and finalize seconds."""
    from lattice_tpu_torch.core.types import EdgeType, EntityType
    from lattice_tpu_torch.index.graph_store import GraphStore
    names = list(dict.fromkeys(
        p["graph_node_id"] for p in store._payloads
        if p and p.get("graph_node_id")))
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    graph = GraphStore(device="cuda")
    graph.add_nodes_bulk(names, EntityType.FUNCTION, "synthetic.py")
    n = len(names)
    src = rng.integers(0, n, size=DEEP_EDGES, dtype=np.int64)
    dst = np.minimum((n * rng.random(DEEP_EDGES) ** 4).astype(np.int64),
                     n - 1)
    graph.add_edges_bulk(src, dst, EdgeType.CALLS)
    n_ext = max(n // 10, 1)
    child = rng.choice(n, size=n_ext, replace=False)
    parent = np.minimum((n * rng.random(n_ext) ** 4).astype(np.int64), n - 1)
    graph.add_edges_bulk(child, parent, EdgeType.EXTENDS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph.finalize()
    return graph, build_s, time.perf_counter() - t0


FREE_VERBS = ("drain", "parse", "retry", "render", "validate", "schedule",
              "encode", "flush", "resolve", "merge", "rotate", "sign")
FREE_NOUNS = ("webhook queue", "config file", "payment invoice",
              "socket timeout", "cache eviction", "schema migration",
              "token bucket", "email template", "upload chunk",
              "session cookie", "audit log", "rate limit")


def free_texts(n: int, seed: int) -> list[str]:
    """`n` distinct free-text searches ("<verb> the <noun>") drawn by seed:
    no entity to seed a walk, and no word of the corpus's name vocabulary,
    so their evidence is the cosine alone."""
    gen = np.random.default_rng(seed)
    pool = [f"{v} the {w}" for v in FREE_VERBS for w in FREE_NOUNS]
    return [pool[j] for j in gen.permutation(len(pool))[:n]]


def deep_texts(store, n: int, seed: int) -> list[str]:
    """`n` questions cycling over "who calls X?", "what does X call?" (X the
    bare function name of a row drawn by seed, which a few dozen graph
    nodes share, so it is found by exact name and no fuzzy scan of the
    million names runs) and a free-text search."""
    gen = np.random.default_rng(seed)
    live = np.flatnonzero(store._valid_host)
    free = free_texts(n, seed)
    out = []
    for j, row in enumerate(gen.choice(live, n, replace=False)):
        bare = store.payload(int(row))["name"].rsplit(".", 1)[-1]
        out.append((f"who calls {bare}?", f"what does {bare} call?",
                    free[j])[j % 3])
    return out


def same_deep(a: list, b: list, where: str, exact: bool = False) -> None:
    """Two result lists of one deep query: with `exact`, the same names,
    sources and scores bit for bit; else `compare_top`'s rule (near-tie
    swaps within QUERY_NEAR_TIE, scores within QUERY_SCORE_TOL) and equal
    sources where the names are equal."""
    if exact:
        require([(r.qualified_name, r.source, r.score) for r in a]
                == [(r.qualified_name, r.source, r.score) for r in b],
                f"{where}: results differ")
        return
    compare_top(a, b, where)
    for x, y in zip(a[:K], b[:K]):
        if x.qualified_name == y.qualified_name:
            require(x.source == y.source, f"{where}: {x.qualified_name} "
                    f"sources {x.source} / {y.source}")


def phase_deep_path(ctx: dict) -> None:
    """3i: the deep path on corpus A's store (1,048,576 x 768 bf16, one
    file deleted in 3a) and a 1M-node / 10M-edge graph of its
    `graph_node_id`s: `QueryEngine.deep_search` through its device branch
    (the store is past DEEP_DEVICE_THRESHOLD), equal to the same calls with
    the selection forced to its plain version (on the same evidence);
    `deep_search_batch` at Q=16 and Q=130 (two chunks; the 16 questions
    and 114 free-text searches) equal to the sequential calls;
    `GraphStore.k_hop(device=True)` and `k_hop_batch(device=True)` equal
    to the host walk; after `delete_file` the rank columns are rebuilt and
    the deleted rows never surface."""
    from lattice_tpu_torch.core.types import EdgeType
    from lattice_tpu_torch.ops import ranking
    from lattice_tpu_torch.ops import topk as topk_ops
    from lattice_tpu_torch.query.engine import QueryEngine
    t_phase = time.perf_counter()
    store, indexer = ctx["store"], ctx["indexer"]
    graph, build_s, fin_s = deep_graph(store, SEED + 3)
    times = {"graph_build_s": build_s, "graph_finalize_s": fin_s}
    t0 = time.perf_counter()
    for et in (EdgeType.CALLS, EdgeType.EXTENDS):
        for reverse in (False, True):
            graph.device_edges(et, reverse=reverse)
        graph.device_degree(et)
    graph.device_alive()
    torch.cuda.synchronize()
    times["device_upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = store.device_rank_columns(graph)
    torch.cuda.synchronize()
    times["rank_columns_s"] = time.perf_counter() - t0
    n_nodes = graph.n_nodes()
    joined = int((cols.node_ids >= 0).sum().item())
    log(f"deep cell: {n_nodes} nodes, {graph.n_edges(EdgeType.CALLS)} CALLS "
        f"+ {graph.n_edges(EdgeType.EXTENDS)} EXTENDS edges; {joined} of "
        f"{len(store)} rows joined to a node; host build "
        f"{build_s:.2f} s, finalize {fin_s:.2f} s, device upload (edges "
        f"both ways, degrees, liveness) {times['device_upload_s']:.2f} s, "
        f"rank columns {times['rank_columns_s']:.2f} s")
    require(joined == len(store), f"{joined} rows joined to a node")
    require(cols.degree.device.type == "cuda", "rank columns off the card")

    engine = QueryEngine(graph, indexer)
    require(store.capacity >= engine.DEEP_DEVICE_THRESHOLD,
            f"capacity {store.capacity} below the device threshold")
    texts = deep_texts(store, DEEP_TEXTS, SEED + 4)
    # each question's evidence, kept (with its host time) for the rerun
    # with the plain selection and for 3i's timings
    evidence, memo, ev_ms = engine._deep_evidence, {}, {}

    def kept(plan, walks=None, seeds=None):
        if plan.raw_query not in memo:
            t0 = time.perf_counter()
            memo[plan.raw_query] = evidence(plan, walks, seeds)
            ev_ms[plan.raw_query] = (time.perf_counter() - t0) * 1e3
        return memo[plan.raw_query]

    calls, lat = [0], []
    device_branch = engine._deep_search_device

    def counted(*args, **kwargs):
        calls[0] += 1
        return device_branch(*args, **kwargs)

    engine._deep_search_device, engine._deep_evidence = counted, kept
    singles = []
    for t in texts:
        t0 = time.perf_counter()
        singles.append(engine.deep_search(t, limit=K))
        lat.append((time.perf_counter() - t0) * 1e3)
    require(calls[0] == len(texts), f"{calls[0]} of {len(texts)} deep "
            f"searches took the device branch")
    for t, res in zip(texts, singles):
        check_results(engine, res, f"deep_search({t!r})")
        require(len(res.results) == K, f"deep_search({t!r}): "
                f"{len(res.results)} results")
    hybrid = sum(r.source.value == "hybrid" for s in singles
                 for r in s.results)
    # the same calls on the same evidence, the selection forced plain
    select = ranking._select_topk
    ranking._select_topk = lambda fused, k: topk_ops.stable_topk(
        fused, min(k, fused.shape[-1]))
    try:
        for t, res in zip(texts, singles):
            same_deep(res.results, engine.deep_search(t, limit=K).results,
                      f"deep_search({t!r}), plain selection", exact=True)
    finally:
        ranking._select_topk = select
        del engine._deep_search_device, engine._deep_evidence
    log(f"deep_search: {len(texts)} questions through the device branch, "
        f"{hybrid} of {len(texts) * K} results hybrid; equal to the plain "
        f"selection's on the same evidence, bit for bit")

    big = texts + free_texts(DEEP_BIG_BATCH - DEEP_TEXTS, SEED + 5)
    batch_ms = {}
    for batch_texts in (texts, big):
        q = len(batch_texts)
        t0 = time.perf_counter()
        batch = engine.deep_search_batch(batch_texts, limit=K)
        batch_ms[q] = (time.perf_counter() - t0) * 1e3
        require(len(batch) == q, f"deep_search_batch gave {len(batch)}")
        seq = singles + [engine.deep_search(t, limit=K)
                         for t in batch_texts[DEEP_TEXTS:]]
        for t, b, one in zip(batch_texts, batch, seq):
            same_deep(b.results, one.results,
                      f"deep_search_batch Q={q} {t!r}")
        log(f"deep_search_batch at Q={q} ({-(-q // engine.DEEP_BATCH_CHUNK)} "
            f"chunks) equals the sequential calls")

    # the graph's device traversals against the host walk
    rng = np.random.default_rng(SEED + 6)
    seeds = [rng.choice(n_nodes, int(rng.integers(1, 4)),
                        replace=False).tolist() for _ in range(DEEP_WALKS)]
    dev = graph.k_hop_batch(seeds, EdgeType.CALLS, DEEP_HOPS,
                            limit=DEEP_LIMIT, device=True)
    for s, d in zip(seeds, dev):
        host = graph.k_hop(s, EdgeType.CALLS, DEEP_HOPS, limit=DEEP_LIMIT)
        require(sorted((v, k) for k, v in d.items())
                == sorted((v, k) for k, v in host.items()),
                f"k_hop_batch(device=True) seeds {s}: not the host walk's "
                f"(depth, id) prefix")
    for s in seeds[:8]:
        for reverse in (False, True):
            d = graph.k_hop(s, EdgeType.CALLS, DEEP_HOPS, reverse=reverse,
                            device=True, limit=DEEP_LIMIT)
            host = graph.k_hop(s, EdgeType.CALLS, DEEP_HOPS, reverse=reverse,
                               limit=DEEP_LIMIT)
            require(list(d.items()) == sorted(
                host.items(), key=lambda kv: (kv[1], kv[0])),
                f"k_hop(device=True, reverse={reverse}) seeds {s}")
    # unbounded (limit <= 0): every padded node is selected (stable_topk)
    few = seeds[:8]
    dev0 = graph.k_hop_batch(few, EdgeType.CALLS, 3, limit=0, device=True)
    for s, d in zip(few, dev0):
        host = graph.k_hop(s, EdgeType.CALLS, 3, limit=0)
        require(d == host, f"k_hop_batch(device=True, limit=0) seeds {s}")
        require(graph.k_hop(s, EdgeType.CALLS, 3, device=True) == host,
                f"k_hop(device=True) unbounded, seeds {s}")
    log(f"k_hop(device=True) and k_hop_batch(device=True) at Q="
        f"{DEEP_WALKS}, {DEEP_HOPS} hops, limit {DEEP_LIMIT} (and unbounded "
        f"at 3 hops, Q=8) equal the host walk")

    # delete the file of a question's first result: the columns rebuild,
    # and none of its rows surfaces again
    j, first = next((j, s.results[0]) for j, s in enumerate(singles)
                    if s.results[0].file_path)
    target = first.file_path
    gone = {store.payload(r)["graph_node_id"]
            for r in store._inverted["file_path"][target]}
    n_del = indexer.delete_file(target)
    require(n_del > 0 and store._rank_cols_dirty, "delete_file did not "
            "mark the rank columns dirty")
    again = [texts[j]] + [t for t in texts if t != texts[j]][:3]
    after = [engine.deep_search(texts[j], limit=K)]
    after += engine.deep_search_batch(again, limit=K)
    require(not store._rank_cols_dirty
            and store.device_rank_columns(graph) is not cols,
            "the rank columns were not rebuilt after delete_file")
    require(not any(r.qualified_name in gone for a in after
                    for r in a.results),
            f"rows of the deleted file {target} came back")
    log(f"delete_file({target!r}) removed {n_del} rows, among them the first "
        f"result of {texts[j]!r}: the rank columns were rebuilt and none of "
        f"its rows surfaced in {len(after)} deep searches")
    ctx.update(deep_engine=engine, deep_texts=texts, deep_big=big,
               deep_seeds=seeds, deep_memo=memo,
               deep_times=dict(times, evidence_ms=ev_ms, lat_ms=lat,
                               batch_ms=batch_ms))
    log(f"phase 3i took {time.perf_counter() - t_phase:.2f} s")


def deep_rank_inputs(engine, texts: list[str], memo: dict
                     ) -> list[torch.Tensor]:
    """Device tensors of the batched deep rank for these texts (their kept
    evidence where `memo` has it): queries, packed reach, relevance
    tables, match rows, weights."""
    from lattice_tpu_torch.ops.ranking import FuseWeights, pack_weights
    from lattice_tpu_torch.query.engine import _weights_tuple
    plans = [engine.planner.plan_heuristic(t) for t in texts]
    evs = [memo.get(t) or engine._deep_evidence(p)
           for t, p in zip(texts, plans)]
    packed, match = engine._pack_deep_evidence(evs)
    qv = np.asarray(engine.vector_searcher.embedder.embed_batch(texts),
                    np.float32)
    w = np.stack([pack_weights(FuseWeights(*_weights_tuple(
        engine.ranker.config, p))) for p in plans])
    rel = np.stack([e["rel_table"] for e in evs])
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (qv, packed, rel, match, w)]


def phase_deep_kernels(ctx: dict, err: dict, smi: str) -> None:
    """3i, after its launch counts are read: kernel B against its plain
    version (`stable_topk`) on the same fused rows (Q in FUSED_Q, k in
    FUSED_K) and on the BFS distance rows of k_hop_batch, bit for bit;
    then the timings (information only)."""
    from lattice_tpu_torch.core.types import EdgeType
    from lattice_tpu_torch.ops import graph_kernels as gk
    from lattice_tpu_torch.ops import ranking
    from lattice_tpu_torch.ops import scan_topk as scan
    from lattice_tpu_torch.ops import topk as topk_ops
    # the engine, its questions, their evidence and walks stay for 3n
    engine, texts = ctx["deep_engine"], ctx["deep_texts"]
    big, memo = ctx.pop("deep_big"), ctx["deep_memo"]
    store, graph = engine.indexer.code, engine.graph_store
    emb, valid = store.device_arrays
    n = emb.shape[0]
    cols = store.device_rank_columns(graph)

    def inputs(batch_texts: list[str]):
        return deep_rank_inputs(engine, batch_texts, memo)

    def fused(args) -> torch.Tensor:
        qv, packed, rel, match, w = args
        return ranking.fuse_packed(ranking.row_scores(qv, emb, valid), packed,
                                   rel, match, cols.degree, cols.quality, w)

    def check_rows(rows: torch.Tensor, k: int, where: str) -> None:
        ks, ki = scan.merge_positions(rows, k)
        ps, pi = topk_ops.stable_topk(rows, k)
        require(torch.equal(ki, pi) and same_bits(ks, ps),
                f"kernel B on {where} (Q={rows.shape[0]}, k={k}) differs "
                f"from stable_topk: ids agree on "
                f"{(ki == pi).float().mean().item():.6f}")
        err["merge_candidates"] = max(err["merge_candidates"],
                                      (ks - ps).abs().max().item())

    # the 16 questions first, then free-text searches up to 128
    order = texts + [t for t in big if t not in texts]
    slabs = {q: fused(inputs(order[:q])) for q in FUSED_Q}
    for q, slab in slabs.items():
        for k in FUSED_K:
            check_rows(slab, k, "fused rows")
    log(f"kernel B on fused rows of {n} (Q in {FUSED_Q}, k in {FUSED_K}): "
        f"ids equal and scores bit-equal to stable_topk")
    seeds = ctx["deep_seeds"]
    psrc, pdst = graph.device_edges(EdgeType.CALLS)
    seed_arr = np.full((len(seeds), 3), -1, np.int32)
    for i, s in enumerate(seeds):
        seed_arr[i, :len(s)] = s
    n_pad = graph._n_padded()
    dist = gk.bfs_distances_batch(
        psrc, pdst, torch.from_numpy(seed_arr).cuda(), n_pad, DEEP_HOPS)
    neg = -torch.where(graph.device_alive() & (dist > 0), dist,
                       int(gk.UNREACHED)).to(torch.float32)
    for k in (DEEP_LIMIT, 512):
        check_rows(neg, k, "negated BFS distance rows")
    log(f"kernel B on the negated distance rows of k_hop_batch (Q="
        f"{len(seeds)}, {n_pad} nodes): equal to stable_topk at k in "
        f"{(DEEP_LIMIT, 512)}")

    # timings (information only): deep_search's parts on the kept
    # evidence of its 16 questions
    times = ctx.pop("deep_times")
    parts = {"pack_upload": [], "cosine": [], "fuse_select": []}
    for t in texts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qv, packed, rel, match, w = inputs([t])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vec = ranking.row_scores(qv, emb, valid)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ranking._select_topk(ranking.fuse_packed(
            vec, packed, rel, match, cols.degree, cols.quality, w), K)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(v * 1e3)
    ev = times.pop("evidence_ms")
    lat = times.pop("lat_ms")
    named = statistics.median(ev[t] for t in texts if " the " not in t)
    free = statistics.median(ev[t] for t in texts if " the " in t)
    log(f"3i timing, deep_search p50 {statistics.median(lat):.3f} ms over "
        f"{len(texts)} questions (host clock); parts p50 ms: evidence "
        f"{statistics.median(ev.values()):.3f} (questions naming a function "
        f"{named:.3f}, free text {free:.3f}), "
        + ", ".join(f"{k} {statistics.median(v):.3f}"
                    for k, v in parts.items()) + f"; {smi}")
    for q, ms in times.pop("batch_ms").items():
        log(f"3i timing, deep_search_batch Q={q}: {ms / q:.3f} ms a query "
            f"({ms:.1f} ms the batch, host clock; {smi})")
    batch128 = order[:128]
    t0 = time.perf_counter()
    engine.deep_search_batch(batch128, limit=K)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"3i timing, deep_search_batch Q=128 (16 questions, 112 free-text "
        f"searches): {ms / 128:.3f} ms a query ({ms:.1f} ms the batch, host "
        f"clock; {smi})")
    host_ms = p50_ms(lambda j: graph.k_hop(seeds[j % len(seeds)],
                                           EdgeType.CALLS, DEEP_HOPS,
                                           limit=DEEP_LIMIT), 32)
    dev_ms = p50_ms(lambda j: graph.k_hop(seeds[j % len(seeds)],
                                          EdgeType.CALLS, DEEP_HOPS,
                                          device=True, limit=DEEP_LIMIT), 16)
    kb = {}
    for device in (False, True):
        graph.k_hop_batch(seeds, EdgeType.CALLS, DEEP_HOPS, limit=DEEP_LIMIT,
                          device=device)
        t0 = time.perf_counter()
        graph.k_hop_batch(seeds, EdgeType.CALLS, DEEP_HOPS, limit=DEEP_LIMIT,
                          device=device)
        torch.cuda.synchronize()
        kb[device] = (time.perf_counter() - t0) * 1e3
    log(f"3i timing, k_hop {DEEP_HOPS} hops limit {DEEP_LIMIT}: p50 host "
        f"walk {host_ms:.3f} ms, device {dev_ms:.3f} ms; k_hop_batch Q="
        f"{len(seeds)}: host {kb[False]:.1f} ms, device {kb[True]:.1f} ms "
        f"(host clock; {smi})")
    for q, slab in slabs.items():
        b_ms = device_ms(lambda: scan.merge_positions(slab, K))
        topk_ms = device_ms(lambda: torch.topk(slab, K))
        sort_ms = device_ms(lambda: torch.sort(slab, dim=-1, descending=True,
                                               stable=True), 5)
        bnd = bound(q * n * 4 + q * K * 8, 0, "f32")
        log(f"3i timing, kernel B (lt_merge_positions) on fused rows Q={q} "
            f"m={n} k={K}: {b_ms:.4f} ms, torch.topk {topk_ms:.4f} ms, "
            f"torch.sort (stable_topk's) {sort_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); device time, {smi}")
    log(f"3i host times: "
        f"{json.dumps({k: round(v, 3) for k, v in times.items()})}")


# ---- 3n: the sharded paths (cell K) ------------------------------------------

SHARDS = 4                 # logical shards on one card
SHARD_BITS = (16, 8, 4)    # the sharded views' tiers
SHARD_RECALL = {16: RECALL_MIN, 8: RECALL_MIN, 4: INT4_RECALL_MIN}
SHARD_HOPS = (1, 2, 3)
SHARD_WALKS = 8            # seed sets of 3i walked forward and reverse
RANK_Q = (1, 16)
SHARD_DEEP = 4             # 3i's questions asked through the engine's branch


def shard_mesh():
    """The mesh of 3n: four logical shards on one card, one shard a card
    where there are more."""
    from lattice_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    return make_mesh(SHARDS if n == 1 else n)


@contextlib.contextmanager
def stores_sharded(mesh):
    """Within the block, LATTICE_SHARDED=1 on the stores' one mesh
    (`default_mesh`): the store's sharded plan, the graph's sharded walk
    and the engine's sharded deep branch. The plan's variables come back
    after it."""
    from lattice_tpu_torch.parallel.mesh import default_mesh
    names = ("LATTICE_SHARDED", "LATTICE_SHARDED_BITS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ["LATTICE_SHARDED"] = "1"
    try:
        with default_mesh(mesh):
            yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_ranks(got: tuple, want: tuple, exact, live: torch.Tensor,
               tie: float, where: str) -> int:
    """(scores, ids) lists that agree at every rank, by `check_bf16`'s
    rule: scores within `tie`, and every slot whose id differs holds a live
    row whose exact score (`exact(query index, rows)`) is the score
    reported there within `tie` and ties the reference's score at that
    slot within it. Returns how many slots hold another id."""
    gs, gi = got
    ws, wi = (x.to(gs.device) for x in want)
    require(gs.shape == ws.shape and gi.shape == wi.shape,
            f"{where}: shapes {tuple(gs.shape)} / {tuple(ws.shape)}")
    gap = (gs - ws).abs().max().item() if gs.numel() else 0.0
    require(gap <= tie, f"{where}: scores differ by {gap:.3g} (> {tie})")
    off = gi != wi
    if bool(off.any()):
        rows = gi[off].long()
        ex = exact(off.nonzero()[:, 0], rows)
        gap = torch.maximum((ex - gs[off]).abs(), (gs[off] - ws[off]).abs())
        require(bool(live[rows].all()) and gap.max().item() <= tie,
                f"{where}: {int(off.sum())} ids differ from the reference's, "
                f"not by a tie (largest gap {gap.max().item():.3g})")
    return int(off.sum())


def dequant_topk(q: torch.Tensor, view, k: int) -> torch.Tensor:
    """Exact f32 top-k ids over a quantized view's own dequantized rows
    (TF32 off), shard by shard in row blocks: the plain reference of the
    view's capacity mode, whose rescore scores its candidates so."""
    from lattice_tpu_torch.ops import scan_topk as scan
    from lattice_tpu_torch.ops import topk as topk_ops
    qn = normalize(q.to(torch.float32))
    best = None
    for s, (v, sc, ok) in enumerate(zip(view.value_shards, view.scale_shards,
                                        view.valid_shards)):
        qd = qn.to(v.device)

        def block(lo, hi, v=v, sc=sc, ok=ok, qd=qd):
            rows = v[lo:hi] if view.bits == 8 else scan.unpack_int4(v[lo:hi])
            with topk_ops.full_f32():
                x = qd @ (rows.to(torch.float32) * sc[lo:hi, None]).T
            return torch.where(ok[None, lo:hi], x,
                               torch.full_like(x, topk_ops.NEG_INF))

        top, ids = topk_ops.blocked_topk(block, v.shape[0], k)
        top, ids = top.to(q.device), view._global(s, ids).to(q.device)
        best = ((top, ids) if best is None
                else topk_ops.merge_topk(*best, top, ids, k))
    return best[1]


def phase_sharded_path(ctx: dict) -> None:
    """3n (cell K): the sharded paths on corpus A's store and cell G's graph,
    both still resident after 3i, over four logical shards on one card (one
    shard a card on more): (a) `to_sharded` searched at B=256 and B=1; (b)
    `to_sharded_quantized` at bits 8 and 4, and the views that keep bf16
    rows beside the planes (`keep_full_precision=True`), then the store's
    "sharded" plan (LATTICE_SHARDED=1 on the stores' one mesh,
    `default_mesh`) at LATTICE_SHARDED_BITS 16, 8 and 4, a filtered
    search, and an `add` and a `remove` that the views take in place; (c) `sharded_hybrid` at Q=1
    and 16 on 3i's evidence and `deep_search` through the engine's sharded
    branch; (d) `GraphStore.to_sharded(CALLS)` walked 1-3 hops both ways;
    (e) a 2 x 2 multislice view; (f) the encoder's batch split over the
    shards (`use_mesh`) at B=128, L=512. The results are held to the
    single-device paths after the launch counts are read
    (`phase_sharded_checks`)."""
    from lattice_tpu_torch.core.types import EdgeType
    from lattice_tpu_torch.models.unixcoder import (UniXcoderConfig,
                                                    UniXcoderModel)
    from lattice_tpu_torch.ops.topk import NEG_INF
    from lattice_tpu_torch.parallel.mesh import make_multislice_mesh
    from lattice_tpu_torch.parallel.sharded_index import (
        ShardedQuantizedIndex)
    t_phase = time.perf_counter()
    store, engine = ctx["store"], ctx["deep_engine"]
    graph, q = engine.graph_store, ctx["queries"]
    mesh = shard_mesh()
    n_shards = len(mesh.row_devices)
    log(f"3n: {mesh}: {n_shards} shards over "
        f"{len(set(mesh.row_devices))} of {torch.cuda.device_count()} "
        f"visible card(s); {ctx['smi']}")
    res: dict = {"mesh": mesh, "build": {}}
    for bits in SHARD_BITS:                                       # (a), (b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view = (store.to_sharded(mesh) if bits == 16
                else store.to_sharded_quantized(mesh, bits=bits))
        torch.cuda.synchronize()
        res["build"][bits] = (time.perf_counter() - t0, view.memory_bytes())
        res[("view", bits)] = view
        for b in (256, 1):
            res[("view", bits, b)] = view.search_device(q[:b], K)
    for bits in SHARD_BITS[1:]:
        fp = ShardedQuantizedIndex(store._emb, store._valid, mesh=mesh,
                                   bits=bits, keep_full_precision=True)
        for b in (256, 1):
            res[("fp", bits, b)] = fp.search_device(q[:b], K)
        del fp
    shards = res[("view", 16)].embeddings
    require(all(e.data_ptr() % 16 == 0 and e.is_contiguous()
                for e in shards), "a bf16 shard is not 16-byte aligned")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    with stores_sharded(mesh):
        for bits in SHARD_BITS:
            os.environ["LATTICE_SHARDED_BITS"] = str(bits)
            plan = store._plan_search(256, K, None, "auto")
            require(plan == "sharded", f"LATTICE_SHARDED=1 on {mesh} "
                    f"planned {plan!r}")
            for b in (256, 1):
                res[("store", bits, b)] = store.search_device(q[:b], K)
            target = store.payload(
                int(res[("store", bits, 256)][1][0, 0]))["file_path"]
            fs, fi = store.search_device(q[:8], K,
                                         filters={"file_path": target})
            live = fi[fs > NEG_INF / 2].tolist()
            require(live and set(live) <= store._inverted["file_path"][target],
                    f"bits {bits}: a filtered sharded search left the mask")
            view = store._sharded if bits == 16 else store._shardedq
            new = normalize(torch.randn(2, DIM, generator=gen,
                                        device="cuda"))
            rows = store.add(new, payloads(0, 2))
            _, ni = store.search_device(new, 1)
            store.remove(rows)
            _, gi = store.search_device(new, 1)
            again = store._sharded if bits == 16 else store._shardedq
            require(again is view and not store._sharded_dirty
                    and (bits == 16 or not store._shardedq_dirty),
                    f"bits {bits}: add / remove rebuilt the sharded view")
            require(ni[:, 0].tolist() == rows and not set(
                gi[:, 0].tolist()) & set(rows),
                f"bits {bits}: the view missed an add or a remove: found "
                f"{ni[:, 0].tolist()} for {rows}, then {gi[:, 0].tolist()}")
        log(f"3n(b): the store's sharded plan at bits {SHARD_BITS}: "
            f"filtered searches within the mask, add / remove taken in "
            f"place by the views")
        os.environ["LATTICE_SHARDED_BITS"] = "16"                 # (c)
        args = deep_rank_inputs(engine, ctx["deep_texts"], ctx["deep_memo"])
        hview = store.sharded_hybrid(graph, mesh)
        require(hview.bits == 16, f"sharded_hybrid at bits {hview.bits}")
        for n_q in RANK_Q:
            res[("rank", n_q)] = hview.rank_device(
                *[a[:n_q] for a in args], K)
        require(engine._sharded_deep_enabled(), "the engine's sharded "
                "deep branch is off")
        res["deep"] = [engine.deep_search(t, limit=K)
                       for t in ctx["deep_texts"][:SHARD_DEEP]]
    res["args"] = args
    torch.cuda.synchronize()                                      # (d)
    t0 = time.perf_counter()
    gview = graph.to_sharded(EdgeType.CALLS, mesh)
    torch.cuda.synchronize()
    res["graph_build_s"] = time.perf_counter() - t0
    res["walks"] = {(h, r, j): gview.k_hop(s, h, reverse=r)
                    for h in SHARD_HOPS for r in (False, True)
                    for j, s in enumerate(ctx["deep_seeds"][:SHARD_WALKS])}
    ms = make_multislice_mesh(2, n_shards if n_shards % 2 == 0 else SHARDS,
                              device=list(dict.fromkeys(mesh.row_devices)))
    res["multislice"] = (str(ms), store.to_sharded(ms).search_device(
        q, K))                                                    # (e)
    model = UniXcoderModel(UniXcoderConfig(), seed=SEED, device="cuda")
    egen = torch.Generator(device="cuda").manual_seed(SEED + 9)   # (f)
    ids = torch.randint(5, model.config.vocab_size, (ENC_BATCH, ENC_LEN),
                        generator=egen, device="cuda")
    lengths = torch.randint(1, ENC_LEN + 1, (ENC_BATCH,), generator=egen,
                            device="cuda")
    mask = (torch.arange(ENC_LEN, device="cuda")[None, :]
            < lengths[:, None]).to(torch.int64)
    ids = torch.where(mask > 0, ids, model.config.pad_token_id)
    model.use_mesh(mesh)
    res["encoder"] = (model, ids, mask, model.encode_device(ids, mask))
    torch.cuda.synchronize()
    ctx["sharded"] = res
    log(f"phase 3n took {time.perf_counter() - t_phase:.2f} s")


def phase_sharded_checks(ctx: dict, err: dict, smi: str) -> None:
    """3n after its launch counts are read: (a) the merged shards against
    one A + B over the whole store (ids equal except ties within TIE_TOL,
    scores within it) and recall@10 against the exact f32 scan; kernel B's
    merge of the shards' lists bit-equal to its plain version; (b) the
    store's sharded plan at each tier held to the recall bars of the flat
    and "int4" plans; (c) the sharded deep rank equal to the single-device
    rank on the same inputs (ids except ties within 1e-5, scores within
    1e-5) and `deep_search`'s sharded branch ranking as its unsharded
    branch; (d) every walk equal to the host walk; (e) the multislice view
    bit-equal to the flat merge; (f) every pooled row's cosine >= 0.999
    against the unsplit forward. Then the timings (information only)."""
    from lattice_tpu_torch.core.types import EdgeType
    from lattice_tpu_torch.ops import ranking
    from lattice_tpu_torch.ops import scan_topk as scan
    from lattice_tpu_torch.parallel.mesh import replicated
    res = ctx.pop("sharded")
    store, engine = ctx["store"], ctx["deep_engine"]
    graph, q, mesh = engine.graph_store, ctx["queries"], res["mesh"]
    emb, valid = store.device_arrays
    truth = exact_topk(q, emb, valid, K)
    view = res[("view", 16)]
    qb = normalize(q).to(torch.bfloat16).float()

    def exact_dot(qi, rows):
        return (qb[qi] * emb[rows].float()).sum(dim=1)

    for b in (256, 1):                                            # (a)
        got = res[("view", 16, b)]
        off = same_ranks(got, scan.fused_topk(normalize(q[:b]), emb, valid,
                                              K), exact_dot, valid, TIE_TOL,
                         f"3n(a) sharded A + B against one A + B, B={b}")
        r = recall(got[1], truth[:b])
        require(r >= RECALL_MIN, f"3n(a) bf16 view B={b}: recall@{K} "
                f"{r:.4f} < {RECALL_MIN}")
        log(f"3n(a) to_sharded over {mesh}, B={b}: equal to one A + B over "
            f"the store ({off} tied slots swapped), recall@{K} {r:.4f}")
    lists = [scan.fused_topk(x, e, v, K) for x, e, v in zip(
        replicated(mesh, normalize(q)), view.embeddings, view.valid)]
    cs = torch.cat([s.to(mesh.lead) for s, _ in lists], dim=1)
    ci = torch.cat([view._global(j, i).to(mesh.lead)
                    for j, (_, i) in enumerate(lists)], dim=1)
    check_merge(cs, ci, K, "3n shard lists", err)
    for bits in SHARD_BITS[1:]:
        own = dequant_topk(q, res[("view", bits)], K)
        for b in (256, 1):
            s, i = res[("view", bits, b)]
            require(bool(torch.isfinite(s).all()) and bool(
                (s[:, :-1] >= s[:, 1:]).all()) and int(i.max()) < store.capacity,
                f"3n(b) int{bits} view B={b}: bad output")
            r_own = recall(i, own[:b])
            require(r_own >= SHARD_RECALL[bits], f"3n(b) to_sharded_quantized"
                    f"(bits={bits}) B={b}: recall@{K} {r_own:.4f} against an "
                    f"exact scan of its own rows < {SHARD_RECALL[bits]}")
            r_fp = recall(res[("fp", bits, b)][1], truth[:b])
            require(r_fp >= SHARD_RECALL[bits], f"3n(b) keep_full_precision "
                    f"int{bits} view B={b}: recall@{K} {r_fp:.4f} < "
                    f"{SHARD_RECALL[bits]}")
            log(f"3n(b) int{bits} views, B={b}: capacity mode (rescored "
                f"against its own dequantized rows) recall@{K} {r_own:.4f} "
                f"against an exact f32 scan of those rows (bar "
                f"{SHARD_RECALL[bits]}), {recall(i, truth[:b]):.4f} against "
                f"the exact f32 scan of the store, where an exact scan of "
                f"its rows reaches {recall(own[:b], truth[:b]):.4f}; "
                f"keep_full_precision recall@{K} {r_fp:.4f} against the "
                f"store's scan (bar {SHARD_RECALL[bits]})")
    for bits in SHARD_BITS:                                       # (b)
        r = recall(res[("store", bits, 256)][1], truth)
        require(r >= SHARD_RECALL[bits], f"3n(b) store's sharded plan at "
                f"bits {bits}: recall@{K} {r:.4f} < {SHARD_RECALL[bits]}")
        log(f"3n(b) store's sharded plan, LATTICE_SHARDED_BITS={bits}: "
            f"recall@{K} {r:.4f} (bar {SHARD_RECALL[bits]})")
    cols = store.device_rank_columns(graph)                       # (c)
    for n_q in RANK_Q:
        a = [x[:n_q] for x in res["args"]]
        want = ranking.hybrid_rank_device_packed_batch(
            a[0], emb, valid, a[1], a[2], a[3], cols.degree, cols.quality,
            a[4], K)
        fused = ranking.fuse_packed(ranking.row_scores(a[0], emb, valid),
                                    a[1], a[2], a[3], cols.degree,
                                    cols.quality, a[4])
        off = same_ranks(res[("rank", n_q)], want,
                         lambda qi, rows, f=fused: f[qi, rows], valid, 1e-5,
                         f"3n(c) sharded deep rank Q={n_q}")
        del fused
        log(f"3n(c) sharded_hybrid Q={n_q}: equal to the single-device "
            f"rank ({off} tied slots swapped)")
    for t, got in zip(ctx["deep_texts"], res["deep"]):
        same_deep(got.results, engine.deep_search(t, limit=K).results,
                  f"3n(c) deep_search({t!r}) sharded against unsharded")
    log(f"3n(c) deep_search through the engine's sharded branch ranks as "
        f"its unsharded branch on {len(res['deep'])} questions")
    sizes = []                                                    # (d)
    for (h, r, j), got in res["walks"].items():
        want = graph.k_hop(ctx["deep_seeds"][j], EdgeType.CALLS, h,
                           reverse=r)
        require(got == want, f"3n(d) sharded k_hop hops={h} reverse={r} "
                f"seeds {ctx['deep_seeds'][j]}: not the host walk")
        sizes.append(len(got))
    log(f"3n(d) GraphStore.to_sharded(CALLS) over "
        f"{graph.n_edges(EdgeType.CALLS)} edges: {len(res['walks'])} walks "
        f"(hops {SHARD_HOPS}, both ways) equal the host walk, reaching "
        f"{min(sizes)}-{max(sizes)} nodes")
    ms_name, (ms_s, ms_i) = res["multislice"]                     # (e)
    fs, fi = res[("view", 16, 256)]
    require(torch.equal(ms_i, fi) and same_bits(ms_s, fs),
            f"3n(e) {ms_name} differs from the flat merge")
    log(f"3n(e) {ms_name}: ids and scores bit-equal to the flat merge")
    model, ids, mask, pooled = res["encoder"]                     # (f)
    with torch.inference_mode():
        plain = model.encoder(ids, mask)[1]
    cos = torch.nn.functional.cosine_similarity(pooled.float(),
                                                plain.float(), dim=-1)
    require(cos.min().item() >= 0.999, f"3n(f) pooled cosine "
            f"{cos.min().item():.6f} < 0.999")
    log(f"3n(f) UniXcoderModel.use_mesh over {mesh}, B={ENC_BATCH}, "
        f"L={ENC_LEN}: every pooled cosine >= {cos.min().item():.6f} "
        f"against the unsplit forward")
    phase_sharded_timings(ctx, res, lists, smi)


def trace_calls(name: str, fn, smi: str, n: int = 4) -> None:
    """A device trace of `n` calls of `fn`: busy ms a call, the idle share
    of the traced window, the kernels that took the most device time."""
    from lattice_tpu_torch.utils.tracing import (device_trace,
                                                 summarize_device_trace)
    where = str(ROOT / "build" / "traces" / re.sub(r"\W+", "_", name))
    fn()
    torch.cuda.synchronize()
    with device_trace(where):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    summ = summarize_device_trace(where, "GPU", top=4)
    require("error" not in summ and summ["total_ms"] > 0,
            f"{name} trace: {summ.get('error', 'no device time')}")
    busy = summ["total_ms"]
    top = ", ".join(f"{op[:48]} {ms / n:.4f}" for op, ms, _ in summ["ops"])
    log(f"3n trace, {name}: device busy {busy / n:.4f} ms a call, idle "
        f"{1 - busy / wall:.4f} of the traced window ({wall / n:.4f} ms a "
        f"call under the profiler); top kernels (ms a call): {top} ({smi})")


def phase_sharded_timings(ctx: dict, res: dict, lists: list,
                          smi: str) -> None:
    """3n timings (information only; four shards on one card measure the
    cost of sharding, not scale-out): each view and the store's sharded
    plan at B=256 (device time of back-to-back calls, QPS) and B=1 (host
    p50) beside the store's single-device plan in the same process; the
    merge's share of a bf16 view call; the views' build seconds and GB;
    the sharded walk and the split encoder beside their unsharded
    counterparts."""
    from lattice_tpu_torch.core.types import EdgeType
    from lattice_tpu_torch.ops import ranking
    from lattice_tpu_torch.parallel.sharded_index import merge_shards
    store, q, mesh = ctx["store"], ctx["queries"], res["mesh"]
    graph = ctx["deep_engine"].graph_store
    for bits, (sec, nbytes) in res["build"].items():
        log(f"3n timing, view build bits {bits}: {sec:.3f} s, "
            f"{nbytes / 1e9:.3f} GB ({smi})")
    rows = []

    def timed(name, fn):
        ms = cuda_ms(lambda: fn(q), 10)
        p50 = p50_ms(lambda j: fn(q[j:j + 1]), 30)
        rows.append((name, ms, p50))
        log(f"3n timing, {name}: B=256 {ms:.4f} ms = {256 / ms * 1e3:.0f} "
            f"QPS; B=1 p50 {p50:.4f} ms ({smi})")

    timed("store, single-device auto plan "
          f"({store._plan_search(256, K, None, 'auto')})",
          lambda x: store.search_device(x, K))
    for bits in SHARD_BITS:
        view = res[("view", bits)]
        name = f"to_sharded{'' if bits == 16 else '_quantized'} bits {bits}"
        timed(name, lambda x, v=view: v.search_device(x, K))
        trace_calls(f"{name} B=256", lambda v=view: v.search_device(q, K),
                    smi)
    with stores_sharded(mesh):
        for bits in SHARD_BITS:
            os.environ["LATTICE_SHARDED_BITS"] = str(bits)
            timed(f"store, sharded plan bits {bits}",
                  lambda x: store.search_device(x, K))
        trace_calls("store, sharded plan bits 4, B=256",
                    lambda: store.search_device(q, K), smi)
    view = res[("view", 16)]
    scores = [s for s, _ in lists]
    ids = [view._global(j, i) for j, (_, i) in enumerate(lists)]
    merge = cuda_ms(lambda: merge_shards(mesh, scores, ids, K), 20)
    call = cuda_ms(lambda: view.search_device(q, K), 10)
    log(f"3n timing, the merge of {len(scores)} shards' [256, {K}] lists "
        f"(gather + kernel B): {merge:.4f} ms of a {call:.4f} ms bf16 view "
        f"call ({merge / call:.1%}; {smi})")
    cols = store.device_rank_columns(graph)
    emb, valid = store.device_arrays
    hview = store.sharded_hybrid(graph, mesh)
    for n_q in RANK_Q:
        a = [x[:n_q] for x in res["args"]]
        sh = p50_ms(lambda j: hview.rank_device(*a, K), 16)
        one = p50_ms(lambda j: ranking.hybrid_rank_device_packed_batch(
            a[0], emb, valid, a[1], a[2], a[3], cols.degree, cols.quality,
            a[4], K), 16)
        log(f"3n timing, deep rank Q={n_q}: sharded_hybrid p50 {sh:.3f} ms, "
            f"single-device {one:.3f} ms (host clock; {smi})")
    seeds = ctx["deep_seeds"]
    gview = graph.to_sharded(EdgeType.CALLS, mesh)
    walk_sh = p50_ms(lambda j: gview.k_hop(seeds[j % len(seeds)], 3), 16)
    walk_host = p50_ms(lambda j: graph.k_hop(seeds[j % len(seeds)],
                                             EdgeType.CALLS, 3), 16)
    log(f"3n timing, k_hop 3 hops: sharded p50 {walk_sh:.3f} ms, host walk "
        f"{walk_host:.3f} ms, view build {res['graph_build_s']:.3f} s "
        f"({smi})")
    model, ids_, mask, _ = res["encoder"]
    split = cuda_ms(lambda: model._forward(ids_, mask), 5)
    with torch.inference_mode():
        whole = cuda_ms(lambda: model.encoder(ids_, mask), 5)
    log(f"3n timing, encoder B={ENC_BATCH} L={ENC_LEN}: split over "
        f"{len(mesh.row_devices)} shards {split:.3f} ms, unsplit "
        f"{whole:.3f} ms ({smi})")


def phase_capacity_path(ctx: dict) -> None:
    """3e: 4,194,304 x 768 rows held only as packed int4 (the bench's
    capacity cell), served at B=1024."""
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    from lattice_tpu_torch.ops import topk as topk_ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    centers = cluster_centers(gen, N_CLUSTERS, DIM)
    q = cluster_rows(centers, CAP_BATCH, gen)
    q_truth = q[:CAP_TRUTH]
    packed = torch.empty((CAP_ROWS, DIM // 2), dtype=torch.int8,
                         device="cuda")
    scales = torch.empty((CAP_ROWS,), dtype=torch.float32, device="cuda")
    best = None
    t0 = time.perf_counter()
    for lo in range(0, CAP_ROWS, CAP_BLOCK):
        blk = cluster_rows(centers, CAP_BLOCK, gen).to(torch.bfloat16)
        with topk_ops.full_f32():
            sc = q_truth @ blk.to(torch.float32).T
        top, pos = topk_ops.stable_topk(sc, K)
        best = ((top, pos + lo) if best is None
                else topk_ops.merge_topk(*best, top, pos + lo, K))
        packed[lo:lo + CAP_BLOCK], scales[lo:lo + CAP_BLOCK] = (
            quant.quantize_rows_int4_device(blk))
        del blk, sc
    truth = best[1]
    view = quant.Int4View.from_packed(packed, scales)
    valid = torch.ones((CAP_ROWS,), dtype=torch.bool, device="cuda")
    del packed, scales, best
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log(f"capacity: {CAP_ROWS} x {DIM} rows (spread {SPREAD}) made, scored "
        f"against {CAP_TRUTH} queries and packed in {made_s:.1f} s; int4 view "
        f"{view.memory_bytes() / 1e9:.3f} GB; {allocated / 1e9:.3f} GB "
        f"allocated at search time")
    require(allocated < CAP_MEMORY, f"{allocated / 1e9:.3f} GB allocated at "
            f"capacity search time (limit {CAP_MEMORY / 1e9:.1f} GB)")
    for dequant in (False, True):
        s, i = view.search_device(q, valid, K, dequant_rescore=dequant)
        torch.cuda.synchronize()
        mode = "dequant_rescore" if dequant else "first stage only"
        require(s.shape == i.shape == (CAP_BATCH, K)
                and bool(torch.isfinite(s).all())
                and bool((s[:, :-1] >= s[:, 1:]).all()),
                f"capacity {mode}: bad output")
        require(bool(((i >= 0) & (i < CAP_ROWS)).all())
                and bool(valid[i.long()].all()),
                f"capacity {mode}: ids out of range or not live")
        srt = i.sort(dim=1).values
        require(bool((srt[:, 1:] != srt[:, :-1]).all()),
                f"capacity {mode}: repeated ids")
        r = recall(i[:CAP_TRUTH], truth)
        ctx[f"recall_capacity_{'dequant' if dequant else 'first'}"] = r
        log(f"capacity {mode}, B={CAP_BATCH}: recall@{K} against the exact "
            f"f32 scan {r:.4f} (information)")
    peak = torch.cuda.max_memory_allocated()
    log(f"capacity: peak {peak / 1e9:.3f} GB allocated while searching")
    require(peak < CAP_MEMORY, f"capacity search peaked at {peak / 1e9:.3f} "
            "GB allocated")
    ctx["capacity"] = (view, valid, q)


def phase_capacity_kernels(ctx: dict, err: dict, smi: str) -> None:
    """Kernels D and B against their plain versions on the inputs the
    capacity path gave them: all 1,024 queries, quantized as
    `Int4View.search_device` quantizes them, over the 4M packed rows, at
    both of its widths (k1 = 16 first stage only, 80 for the rescore).
    Ids identical, scores bit-equal. Run after the path's launch counts
    were read, so these launches are not counted."""
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    view, valid, q = ctx["capacity"]
    qv, qs = quant.quantize_rows_device(quant._l2n(q).contiguous())
    for k1 in (scan.first_stage_width(K, view.n),
               scan.int4_first_stage_width(K, view.n)):
        cs, ci = scan.scan_blocks_int4(qv, qs, view.values, view.scales,
                                       valid, k1)
        ks, ki = scan.merge_candidates(cs, ci, k1)
        torch.cuda.synchronize()
        ps, pi = scan.scan_topk_int4_plain(qv, qs, view.values, view.scales,
                                           valid, k1)
        require(torch.equal(ki, pi) and torch.equal(ks, ps),
                f"kernels D + B differ from their plain version at "
                f"N={view.n}, B={CAP_BATCH}, k1={k1}: ids agree on "
                f"{(ki == pi).float().mean().item():.6f}, max score error "
                f"{(ks - ps).abs().max().item():.3g}")
        err["scan_topk_int4"] = max(err["scan_topk_int4"],
                                    (ks - ps).abs().max().item())
        ms_, mi = scan.merge_candidates_plain(cs, ci, k1)
        require(torch.equal(ki, mi) and torch.equal(ks, ms_),
                f"kernel B differs from its plain version on D's "
                f"{cs.shape[1]} candidates per query at k1={k1}")
        log(f"kernels ok: scan_topk_int4 + merge_candidates at N={view.n}, "
            f"B={CAP_BATCH}, k1={k1} ({cs.shape[1]} candidates per query "
            f"merged)")
        check_merge(cs, ci, k1, "capacity kernel D lists", err)
        merge_timing(cs, ci, k1, "capacity kernel D lists", smi)
        del cs, ci, ks, ki, ps, pi, ms_, mi


def phase_capacity_timings(ctx: dict, smi: str) -> None:
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    view, valid, q = ctx.pop("capacity")
    for dequant in (False, True):
        ms = cuda_ms(lambda: view.search_device(q, valid, K,
                                                dequant_rescore=dequant), 3, 1)
        mode = "dequant_rescore" if dequant else "first stage only"
        ctx[f"qps_capacity_{'dequant' if dequant else 'first'}"] = (
            CAP_BATCH / ms * 1e3)
        log(f"capacity {mode}: B={CAP_BATCH} {ms:.3f} ms/batch = "
            f"{CAP_BATCH / ms * 1e3:.0f} QPS ({smi})")
    qv, qs = quant.quantize_rows_device(normalize(q))
    k1 = scan.first_stage_width(K, view.n)
    ms = cuda_ms(lambda: scan.scan_blocks_int4(qv, qs, view.values,
                                               view.scales, valid, k1), 3, 1)
    plain = cuda_ms(lambda: scan.scan_topk_int4_plain(
        qv, qs, view.values, view.scales, valid, k1), 1, 0)
    bnd = scan_bound(view.n, DIM, CAP_BATCH, k1, DIM / 2, "int8")
    ctx["capacity_kernel"] = (ms, plain, bnd)
    log(f"kernel scan_topk_int4 B={CAP_BATCH} N={view.n} d={DIM} k1={k1}: "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}) ({smi})")
    from lattice_tpu_torch.tools import dissect
    ctx["capacity_probe"] = dissect.capacity_probe(view, q, log)


def p50_ms(fn, n: int = 50) -> float:
    """Median host-clock latency of a synchronized call, in ms."""
    lat = []
    for j in range(n):
        t0 = time.perf_counter()
        fn(j)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def phase_ivf_timings(ctx: dict, kernels_ms: dict, err: dict,
                      smi: str) -> None:
    """"ivf" against "quantized" through `search_device` on the clustered
    store, by batch; `ivf_probe` alone beside its plain version."""
    from lattice_tpu_torch.index import chunk_store as cs
    from lattice_tpu_torch.ops import ivf
    store, q256 = ctx["store2"], ctx["queries2"]
    ivf_ = store._ivf
    rows = {}
    for b in (1, 8, 32, 64, 128, 256):
        qb = q256[:b].contiguous()
        rows[b] = {m: cuda_ms(lambda: store.search_device(qb, K, method=m), 20)
                   for m in ("ivf", "quantized")}
        log(f"search_device B={b}: ivf {rows[b]['ivf']:.4f} ms, quantized "
            f"{rows[b]['quantized']:.4f} ms per batch")
    wins = [b for b, t in rows.items() if t["ivf"] < t["quantized"]]
    crossover = max(wins, default=0)
    for m in ("ivf", "quantized"):
        ctx[f"p50_{m}_clustered"] = p50_ms(
            lambda j: store.search_device(q256[j:j + 1], K, method=m))
    log(f"B=1 p50: ivf {ctx['p50_ivf_clustered']:.3f} ms, quantized "
        f"{ctx['p50_quantized_clustered']:.3f} ms; ivf faster at B in "
        f"{wins}: measured crossover {crossover}, IVF_SMALL_BATCH "
        f"{cs.IVF_SMALL_BATCH} "
        f"({'matches' if crossover == cs.IVF_SMALL_BATCH else 'DIFFERS'})")
    probe = ivf.probe_table(q256, ivf_.centroids, cs.IVF_AUTO_NPROBE)
    data, ids = ivf_.bucket_data, ivf_.bucket_ids
    slots = ivf_.bucket_size
    for b in (1, 256):
        q, pb = q256[:b].contiguous(), probe[:b].contiguous()
        # the buckets this batch probes, each read once, and its products
        touched = pb.unique().numel()
        bnd = bound(touched * slots * (DIM * data.element_size() + 4)
                    + b * DIM * 4 + pb.numel() * 4 + b * K * 8,
                    2 * b * pb.shape[1] * slots * DIM, "bf16")
        row = kernel_row(
            cuda_ms(lambda: ivf.probe_blocks(q, pb, data, ids, K), 20),
            cuda_ms(lambda: probe_plain_chunked(q, pb, data, ids, K), 3, 1),
            bnd, None)
        log(f"kernel ivf_probe B={b} C={ivf_.n_clusters} S={slots} "
            f"nprobe={cs.IVF_AUTO_NPROBE} d={DIM} k1={K}: {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}; {touched} buckets touched)")
        if b == 256:
            kernels_ms["ivf_probe"] = row
        lists = ivf.probe_blocks(q, pb, data, ids, K)
        check_merge(*lists, K, "ivf_probe lists", err)
        merge_timing(*lists, K, "ivf_probe lists", smi)


# ---- serving (cell I) --------------------------------------------------------

SERVE_CLIENTS = 64         # 3k: concurrent HTTP clients
SERVE_EACH = 8             # /v1/search_vector requests each
SERVE_BATCH = 256          # rows of one /v1/search_vector_batch
SERVE_FORCED = ("quantized", "ivf", "pq")
SERVE_CLI_EACH = 4         # 3l: texts through each single endpoint


def http_call(base: str, path: str, body: dict | None = None,
              timeout: float = 600.0):
    """(status, JSON body, or text for /metrics) of one request to a server
    on this machine, over a connection with TCP_NODELAY as curl and
    urllib3 open theirs (`http.client` writes a request's headers and body
    apart, and Nagle's algorithm would hold the body for the server's
    delayed ACK)."""
    import http.client
    import socket
    host, port = base.split("//")[1].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        status, text = resp.status, resp.read().decode()
    finally:
        conn.close()
    return status, (text if path == "/metrics" else json.loads(text))


def wait_warm(base: str, fe, limit_s: float = 600.0) -> float:
    """Seconds until `/healthz` says warm; a failed warmup fails."""
    t0 = time.perf_counter()
    while True:
        status, body = http_call(base, "/healthz")
        require(status == 200, f"/healthz {status}: {body}")
        if body["warm"]:
            return time.perf_counter() - t0
        require(not fe.warmup_failed, "the server's warmup failed")
        require(time.perf_counter() - t0 < limit_s, "never warm")
        time.sleep(0.02)


def served_rows(answers) -> torch.Tensor:
    require(all(s == 200 for s, _ in answers),
            f"statuses {sorted({s for s, _ in answers})}: "
            f"{[b for s, b in answers if s != 200][:2]}")
    return torch.tensor([[h["row"] for h in b["hits"]] for _, b in answers],
                        dtype=torch.int32)


def same_as_direct(items: list[dict], s: torch.Tensor, i: torch.Tensor,
                   where: str, tol: float = 0.0) -> None:
    """Served hits (rows, scores rounded to 4 places as the server rounds)
    against a direct `search_device`'s [B, k] ids and scores: the same
    rows, and the direct scores rounded alike (`tol` 0) or within `tol`."""
    s, i = s.cpu().tolist(), i.cpu().tolist()
    for qi, item in enumerate(items):
        want = [(r, v) for r, v in zip(i[qi], s[qi]) if r >= 0 and v > -1e29]
        got = [(h["row"], h["score"]) for h in item["hits"]]
        require([r for r, _ in got] == [r for r, _ in want]
                and all((g == round(w, 4)) if tol == 0 else abs(g - w) <= tol
                        for (_, g), (_, w) in zip(got, want)),
                f"{where}, query {qi}: served {got[:4]} / direct {want[:4]}")


def dispatched(fe, n: int) -> list[int]:
    """The sizes, in order, of a frontend's last dispatches, which served
    its last `n` queries (its queue is FIFO)."""
    sizes, out = list(fe.stats.batch_sizes), []
    while sum(out) < n:
        out.append(sizes.pop())
    require(sum(out) == n, f"dispatches {out[::-1]} do not make {n}")
    return out[::-1]


def as_dispatched(store, q: torch.Tensor, sizes: list[int], method: str,
                  max_batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`search_device` of `q` as the frontend dispatched it: each batch
    padded to its bucket with copies of its first query."""
    from lattice_tpu_torch.serving.frontend import BatchingFrontend
    out_s, out_i, lo = [], [], 0
    for n in sizes:
        qb = q[lo:lo + n]
        pad = BatchingFrontend._bucket(n, max_batch) - n
        if pad:
            qb = torch.cat([qb, qb[:1].expand(pad, -1)])
        s, i = store.search_device(qb.contiguous(), K, method=method)
        out_s.append(s[:n])
        out_i.append(i[:n])
        lo += n
    return torch.cat(out_s), torch.cat(out_i)


def phase_serving_path(ctx: dict) -> None:
    """3k: `ServingHTTPServer` over corpus B's resident store (cell I)."""
    import os
    import threading
    from lattice_tpu_torch.index import chunk_store as cs
    from lattice_tpu_torch.serving.http import ServingHTTPServer
    store, centers, gen = ctx["store2"], ctx["centers"], ctx["gen"]
    emb, valid = store.device_arrays
    n_q = SERVE_CLIENTS * SERVE_EACH
    q = cluster_rows(centers, n_q, gen, IVF_SPREAD)
    q256 = q[:SERVE_BATCH].contiguous()
    truth = exact_topk(q, emb, valid, K)
    rows = q.cpu().tolist()      # f32 -> JSON -> f32 is exact
    t0 = time.perf_counter()
    srv = ServingHTTPServer(store, warmup=True).start()
    try:
        base = "http://%s:%d" % srv.address
        fe = srv.router.peek()
        warm_s = wait_warm(base, fe)
        log(f"3k: server over corpus B ({len(store)} rows) warm in "
            f"{warm_s:.3f} s ({time.perf_counter() - t0:.3f} s from its "
            f"construction; {len(fe._warmed_buckets)} pad buckets)")

        # 64 concurrent clients, one query a request, the auto plan
        answers: list = [None] * n_q

        def client(c: int) -> None:
            for j in range(SERVE_EACH):
                i = c * SERVE_EACH + j
                answers[i] = http_call(base, "/v1/search_vector",
                                       {"vector": rows[i], "k": K})
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        before = (fe.stats.queries, fe.stats.batches)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        got = served_rows(answers).to(truth.device)
        r_auto = recall(got, truth)
        require(got.shape == (n_q, K) and r_auto >= cs.IVF_MIN_RECALL,
                f"served auto recall@{K} {r_auto:.4f}")
        st = fe.stats
        batches = st.batches - before[1]
        mean_batch = (st.queries - before[0]) / max(batches, 1)
        p50, p99 = st.latency_percentile(50), st.latency_percentile(99)
        plans = {store._plan_search(b, K, None, "auto")
                 for b in set(st.batch_sizes)}
        direct_ms = cuda_ms(lambda: store.search_device(q256, K), 20)
        ctx["serve_qps"] = n_q / wall
        log(f"3k: {SERVE_CLIENTS} clients x {SERVE_EACH} /v1/search_vector "
            f"(k={K}, auto: plans {sorted(plans)}): {n_q / wall:.1f} QPS "
            f"({wall:.3f} s), {batches} batches, mean batch "
            f"{mean_batch:.2f}, frontend p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
            f"recall@{K} {r_auto:.4f}; direct search_device B={SERVE_BATCH} "
            f"auto {direct_ms:.4f} ms ({SERVE_BATCH / direct_ms * 1e3:.1f} "
            f"QPS); {ctx.get('smi', '')}")

        t0 = time.perf_counter()
        status, body = http_call(base, "/v1/search_vector_batch",
                                 {"vectors": rows[:SERVE_BATCH], "k": K})
        batch_s = time.perf_counter() - t0
        got = served_rows([(status, it) for it in body["results"]])
        require(recall(got.to(truth.device), truth[:SERVE_BATCH])
                >= cs.IVF_MIN_RECALL, "batch endpoint recall")
        log(f"3k: one /v1/search_vector_batch of {SERVE_BATCH}: "
            f"{batch_s * 1e3:.3f} ms ({SERVE_BATCH / batch_s:.1f} QPS)")

        # PQ at full width, then every forced plan against the direct call
        t0 = time.perf_counter()
        pq = store.build_pq()
        torch.cuda.synchronize()
        pq_s = time.perf_counter() - t0
        os.environ["LATTICE_PQ"] = "1"
        try:
            pq_plan = store._plan_search(SERVE_BATCH, K, None, "auto")
        finally:
            del os.environ["LATTICE_PQ"]
        log(f"3k: build_pq {pq_s:.3f} s: m={pq.m}, ksub={pq.ksub}, "
            f"{pq.codes.shape[0]} x {pq.m} codes ({pq.codes.numel() / 1e6:.1f}"
            f" MB), {pq.memory_bytes() / 1e6:.1f} MB in all; self-measured "
            f"rescored recall@{K} {pq.measured_recall:.4f}; LATTICE_PQ=1 "
            f"auto plan {pq_plan!r}")
        for method in SERVE_FORCED:
            # through HTTP: the rows and rounded scores of search_device on
            # the batches the frontend dispatched
            status, body = http_call(base, "/v1/search_vector_batch",
                                     {"vectors": rows[:SERVE_BATCH], "k": K,
                                      "method": method})
            require(status == 200, f"{method}: {status}")
            fe_m = srv.router.peek(method=method)
            http_sizes = dispatched(fe_m, SERVE_BATCH)
            same_as_direct(body["results"], *as_dispatched(
                store, q256, http_sizes, method, fe_m.max_batch),
                f"served {method!r} against search_device")
            # raw f32 answers through the same router: ids and bit-equal
            # scores of search_device on the same batches
            futs = [srv.router.submit(v, K, method=method)
                    for v in q256.cpu().numpy()]
            res = [f.result(timeout=600) for f in futs]
            s_srv = torch.tensor(np.stack([r[0] for r in res]))
            i_srv = torch.tensor(np.stack([r[1] for r in res]))
            sizes = dispatched(fe_m, SERVE_BATCH)
            s_dir, i_dir = as_dispatched(store, q256, sizes, method,
                                         fe_m.max_batch)
            require(torch.equal(i_srv, i_dir.cpu())
                    and same_bits(s_srv, s_dir.cpu()),
                    f"{method}: served answers differ from search_device")
            # partners: the same queries at the same shape, in reverse
            # order and with every other partner replaced, bit-equal
            s_a, i_a = store.search_device(q256, K, method=method)
            s_b, i_b = store.search_device(q256.flip(0).contiguous(), K,
                                           method=method)
            mixed = q256.clone()
            mixed[1::2] = q[SERVE_BATCH:SERVE_BATCH + SERVE_BATCH // 2]
            s_c, i_c = store.search_device(mixed, K, method=method)
            require(torch.equal(i_b.flip(0), i_a)
                    and same_bits(s_b.flip(0), s_a)
                    and torch.equal(i_c[::2], i_a[::2])
                    and same_bits(s_c[::2], s_a[::2]),
                    f"{method}: a query's answer depends on its batch "
                    f"partners")
            # every 8th query alone: B=1 is another shape, whose
            # reductions may order sums otherwise, so scores may move in
            # their last bits (counted), but no id may move
            alone = [store.search_device(q256[j:j + 1], K, method=method)
                     for j in range(0, SERVE_BATCH, 8)]
            ids_off = sum(int((a[1][0] != i_a[j * 8]).sum())
                          for j, a in enumerate(alone))
            bits_off = sum(int((a[0][0].view(torch.int32)
                                != s_a[j * 8].view(torch.int32)).sum())
                           for j, a in enumerate(alone))
            require(ids_off == 0, f"{method}: {ids_off} ids of "
                    f"{len(alone)} queries alone (B=1) differ from "
                    f"B={SERVE_BATCH}")
            r = recall(i_a, truth[:SERVE_BATCH])
            log(f"3k: forced {method!r} through /v1/search_vector_batch "
                f"(dispatches {http_sizes}) and the router (dispatches "
                f"{sizes}) equals search_device on those batches (ids, "
                f"scores bit-equal); reversed and half-replaced partners "
                f"at B={SERVE_BATCH} bit-equal; {len(alone)} queries alone "
                f"(B=1): the same ids, {bits_off} of {len(alone) * K} "
                f"score bit patterns differ from B={SERVE_BATCH}; "
                f"recall@{K} {r:.4f}")
            if method == "pq":
                ctx["pq_recall"] = r
                pq_ms = cuda_ms(lambda: store.search_device(
                    q256, K, method="pq"), 5)
                pq_p50 = p50_ms(lambda j: store.search_device(
                    q[j:j + 1], K, method="pq"), 20)
                log(f"3k: 'pq' B={SERVE_BATCH} {pq_ms:.3f} ms "
                    f"({SERVE_BATCH / pq_ms * 1e3:.1f} QPS), B=1 p50 "
                    f"{pq_p50:.3f} ms; {ctx.get('smi', '')}")
        status, stats = http_call(base, "/v1/stats")
        agg = stats["configs"]["_aggregate"]
        require(status == 200 and agg["errors"] == 0
                and stats["errors"] == 0, f"/v1/stats {agg}")
        status, metrics = http_call(base, "/metrics")
        require(status == 200 and "lattice_errors_total" in metrics
                and f"lattice_corpus_rows {len(store)}" in metrics,
                "/metrics")
        log(f"3k: /v1/stats: {agg['queries']} queries in {agg['batches']} "
            f"batches over {len(stats['configs']) - 1} configurations, "
            f"{agg['errors']} errors, {agg['cold_compiles']} cold compiles")
    finally:
        srv.shutdown()
    ctx["serve_pq"], ctx["serve_q"] = pq, normalize(q256)


def phase_serving_kernels(ctx: dict, err: dict) -> None:
    """3k, after its launch counts are read: kernel B at "pq"'s shapes.
    `PQIndex.search_device` at the store's k1 = max(k, 32) (`pq_topk`:
    `lt_merge_positions` on [B, 4096] block rows, the one-block route, and
    `lt_merge_candidates` on [B, 2 k1] running lists) at B = 256 and 1,
    against the same call with `stable_topk` and `merge_candidates_plain`
    in their place on the same card tensors: ids equal, scores
    bit-equal."""
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.ops import scan_topk as scan
    from lattice_tpu_torch.ops import topk as topk_ops
    from lattice_tpu_torch.ops.pq import DEFAULT_BLOCK
    pq, q = ctx.pop("serve_pq"), ctx.pop("serve_q")
    k1 = max(K, 32)
    n_blocks = -(-pq.codes.shape[0] // DEFAULT_BLOCK)
    kept = scan.merge_positions, scan.merge_candidates
    for qb in (q, q[:1]):
        before = _build.entry_launch_counts()
        ks, ki = pq.search_device(qb, k1)
        torch.cuda.synchronize()
        after = _build.entry_launch_counts()
        ran = {e: after.get(e, 0) - before.get(e, 0)
               for e in ("lt_merge_positions", "lt_merge_candidates")}
        require(all(v == n_blocks for v in ran.values()),
                f"pq_topk at B={qb.shape[0]}: kernel B launches {ran}, "
                f"not {n_blocks} blocks of each entry")
        scan.merge_positions = topk_ops.stable_topk
        scan.merge_candidates = scan.merge_candidates_plain
        try:
            ps, pi = pq.search_device(qb, k1)
        finally:
            scan.merge_positions, scan.merge_candidates = kept
        require(torch.equal(ki, pi) and same_bits(ks, ps),
                f"pq_topk at B={qb.shape[0]}, k1={k1}: kernel B differs "
                f"from its plain versions: ids agree on "
                f"{(ki == pi).float().mean().item():.6f}")
        finite = torch.isfinite(ps)
        if bool(finite.any()):
            err["merge_candidates"] = max(
                err["merge_candidates"],
                (ks - ps)[finite].abs().max().item())
        log(f"3k: pq_topk at B={qb.shape[0]}, k1={k1} ({n_blocks} blocks "
            f"of {DEFAULT_BLOCK} rows; kernel B {ran}): ids equal and scores "
            f"bit-equal to stable_topk + merge_candidates_plain")


def same_ranked(got: list[dict], want: list[dict], where: str) -> int:
    """Ranked results as JSON (scores rounded as the surface rounds them):
    the same scores in order, the same items in each run of equal scores
    (which both processes order by their own string hash seed). Returns
    the runs in another order."""
    require([r["score"] for r in got] == [r["score"] for r in want],
            f"{where}: scores {[r['score'] for r in got][:6]} / "
            f"{[r['score'] for r in want][:6]}")
    permuted, lo = 0, 0
    dump = functools.partial(json.dumps, sort_keys=True)
    for i in range(1, len(want) + 1):
        if i == len(want) or want[i]["score"] != want[lo]["score"]:
            a, b = list(map(dump, got[lo:i])), list(map(dump, want[lo:i]))
            require(sorted(a) == sorted(b), f"{where}: results "
                    f"{got[lo:i][:2]} / {want[lo:i][:2]}")
            permuted += a != b
            lo = i
    return permuted


def same_text(got: str, want: str, where: str) -> int:
    """An answer text, or the same lines in another order (tied sources).
    Returns 1 if reordered."""
    if got == want:
        return 0
    require(sorted(got.splitlines()) == sorted(want.splitlines()),
            f"{where}: {got[:300]!r} / {want[:300]!r}")
    return 1


def ranked_json(results) -> list[dict]:
    """`ServingHTTPServer._ranked` of in-process results."""
    from lattice_tpu_torch.serving.http import ServingHTTPServer
    return json.loads(json.dumps(ServingHTTPServer._ranked(results)))


def phase_serving_cli(ctx: dict) -> None:
    """3l: `lattice serve` and `lattice mcp` as processes over 3j's
    persisted index of the golden fixture, on the card, against the same
    index loaded in this process."""
    import asyncio
    import os
    import shutil
    import signal
    from lattice_tpu_torch import main as cli
    from lattice_tpu_torch.config.settings import Settings
    from lattice_tpu_torch.mcp.server import MCPServer
    from lattice_tpu_torch.ops import _build
    keep = ctx.pop("cli_index")
    try:
        repo, env_file = keep / "golden", keep / "cli.env"
        settings = Settings.from_env(env_file)
        engine, _ = cli._load_engine(repo, settings, "cuda")
        store = engine.indexer.code
        embed = engine.vector_searcher.embedder
        _, batch, texts = cli_texts(golden_cases())
        singles = texts[:SERVE_CLI_EACH]
        env = {**os.environ, "HOME": str(keep)}
        argv = ["--env", str(env_file)]
        t0 = time.perf_counter()
        err_file = keep / "serve.err"
        with open(err_file, "w") as err_out:
            proc = subprocess.Popen(
                [sys.executable, "-c", CLI_SCRIPT, str(ROOT), *argv, "serve",
                 "--path", str(repo), "--port", "0"],
                stdout=subprocess.PIPE, stderr=err_out, text=True, env=env,
                cwd=str(keep))
        try:
            line = proc.stdout.readline()
            start_s = time.perf_counter() - t0
            require("serving" in line and "http://" in line,
                    f"serve printed {line!r}: "
                    f"{err_file.read_text()[-2000:]}")
            base = "http://" + line.split("http://")[1].split()[0]
            require(not base.endswith(":0"), f"unbound port in {line!r}")
            status, health = http_call(base, "/healthz")
            require(status == 200 and health["corpus"] == len(store),
                    f"/healthz {health}")
            reordered = 0
            times: dict[str, list[float]] = {}

            def post(path, body):
                t = time.perf_counter()
                status, out = http_call(base, path, body)
                times.setdefault(path, []).append(time.perf_counter() - t)
                require(status == 200, f"{path}: {status} {out}")
                return out

            for text in singles:
                vec = torch.from_numpy(embed.embed(text))[None]
                s, i = store.search_device(vec, K)
                same_as_direct([post("/v1/search", {"query": text, "k": K})],
                               s, i, f"/v1/search {text!r}")
            # the server may split the batch into other shapes than this
            # call's, whose scores can differ in their last bits
            out = post("/v1/search_batch", {"queries": batch, "k": K})
            s, i = store.search_device(
                torch.from_numpy(embed.embed_batch(batch)), K)
            same_as_direct(out["results"], s, i, "/v1/search_batch",
                           tol=1e-4)
            for text in singles:
                out = post("/v1/query", {"query": text})
                res = engine.query_sync(text)
                reordered += same_ranked(out["results"],
                                         ranked_json(res.results),
                                         f"/v1/query {text!r}")
                reordered += same_text(out["answer"], res.answer,
                                       f"/v1/query {text!r} answer")
                out = post("/v1/deep_search", {"query": text})
                reordered += same_ranked(
                    out["results"], ranked_json(engine.deep_search(
                        text).results), f"/v1/deep_search {text!r}")
            out = post("/v1/deep_search_batch", {"queries": batch})
            for item, res in zip(out["results"],
                                 engine.deep_search_batch(batch)):
                reordered += same_ranked(item["results"],
                                         ranked_json(res.results),
                                         f"/v1/deep_search_batch {res.query!r}")
            status, stats = http_call(base, "/v1/stats")
            require(status == 200 and stats["errors"] == 0
                    and stats["configs"]["_aggregate"]["errors"] == 0
                    and stats["corpus"] == len(store), f"/v1/stats {stats}")
            status, metrics = http_call(base, "/metrics")
            require(status == 200 and "lattice_queries_total" in metrics,
                    "/metrics")
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        require(proc.returncode == 0 and "shutting down" in rest,
                f"serve exited {proc.returncode}: "
                f"{err_file.read_text()[-2000:]}")
        tail = json.loads(rest.rstrip("\n").rpartition("\n")[2])
        require(tail["rc"] == 0, f"serve returned {tail['rc']}")
        launches, by_kernel = dict(tail["launches"]), tail["by_kernel"]
        log(f"3l: `lattice serve` printed its address {start_s:.3f} s after "
            f"the process started (imports {tail['import_s']:.3f} s); "
            + "; ".join(f"{p} {statistics.median(v) * 1e3:.3f} ms p50 x"
                        f"{len(v)}" for p, v in times.items())
            + f"; answers equal the in-process engine's ({reordered} tie "
            f"runs or answer lines in another order); SIGTERM: exit 0; "
            f"launches in the process {launches}; {ctx.get('smi', '')}")

        # the MCP stdio server, against an in-process MCPServer
        calls = [("semantic_search", {"query": singles[0], "limit": K}),
                 ("query_code_graph", {"question": singles[1]}),
                 ("get_code_snippet", {"entity": "UserService",
                                       "context_lines": 1}),
                 ("deep_search_batch", {"questions": batch, "limit": K})]
        reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                 "params": {}},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"}]
        reqs += [{"jsonrpc": "2.0", "id": 3 + n, "method": "tools/call",
                  "params": {"name": name, "arguments": args}}
                 for n, (name, args) in enumerate(calls)]
        reqs.append({"jsonrpc": "2.0", "id": 99, "method": "shutdown"})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_SCRIPT, str(ROOT), *argv, "mcp",
             "--path", str(repo)],
            input="".join(json.dumps(r) + "\n" for r in reqs),
            capture_output=True, text=True, env=env, cwd=str(keep),
            timeout=600)
        mcp_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"mcp exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        lines = proc.stdout.rstrip("\n").split("\n")
        tail = json.loads(lines[-1])
        require(tail["rc"] == 0, f"mcp returned {tail['rc']}")
        for name, n in tail["launches"].items():
            launches[name] = launches.get(name, 0) + n
        for name, entries in tail["by_kernel"].items():
            mine = by_kernel.setdefault(name, {})
            for e, n in entries.items():
                mine[e] = mine.get(e, 0) + n
        by_id = {r["id"]: r for r in map(json.loads, lines[:-1])}
        local = MCPServer(repo, settings, device="cuda")

        def in_process(req):
            return asyncio.run(local.handle_request(req))
        for req in reqs[:2]:
            require(by_id[req["id"]] == in_process(req), f"mcp {req}")
        mcp_reordered = 0
        for req in reqs[2:-1]:
            got, want = by_id[req["id"]]["result"], in_process(req)["result"]
            name = req["params"]["name"]
            require(not got["isError"] and not want["isError"],
                    f"{name}: {got} / {want}")
            g = json.loads(got["content"][0]["text"])
            w = json.loads(want["content"][0]["text"])
            g.pop("phase_times_ms", None)
            w.pop("phase_times_ms", None)
            if name == "semantic_search":
                mcp_reordered += same_ranked(g["results"], w["results"], name)
            elif name == "query_code_graph":
                mcp_reordered += same_ranked(g.pop("sources"),
                                             w.pop("sources"), name)
                mcp_reordered += same_text(g.pop("answer"), w.pop("answer"),
                                           name)
                require(g == w, f"{name}: {g} / {w}")
            elif name == "deep_search_batch":
                for ga, wa in zip(g["answers"], w["answers"], strict=True):
                    mcp_reordered += same_ranked(ga.pop("results"),
                                                 wa.pop("results"), name)
                    require(ga == wa, f"{name}: {ga} / {wa}")
            else:
                require(g == w, f"{name}: {g} / {w}")
        log(f"3l: `lattice mcp` over stdio: initialize, tools/list and "
            f"tools/call of {[c[0] for c in calls]} equal an in-process "
            f"MCPServer's ({mcp_reordered} tie runs or answer lines in "
            f"another order); the process {mcp_s:.3f} s start to exit")
        for name in ("scan_topk_int8", "merge_candidates"):
            require(launches.get(name, 0) > 0,
                    f"{name} never ran in the serve or mcp process")
        # the processes' launches count with this process's own
        for k in _build.KERNELS:
            k.launches += launches.get(k.name, 0)
            for e, n in by_kernel.get(k.name, {}).items():
                k.entry_launches[e] = k.entry_launches.get(e, 0) + n
        log(f"3l: launches in the serve and mcp processes {launches}, by C "
            f"entry {by_kernel}")
    finally:
        shutil.rmtree(keep, ignore_errors=True)


# ---- 3m: training (cell J) --------------------------------------------------

TRAIN_STEPS = 100          # 3m(b): `lattice train`'s defaults
TRAIN_BATCH = 16
TRAIN_LEN = 256
TRAIN_LR = 2e-5
CHECK_STEPS = 3            # 3m(a): the card's first steps against the CPU's
CHECK_LEN = 64
# bf16 products on both devices (cuBLAS and the CPU's accumulate in other
# orders and round in other places) through 12 layers and both encodes
CHECK_LOSS_RTOL = 1e-2
# AdamW moves an element by about lr a step (|m_hat| / sqrt(v_hat) ~ 1,
# a little over 1 at the first steps), and bf16 noise can flip the sign of
# a near-zero gradient, so the devices may move an element apart by up to
# ~2 lr a step: 3 lr a step bounds it
CHECK_PARAM_TOL = 3 * CHECK_STEPS * TRAIN_LR
MEM_STEPS = 5              # 3m(b): steps each with remat on and off
WRITER_LAYER = "layer_0/"  # 3m(b): the arrays both npz writers are timed on
FUSED_ORDER = ("unfused", "fused", "fused", "unfused")

# the HF RoBERTa names of one encoder layer's tensors, [out, in] / [out]
HF_LAYER = (("attention.self.query", True), ("attention.self.key", True),
            ("attention.self.value", True), ("attention.output.dense", True),
            ("attention.output.LayerNorm", False),
            ("intermediate.dense", True), ("output.dense", True),
            ("output.LayerNorm", False))


def train_batches(run, n: int, max_length: int) -> tuple[list[dict], int]:
    """The first `n` batches `lattice train` would take from 3g(b)'s
    stores (`mine_pairs`, `PairBatcher` at the CLI's batch and seed)."""
    from lattice_tpu_torch.models.data import PairBatcher, mine_pairs
    from lattice_tpu_torch.models.unixcoder import UniXcoderConfig
    from lattice_tpu_torch.text.tokenizer import CodeTokenizer
    pairs = mine_pairs(run.indexer.code, run.indexer.summaries)
    batcher = PairBatcher(pairs, CodeTokenizer(
        vocab_size=UniXcoderConfig().vocab_size), batch_size=TRAIN_BATCH,
        max_length=max_length, seed=SEED)
    batches = batcher.batches()
    return [next(batches) for _ in range(n)], len(pairs)


def batch_tokens(batch: dict) -> tuple[int, int]:
    """(padded, live) tokens of both sides of a batch."""
    return (batch["anchor_ids"].size + batch["positive_ids"].size,
            int(batch["anchor_mask"].sum() + batch["positive_mask"].sum()))


def phase_train_path(ctx: dict) -> None:
    """3m: training at full width over 3g(b)'s stores (cell J)."""
    t0 = time.perf_counter()
    phase_train_parity(ctx)
    phase_train_finetune(ctx)
    phase_fused_qkv(ctx)
    phase_train_cli(ctx)
    log(f"phase 3m took {time.perf_counter() - t0:.2f} s")


def phase_train_parity(ctx: dict) -> None:
    """3m(a): `ContrastiveTrainer`'s first steps on the card against the
    CPU's, at `UniXcoderConfig()` from one seed, on the same batches
    (max_length 64): losses and parameters within the stated bars; the
    trainer never launches `paired_attention`."""
    from lattice_tpu_torch.models.train import ContrastiveTrainer
    from lattice_tpu_torch.ops import _build
    batches, n_pairs = train_batches(ctx["real_run"], CHECK_STEPS, CHECK_LEN)
    before = _build.launch_counts()["paired_attention"]
    card = ContrastiveTrainer(learning_rate=TRAIN_LR, seed=SEED,
                              device="cuda")
    # remat recomputes the same layers (bit-equal on the CPU, held in
    # tests/test_torch_port_train.py), so the CPU's steps skip it
    host = ContrastiveTrainer(learning_rate=TRAIN_LR, seed=SEED, remat=False,
                              device="cpu")
    require(all(torch.equal(a.cpu(), b) for a, b in zip(
        card.state_dict().values(), host.state_dict().values())),
        "the card's and the CPU's trainers start from other weights")
    start = [p.clone() for p in host.state_dict().values()]
    losses, host_s = [], 0.0
    for batch in batches:
        lc = card.train_step(batch)
        t0 = time.perf_counter()
        lh = host.train_step(batch)
        host_s += time.perf_counter() - t0
        losses.append((lc, lh))
    worst = max(abs(c - h) / abs(h) for c, h in losses)
    diffs = torch.cat([(a.cpu() - b).abs().flatten()
                       for a, b in zip(card.state_dict().values(),
                                       host.state_dict().values())])
    moved = torch.cat([(a - b).abs().flatten()
                       for a, b in zip(host.state_dict().values(), start)])
    launched = _build.launch_counts()["paired_attention"] - before
    log(f"3m(a): {CHECK_STEPS} steps at UniXcoderConfig(), batch "
        f"{TRAIN_BATCH}, max_length {CHECK_LEN} ({n_pairs} pairs mined from "
        f"{REAL_REPO}/): losses card / CPU "
        f"{[(round(c, 6), round(h, 6)) for c, h in losses]}, worst relative "
        f"difference {worst:.3g} (bar {CHECK_LOSS_RTOL}); parameters apart "
        f"by max {diffs.max().item():.3g} (bar {CHECK_PARAM_TOL:.3g}), mean "
        f"{diffs.mean().item():.3g}, against a mean move of "
        f"{moved.mean().item():.3g} from the start; the CPU's steps "
        f"{host_s:.1f} s; paired_attention launches {launched}")
    require(worst <= CHECK_LOSS_RTOL, f"training losses differ by {worst}")
    require(diffs.max().item() <= CHECK_PARAM_TOL,
            f"trained parameters differ by {diffs.max().item()}")
    require(launched == 0, "the trainer launched paired_attention")


def phase_train_finetune(ctx: dict) -> None:
    """3m(b): `finetune_from_index` at full width over 3g(b)'s stores, the
    CLI's defaults (100 steps, batch 16, max_length 256, lr 2e-5): step
    times, tokens/s, the tokenizer's share, peak device memory, the
    checkpoint's write; both npz writers on one layer's arrays; then remat
    on against off on the same batches. 3m(c): the checkpoint loaded by a
    card `UniXcoderModel(finetune_dir=...)` embeds through
    `paired_attention` as the CPU model on the same checkpoint does."""
    import tempfile
    from lattice_tpu_torch.models import finetune
    from lattice_tpu_torch.models.train import ContrastiveTrainer
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.text.tokenizer import CodeTokenizer
    run, smi = ctx["real_run"], ctx["smi"]
    steps, marks, tok_s = [], {}, [0.0]

    class Timed(ContrastiveTrainer):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            marks["loop"] = time.perf_counter()
            marks["init_s"] = marks["loop"] - t0

        def train_step(self, batch):
            t0 = time.perf_counter()
            loss = super().train_step(batch)   # float(): synchronized
            marks["last"] = time.perf_counter()
            steps.append((marks["last"] - t0, *batch_tokens(batch)))
            return loss

    encode_batch = CodeTokenizer.encode_batch

    def timed_encode(self, texts, max_length=512):
        t0 = time.perf_counter()
        out = encode_batch(self, texts, max_length)
        tok_s[0] += time.perf_counter() - t0
        return out

    before = _build.launch_counts()["paired_attention"]
    with tempfile.TemporaryDirectory() as tmp:
        finetune.ContrastiveTrainer = Timed
        CodeTokenizer.encode_batch = timed_encode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            report = finetune.finetune_from_index(
                run.indexer.code, run.indexer.summaries, data_dir=tmp,
                steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                max_length=TRAIN_LEN, learning_rate=TRAIN_LR, seed=SEED,
                device="cuda")
            done = time.perf_counter()
        finally:
            finetune.ContrastiveTrainer = ContrastiveTrainer
            CodeTokenizer.encode_batch = encode_batch
        peak = torch.cuda.max_memory_allocated()
        require(_build.launch_counts()["paired_attention"] == before,
                "finetune_from_index launched paired_attention")
        ckpt = Path(tmp) / "finetuned_params.npz"
        require(report["status"] == "completed"
                and report["steps"] == TRAIN_STEPS == len(steps)
                and report["checkpoint"] == str(ckpt) and ckpt.is_file()
                and math.isfinite(report["last_loss"]),
                f"finetune_from_index: {report}")
        loop = marks["last"] - marks["loop"]
        ms = [s * 1e3 for s, _, _ in steps]
        padded = sum(p for _, p, _ in steps)
        live = sum(n for _, _, n in steps)
        log(f"3m(b): finetune_from_index over {REAL_REPO}/'s stores, "
            f"{report['pairs_mined']} pairs, {TRAIN_STEPS} steps x batch "
            f"{TRAIN_BATCH} (max_length {TRAIN_LEN}, remat on): loss "
            f"{report['first_loss']} -> {report['last_loss']}; trainer made "
            f"in {marks['init_s']:.2f} s; the loop {loop:.2f} s: step p50 "
            f"{statistics.median(ms[1:]):.2f} ms (first {ms[0]:.1f}, p90 "
            f"{sorted(ms)[int(0.9 * len(ms))]:.2f}), {padded / loop:.0f} "
            f"padded tokens/s ({live / loop:.0f} live; {padded} and {live} "
            f"in all), the tokenizer {tok_s[0]:.2f} s = "
            f"{tok_s[0] / loop:.3f} of the loop; checkpoint "
            f"{ckpt.stat().st_size / 1e6:.1f} MB written in "
            f"{done - marks['last']:.2f} s (np.savez); peak device memory "
            f"{peak / 1e9:.2f} GB ({smi})")
        phase_npz_writers(ckpt, smi)
        phase_finetuned_embeds(ctx, Path(tmp))
    phase_remat_memory(ctx, smi)


def phase_npz_writers(ckpt: Path, smi: str) -> None:
    """Both writers on the same arrays (one encoder layer's): the
    reference's `np.savez_compressed` and the port's `np.savez`."""
    import tempfile
    with np.load(ckpt) as flat:
        arrays = {k: flat[k] for k in flat.files if k.startswith(WRITER_LAYER)}
    size = sum(a.nbytes for a in arrays.values())
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for writer in (np.savez, np.savez_compressed):
            t0 = time.perf_counter()
            writer(Path(tmp) / f"{writer.__name__}.npz", **arrays)
            rates[writer.__name__] = size / (time.perf_counter() - t0) / 1e6
    log(f"3m(b): npz writers on {WRITER_LAYER}'s {len(arrays)} arrays "
        f"({size / 1e6:.1f} MB of f32): np.savez {rates['savez']:.1f} MB/s, "
        f"np.savez_compressed {rates['savez_compressed']:.2f} MB/s; at that "
        f"rate the whole checkpoint ({ckpt.stat().st_size / 1e6:.1f} MB) "
        f"takes {ckpt.stat().st_size / 1e6 / rates['savez_compressed']:.1f}"
        f" s compressed ({smi})")


def phase_finetuned_embeds(ctx: dict, data_dir: Path) -> None:
    """3m(c): the fine-tuned checkpoint through `finetune_dir` on the card
    (`paired_attention`, 12 launches a forward, one forward a length
    bucket of the rows) and on the CPU (its plain version), 16 of the
    store's chunks: every pooled cosine >= 0.999."""
    from lattice_tpu_torch.models.unixcoder import UniXcoderModel
    from lattice_tpu_torch.ops import _build
    card = UniXcoderModel(finetune_dir=data_dir, device="cuda")
    host = UniXcoderModel(finetune_dir=data_dir, device="cpu")
    require(card.loaded_finetuned and host.loaded_finetuned
            and "+ft-" in card.weights_fingerprint,
            f"the checkpoint did not load: {card.weights_fingerprint}")
    store = ctx["real_run"].indexer.code
    texts = [p["content"] for p in store._payloads if p][:TRAIN_BATCH]
    ids, mask = ctx["provider"].tokenizer.encode_batch(texts, TRAIN_LEN)
    before = _build.launch_counts()["paired_attention"]
    with counted_forwards(card) as seen:
        a = card.encode(ids, mask)
    launched = _build.launch_counts()["paired_attention"] - before
    b = host.encode(ids, mask)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b,
                                                                      axis=1)
    log(f"3m(c): the fine-tuned checkpoint ({card.weights_fingerprint}) on "
        f"the card and on the CPU, {len(texts)} chunks of up to "
        f"{len(ids[0])} tokens: pooled cosine min "
        f"{cos.min():.7f}, max abs difference {np.abs(a - b).max():.3g}; "
        f"{seen['forwards']} forwards, paired_attention launches "
        f"{launched}")
    require_forwards(seen, launched, card.config.num_layers, "3m(c)")
    require(cos.min() >= 0.999, f"fine-tuned embeddings: cosine {cos.min()}")


def phase_remat_memory(ctx: dict, smi: str) -> None:
    """3m(b): the same batches (max_length 256) through a trainer with
    remat on and one with it off: step p50 and peak device memory."""
    import gc
    from lattice_tpu_torch.models.train import ContrastiveTrainer
    batches, _ = train_batches(ctx["real_run"], MEM_STEPS, TRAIN_LEN)
    out = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = ContrastiveTrainer(learning_rate=TRAIN_LR, seed=SEED,
                                     remat=remat, device="cuda")
        ms = []
        for batch in batches:
            t0 = time.perf_counter()
            trainer.train_step(batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[remat] = (statistics.median(ms[1:]),
                      (torch.cuda.max_memory_allocated() - base) / 1e9)
        if remat:
            trace_train_steps(trainer, batches[:2], smi)
        del trainer
    shapes = [b["anchor_ids"].shape[1] for b in batches]
    log(f"3m(b): remat on / off, {MEM_STEPS} steps at batch {TRAIN_BATCH} "
        f"(lengths {shapes}): step p50 {out[True][0]:.2f} / "
        f"{out[False][0]:.2f} ms, peak device memory above the start "
        f"{out[True][1]:.2f} / {out[False][1]:.2f} GB ({smi})")


def trace_train_steps(trainer, batches: list[dict], smi: str) -> None:
    """A `utils/tracing.py` device trace of training steps: device busy
    ms a step, the idle share of the traced window, the kernels that took
    the most time."""
    from lattice_tpu_torch.utils.tracing import (_device_events,
                                                 _load_events,
                                                 device_trace,
                                                 summarize_device_trace)
    where = str(ROOT / "build" / "traces" / "train")
    with device_trace(where):
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        wall = (time.perf_counter() - t0) * 1e3
    summ = summarize_device_trace(where, "GPU", top=1 << 20)
    require("error" not in summ and summ["total_ms"] > 0,
            f"training trace: {summ.get('error', 'no device time')}")
    n, busy = len(batches), summ["total_ms"]
    kernels = sum(1 for _ in _device_events(_load_events(where)))
    log(f"3m(b): training trace, {n} steps (remat on): device busy "
        f"{busy / n:.3f} ms a step, idle {1 - busy / wall:.4f} of the traced "
        f"window ({wall / n:.3f} ms a step under the profiler); "
        f"{kernels / n:.0f} device events a step; top kernels (ms over "
        f"{n} steps): {top_kernels(summ)} ({smi})")


def phase_fused_qkv(ctx: dict) -> None:
    """3m(d): `enable_fused_qkv` at B=128, L=512 on this checkout's chunks:
    pooled cosine against the unfused model >= 0.999, chunks/s of each
    (unfused, fused, fused, unfused); one layer's fused q/k/v slices
    through the kernel bit-equal to the kernel on contiguous copies, and
    within phase 2's bar of the plain version."""
    from lattice_tpu_torch.models import unixcoder as um
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.ops import attention as attn
    smi, tok = ctx["smi"], ctx["provider"].tokenizer
    ids, mask = tok.encode_batch(ctx["enc_texts"][:ENC_BATCH], ENC_LEN)
    pad = ENC_LEN - len(ids[0])
    ids = torch.tensor([r + [tok.PAD] * pad for r in ids], device="cuda")
    mask = torch.tensor([r + [0] * pad for r in mask], device="cuda")
    models = {"unfused": um.UniXcoderModel(device="cuda"),
              "fused": um.UniXcoderModel(device="cuda")}
    models["fused"].enable_fused_qkv()
    require(models["fused"].weights_fingerprint.endswith("+qkvfused")
            and models["fused"].config.fused_qkv, "enable_fused_qkv")
    seen = []

    def spy(q, k, v, m, scale, _real=um.paired_attention):
        if not seen:
            seen.append((q, k, v, m, scale))
        return _real(q, k, v, m, scale)

    before = _build.launch_counts()["paired_attention"]
    um.paired_attention = spy
    try:
        with counted_forwards(models["fused"]) as calls:
            fused = models["fused"].encode_device(ids, mask)
    finally:
        um.paired_attention = attn.paired_attention
    launched = _build.launch_counts()["paired_attention"] - before
    unfused = models["unfused"].encode_device(ids, mask)
    cos = torch.nn.functional.cosine_similarity(fused, unfused)
    q, k, v, m, scale = seen[0]
    strided = attn.paired_attention(q, k, v, m, scale)
    copies = attn.paired_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), m, scale)
    plain = attn.paired_attention_plain(q, k, v, m, scale)
    e = (strided - plain).abs().max().item()
    ms = {}
    for name in FUSED_ORDER:
        model = models[name]
        ms.setdefault(name, []).append(
            cuda_ms(lambda: model.encode_device(ids, mask), 5, 2))
    chunks = {n: [round(ENC_BATCH / t * 1e3, 1) for t in v]
              for n, v in ms.items()}
    log(f"3m(d): fused QKV at B={ENC_BATCH}, L={ENC_LEN}: pooled cosine "
        f"against unfused min {cos.min().item():.7f}; q/k/v of layer 0 "
        f"{tuple(q.shape)} at strides {q.stride()} (contiguous "
        f"{q.is_contiguous()}), kernel on the slices bit-equal to the "
        f"kernel on copies {torch.equal(strided, copies)}, max abs error "
        f"against plain {e:.3g}; paired_attention launches {launched} in "
        f"{calls['forwards']} forwards; "
        f"chunks/s {' / '.join(f'{n} {c}' for n, c in chunks.items())} "
        f"(in order {FUSED_ORDER}; ms {ms}; {smi})")
    require(not q.is_contiguous() and q.stride()[1] == 3 * q.shape[2],
            f"the fused q is not a column slice: strides {q.stride()}")
    require(torch.equal(strided, copies), "paired_attention on the fused "
            "slices differs from the kernel on contiguous copies")
    require(e <= 1e-2, f"paired_attention on the fused slices: error {e}")
    require_forwards(calls, launched, 12, "3m(d) fused forward")
    require(cos.min().item() >= 0.999, f"fused QKV: cosine {cos.min()}")
    del models, seen
    torch.cuda.empty_cache()


def write_hf_checkpoint(d: Path, seed: int) -> None:
    """A synthetic full-size checkpoint in HF RoBERTa layout (the
    unixcoder-base config: 12 x 768, vocab 50,265, 514 positions) with its
    config.json, drawn from a seed: `validate-weights`' input where no
    real checkpoint is mounted."""
    gen = torch.Generator().manual_seed(seed)
    h, ffn, layers = 768, 3072, 12

    def draw(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    state = {"embeddings.word_embeddings.weight": draw(50265, h),
             "embeddings.position_embeddings.weight": draw(514, h),
             "embeddings.token_type_embeddings.weight": draw(10, h),
             "embeddings.LayerNorm.weight": torch.ones(h),
             "embeddings.LayerNorm.bias": torch.zeros(h)}
    for i in range(layers):
        for name, dense in HF_LAYER:
            out_f = ffn if name == "intermediate.dense" else h
            in_f = ffn if name == "output.dense" else h
            key = f"encoder.layer.{i}.{name}"
            state[f"{key}.weight"] = (draw(out_f, in_f) if dense
                                      else torch.ones(out_f))
            state[f"{key}.bias"] = torch.zeros(out_f)
    d.mkdir(parents=True)
    torch.save(state, d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({
        "model_type": "roberta", "vocab_size": 50265, "hidden_size": h,
        "num_hidden_layers": layers, "num_attention_heads": 12,
        "intermediate_size": ffn, "max_position_embeddings": 514,
        "type_vocab_size": 10, "layer_norm_eps": 1e-5, "pad_token_id": 1}))


def phase_train_cli(ctx: dict) -> None:
    """3m(e): a copy of the golden fixture indexed and saved in this
    process (as `lattice index` saves it), then `lattice train --steps 4`
    over it and `lattice validate-weights` on a synthetic full-size
    checkpoint, each a process of the port's CLI on the card, each exiting
    0 with the reference's report; their launches count with this
    path's."""
    import asyncio
    import shutil
    import tempfile
    from lattice_tpu_torch.config.settings import Settings
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.providers.factory import get_embedding_provider
    from lattice_tpu_torch.storage import persistence
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        repo = tmp / "golden"
        shutil.copytree(GOLDEN, repo)
        env_file = tmp / "cli.env"
        env_file.write_text("EMBEDDING_PROVIDER=hash\n"
                            f"EMBEDDING_DIMENSIONS={GOLDEN_DIM}\n")
        settings = Settings.from_env(env_file)
        run = asyncio.run(PipelineOrchestrator(
            repo, Embedder(get_embedding_provider(settings.ai,
                                                  device="cuda")),
            project_name="train_cli", settings=settings,
            device="cuda").run())
        persistence.save_index(
            repo / settings.storage.data_dir, run.graph_builder.store,
            run.indexer, project="train_cli",
            provider=settings.ai.embedding_provider,
            file_hashes={f.relative_path: f.content_hash for f in run.files})
        (tmp / "home").mkdir()
        lattice = CliProcesses(env_file, tmp / "home", "cuda")
        out, _ = lattice("train", "train", "--path", str(repo), "--steps",
                         "4")
        report = json.loads(out[out.index("{"):])
        ckpt = repo / ".lattice" / "finetuned_params.npz"
        require(report["status"] == "completed" and report["steps"] == 4
                and report["checkpoint"] == str(ckpt) and ckpt.is_file()
                and "step 4/4 loss=" in out, f"lattice train: {out[-800:]}")
        write_hf_checkpoint(tmp / "hf", SEED)
        out, _ = lattice("validate-weights", "validate-weights",
                         str(tmp / "hf"))
        vrep = json.loads(out)
        checks = vrep["checks"]
        require(vrep["ok"] and checks["param_mapping"]["ok"]
                and checks["embedding_probe"]["ok"]
                and checks["state_dict"]["config"]["hidden_size"] == 768
                and checks["torch_parity"]["ok"] is not False,
                f"validate-weights: {json.dumps(vrep)[:1500]}")
        for k in _build.KERNELS:
            k.launches += lattice.launches.get(k.name, 0)
            for e, n in lattice.by_kernel.get(k.name, {}).items():
                k.entry_launches[e] = k.entry_launches.get(e, 0) + n
        times = "; ".join(f"`{label}` {wall:.2f} s (imports {imp:.2f}, "
                          f"main() {main_s:.2f})"
                          for label, wall, imp, main_s in lattice.times)
        log(f"3m(e): CLI processes on the card: {times}; train {report}; "
            f"validate-weights checks "
            f"{ {n: c['ok'] for n, c in checks.items()} } (parity: "
            f"{checks['torch_parity']}); launches "
            f"{lattice.by_kernel.get('paired_attention')} ({ctx['smi']})")


MESH_SHARDS = 4            # 3o: logical shards on the one card
MESH_MP = 2                # 3o: the model axis of the dp x tp mesh
# 3o(a): the largest distance (relative L2 over every weight) of a mesh
# trainer's first gradient from the single device's: 3 x the largest sound
# reading. The bf16 products round at other shapes on a mesh, and a tp
# split rounds each partial product: 3o(a) read 3.3e-3 (dp-4) and 1.4e-2
# (dp-2 x tp-2), the planted faults 0.47-0.61 (PERF.md section 6)
GRAD_RTOL = 5e-2
# 3o(d): (LATTICE_PAIRED_ATTN, LATTICE_FLASH_ATTN) -> paired_attention
# launches in one forward of the 12-layer encoder
LEVER_LAUNCHES = {("0", None): 0, ("1", None): 12, (None, "1"): 0}


@contextlib.contextmanager
def attention_env(paired: str | None, flash: str | None):
    """LATTICE_PAIRED_ATTN / LATTICE_FLASH_ATTN set (None: unset) within the
    block, the caller's values back after it."""
    names = ("LATTICE_PAIRED_ATTN", "LATTICE_FLASH_ATTN")
    saved = {n: os.environ.get(n) for n in names}
    try:
        for n, v in zip(names, (paired, flash)):
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def encoder_batch(ctx: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """This checkout's first ENC_BATCH chunks at ENC_LEN on the card."""
    tok = ctx["provider"].tokenizer
    ids, mask = tok.encode_batch(ctx["enc_texts"][:ENC_BATCH], ENC_LEN)
    pad = ENC_LEN - len(ids[0])
    return (torch.tensor([r + [tok.PAD] * pad for r in ids], device="cuda"),
            torch.tensor([r + [0] * pad for r in mask], device="cuda"))


def phase_train_mesh_path(ctx: dict) -> None:
    """3o: the trainer's mesh, the tensor-parallel encoder, the flash
    option, the attention levers and the dry run, at full width on
    MESH_SHARDS logical shards of the card (cell L)."""
    t0 = time.perf_counter()
    phase_mesh_training(ctx)
    phase_tp_encoder(ctx)
    from lattice_tpu_torch import graft_entry
    t1 = time.perf_counter()
    graft_entry.dryrun_multichip(MESH_SHARDS)
    log(f"3o(e): graft_entry.dryrun_multichip({MESH_SHARDS}) on the card "
        f"(the dp x tp forward at UniXcoderConfig()): every step held, "
        f"{time.perf_counter() - t1:.2f} s")
    log(f"phase 3o took {time.perf_counter() - t0:.2f} s")


def mesh_steps(trainer, batches: list[dict]) -> tuple[list[float], float,
                                                      float]:
    """(losses, step p50 ms past the first, peak device GB above the
    start) of `trainer` on `batches`."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))   # float(): synchronized
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return losses, statistics.median(ms[1:]), peak


def grads_of(trainer, loss: torch.Tensor) -> dict[str, torch.Tensor]:
    """d `loss` / d every weight of `trainer`, whole (`trainer.grads()`);
    the trainer's `.grad`s are left cleared."""
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward(retain_graph=True)
    grads = trainer.grads()
    trainer.optimizer.zero_grad(set_to_none=True)
    return grads


def grad_distance(got: dict, want: dict) -> float:
    """|got - want| / |want|, L2 over every weight's gradient at once."""
    num = sum(float((got[k].float() - want[k].float()).square().sum())
              for k in want)
    return (num / sum(float(w.float().square().sum())
                      for w in want.values())) ** 0.5


def planted_faults(one, batch: dict) -> tuple[dict, dict[str, float]]:
    """The single-device trainer's gradient on `batch` at its weights, and
    `grad_distance` from it of two planted faults computed on the same
    encode: the loss with the first data row's pooled rows detached (that
    row's gradient dropped) and the mean of the data rows' own losses
    (per-shard negatives). Rows of the dp-4 mesh: the smaller fault."""
    from lattice_tpu_torch.models.train import info_nce
    want = grads_of(one, one.loss(batch))
    anchor, positive = one.encode_pairs(batch)
    per = anchor.shape[0] // MESH_SHARDS
    shards = range(0, anchor.shape[0], per)
    losses = {
        "one row's gradient dropped": info_nce(
            torch.cat([anchor[:per].detach(), anchor[per:]]),
            torch.cat([positive[:per].detach(), positive[per:]])),
        "per-shard losses": sum(info_nce(anchor[r:r + per],
                                         positive[r:r + per])
                                for r in shards) / len(shards)}
    return want, {fault: grad_distance(grads_of(one, loss), want)
                  for fault, loss in losses.items()}


def phase_mesh_training(ctx: dict) -> None:
    """3o(a): three steps of `ContrastiveTrainer` on a dp-4 mesh and on a
    dp-2 x tp-2 mesh from the single-device trainer's starting weights, on
    3m's batches, against that trainer's steps: losses within
    CHECK_LOSS_RTOL, parameters within CHECK_PARAM_TOL, the first batch's
    gradient within GRAD_RTOL while the planted faults' land beyond it; no
    `paired_attention` launch. 3o(c), second half: a training step with
    `LATTICE_FLASH_ATTN=1` (SDPA) beside the einsum step, on the same
    weights and batches of length >= 128."""
    from lattice_tpu_torch.models.train import ContrastiveTrainer
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.parallel.mesh import make_mesh
    smi = ctx["smi"]
    batches, _ = train_batches(ctx["real_run"], CHECK_STEPS, CHECK_LEN)
    before = _build.launch_counts()["paired_attention"]
    one = ContrastiveTrainer(learning_rate=TRAIN_LR, seed=SEED,
                             device="cuda")
    start = {k: v.clone() for k, v in one.state_dict().items()}
    first = one.shard_batch(batches[0])
    want_grads, faults = planted_faults(one, first)
    want, one_ms, one_gb = mesh_steps(one, batches)
    want_params = one.state_dict()
    rows = {}
    for name, mp in (("dp-4", 1), (f"dp-{MESH_SHARDS // MESH_MP} x tp-"
                                   f"{MESH_MP}", MESH_MP)):
        mesh = make_mesh(MESH_SHARDS, model_parallel=mp)
        trainer = ContrastiveTrainer(mesh=mesh, learning_rate=TRAIN_LR,
                                     seed=SEED)
        trainer.load_state_dict(start)
        grad = grad_distance(grads_of(trainer, trainer.loss(first)),
                             want_grads)
        got, ms, gb = mesh_steps(trainer, batches)
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        state = trainer.state_dict()
        diff = max((state[k] - want_params[k]).abs().max().item()
                   for k in state)
        rows[name] = (mesh, got, worst, diff, grad, ms, gb)
        del trainer, state
        torch.cuda.empty_cache()
    launched = _build.launch_counts()["paired_attention"] - before
    log(f"3o(a): first-batch gradient distance from the single device's "
        f"(bar GRAD_RTOL {GRAD_RTOL:.3g}): "
        f"{ {n: f'{r[4]:.4g}' for n, r in rows.items()} }; planted faults "
        f"on the single device { {f: f'{v:.4g}' for f, v in faults.items()} }"
        f" ({smi})")
    for fault, dist in faults.items():
        require(dist > GRAD_RTOL, f"3o(a): the gradient bar misses the "
                f"planted fault '{fault}' ({dist:.3g})")
    for name, (mesh, got, worst, diff, grad, ms, gb) in rows.items():
        log(f"3o(a): {name} ({mesh}) {CHECK_STEPS} steps at "
            f"UniXcoderConfig(), batch {TRAIN_BATCH}, max_length "
            f"{CHECK_LEN}: losses {[round(x, 6) for x in got]} against the "
            f"single device's {[round(x, 6) for x in want]}, worst relative "
            f"{worst:.3g} (bar {CHECK_LOSS_RTOL}); parameters apart by max "
            f"{diff:.3g} (bar {CHECK_PARAM_TOL:.3g}); step p50 {ms:.2f} ms "
            f"against the single device's {one_ms:.2f} ms; peak device "
            f"memory above the start {gb:.2f} GB (single device {one_gb:.2f}"
            f" GB) ({smi})")
        require(worst <= CHECK_LOSS_RTOL, f"3o(a) {name}: losses differ by "
                f"{worst}")
        require(diff <= CHECK_PARAM_TOL, f"3o(a) {name}: parameters differ "
                f"by {diff}")
        require(grad <= GRAD_RTOL, f"3o(a) {name}: first gradient "
                f"{grad:.3g} from the single device's")
    require(launched == 0, "3o(a): the trainers launched paired_attention")
    long_batches = [b for b in train_batches(ctx["real_run"], 6,
                                             TRAIN_LEN)[0]
                    if b["anchor_ids"].shape[1] >= 128][:3]
    require(len(long_batches) >= 2, "3o(c): fewer than 2 batches of L >= 128")
    batch = one.shard_batch(long_batches[0])
    with torch.no_grad():
        einsum_loss = one.loss(batch).item()
        with attention_env(None, "1"):
            flash_loss = one.loss(batch).item()
    step = {}
    for label, flash in (("einsum", None), ("flash", "1"),
                         ("flash ", "1"), ("einsum ", None)):
        with attention_env(None, flash):
            step.setdefault(label.strip(), []).append(
                mesh_steps(one, long_batches)[1])
    rel = abs(flash_loss - einsum_loss) / abs(einsum_loss)
    log(f"3o(c): a training step with LATTICE_FLASH_ATTN=1 "
        f"(scaled_dot_product_attention) at batch {TRAIN_BATCH}, lengths "
        f"{[b['anchor_ids'].shape[1] for b in long_batches]}: loss on the "
        f"same weights {flash_loss:.6f} against the einsum path's "
        f"{einsum_loss:.6f} (relative {rel:.3g}, bar {CHECK_LOSS_RTOL}); "
        f"step p50 flash {step['flash']} ms, einsum {step['einsum']} ms "
        f"(in turns einsum, flash, flash, einsum; {smi})")
    require(rel <= CHECK_LOSS_RTOL, f"3o(c): flash loss differs by {rel}")
    del one
    torch.cuda.empty_cache()


def phase_tp_encoder(ctx: dict) -> None:
    """3o(b): with `random_vectors_`' biases and LayerNorms,
    `use_mesh(make_mesh(4, model_parallel=2))` at B=128, L=512 against the
    unsharded forward: pooled cosine >= 0.999 a row, the
    kernel launched 2 rows x 2 positions x 12 layers times a forward;
    times beside the unsharded forward and the dp-only split. 3o(c): the
    flash path (SDPA) against the einsum path on the live rows, cosine >=
    0.999. 3o(d): the attention levers' launches a forward."""
    from lattice_tpu_torch.models.unixcoder import UniXcoderModel
    from lattice_tpu_torch.ops import _build
    from lattice_tpu_torch.parallel.mesh import make_mesh
    smi = ctx["smi"]
    from lattice_tpu_torch.graft_entry import random_vectors_
    ids, mask = encoder_batch(ctx)
    model = UniXcoderModel(seed=SEED, device="cuda")
    random_vectors_(model.encoder)
    launches = {}
    for (paired, flash), want in LEVER_LAUNCHES.items():       # (d)
        with attention_env(paired, flash), counted_forwards(model) as seen:
            before = _build.launch_counts()["paired_attention"]
            model.encode_device(ids[:16], mask[:16])
            launched = _build.launch_counts()["paired_attention"] - before
        forwards = require_forwards(seen, launched, want,
                                    f"3o(d) {paired}/{flash}")
        launches[(paired, flash)] = (launched, forwards)
    log(f"3o(d): paired_attention launches, forwards under "
        f"(LATTICE_PAIRED_ATTN, LATTICE_FLASH_ATTN) = "
        f"{ {f'{p}/{f}': n for (p, f), n in launches.items()} } "
        f"(want a forward "
        f"{ {f'{p}/{f}': n for (p, f), n in LEVER_LAUNCHES.items()} })")
    live = mask.sum(1) > 0
    whole = model.encode_device(ids, mask)
    with attention_env("0", None):                               # (c)
        einsum = model.encode_device(ids, mask)
        einsum_ms = cuda_ms(lambda: model.encode_device(ids, mask), 3, 1)
    with attention_env(None, "1"):
        flash = model.encode_device(ids, mask)
        flash_ms = cuda_ms(lambda: model.encode_device(ids, mask), 3, 1)
    whole_ms = cuda_ms(lambda: model.encode_device(ids, mask), 3, 1)
    cos_f = torch.nn.functional.cosine_similarity(flash[live], einsum[live])
    log(f"3o(c): fused_attention (LATTICE_FLASH_ATTN=1, SDPA) at "
        f"B={ENC_BATCH}, L={ENC_LEN}: pooled cosine against the einsum path "
        f"over {int(live.sum())} live rows min {cos_f.min().item():.7f}; "
        f"forward {flash_ms:.2f} ms, einsum {einsum_ms:.2f} ms, "
        f"paired_attention {whole_ms:.2f} ms ({smi})")
    require(cos_f.min().item() >= 0.999, f"3o(c): cosine {cos_f.min()}")
    model.use_mesh(make_mesh(MESH_SHARDS))
    dp_ms = cuda_ms(lambda: model.encode_device(ids, mask), 3, 1)
    tp_mesh = make_mesh(MESH_SHARDS, model_parallel=MESH_MP)
    model.use_mesh(tp_mesh)                                      # (b)
    before = _build.launch_counts()["paired_attention"]
    with counted_forwards(model) as seen:
        sharded = model.encode_device(ids, mask)
    launched = _build.launch_counts()["paired_attention"] - before
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tp_ms = cuda_ms(lambda: model.encode_device(ids, mask), 3, 1)
    tp_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    cos = torch.nn.functional.cosine_similarity(sharded, whole)
    want = len(tp_mesh.model_rows) * MESH_MP * model.config.num_layers
    log(f"3o(b): UniXcoderModel.use_mesh over {tp_mesh}, B={ENC_BATCH}, "
        f"L={ENC_LEN}: pooled cosine against the unsharded forward min "
        f"{cos.min().item():.7f}; paired_attention launches {launched} "
        f"in {seen['forwards']} forwards (want {want} a forward, 6 heads a "
        f"position); forward {tp_ms:.2f} ms "
        f"(peak {tp_gb:.2f} GB above the start), unsharded {whole_ms:.2f} "
        f"ms, dp-only split over {MESH_SHARDS} shards {dp_ms:.2f} ms "
        f"({smi})")
    require(cos.min().item() >= 0.999, f"3o(b): cosine {cos.min()}")
    require_forwards(seen, launched, want, "3o(b)")
    del model
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 1
    name, smi = phase_device()
    # every module that registers a kernel
    from lattice_tpu_torch.ops import (_build, attention,  # noqa: F401
                                       ivf, probe)
    t_start = time.perf_counter()
    err = {k.name: 0.0 for k in _build.KERNELS}
    _build.reset_launch_counts()
    phase_kernels(err)
    phase_bf16_kernel(err)
    phase_int8_kernel(err)
    phase_int4_kernel(err)
    phase_merge_kernel(err)
    phase_ivf_kernels(err)
    phase_attention_kernel(err)
    phase_probe_kernel(err)
    log(f"phase 2 launches by C entry: {_build.entry_launch_counts()}")
    # every route (C entry) of each kernel that phase 2 held to its plain
    # version, counted from 0 on the main paths below
    routes = {k.name: dict.fromkeys(k.entry_launches, 0)
              for k in _build.KERNELS}

    ctx: dict = {"smi": smi}   # the card's name and power limit
    kernels_ms: dict = {}
    launches = {k.name: 0 for k in _build.KERNELS}
    entries = {k.name: {} for k in _build.KERNELS}
    # each path's kernels, and the C entries (routes) it must have run:
    # kernel A's and the bf16 probe's wgmma entries on the corpus-A store
    for path, phase, needs in (
            ("flat tier", phase_main_path,
             ("scan_topk", "scan_topk_int8", "merge_candidates",
              "lt_scan_topk_bf16", "lt_scan_topk_int8")),
            ("int4 tier", phase_int4_path,
             ("scan_topk_int4", "merge_candidates", "scan_topk",
              "lt_scan_topk_bf16", "lt_scan_topk_int4")),
            ("dissection", phase_dissect_path,
             ("score_probe", "scan_topk", "scan_topk_int8",
              "scan_topk_int4", "lt_score_probe_bf16",
              "lt_score_probe_int8", "lt_score_probe_int4")),
            ("deep path", phase_deep_path,
             ("merge_candidates", "lt_merge_positions")),
            ("sharded", phase_sharded_path,
             ("scan_topk", "scan_topk_int8", "scan_topk_int4",
              "merge_candidates", "paired_attention", "lt_scan_topk_bf16",
              "lt_scan_topk_int8", "lt_scan_topk_int4",
              "lt_merge_positions")),
            ("ivf", phase_ivf_path,
             ("ivf_probe", "merge_candidates", "scan_topk_int8")),
            ("serving", phase_serving_path,
             ("ivf_probe", "merge_candidates", "lt_merge_positions",
              "scan_topk_int8")),
            ("capacity", phase_capacity_path,
             ("scan_topk_int4", "merge_candidates", "lt_scan_topk_int4")),
            ("encoder", phase_encoder_path,
             ("paired_attention", "scan_topk_int8", "merge_candidates")),
            ("indexing", phase_index_path,
             ("scan_topk_int8", "merge_candidates", "scan_topk",
              "paired_attention")),
            ("query side", phase_query_path,
             ("scan_topk_int8", "merge_candidates", "paired_attention")),
            ("CLI", phase_cli_path,
             ("scan_topk_int8", "merge_candidates")),
            ("serving CLI", phase_serving_cli,
             ("scan_topk_int8", "merge_candidates")),
            ("training", phase_train_path,
             ("paired_attention", "lt_paired_attention_bf16",
              "lt_paired_attention_f32")),
            ("trainer mesh", phase_train_mesh_path,
             ("paired_attention", "lt_paired_attention_bf16", "scan_topk",
              "merge_candidates"))):
        _build.reset_launch_counts()
        phase(ctx)
        counts = {**_build.launch_counts(), **_build.entry_launch_counts()}
        log(f"main-path launches ({path}): {counts}")
        for k in needs:
            require(counts.get(k, 0) > 0, f"{k} never ran on the {path} path")
        for k in _build.KERNELS:
            launches[k.name] += k.launches
            for e, v in k.entry_launches.items():
                entries[k.name][e] = entries[k.name].get(e, 0) + v
                routes[k.name][e] = routes[k.name].get(e, 0) + v
        if path == "flat tier":
            phase_timings(ctx, kernels_ms, err, smi)
        elif path == "int4 tier":
            phase_int4_timings(ctx, kernels_ms, err, smi)
        elif path == "dissection":
            rep = ctx.pop("dissect")
            floor = rep["probes"]["bf16_rawmax_t2048"]
            err["score_probe"] = max([err["score_probe"]] + [
                r["max_abs_err"] for case, r in rep["probes"].items()
                if "_rawmax_" in case])
            kernels_ms["score_probe"] = kernel_row(
                floor["ms"], floor["plain_ms"],
                (floor["bound_ms"], floor["bound_by"]), None,
                rep["library"]["bf16"])
        elif path == "deep path":
            phase_deep_kernels(ctx, err, smi)
        elif path == "sharded":
            phase_sharded_checks(ctx, err, smi)
            # free the first store and the graph before the second store
            for key in ("store", "indexer", "queries", "deep_engine",
                        "deep_texts", "deep_memo", "deep_seeds"):
                del ctx[key]
            gc.collect()
            torch.cuda.empty_cache()
            log(f"first store freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
                f" GB allocated")
        elif path == "ivf":
            phase_ivf_timings(ctx, kernels_ms, err, smi)
            phase_cli_roundtrip(ctx)
        elif path == "serving":
            phase_serving_kernels(ctx, err)
            del ctx["store2"], ctx["queries2"]
            gc.collect()
            torch.cuda.empty_cache()
        elif path == "query side":
            phase_query_timings(ctx, smi)
        elif path == "capacity":
            phase_capacity_kernels(ctx, err, smi)
            phase_capacity_timings(ctx, smi)
            gc.collect()
            torch.cuda.empty_cache()
    for k in _build.KERNELS:
        require(launches[k.name] > 0, f"{k.name} never ran on the main path")
    phase_encoder_timings(ctx, kernels_ms, smi)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s after the build")
    log(smi)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "entries": entries[k.name], "routes": routes[k.name],
         "max_abs_err": err[k.name],
         **kernels_ms[k.name]}
        for k in _build.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
