"""Drive the port's vector-search main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. Device: require CUDA; print the card and its power limit; build the
   kernels of `lattice_tpu_torch/csrc/` and print the build time.
2. Kernels against their plain versions on the card, at N in {4099,
   1048576}, B in {1, 16, 256}, k in {1, 10, 64}, with masked rows.
   int8 (kernel C + B): first-stage ids identical, scores within 1 ulp.
   bf16 (kernel A + B): first-stage ids agree on >= 99.9% of slots and
   scores within 1e-4; after the rescore, final ids agree on >= 99.9% of
   slots, every mismatch within 1e-4 of rescored score. Kernel B alone: ids and
   scores identical to its plain version. `ivf_probe` + B against
   `ivf_search_batch`'s probe step, on buckets of S=1000 slots with -1
   holes and a filter mask: C in {7, 1024}, d in {100, 768}, bf16 and f32
   buckets, B in {1, 16, 256}, nprobe in {1, 8, C}, k in {1, 10, 64}; ids
   agree on >= 99.9% of slots, scores within 1e-4, no -1 among live
   results, and nprobe = C equal to the exact scan at storage precision.
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
   and "pallas"; each scan kernel beside its plain version at B in {1, 256}.
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
Launch counts are zeroed just before each of 3a and 3b and read just after
it; each path's kernels, and every registered kernel, must have launched.

The line before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
N_ROWS = 1 << 20
DIM = 768
N_CLUSTERS = 1024
SPREAD = 0.35          # the near-isotropic corpus: IVF must refuse it
IVF_SPREAD = 0.06      # the clustered corpus: IVF serves it
ADD_BATCH = 65_536
ROWS_PER_FILE = 50
K = 10
RECALL_MIN = 0.99


def log(*args) -> None:
    print(*args, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn()` in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---- data -------------------------------------------------------------------


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def cluster_centers(gen: torch.Generator) -> torch.Tensor:
    return normalize(torch.randn(N_CLUSTERS, DIM, device="cuda",
                                 generator=gen))


def cluster_rows(centers: torch.Tensor, n: int, gen: torch.Generator,
                 spread: float = SPREAD) -> torch.Tensor:
    """Rows around bf16 cluster centers with Gaussian spread, normalized
    (the bench's `gen_block`)."""
    assign = torch.randint(0, N_CLUSTERS, (n,), device="cuda", generator=gen)
    base = centers.to(torch.bfloat16).to(torch.float32)[assign]
    return normalize(base + spread * torch.randn(n, DIM, device="cuda",
                                                 generator=gen))


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
    return name, smi


def phase_kernels(err: dict) -> None:
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for n in (4099, N_ROWS):
        emb = normalize(torch.randn(n, DIM, device="cuda", generator=gen))
        emb_bf16 = emb.to(torch.bfloat16)
        valid = torch.rand(n, device="cuda", generator=gen) > 0.1
        ev, es = quant.quantize_rows_device(emb_bf16)
        del emb
        for b in (1, 16, 256):
            q = normalize(torch.randn(b, DIM, device="cuda", generator=gen))
            qv, qs = quant.quantize_rows_device(q)
            for k in (1, 10, 64):
                # kernel C + B: exact integer dot, identical selection
                k1 = scan.int8_first_stage_width(k, n)
                s, i = scan.scan_topk_int8(qv, qs, ev, es, valid, k1)
                torch.cuda.synchronize()
                ps, pi = scan.scan_topk_int8_plain(qv, qs, ev, es, valid, k1)
                ulp = (torch.nextafter(ps, torch.full_like(ps, float("inf")))
                       - ps).abs()
                require(torch.equal(i, pi), f"int8 ids differ n={n} b={b} k={k}")
                require(bool(((s - ps).abs() <= ulp).all()),
                        f"int8 scores beyond 1 ulp n={n} b={b} k={k}")
                err["scan_topk_int8"] = max(err["scan_topk_int8"],
                                            (s - ps).abs().max().item())
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
    centers = cluster_centers(gen)
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


def phase_timings(ctx: dict, kernels_ms: dict) -> None:
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
    k1 = scan.first_stage_width(K, emb.shape[0])
    for b in (1, 256):
        q = q256[:b].contiguous()
        qv, qs = quant.quantize_rows_device(q)
        cs, ci = scan.scan_blocks(q, emb, valid, k1)
        t = {
            "scan_topk": (
                cuda_ms(lambda: scan.scan_blocks(q, emb, valid, k1), 10),
                cuda_ms(lambda: scan.scan_topk_plain(q, emb, valid, k1), 3, 1)),
            "merge_candidates": (
                cuda_ms(lambda: scan.merge_candidates(cs, ci, k1), 20),
                cuda_ms(lambda: scan.merge_candidates_plain(cs, ci, k1), 5)),
            "scan_topk_int8": (
                cuda_ms(lambda: scan.scan_blocks_int8(
                    qv, qs, view.values, view.scales, valid, k1), 10),
                cuda_ms(lambda: scan.scan_topk_int8_plain(
                    qv, qs, view.values, view.scales, valid, k1), 3, 1)),
        }
        for name, (ms, plain) in t.items():
            log(f"kernel {name} B={b} N={emb.shape[0]} d={DIM} k1={k1}: "
                f"{ms:.4f} ms, plain {plain:.4f} ms")
            if b == 256:
                kernels_ms[name] = (ms, plain)


def p50_ms(fn, n: int = 50) -> float:
    """Median host-clock latency of a synchronized call, in ms."""
    lat = []
    for j in range(n):
        t0 = time.perf_counter()
        fn(j)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def phase_ivf_timings(ctx: dict, kernels_ms: dict) -> None:
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
    for b in (1, 256):
        q, pb = q256[:b].contiguous(), probe[:b].contiguous()
        t = (cuda_ms(lambda: ivf.probe_blocks(q, pb, ivf_.bucket_data,
                                              ivf_.bucket_ids, K), 20),
             cuda_ms(lambda: probe_plain_chunked(
                 q, pb, ivf_.bucket_data, ivf_.bucket_ids, K), 3, 1))
        log(f"kernel ivf_probe B={b} C={ivf_.n_clusters} S={ivf_.bucket_size} "
            f"nprobe={cs.IVF_AUTO_NPROBE} d={DIM} k1={K}: {t[0]:.4f} ms, "
            f"plain {t[1]:.4f} ms")
        if b == 256:
            kernels_ms["ivf_probe"] = t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 1
    name, smi = phase_device()
    from lattice_tpu_torch.ops import _build, ivf  # noqa: F401 (ivf_probe)
    err = {k.name: 0.0 for k in _build.KERNELS}
    phase_kernels(err)
    phase_ivf_kernels(err)

    ctx: dict = {}
    kernels_ms: dict = {}
    launches = {k.name: 0 for k in _build.KERNELS}
    for path, phase, needs in (
            ("flat tier", phase_main_path,
             ("scan_topk", "scan_topk_int8", "merge_candidates")),
            ("ivf", phase_ivf_path,
             ("ivf_probe", "merge_candidates", "scan_topk_int8"))):
        _build.reset_launch_counts()
        phase(ctx)
        counts = _build.launch_counts()
        log(f"main-path launches ({path}): {counts}")
        for k in needs:
            require(counts[k] > 0, f"{k} never ran on the {path} path")
        for k, v in counts.items():
            launches[k] += v
        if path == "flat tier":
            phase_timings(ctx, kernels_ms)
            # free the first store before the second is built
            del ctx["store"], ctx["indexer"], ctx["queries"]
            gc.collect()
            torch.cuda.empty_cache()
            log(f"first store freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
                f" GB allocated")
    for k in _build.KERNELS:
        require(launches[k.name] > 0, f"{k.name} never ran on the main path")
    phase_ivf_timings(ctx, kernels_ms)
    log(smi)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": err[k.name], "ms": kernels_ms[k.name][0],
         "plain_ms": kernels_ms[k.name][1]} for k in _build.KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
