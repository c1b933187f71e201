"""Drive the port's vector-search main path once on one NVIDIA card.

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
   scores identical to its plain version.
3. The main path at full size: 1,048,576 x 768 clustered rows (1024
   clusters, spread 0.35, as `bench.py` makes them), from a seed, through
   `VectorIndexer` -> `ChunkStore.add` (batches of 65,536, with payloads)
   -> `search_device` at B=256, k=10, planned "quantized" (kernel C) and
   forced "pallas" (kernel A), each with recall@10 >= 0.99 against an
   exact f32 scan; then text queries, a file filter, `delete_file` and
   `lexical_candidates`. Launch counts are zeroed just before this phase
   and read just after it; every kernel must have launched.
4. Timings (informational), CUDA events after warm-up: `search_device`
   QPS at B=256 and p50 latency at B=1 for both plans; each kernel beside
   its plain version at B in {1, 256}.

The line before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
SPREAD = 0.35
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


def cluster_rows(centers: torch.Tensor, n: int,
                 gen: torch.Generator) -> torch.Tensor:
    """Rows around bf16 cluster centers with Gaussian spread, normalized
    (the bench's `gen_block`)."""
    assign = torch.randint(0, N_CLUSTERS, (n,), device="cuda", generator=gen)
    base = centers.to(torch.bfloat16).to(torch.float32)[assign]
    return normalize(base + SPREAD * torch.randn(n, DIM, device="cuda",
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


def phase_main_path(ctx: dict) -> None:
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.embeddings.indexer import (VectorIndexer,
                                                      VectorSearcher)
    from lattice_tpu_torch.index.chunk_store import name_token_set
    from lattice_tpu_torch.providers.hash_provider import HashEmbedder

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    centers = cluster_centers(gen)
    t0 = time.perf_counter()
    indexer = VectorIndexer(Embedder(HashEmbedder(dimensions=DIM)),
                            dtype="bfloat16", initial_capacity=N_ROWS,
                            device="cuda")
    store = indexer.code
    for lo in range(0, N_ROWS, ADD_BATCH):
        hi = min(lo + ADD_BATCH, N_ROWS)
        rows = store.add(cluster_rows(centers, hi - lo, gen), payloads(lo, hi))
        require(rows == list(range(lo, hi)), "add assigned unexpected rows")
    torch.cuda.synchronize()
    log(f"indexed {len(store)} rows x {DIM} (bf16) in "
        f"{time.perf_counter() - t0:.1f} s; store {store.stats}")
    require(len(store) == N_ROWS and store.capacity == N_ROWS,
            f"store holds {len(store)} rows, capacity {store.capacity}")

    q = cluster_rows(centers, 256, gen)
    emb, valid = store.device_arrays
    truth = exact_topk(q, emb, valid, K)
    plan = store._plan_search(256, K, None, "auto")
    require(plan == "quantized", f"auto plan at B=256 is {plan!r}")
    ctx["queries"] = q
    for method, kernel in (("auto", "scan_topk_int8"), ("pallas", "scan_topk")):
        from lattice_tpu_torch.ops import _build
        before = _build.launch_counts()[kernel]
        s, i = store.search_device(q, K, method=method)
        torch.cuda.synchronize()
        require(_build.launch_counts()[kernel] > before,
                f"{method}: {kernel} was not launched")
        require(s.shape == (256, K) and i.shape == (256, K)
                and bool(torch.isfinite(s).all()), f"{method}: bad output")
        require(bool((s[:, :-1] >= s[:, 1:]).all()), f"{method}: unsorted")
        r = recall(i, truth)
        ctx[f"recall_{method}"] = r
        log(f"search_device method={method} (plan "
            f"{plan if method == 'auto' else method}): recall@{K} {r:.4f}")
        require(r >= RECALL_MIN, f"{method}: recall@{K} {r:.4f} < {RECALL_MIN}")
    sm, _ = store.search_device(q[:8], K)
    require(bool(torch.isfinite(sm).all()), "bad scores")
    resident = store._quant.memory_bytes() + emb.numel() * emb.element_size()
    log(f"resident: rows {emb.numel() * emb.element_size() / 1e9:.2f} GB "
        f"+ int8 shadow {store._quant.memory_bytes() / 1e9:.2f} GB "
        f"= {resident / 1e9:.2f} GB")

    searcher = VectorSearcher(indexer)
    texts = ["drain the webhook delivery queue", "parse config file",
             "retry with exponential backoff", "bakoco handler"]
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
    ctx["store"] = store


def phase_timings(ctx: dict, kernels_ms: dict) -> None:
    from lattice_tpu_torch.ops import quant, scan_topk as scan
    store, q256 = ctx["store"], ctx["queries"]
    for method in ("auto", "pallas"):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 1
    name, smi = phase_device()
    from lattice_tpu_torch.ops import _build
    err = {"scan_topk": 0.0, "merge_candidates": 0.0, "scan_topk_int8": 0.0}
    phase_kernels(err)

    ctx: dict = {}
    _build.reset_launch_counts()
    phase_main_path(ctx)
    launches = _build.launch_counts()
    log(f"main-path launches: {launches}")
    for k in _build.KERNELS:
        require(launches[k.name] > 0, f"{k.name} never ran on the main path")

    kernels_ms: dict = {}
    phase_timings(ctx, kernels_ms)
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
