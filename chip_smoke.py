"""Drive the port's main paths (vector search, the encoder) once on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. Device: require CUDA; print the card and its power limit; build the
   kernels of `lattice_tpu_torch/csrc/` and print the build time, and the
   registers and local memory per thread (`cuobjdump`) of kernel D's
   instances, of kernels A's and C's two wgmma instances each (no local
   memory allowed) and of their probes' four each.
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
   bit-equal; kernel B alone on D's lists, bit-equal; the same on
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
   Kernel B on `merge_cases` (the CPU tests' adversarial lists: ties,
   NEG_INF rows, pads past the live candidates, m = k1, k1 = 512, equal
   and signed-zero scores; and, split over blocks, pads, 600,000
   candidates with negative ids, B=200): ids equal and scores bit-equal
   to its plain version on CPU copies; k1 = 513 refused.
   `score_probe` at every type and mode on 64 queries x 262,144 rows (+ a
   ragged tail of 100) x 768 at tiles 2048 and 8192, 300 x 65,636 x 1024
   at tile 2048 (bf16 and int8 at kernel A's and C's instances for k1 =
   16 and 80), and 16 x 4,133 x 100 at tile 256: int8 and int4 bit-equal,
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
   80, 128, 512}, beside the int4 floor (its probe at that B) and the
   selection share; D on rows whose scores rise with the row id (every
   tile beats every list), timed once.
3f. The dissection path on the same store, its int8 and int4 views and
   the 256 queries (`lattice_tpu_torch/tools/dissect.py`): `score_probe`
   at every (type, mode, tile) the round-2 scripts timed, each held to its
   plain version as in phase 2 on the same inputs; kernels A, C and
   D at k1 in {16, 80} beside their floors (the selection share is scan ms
   minus probe ms over scan ms; C's over the probe at the instance it
   ran); the library product of each type; `binned_topk`, and kernel C at
   k1 = 16 beside the int8 probe, at B in {1, 8, 32, 64, 128, 256}; one
   device-trace summary (torch.profiler) each of a "quantized", an "int4"
   and a forced "refined" `search_device` call. The store is freed after
   it.
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
   (bf16); `paired_attention` launches exactly 12 times per batch. The
   first 256 chunks through the kernel path and the einsum path
   (`paired_attention=False`, same weights): every pooled cosine >= 0.999.
   256 chunks drawn by seed, encoded again as queries, through
   `search_device` at B=256, k=10: >= 99% find their own row in their top
   10; recall@10 against an exact f32 scan is printed (information). B=1
   `search_code` calls return hits with payloads.
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
Launch counts are zeroed just before each of 3a, 3d, 3f, 3b, 3e and 3c
and read just after it; each path's kernels, and every registered kernel, must
have launched, and the C entries each path must have run with them (kernel
A's and C's wgmma routes on corpus A, the bf16 and int8 probes' in 3f).

The line before the last is the kernel table as JSON: per kernel its
launches on those paths (and by C entry), its largest error against its
plain version, its time, its plain version's time, its bound (the larger
of its bytes over 3.35 TB/s and its operations over the H100's dense peak
for their type, from this run's shapes) and the time of one PyTorch call
computing the same function where one exists. The last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import gc
import json
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
    three instances (serial: 64 queries a block, lists <= 16; batched: 64
    queries, lists <= 128; 32 queries, <= 512), the two wgmma instances
    (128 and 64 queries a block) of kernels A and C, and the four of each
    of their probes (the same two, rawmax and pack). A's and C's wgmma
    instances must use no local memory."""
    from lattice_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lines = subprocess.run(
        [str(tool), "--dump-resource-usage", str(_build.library_path())],
        capture_output=True, text=True, check=True, timeout=120
    ).stdout.splitlines()
    found = {"D": 0, "A": 0, "C": 0, "bf16 probe": 0, "int8 probe": 0}
    for name, usage in zip(lines, lines[1:]):
        regs = " ".join(usage.split()[:5])
        if inst := (re.search(r"scan_topk_int4_kernelILi(\d+)ELi(\d+)E", name)
                    or re.search(r"scan_topk_kernelILi3ELi(\d+)ELi(\d+)E",
                                 name)):
            found["D"] += 1
            kind = ("batched, lists <= " + inst[2] if "int4" in name
                    else "serial")
            log(f"kernel D, {kind}, {inst[1]} queries a block: {regs}")
        elif inst := re.search(r"scan_topk_(bf16|int8)_wg_kernelILi(\d+)E",
                               name):
            kernel = "A" if inst[1] == "bf16" else "C"
            found[kernel] += 1
            log(f"kernel {kernel} (wgmma), {inst[2]} queries a block: {regs}")
            require(re.search(r"LOCAL:0\b", usage) is not None,
                    f"kernel {kernel} ({inst[2]} queries) uses local "
                    f"memory: {regs}")
        elif inst := re.search(
                r"score_probe_(bf16|int8)_wg_kernelILi(\d+)ELb(\d)E", name):
            found[f"{inst[1]} probe"] += 1
            log(f"{inst[1]} probe (wgmma), {inst[2]} queries a block, "
                f"{'pack' if inst[3] == '1' else 'rawmax'}: {regs}")
    require(found == {"D": 3, "A": 2, "C": 2, "bf16 probe": 4,
                      "int8 probe": 4},
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
    queries x 65,636 rows x 1024 at tile 2048 (three query tiles, the last
    partial; bf16 and int8 at kernel A's and C's instances for k1 = 16 and
    80), and 16 queries x 4,133 rows x 100 at tile 256 (scalar loads, a
    partial query tile; bf16 and int8 on kernel A's and C's wmma routes).
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
                k1s = (16, 80) if kind != "int4" and b > 64 else (16,)
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
    t0 = time.perf_counter()
    vectors = embedder.embed_with_progress(texts)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    batches = -(-n // ENC_BATCH)
    launched = _build.launch_counts()["paired_attention"] - before
    require(launched == model.config.num_layers * batches,
            f"paired_attention launched {launched} times for {batches} "
            f"batches of {model.config.num_layers} layers")
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
        f"tokenizer included); paired_attention launches {launched} = "
        f"{model.config.num_layers} x {batches}; store {store.stats}")

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


def phase_encoder_trace(model, ids: torch.Tensor, mask: torch.Tensor,
                        smi: str, n: int = 4) -> None:
    """A `utils/tracing.py` device trace of `n` encoder forwards on
    device-resident ids: busy ms per batch, the idle share of the traced
    window, `paired_attention`'s share of busy time, and the time by
    kernel class."""
    from lattice_tpu_torch.utils.tracing import (categorize_device_trace,
                                                 device_trace,
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
    cats = categorize_device_trace(where)["categories"]
    log(f"encoder trace, {n} forwards B={ENC_BATCH} L={ENC_LEN}: device busy "
        f"{busy / n:.3f} ms per batch, idle {1 - busy / wall:.4f} of the "
        f"traced window ({wall / n:.3f} ms per batch under the profiler); "
        f"paired_attention {attn_ms / n:.4f} ms per batch = "
        f"{attn_ms / busy:.4f} of busy time; by kernel class (ms over {n} "
        f"batches): {cats} ({smi})")


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
    # at B=256 and B=1 over k1 = 16 (the first stage alone), 80 (8k at
    # k=10), 128 (8k at k=16, where D stages fewer candidates a query) and
    # 512 (8k at k=64, D only), beside the int4 floor (its probe at the
    # same B) and the selection share (D ms - floor ms) / D ms
    from lattice_tpu_torch.ops.probe import score_probe
    from lattice_tpu_torch.tools.dissect import FLOOR_TILE
    i8 = store._quant
    for b in (256, 1):
        qv, qs = quant.quantize_rows_device(q256[:b].contiguous())
        floor = cuda_ms(lambda: score_probe(qv, view.values, tile=FLOOR_TILE),
                        5)
        sweep = {k1: (cuda_ms(lambda: scan.scan_blocks_int4(
            qv, qs, view.values, view.scales, valid, k1), 3, 1),
                      cuda_ms(lambda: scan.scan_blocks_int8(
            qv, qs, i8.values, i8.scales, valid, k1), 3, 1)
                      if k1 <= scan.MAX_K1 else None)
                 for k1 in (16, 80, 128, 512)}
        log(f"kernel D (C) at B={b} by list length, int4 floor "
            f"{floor:.4f} ms: " + ", ".join(
                f"k1={k1}: {d_ms:.4f} ms, selection "
                f"{(d_ms - floor) / d_ms:.1%} ({c_ms})"
                for k1, (d_ms, c_ms) in sweep.items()) + f" ({smi})")
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
    phase_kernels(err)
    phase_bf16_kernel(err)
    phase_int8_kernel(err)
    phase_merge_kernel(err)
    phase_ivf_kernels(err)
    phase_attention_kernel(err)
    phase_probe_kernel(err)

    ctx: dict = {}
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
              "lt_scan_topk_bf16")),
            ("dissection", phase_dissect_path,
             ("score_probe", "scan_topk", "scan_topk_int8",
              "scan_topk_int4", "lt_score_probe_bf16",
              "lt_score_probe_int8")),
            ("ivf", phase_ivf_path,
             ("ivf_probe", "merge_candidates", "scan_topk_int8")),
            ("capacity", phase_capacity_path,
             ("scan_topk_int4", "merge_candidates")),
            ("encoder", phase_encoder_path,
             ("paired_attention", "scan_topk_int8", "merge_candidates"))):
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
            # free the first store before the second is built
            del ctx["store"], ctx["indexer"], ctx["queries"]
            gc.collect()
            torch.cuda.empty_cache()
            log(f"first store freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
                f" GB allocated")
        elif path == "ivf":
            phase_ivf_timings(ctx, kernels_ms, err, smi)
            del ctx["store2"], ctx["queries2"]
            gc.collect()
            torch.cuda.empty_cache()
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
         "entries": entries[k.name], "max_abs_err": err[k.name],
         **kernels_ms[k.name]}
        for k in _build.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
