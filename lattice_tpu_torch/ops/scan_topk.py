"""Fused flat-scan score + select for the card, with plain versions.

Port of `lattice_tpu/ops/pallas_topk.py`. Four hand-written CUDA kernels
(`csrc/scan_topk.cu`, and `csrc/merge_candidates.cu` for kernel B):

- `scan_topk` (kernel A) replaces `_binned_kernel` (pallas_topk.py:434)
  and the bin/key selection of `binned_topk` (:627): Q·Eᵀ over bf16 (or
  f32) rows, masked, with a running exact top-k1 per query for each run
  of rows a block owns. On bf16 rows with d % 8 == 0 and 16-byte aligned
  queries and rows (every store's rows) it runs kernel C's `wgmma` main
  loop (`csrc/scan_wg.cuh`) on a bf16 copy of the queries, at kernel C's
  instance and chunking (`wg_plan`); any other bf16 shape takes its
  wmma tile loop (`lt_scan_topk_bf16_scalar`), f32 rows too
  (`lt_scan_topk_f32`). The shape alone picks the route (`bf16_route`).
- `merge_candidates` (kernel B, `csrc/merge_candidates.cu`) replaces the
  `approx_max_k` finish of `_binned_candidates` (:525): the exact top-k1
  over the per-block lists, by a block-wide radix select. Its positional
  entry (`merge_positions`, ids = columns) is the exact top-k over whole
  score rows (`topk_rows`): the deep path's fused [Q, N] rows and the
  negated BFS distances of `graph_kernels.khop_select`, where the
  reference finished `approx_max_k` / `approx_min_k` the same way.
- `scan_topk_int8` (kernel C) replaces `_binned_kernel_int8` (:466) via
  `binned_topk_int8` (:720): the i8·i8 -> i32 dot, times the query and
  row scales, masked, selected like kernel A and finished by kernel B.
  Where d % 16 == 0 and the int8 queries and rows are 16-byte aligned
  (every store's view) it runs on `wgmma` from a TMA ring
  (`csrc/scan_wg.cuh`), one block an SM, 128 or 64 queries a block
  (`wg_plan`); any other shape takes its wmma tile loop
  (`lt_scan_topk_int8_scalar`). The shape alone picks the route.
- `scan_topk_int4` (kernel D) replaces the packed-int4 bodies of
  `binned_topk_int4` (:980): `_binned_kernel_int4_hoistq` (:894, its
  default), `_binned_kernel_int4` (:938), `_fma` (:843) and `_matmul`
  (:793), over packed rows [N, d/2]; lists up to 512 long (the int4
  view's 8k candidates). Where d/2 % 16 == 0, the int8 queries and packed
  rows are 16-byte aligned and k1 <= MAX_K1 (every store's view at the
  plans' widths) it runs kernel C's `wgmma` loop and plan, each packed
  slab unpacked in shared memory for the s8 products; any other shape or
  longer list takes its wmma tile loop, which unpacks in registers
  (`lt_scan_topk_int4_scalar`). Shape and list length alone pick the
  route (`int4_route`).

The TPU's other scans compute functions these kernels already compute
exactly, so they are entry points over them: `fused_topk` (`_topk_kernel`
with `_select_topk_insertion`, :193, :236, :102) is A + B at k, and
`refined_topk` (:1114) widens it and rescores; `fused_topk_int8`
(`_topk_kernel_int8`, :297, :345) is C + B at k; the int8 `hoistq` chain
(`_binned_kernel_int8_hoistq`, :492) is C + B like `"mul"`. Every variant
of `binned_topk_int4` (`unpack=`, `selection=`) reaches kernel D: they
approximated one exact function in different ways.

What bounds them on the H100 and how the design answers it is written at
the head of the CUDA source. In short: one read of the rows (1.61 GB of
bf16, 0.81 GB of int8 at 1M x 768), the products on tensor cores, and a
selection that costs one warp ballot per 32 scores plus, for each score
that beats the list, an insertion (A, C) or a share of a batched merge
(D).

The TPU kernels' selection was lossy (128 strided bins of ~1e-3 packed
keys; about 0.2 pp of recall at 1M). Here selection is exact at the
precision of the first-stage scores, ordered (score desc, row id asc) as
`lax.top_k` orders ties. The TPU's workarounds do not carry over: no tile
gate (the kernels take any N and mask the ragged edge), no [N, 1] layout
pins (validity stays [N] bool, scales [N] f32), no packed keys.

Beside each kernel stands its plain torch version: exact masked scores,
then a stable top-k1. A wrapper takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises. The exact
rescore stays torch code, as XLA ran it outside the Pallas body.
"""

from __future__ import annotations

import functools
import math

import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops.topk import (NEG_INF, blocked_topk,
                                        flat_topk_blocked, full_f32,
                                        l2_normalize_t, stable_topk)
from lattice_tpu_torch.utils.tracing import get_tracer

# must match csrc/scan_topk.cu and csrc/scan_wg.cuh
BQ = 64          # queries per block
BQ_LONG = 32     # queries per block of kernel D past MAX_K1
BQ_WIDE = 128    # queries per block of kernel C's wide instance
K1_WIDE = 32     # longest list of that instance
BN = 128         # rows per tile
WG_BK = 128      # bytes of each row in one k slab of the wgmma ring
WG_BN = 64       # rows of one tile of the wgmma main loop
WG_SC_LD = WG_BN + 8  # row stride of its score tile
SMEM_MAX = 232_448  # shared memory one block may have on the H100
MAX_K1 = 128     # longest first-stage list a block keeps per query
MAX_K1_LONG = 512  # longest list of kernels D and B
MERGE_CAP = 16384  # candidates one block of kernel B holds
# kernel B splits a query's candidates over blocks only past this many: up
# to it one block takes about as long as split blocks plus a second pass
MERGE_ONE_BLOCK = 8192
# plain versions score this many rows at a time (bounded f32 temporaries)
PLAIN_BLOCK = 1 << 17

_SRC = "lattice_tpu_torch/csrc/scan_topk.cu"
SCAN_TOPK = _build.Kernel(
    "scan_topk", _SRC, "lattice_tpu/ops/pallas_topk.py:434")
MERGE_CANDIDATES = _build.Kernel(
    "merge_candidates", "lattice_tpu_torch/csrc/merge_candidates.cu",
    "lattice_tpu/ops/pallas_topk.py:525")
SCAN_TOPK_INT8 = _build.Kernel(
    "scan_topk_int8", _SRC, "lattice_tpu/ops/pallas_topk.py:466")
SCAN_TOPK_INT4 = _build.Kernel(
    "scan_topk_int4", _SRC, "lattice_tpu/ops/pallas_topk.py:894")


def first_stage_width(k: int, n: int) -> int:
    """k1 = max(k, 16), capped by the row count (`binned_topk`'s width)."""
    return min(max(k, 16), n)


def int8_first_stage_width(k: int, n: int) -> int:
    """k1 = max(k, 16) capped by 4k and the row count: how many int8
    candidates `QuantizedView` rescores (JAX `quant.py:251`). The scan
    itself runs at `first_stage_width(k1, n)`, which for every k equals
    `first_stage_width(k, n)`."""
    return min(max(k, 16), 4 * k, n)


def int4_first_stage_width(k: int, n: int) -> int:
    """k1 = max(8k, 32), capped by the row count: how many int4 candidates
    `Int4View` rescores (JAX `quant.py:497, :523, :534`). int4 steps are
    amax/7 against int8's amax/127, so the first stage widens further."""
    return min(max(8 * k, 32), n)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every one lies on one CUDA device (kernel). Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise KernelError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise KernelError(f"no kernel for device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise KernelError(f"{name}: want contiguous {dtype} of rank {ndim}, got "
                          f"{t.dtype} {tuple(t.shape)} "
                          f"contiguous={t.is_contiguous()}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_per_chunk(n: int, target: int) -> tuple[int, int]:
    """(rows per block, number of row chunks) for about `target` chunks,
    each a whole number of 128-row tiles, none empty."""
    rows = max(BN, -(-(-(-n // target)) // BN) * BN)
    return rows, -(-n // rows)


def _chunking(n: int, b: int, device: torch.device, bq: int = BQ
              ) -> tuple[int, int]:
    """Chunks of kernels A, D and C's scalar route: about four blocks per
    SM over the whole grid."""
    q_tiles = -(-b // bq)
    return _rows_per_chunk(n, max(1, -(-4 * _sm_count(device) // q_tiles)))


def wg_block_queries(b: int, k1: int) -> int:
    """The instance of kernels A and C on `wgmma`: 128 queries a block (two
    MMA warpgroups on one row tile) for lists up to K1_WIDE when the batch
    fills more than 64; else 64 (one MMA warpgroup), which holds lists up
    to MAX_K1 in shared memory and wastes no warpgroup on a small batch.
    Both have 16 selection warps."""
    return BQ_WIDE if b > BQ and k1 <= K1_WIDE else BQ


def _up(x: int) -> int:
    """x rounded up to 128 bytes (`round_up`, csrc/scan_tile.cuh)."""
    return -(-x // 128) * 128


def wg_smem_bytes(bq: int, k1: int) -> int:
    """Dynamic shared memory of kernels A and C on `wgmma` (`scan_wg.cuh`
    `wg_smem_bytes`, `select_epi_bytes` in scan_topk.cu): alignment slack,
    the ring (6 stages at 128 queries, 8 at 64: a row slab of 64 x 128
    bytes and a 64 x 128-byte query slab per warpgroup, bf16 or int8
    alike), its mbarriers, the f32 or i32 score tile and two lists of k1
    per query."""
    stages = 6 if bq == BQ_WIDE else 8
    ring = stages * (WG_BN * WG_BK + bq // BQ * BQ * WG_BK)
    return 1024 + ring + 256 + _up(bq * WG_SC_LD * 4) + 2 * _up(bq * k1 * 4)


def wg_plan(n: int, b: int, k1: int, sms: int) -> tuple[int, int, int]:
    """(queries per block, rows per chunk, chunks) of kernels A and C on
    `wgmma`: one block an SM, so the grid is at most one wave (sms //
    query tiles chunks; 66 of ~15,900 rows at 1M, B=256) and each row is
    read by as few blocks as the batch has query tiles."""
    bq = wg_block_queries(b, k1)
    q_tiles = -(-b // bq)
    return (bq, *_rows_per_chunk(n, max(1, sms // q_tiles)))


# kernel C's names of the plan that kernels A and D share with it (a k slab
# is 128 bytes of each row in any type)
int8_block_queries = wg_block_queries
int8_smem_bytes = wg_smem_bytes
int8_plan = wg_plan


def int8_route(q_values: torch.Tensor, e_values: torch.Tensor) -> str:
    """Kernel C's entry by shape: the wgmma route where TMA can read the
    int8 queries and rows (d % 16 == 0, 16-byte aligned), else the wmma
    tile loop."""
    d = q_values.shape[1]
    return ("lt_scan_topk_int8" if d % 16 == 0 and _aligned(q_values, e_values)
            else "lt_scan_topk_int8_scalar")


def int4_route(q_values: torch.Tensor, e_packed: torch.Tensor, k1: int
               ) -> str:
    """Kernel D's entry by shape and list length: the wgmma route where TMA
    can read the int8 queries' halves and the packed rows (d/2 % 16 == 0,
    16-byte aligned) and the lists fit beside its ring (k1 <= MAX_K1),
    else the wmma tile loop."""
    dh = e_packed.shape[1]
    return ("lt_scan_topk_int4"
            if dh % 16 == 0 and k1 <= MAX_K1
            and _aligned(q_values, e_packed)
            else "lt_scan_topk_int4_scalar")


def bf16_route(queries: torch.Tensor, embeddings: torch.Tensor) -> str:
    """Kernel A's entry for bf16 rows by shape: the wgmma route where TMA
    can read the bf16 rows and the bf16 copy of the queries (d % 8 == 0,
    f32 queries and rows 16-byte aligned), else the wmma tile loop."""
    d = queries.shape[1]
    return ("lt_scan_topk_bf16" if d % 8 == 0 and _aligned(queries, embeddings)
            else "lt_scan_topk_bf16_scalar")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---- kernel B: merge_candidates ---------------------------------------------


def merge_candidates_plain(cand_s: torch.Tensor, cand_i: torch.Tensor,
                           k1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k1 of [B, m] candidates by (score desc, id asc)."""
    by_id = torch.argsort(cand_i, dim=-1, stable=True)
    s = torch.gather(cand_s, -1, by_id)
    i = torch.gather(cand_i, -1, by_id)
    vals, pos = stable_topk(s, k1)
    return vals, torch.gather(i, -1, pos.to(torch.int64))


def merge_splits(b: int, m: int, k1: int, sms: int) -> int:
    """Blocks per query of kernel B's first pass. One when the batch alone
    fills the SMs or the list is short (`MERGE_ONE_BLOCK`); else about
    sqrt(m / k1), so that a block's slice and the g * k1 survivors the
    second pass selects from are about as long, capped at two blocks per
    SM over the grid. Never fewer than a block can hold (`MERGE_CAP`
    candidates each)."""
    g = (1 if b >= sms or m <= MERGE_ONE_BLOCK
         else min(max(1, math.isqrt(m // k1)), -(-2 * sms // b)))
    return max(g, -(-m // MERGE_CAP))


def merge_candidates(cand_s: torch.Tensor, cand_i: torch.Tensor, k1: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: sorted top-k1 ([B, k1] f32, [B, k1] i32) of [B, m]
    candidate (score, row id) pairs, by (score desc, id asc)."""
    if _on_cpu(cand_s, cand_i):
        return merge_candidates_plain(cand_s, cand_i, k1)
    _check(cand_s, "cand_s", torch.float32, 2)
    _check(cand_i, "cand_i", torch.int32, 2)
    b, m = cand_s.shape
    if cand_i.shape != cand_s.shape or not 1 <= k1 <= min(m, MAX_K1_LONG):
        raise KernelError(f"merge_candidates: k1={k1}, shapes "
                          f"{tuple(cand_s.shape)} {tuple(cand_i.shape)}")
    device = cand_s.device
    out_s, out_i = _empty_lists(b, k1, device)
    if b == 0:
        return out_s, out_i
    g = merge_splits(b, m, k1, _sm_count(device))
    # two [B, g, k1] buffers of (u64 key, i32 position): 12 bytes an entry
    scratch = (torch.empty(2 * b * g * k1 * 3, dtype=torch.int32,
                           device=device) if g > 1 else None)
    with torch.cuda.device(device):
        MERGE_CANDIDATES.launch(
            "lt_merge_candidates", cand_s.data_ptr(), cand_i.data_ptr(), b, m,
            k1, g, 0 if scratch is None else scratch.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), _stream(device))
    return out_s, out_i


def merge_positions(scores: torch.Tensor, k1: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B over whole score rows: sorted top-k1 ([B, k1] f32, [B, k1]
    i32) of [B, m] scores whose ids are their columns, by (score desc,
    column asc); `lt_merge_positions`, which reads no id tensor. Its plain
    version is `stable_topk`, which is `merge_candidates_plain` with the
    ids `arange(m)`."""
    if _on_cpu(scores):
        return stable_topk(scores, k1)
    _check(scores, "scores", torch.float32, 2)
    b, m = scores.shape
    if not 1 <= k1 <= min(m, MAX_K1_LONG):
        raise KernelError(f"merge_positions: k1={k1}, shape "
                          f"{tuple(scores.shape)}")
    device = scores.device
    out_s, out_i = _empty_lists(b, k1, device)
    if b == 0:
        return out_s, out_i
    g = merge_splits(b, m, k1, _sm_count(device))
    scratch = (torch.empty(2 * b * g * k1 * 3, dtype=torch.int32,
                           device=device) if g > 1 else None)
    with torch.cuda.device(device):
        MERGE_CANDIDATES.launch(
            "lt_merge_positions", scores.data_ptr(), b, m, k1, g,
            0 if scratch is None else scratch.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), _stream(device))
    return out_s, out_i


def topk_rows(scores: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sorted top-k along the last axis of [m] or [B, m] f32 scores,
    ties to the lower column, ids int32. The shape alone picks the route:
    kernel B (`merge_positions`) for 1 <= k <= `MAX_K1_LONG`, the longest
    list it keeps; `stable_topk` above that, on any device (the unbounded
    `k_hop_batch(device=True, limit<=0)` asks for every padded node)."""
    k = min(k, scores.shape[-1])
    if not 1 <= k <= MAX_K1_LONG:
        return stable_topk(scores, k)
    rows = scores.reshape(-1, scores.shape[-1]).contiguous()
    s, i = merge_positions(rows, k)
    return s.reshape(*scores.shape[:-1], k), i.reshape(*scores.shape[:-1], k)


# ---- plain versions of kernels A and C --------------------------------------


def scan_topk_plain(queries: torch.Tensor, embeddings: torch.Tensor,
                    valid: torch.Tensor, k1: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain kernels A + B: queries cast to the row dtype, products and
    sums in f32 (TF32 off), invalid rows NEG_INF, stable top-k1."""
    return flat_topk_blocked(queries, embeddings, valid, k1, PLAIN_BLOCK)


def scan_topk_int8_plain(q_values: torch.Tensor, q_scales: torch.Tensor,
                         e_values: torch.Tensor, e_scales: torch.Tensor,
                         valid: torch.Tensor, k1: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain kernels C + B. The int8 dot runs as an f32 product, which is
    exact: every partial sum is an integer below 127²·d < 2²⁴ for
    d <= 1040, and TF32 is off (`full_f32`). Then (acc·qs)·es, the
    kernel's order, so scores agree bit for bit."""
    d = e_values.shape[1]
    if d > 1040:
        raise KernelError(f"int8 plain dot is exact only for d <= 1040, got {d}")
    qf = q_values.to(torch.float32)
    keep = valid.to(torch.bool)

    def block(lo, hi):
        with full_f32():
            acc = qf @ e_values[lo:hi].to(torch.float32).T
        s = acc * q_scales[:, None] * e_scales[None, lo:hi]
        return torch.where(keep[None, lo:hi], s, torch.full_like(s, NEG_INF))

    return blocked_topk(block, e_values.shape[0], k1, PLAIN_BLOCK)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, d/2] packed -> [N, d] int8: low nibbles (biased by 8) are dims
    [0, d/2), high nibbles (sign-extended) dims [d/2, d)."""
    x = packed.to(torch.int32)
    return torch.cat([(x & 0xF) - 8, x >> 4], dim=-1).to(torch.int8)


def scan_topk_int4_plain(q_values: torch.Tensor, q_scales: torch.Tensor,
                         e_packed: torch.Tensor, e_scales: torch.Tensor,
                         valid: torch.Tensor, k1: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain kernels D + B (JAX `int4_topk`, quant.py:377): unpack a block
    of rows, then kernel C's exact f32 product: every partial sum is an
    integer below 127·8·d < 2²⁴ for d <= 16,000 (TF32 off); then
    (acc·qs)·es, so scores agree with the kernel bit for bit."""
    d = 2 * e_packed.shape[1]
    if d > 16_000:
        raise KernelError(f"int4 plain dot is exact only for d <= 16000, got {d}")
    qf = q_values.to(torch.float32)
    keep = valid.to(torch.bool)

    def block(lo, hi):
        with full_f32():
            acc = qf @ unpack_int4(e_packed[lo:hi]).to(torch.float32).T
        s = acc * q_scales[:, None] * e_scales[None, lo:hi]
        return torch.where(keep[None, lo:hi], s, torch.full_like(s, NEG_INF))

    return blocked_topk(block, e_packed.shape[0], k1, PLAIN_BLOCK)


# ---- kernels A, C and D --------------------------------------------------------


def _check_scan_shapes(b: int, d: int, e: torch.Tensor, valid: torch.Tensor,
                       k1: int, max_k1: int = MAX_K1, width: int | None = None
                       ) -> int:
    """Row count of a scan's rows `e` ([N, width], width d unless packed)."""
    n = e.shape[0]
    if (e.shape[1] != (d if width is None else width) or valid.shape != (n,)
            or valid.dtype != torch.bool):
        raise KernelError(f"scan: queries d={d}, rows {tuple(e.shape)}, "
                          f"valid {valid.dtype} {tuple(valid.shape)}")
    if not 1 <= k1 <= min(n, max_k1):
        raise KernelError(f"scan: k1={k1} outside [1, min(N={n}, {max_k1})]")
    if not valid.is_contiguous():
        raise KernelError("scan: valid must be contiguous")
    return n


def _launch_scan(kernel: _build.Kernel, entry: str, k1: int, b: int, n: int,
                 d: int, vec: int, pointers: tuple, device: torch.device,
                 bq: int = BQ, chunks: tuple[int, int] | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel A, C or D with `bq` queries per block:
    per-chunk sorted lists, [B, n_chunks * k1] scores and row ids, for
    kernel B to merge. The entry refuses a `bq` its instance does not
    have, so the chunking here always matches the kernel's grid. `chunks`
    (rows per chunk, chunks) defaults to `_chunking`'s."""
    rows, n_chunks = chunks or _chunking(n, b, device, bq)
    cand_s = torch.empty((b, n_chunks * k1), dtype=torch.float32,
                         device=device)
    cand_i = torch.empty((b, n_chunks * k1), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        kernel.launch(entry, *pointers, b, n, d, k1, bq, rows, n_chunks, vec,
                      cand_s.data_ptr(), cand_i.data_ptr(), _stream(device))
    return cand_s, cand_i


def scan_blocks(queries: torch.Tensor, embeddings: torch.Tensor,
                valid: torch.Tensor, k1: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A alone on CUDA tensors (bf16 or f32 rows): the unmerged
    per-chunk candidate lists, from the route `bf16_route` names for bf16
    rows (the wgmma route takes a bf16 copy of the queries)."""
    _check(queries, "queries", torch.float32, 2)
    if embeddings.dtype not in (torch.bfloat16, torch.float32):
        raise KernelError(f"scan_topk: no kernel for rows of {embeddings.dtype}")
    _check(embeddings, "embeddings", embeddings.dtype, 2)
    b, d = queries.shape
    n = _check_scan_shapes(b, d, embeddings, valid, k1)
    device = embeddings.device
    entry = ("lt_scan_topk_f32" if embeddings.dtype == torch.float32
             else bf16_route(queries, embeddings))
    if entry == "lt_scan_topk_bf16":
        # rounded to nearest even, as JAX's `astype`; held until the launch
        # is issued: freed earlier, its block could become the lists the
        # kernel writes
        qb = queries.to(torch.bfloat16)
        bq, rows, n_chunks = wg_plan(n, b, k1, _sm_count(device))
        return _launch_scan(
            SCAN_TOPK, entry, k1, b, n, d, 1,
            (qb.data_ptr(), embeddings.data_ptr(), valid.data_ptr()), device,
            bq, (rows, n_chunks))
    vec = int(d % 8 == 0 and _aligned(queries, embeddings))
    return _launch_scan(
        SCAN_TOPK, entry, k1, b, n, d, vec,
        (queries.data_ptr(), embeddings.data_ptr(), valid.data_ptr()), device)


def scan_blocks_int8(q_values: torch.Tensor, q_scales: torch.Tensor,
                     e_values: torch.Tensor, e_scales: torch.Tensor,
                     valid: torch.Tensor, k1: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C alone on CUDA tensors: the unmerged per-chunk lists, from
    the route `int8_route` names for the shape."""
    _check(q_values, "q_values", torch.int8, 2)
    _check(q_scales, "q_scales", torch.float32, 1)
    _check(e_values, "e_values", torch.int8, 2)
    _check(e_scales, "e_scales", torch.float32, 1)
    b, d = q_values.shape
    n = _check_scan_shapes(b, d, e_values, valid, k1)
    if q_scales.shape != (b,) or e_scales.shape != (n,):
        raise KernelError(f"scan_topk_int8: scales {tuple(q_scales.shape)} "
                          f"{tuple(e_scales.shape)} for B={b}, N={n}")
    pointers = (q_values.data_ptr(), q_scales.data_ptr(), e_values.data_ptr(),
                e_scales.data_ptr(), valid.data_ptr())
    device = e_values.device
    entry = int8_route(q_values, e_values)
    if entry == "lt_scan_topk_int8":
        bq, rows, n_chunks = int8_plan(n, b, k1, _sm_count(device))
        return _launch_scan(SCAN_TOPK_INT8, entry, k1, b, n, d, 1, pointers,
                            device, bq, (rows, n_chunks))
    return _launch_scan(SCAN_TOPK_INT8, entry, k1, b, n, d, 0, pointers,
                        device)


def scan_blocks_int4(q_values: torch.Tensor, q_scales: torch.Tensor,
                     e_packed: torch.Tensor, e_scales: torch.Tensor,
                     valid: torch.Tensor, k1: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D alone on CUDA tensors: the unmerged per-chunk lists, from
    the route `int4_route` names (the wgmma route at kernel C's plan). Any
    even d; on the wmma route 16-byte loads where d/2 % 16 == 0, and past
    k1 = MAX_K1 a block owns BQ_LONG queries instead of BQ (shared memory
    for the longer lists); this is the one place that rule is made."""
    _check(q_values, "q_values", torch.int8, 2)
    _check(q_scales, "q_scales", torch.float32, 1)
    _check(e_packed, "e_packed", torch.int8, 2)
    _check(e_scales, "e_scales", torch.float32, 1)
    b, d = q_values.shape
    if d != 2 * e_packed.shape[1]:
        raise KernelError(f"scan_topk_int4: queries d={d} against packed rows "
                          f"{tuple(e_packed.shape)} (d must be even)")
    n = _check_scan_shapes(b, d, e_packed, valid, k1, MAX_K1_LONG, d // 2)
    if q_scales.shape != (b,) or e_scales.shape != (n,):
        raise KernelError(f"scan_topk_int4: scales {tuple(q_scales.shape)} "
                          f"{tuple(e_scales.shape)} for B={b}, N={n}")
    pointers = (q_values.data_ptr(), q_scales.data_ptr(), e_packed.data_ptr(),
                e_scales.data_ptr(), valid.data_ptr())
    device = e_packed.device
    entry = int4_route(q_values, e_packed, k1)
    if entry == "lt_scan_topk_int4":
        bq, rows, n_chunks = wg_plan(n, b, k1, _sm_count(device))
        return _launch_scan(SCAN_TOPK_INT4, entry, k1, b, n, d, 1, pointers,
                            device, bq, (rows, n_chunks))
    vec = int((d // 2) % 16 == 0 and _aligned(q_values, e_packed))
    return _launch_scan(SCAN_TOPK_INT4, entry, k1, b, n, d, vec, pointers,
                        device, BQ if k1 <= MAX_K1 else BQ_LONG)


def _empty_lists(b: int, k1: int, device: torch.device):
    return (torch.empty((b, k1), dtype=torch.float32, device=device),
            torch.empty((b, k1), dtype=torch.int32, device=device))


def scan_topk(queries: torch.Tensor, embeddings: torch.Tensor,
              valid: torch.Tensor, k1: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels A + B: sorted first-stage (scores [B, k1] f32, row ids
    [B, k1] i32) over bf16 or f32 rows. Queries are f32 and normalized,
    cast to the row dtype (by the wrapper on A's wgmma route, else inside
    the kernel)."""
    if _on_cpu(queries, embeddings, valid):
        return scan_topk_plain(queries, embeddings, valid, k1)
    if queries.shape[0] == 0:
        return _empty_lists(0, k1, queries.device)
    return merge_candidates(*scan_blocks(queries, embeddings, valid, k1), k1)


def scan_topk_int8(q_values: torch.Tensor, q_scales: torch.Tensor,
                   e_values: torch.Tensor, e_scales: torch.Tensor,
                   valid: torch.Tensor, k1: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels C + B: sorted first-stage (scores [B, k1] f32, row ids
    [B, k1] i32) of the int8 scan."""
    if _on_cpu(q_values, q_scales, e_values, e_scales, valid):
        return scan_topk_int8_plain(q_values, q_scales, e_values, e_scales,
                                    valid, k1)
    if q_values.shape[0] == 0:
        return _empty_lists(0, k1, q_values.device)
    return merge_candidates(*scan_blocks_int8(q_values, q_scales, e_values,
                                              e_scales, valid, k1), k1)


def scan_topk_int4(q_values: torch.Tensor, q_scales: torch.Tensor,
                   e_packed: torch.Tensor, e_scales: torch.Tensor,
                   valid: torch.Tensor, k1: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels D + B: sorted first-stage (scores [B, k1] f32, row ids
    [B, k1] i32) of int8 queries against packed int4 rows."""
    if _on_cpu(q_values, q_scales, e_packed, e_scales, valid):
        return scan_topk_int4_plain(q_values, q_scales, e_packed, e_scales,
                                    valid, k1)
    if q_values.shape[0] == 0:
        return _empty_lists(0, k1, q_values.device)
    return merge_candidates(*scan_blocks_int4(q_values, q_scales, e_packed,
                                              e_scales, valid, k1), k1)


# ---- the contracts of pallas_topk.py ------------------------------------------


def _exact_rescore(queries: torch.Tensor, embeddings: torch.Tensor,
                   stage_scores: torch.Tensor, candidates: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 rescore of first-stage candidates; padded slots stay NEG_INF.

    A gather of [B, k1, d] rows, an f32 product (TF32 off) and a stable
    top-k, as `_exact_rescore` (pallas_topk.py:1096) ran in XLA. Slots the
    first stage scored NEG_INF (fewer live rows than k1) are masked by
    their stage score so they are never promoted. Traced as the hot span
    `search.rescore`."""
    with get_tracer().hot("search.rescore"):
        rows = embeddings[candidates.to(torch.int64)].to(torch.float32)
        with full_f32():
            scores = torch.einsum("bd,bkd->bk", queries.to(torch.float32),
                                  rows)
        scores = torch.where(stage_scores > NEG_INF / 2, scores,
                             torch.full_like(scores, NEG_INF))
        top, pos = stable_topk(scores, min(k, scores.shape[-1]))
        return top, torch.gather(candidates, -1, pos.to(torch.int64))


def binned_topk(queries: torch.Tensor, embeddings: torch.Tensor,
                valid: torch.Tensor, k: int, normalize: bool = False,
                widen: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan + exact rescore. Returns sorted (scores [B, k], ids [B, k]).

    Candidates widen to k1 = max(k, widen) (capped by N) and rescore in
    f32. With fewer rows than k the contract shape is padded with NEG_INF
    / -1. `normalize` L2-normalizes raw queries first. The scan is traced
    as the hot span `search.first_stage`."""
    queries = queries.to(torch.float32)
    if normalize:
        queries = l2_normalize_t(queries)
    queries = queries.contiguous()
    k1 = min(max(k, widen), embeddings.shape[0])
    with get_tracer().hot("search.first_stage"):
        s1, c1 = scan_topk(queries, embeddings, valid, k1)
    out_s, out_i = _exact_rescore(queries, embeddings, s1, c1, min(k, k1))
    if k > k1:  # corpus smaller than k: pad the contract shape
        pad = k - k1
        out_s = torch.nn.functional.pad(out_s, (0, pad), value=NEG_INF)
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=-1)
    return out_s, out_i


def binned_topk_int8(q_values: torch.Tensor, q_scales: torch.Tensor,
                     e_values: torch.Tensor, e_scales: torch.Tensor,
                     valid: torch.Tensor, k: int, selection: str = "mul"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 scan; the caller rescores (`QuantizedView`). Returns the sorted
    widened (scores [B, k1], ids [B, k1]) with k1 = max(k, 16), capped by
    N. Both `selection` chains ("mul", and "hoistq", which hoisted the
    query scale out of the TPU kernel) are kernels C + B here."""
    _check_choice("selection", selection, ("mul", "hoistq"))
    return scan_topk_int8(q_values, q_scales, e_values, e_scales, valid,
                          first_stage_width(k, e_values.shape[0]))


def binned_topk_int4(q_values: torch.Tensor, q_scales: torch.Tensor,
                     e_packed: torch.Tensor, e_scales: torch.Tensor,
                     valid: torch.Tensor, k: int, unpack: str = "vpu",
                     selection: str = "hoistq"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-int4 scan; the caller rescores (`Int4View`). Returns the
    sorted widened (scores [B, k1], ids [B, k1]) with k1 = max(k, 16),
    capped by N. Every `unpack` ("vpu", "matmul") and `selection`
    ("hoistq", "mul", "fma") is kernels D + B: the TPU bodies differed in
    how they approximated this exact function, not in the function."""
    _check_choice("unpack", unpack, ("vpu", "matmul"))
    _check_choice("selection", selection, ("hoistq", "mul", "fma"))
    return scan_topk_int4(q_values, q_scales, e_packed, e_scales, valid,
                          first_stage_width(k, e_packed.shape[0]))


def _check_choice(name: str, value: str, allowed: tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: one of {allowed}")


def fused_topk(queries: torch.Tensor, embeddings: torch.Tensor,
               valid: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat-scan top-k at the first stage's precision (queries cast to the
    row dtype): kernels A + B at k1 = k. The TPU's insertion scan
    (`_select_topk_insertion`) kept ~1e-3 packed scores; this is exact."""
    return scan_topk(queries.to(torch.float32).contiguous(), embeddings,
                     valid, k)


def fused_topk_int8(q_values: torch.Tensor, q_scales: torch.Tensor,
                    e_values: torch.Tensor, e_scales: torch.Tensor,
                    valid: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized flat-scan top-k: kernels C + B at k1 = k."""
    return scan_topk_int8(q_values, q_scales, e_values, e_scales, valid, k)


def refined_topk(queries: torch.Tensor, embeddings: torch.Tensor,
                 valid: torch.Tensor, k: int, widen: int = 16,
                 normalize: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`binned_topk`'s widened scan and rescore, except where the width
    does not exceed k (k >= widen, or N <= k): there the first stage,
    unrescored and unpadded, is the answer, as in the JAX function."""
    if min(max(k, widen), embeddings.shape[0]) > k:
        return binned_topk(queries, embeddings, valid, k, normalize, widen)
    if normalize:
        queries = l2_normalize_t(queries.to(torch.float32))
    return fused_topk(queries, embeddings, valid,
                      min(k, embeddings.shape[0]))
