"""The score-floor probe: a scan's product with a strided bin max in place
of its selection, with its plain version.

Port of the dissection kernels of the round-2 scripts, which the JAX
package never imported: `make_probe` (scripts/r2_tpu_experiments3.py:105,
bf16), `make_int4_probe` (r2_tpu_experiments4.py:120) and `make_probe`
(r2_tpu_experiments6.py:108, bf16, int8 and int4). One hand-written CUDA
kernel, `score_probe` (`csrc/score_probe.cu`), replaces them: it runs the
same loads and tensor-core products as the scan kernel of its type (A for
bf16, C for int8, D for packed int4) and keeps a running max over 128
strided bins of each `tile` rows instead of a top-k1. Its time is that
scan's floor; the scan's time minus it is what the selection costs
(`tools/dissect.py`).

For queries q [B, d] and rows [N, d] (packed int8 [N, d/2] for int4),
`out[b, t*128 + j]` (t < N // tile; trailing rows are dropped, as the
scripts' grid dropped them) is the max over i < tile/128 of, by type:

- bf16 rows, f32 queries cast to bf16, f32 sums: the score (mode
  "rawmax") or its packed key `pack_keys_fast(score, i*128 + j)` ("pack")
  cast to f32, the key at shift 12 at every tile, as the scripts ran it;
- int8 rows and queries: the i32 sum as f32, no scales, or its key;
- packed int4: `q[:, :d/2] . lo + q[:, d/2:] . hi` in i32 with the
  scripts' unpack `lo = ((b & 0xF) ^ 8) - 8`, `hi = b >> 4`, as f32; no
  pack mode (the scripts' int4 body ignored `mode`).

`quantize_rows_int4` packs the low nibble biased (v + 8), so the scripts'
int4 product is not the int4 view's dot product: a quirk of the
reference, kept on purpose so that the floor does the scripts' work and
parity holds (`unpack_int4_signed`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import _build
from lattice_tpu_torch.ops.scan_topk import (BN, BQ, PLAIN_BLOCK, _aligned,
                                             _check, _chunking, _on_cpu,
                                             _sm_count, _stream, bf16_route,
                                             int8_route, wg_plan)
from lattice_tpu_torch.ops.topk import full_f32

MODES = ("rawmax", "pack")
KEY_SHIFT = 12        # `pallas_topk._KEY_SHIFT`, the scripts' default

SCORE_PROBE = _build.Kernel(
    "score_probe", "lattice_tpu_torch/csrc/score_probe.cu",
    "scripts/r2_tpu_experiments6.py:155")


def pack_keys_fast(scores: torch.Tensor, cols: torch.Tensor,
                   shift: int = KEY_SHIFT) -> torch.Tensor:
    """`pallas_topk._pack_keys_fast`: the bits of score + 2 with the low
    `shift` bits cleared, or'd with the column; i32, ordered as the scores
    for every score above -2."""
    bits = (scores.to(torch.float32) + 2.0).view(torch.int32)
    return (bits & ~((1 << shift) - 1)) | cols.to(torch.int32)


def unpack_int4_signed(packed: torch.Tensor) -> torch.Tensor:
    """[N, d/2] packed -> [N, d] int8 as the probe scripts unpacked it: the
    low nibble as two's complement (not `unpack_int4`'s v + 8) for dims
    [0, d/2), the sign-extended high nibble for [d/2, d)."""
    x = packed.to(torch.int32)
    return torch.cat([((x & 0xF) ^ 8) - 8, x >> 4], dim=-1).to(torch.int8)


def _kind(q: torch.Tensor, rows: torch.Tensor) -> str:
    """"bf16", "int8" or "int4", from the rows' type and the widths."""
    if q.dim() != 2 or rows.dim() != 2:
        raise KernelError(f"score_probe: want 2-d q and rows, got "
                          f"{tuple(q.shape)} {tuple(rows.shape)}")
    if rows.dtype == torch.bfloat16 and q.dtype == torch.float32 \
            and q.shape[1] == rows.shape[1]:
        return "bf16"
    if rows.dtype == torch.int8 and q.dtype == torch.int8:
        if q.shape[1] == rows.shape[1]:
            return "int8"
        if q.shape[1] == 2 * rows.shape[1]:
            return "int4"
    raise KernelError(f"score_probe: no probe for q {q.dtype} "
                      f"{tuple(q.shape)} against rows {rows.dtype} "
                      f"{tuple(rows.shape)}")


def _check_args(q: torch.Tensor, rows: torch.Tensor, tile: int, mode: str
                ) -> str:
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    if tile < BN or tile % BN:
        raise KernelError(f"score_probe: tile={tile} must be a multiple of "
                          f"{BN}")
    return _kind(q, rows)


def score_probe_plain(q: torch.Tensor, rows: torch.Tensor, *, tile: int,
                      mode: str = "rawmax") -> torch.Tensor:
    """Plain version: [B, (N // tile) * 128] f32. Scores of PLAIN_BLOCK rows
    at a time, in f32 with TF32 off; the integer products run as f32
    products, which are exact (every partial sum is an integer below 2^24
    for d <= 1040 in int8 and d <= 16,000 in int4)."""
    kind = _check_args(q, rows, tile, mode)
    b, d = q.shape
    if (kind == "int8" and d > 1040) or (kind == "int4" and d > 16_000):
        raise KernelError(f"score_probe_plain: the {kind} product is exact "
                          f"only up to d = {1040 if kind == 'int8' else 16000}"
                          f", got {d}")
    n_tiles = rows.shape[0] // tile
    qf = (q.to(torch.bfloat16) if kind == "bf16" else q).to(torch.float32)
    cols = torch.arange(tile, device=q.device, dtype=torch.int32)
    step = max(1, PLAIN_BLOCK // tile)
    out = []
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        blk = rows[t0 * tile:t1 * tile]
        if kind == "int4":
            blk = unpack_int4_signed(blk)
        with full_f32():
            s = qf @ blk.to(torch.float32).T
        if kind == "int4" or (kind == "int8" and mode == "rawmax"):
            v = s.to(torch.int32)         # exact integer sums, maxed as i32
        elif mode == "pack":
            v = pack_keys_fast(s, cols.repeat(t1 - t0))
        else:
            v = s
        m = v.view(b, t1 - t0, tile // BN, BN).amax(dim=2)
        out.append(m.reshape(b, (t1 - t0) * BN).to(torch.float32))
    if not out:
        return torch.empty((b, 0), dtype=torch.float32, device=q.device)
    return torch.cat(out, dim=1)


def score_probe(q: torch.Tensor, rows: torch.Tensor, *, tile: int,
                mode: str = "rawmax", k1: int = 16) -> torch.Tensor:
    """[B, (N // tile) * 128] f32 bin maxima of q against rows; the type
    from `rows` (bf16; int8; packed int8 with q twice as wide). On the card
    the kernel runs its scan's loads and products at its register budget
    (A, C or D), so that the two differ only by the selection. bf16 and
    int8 take kernel A's and C's route for the shape and, on the wgmma
    route, the instance and chunking the scan takes at list length `k1`
    (bf16 from a bf16 copy of q, as kernel A)."""
    kind = _check_args(q, rows, tile, mode)
    if _on_cpu(q, rows):
        return score_probe_plain(q, rows, tile=tile, mode=mode)
    _check(q, "q", q.dtype, 2)
    _check(rows, "rows", rows.dtype, 2)
    b, d = q.shape
    n = rows.shape[0]
    n_tiles = n // tile
    out = torch.empty((b, n_tiles * BN), dtype=torch.float32, device=q.device)
    if b == 0 or n_tiles == 0:
        return out
    unit = {"bf16": 8, "int8": 16, "int4": 32}[kind]   # dims per 16 bytes
    vec = int(d % unit == 0 and _aligned(q, rows))
    # the scans' chunking over one 128-row stand-in per probe tile: whole
    # probe tiles per block
    entry, bq = f"lt_score_probe_{kind}", BQ
    if kind == "bf16":
        wg = bf16_route(q, rows) == "lt_scan_topk_bf16"
    else:
        wg = kind == "int8" and int8_route(q, rows) == "lt_scan_topk_int8"
    if wg:
        bq, rows_per_chunk, n_chunks = wg_plan(n_tiles * BN, b, k1,
                                               _sm_count(q.device))
        if kind == "bf16":  # kernel A's copy, held until the launch
            q = q.to(torch.bfloat16)
    else:
        entry += "" if kind == "int4" else "_scalar"
        rows_per_chunk, n_chunks = _chunking(n_tiles * BN, b, q.device)
    with torch.cuda.device(q.device):
        SCORE_PROBE.launch(
            entry, q.data_ptr(), rows.data_ptr(), b, n, d, tile,
            rows_per_chunk // BN, n_chunks, bq,
            int(mode == "pack" and kind != "int4"), vec, out.data_ptr(),
            _stream(q.device))
    return out
