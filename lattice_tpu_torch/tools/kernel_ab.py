"""Time kernels A, C and D of one or more checkouts on one card, in one
call.

    python lattice_tpu_torch/tools/kernel_ab.py [--k1 16,80,128,512]
        [--k1-4m 16,80] [--skip-4m] CHECKOUT [CHECKOUT ...]

A checkout is a directory that holds `lattice_tpu_torch/` (this one, or a
`git archive` of another commit unpacked under `build/`). Each runs in a
process of its own, one after another, so that kernels built from
different sources never share a process. Each process builds its
checkout's kernels, makes corpus A (1,048,576 x 768 rows around 1,024
centers at spread 0.35, seed 0, kept as bf16, quantized to int8 and
packed to int4) and times with CUDA events, on the card, at B=256 and B=1:

- the bf16 probe (`score_probe` at tile 2048, rawmax, on f32 queries):
  kernel A's floor;
- `scan_blocks` (kernel A alone, from f32 queries: the bf16 copy of the
  queries its wgmma route takes is timed with it) at k1 = 16 and 64;
- the int8 probe (`score_probe` at tile 2048, rawmax): kernel C's floor;
- `scan_blocks_int8` (kernel C alone) at k1 = 16 (the plans' width; 128
  queries a block at B=256) and 64 (64 queries a block);
- the int4 probe (kernel D's floor) and `scan_blocks_int4` (kernel D
  alone) at each k1 of --k1;
- unless --skip-4m, corpus D (4,194,304 x 768 rows from the same
  centers, B=1024): the int4 probe and kernel D at each k1 of --k1-4m;

and prints one line `kernel_ab {json}` with the card's name and power
limit. Run the checkouts to compare as A, B, B, A in one call: numbers
from different calls are not comparable.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_ROWS = 1 << 20
N_CAP = 1 << 22
DIM = 768
BLOCK = 1 << 17
C_K1 = (16, 64)        # kernels A and C


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def _rows(torch, centers, n, gen):
    """Corpus A's rows (`tools/dissect.cluster_rows` at spread 0.35)."""
    assign = torch.randint(0, centers.shape[0], (n,), device="cuda",
                           generator=gen)
    base = centers.to(torch.bfloat16).to(torch.float32)[assign]
    x = base + 0.35 * torch.randn(n, DIM, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _views(torch, quant, centers, n, gen, int8: bool = True):
    """Corpus rows as bf16 and int8 (unless `int8` is false: None for
    both) and the packed int4 view, (bf16 rows, (int8 values, scales),
    (packed, scales)), quantized block by block from the same bf16 rows."""
    packed = torch.empty((n, DIM // 2), dtype=torch.int8, device="cuda")
    scales = torch.empty((n,), dtype=torch.float32, device="cuda")
    values8 = (torch.empty((n, DIM), dtype=torch.int8, device="cuda")
               if int8 else None)
    scales8 = torch.empty_like(scales) if int8 else None
    bf16 = (torch.empty((n, DIM), dtype=torch.bfloat16, device="cuda")
            if int8 else None)
    for lo in range(0, n, BLOCK):
        rows = _rows(torch, centers, BLOCK, gen).to(torch.bfloat16)
        packed[lo:lo + BLOCK], scales[lo:lo + BLOCK] = (
            quant.quantize_rows_int4_device(rows))
        if int8:
            bf16[lo:lo + BLOCK] = rows
            values8[lo:lo + BLOCK], scales8[lo:lo + BLOCK] = (
                quant.quantize_rows_device(rows))
    return bf16, (values8, scales8), (packed, scales)


def measure(checkout: str, k1s: list[int], k1s_4m: list[int]) -> dict:
    """Every timing of one checkout, in this process."""
    sys.path.insert(0, str(Path(checkout).resolve()))
    import torch
    from lattice_tpu_torch.ops import _build, quant, scan_topk as scan
    from lattice_tpu_torch.ops.probe import score_probe

    def ms(fn, iters: int, warmup: int = 1) -> float:
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

    t0 = time.perf_counter()
    _build.library()
    out = {"checkout": checkout, "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    centers = torch.randn(1024, DIM, device="cuda", generator=gen)
    centers = centers / centers.norm(dim=1, keepdim=True)
    rows, (values8, scales8), (packed, scales) = _views(
        torch, quant, centers, N_ROWS, gen)
    valid = torch.ones(N_ROWS, dtype=torch.bool, device="cuda")
    q = _rows(torch, centers, 256, gen)
    qv, qs = quant.quantize_rows_device(q)
    for b in (256, 1):
        qf = q[:b].contiguous()
        out[f"floor16_b{b}"] = ms(lambda: score_probe(qf, rows, tile=2048), 5)
        for k1 in C_K1:
            out[f"a_b{b}_k{k1}"] = ms(lambda: scan.scan_blocks(
                qf, rows, valid, k1), 5)
        qb, sb = qv[:b].contiguous(), qs[:b].contiguous()
        out[f"floor8_b{b}"] = ms(lambda: score_probe(qb, values8, tile=2048),
                                 5)
        for k1 in C_K1:
            out[f"c_b{b}_k{k1}"] = ms(lambda: scan.scan_blocks_int8(
                qb, sb, values8, scales8, valid, k1), 5)
        out[f"floor_b{b}"] = ms(lambda: score_probe(qb, packed, tile=2048), 5)
        for k1 in k1s:
            out[f"d_b{b}_k{k1}"] = ms(lambda: scan.scan_blocks_int4(
                qb, sb, packed, scales, valid, k1), 5)
    del rows, values8, scales8, packed, scales, valid
    torch.cuda.empty_cache()
    if k1s_4m:
        _, _, (packed, scales) = _views(torch, quant, centers, N_CAP, gen,
                                        int8=False)
        valid = torch.ones(N_CAP, dtype=torch.bool, device="cuda")
        qv, qs = quant.quantize_rows_device(_rows(torch, centers, 1024, gen))
        out["floor_4m"] = ms(lambda: score_probe(qv, packed, tile=2048), 3)
        for k1 in k1s_4m:
            out[f"d_4m_k{k1}"] = ms(lambda: scan.scan_blocks_int4(
                qv, qs, packed, scales, valid, k1), 3)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--k1", default="16,80,128,512")
    ap.add_argument("--k1-4m", default="16,80")
    ap.add_argument("--skip-4m", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    k1s_4m = [] if args.skip_4m else _ints(args.k1_4m)
    if args.one:
        out = measure(args.checkouts[0], _ints(args.k1), k1s_4m)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print("kernel_ab " + json.dumps(out), flush=True)
        return 0
    rc = 0
    for checkout in args.checkouts:
        cmd = [sys.executable, __file__, "--one", checkout, "--k1", args.k1,
               "--k1-4m", args.k1_4m] + (["--skip-4m"] if args.skip_4m
                                         else [])
        rc |= subprocess.run(cmd, timeout=1800).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
