"""The dissection path: each flat scan beside its score floor, on the card.

Counterpart of the probe sections of the round-2 scripts
(`scripts/r2_tpu_experiments3.py:104-152`, `r2_tpu_experiments4.py:119-165`,
`r2_tpu_experiments6.py:107-236`). On a store of 1,048,576 x 768 bf16 rows
(corpus A of `chip_smoke.py`: 1,024 centers at spread 0.35) and its int8 and
packed-int4 views, at B=256, k=10, it times with CUDA events:

- `score_probe` at every (type, mode, tile) the scripts ran: bf16 rawmax
  and pack at tiles 2048, 4096 and 8192; int8 rawmax and pack at 2048;
  int4 at 2048, 4096 and 8192; each beside its bound and each held to its
  plain version on the same inputs (`check_probe`);
- kernels A, C and D (`scan_blocks*`) at k1 = 16 and 80 on the same rows
  and queries, so each scan's time has its own floor beside it, and the
  selection share (scan ms - probe ms) / scan ms;
- the library product of each type (`torch.matmul` in bf16,
  `torch._int_mm` over the int8 rows and over the unpacked int4 rows);
- script 6's batch sweep of `binned_topk` (kernels A + B + rescore), and
  kernels A and C alone at k1 = 16 beside the bf16 and int8 probes, at
  B = 1, 8, 32, 64, 128, 256;
- one `summarize_device_trace` each of a "quantized", an "int4" and a
  forced "refined" `search_device` call;
- with `--capacity`, the int4 probe at 4,194,304 x 768, B=1024, on a view
  held only as packed int4 (corpus D's shape), held to its plain version.

    python -m lattice_tpu_torch.tools.dissect [--capacity] [--trace-dir DIR]

runs it alone on the card and prints the report as JSON; `chip_smoke.py`
calls `dissect` on its own corpus-A store. The bounds use the H100's
published rates (SXM, dense).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import torch

from lattice_tpu_torch.core.errors import KernelError
from lattice_tpu_torch.ops import quant, scan_topk as scan
from lattice_tpu_torch.ops.probe import (KEY_SHIFT, score_probe,
                                         score_probe_plain)
from lattice_tpu_torch.ops.topk import l2_normalize_t
from lattice_tpu_torch.utils.tracing import (device_trace,
                                             summarize_device_trace)

H100_BYTES_S = 3.35e12
H100_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
K = 10
SCAN_K1 = (16, 80)
BATCH_SWEEP = (1, 8, 32, 64, 128, 256)
# (type, mode, tile) of every probe the scripts timed
PROBE_CASES = tuple(
    [("bf16", m, t) for t in (2048, 4096, 8192) for m in ("rawmax", "pack")]
    + [("int8", m, 2048) for m in ("rawmax", "pack")]
    + [("int4", "rawmax", t) for t in (2048, 4096, 8192)])
FLOOR_TILE = 2048       # the probe a scan's floor is read from
RAWMAX_TOL = 1e-4       # bf16 rawmax against plain, as kernel A's scores
PACK_EQUAL_MIN = 0.999  # bf16 pack: the share of bins whose key is equal
SCANS = (("A", "bf16"), ("C", "int8"), ("D", "int4"))
TRACED_PLANS = ("quantized", "int4", "refined")


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


def bound(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes moved once over its
    memory rate, or operations over its dense peak for `kind`."""
    by_bytes = n_bytes / H100_BYTES_S * 1e3
    by_ops = ops / H100_OPS_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def scan_bound(n: int, d: int, b: int, k1: int, row_bytes: float,
               kind: str) -> tuple[float, str]:
    """A flat scan of n rows of `row_bytes` each (plus the row's 1-byte
    validity, and a 4-byte scale for the quantized kinds) against b f32
    or int8 queries, writing [b, k1] f32 scores and i32 ids; 2 b n d
    operations."""
    scale = 4 if kind == "int8" else 0
    q_bytes = b * d * (1 if kind == "int8" else 4) + b * scale
    return bound(n * (row_bytes + scale + 1) + q_bytes + b * k1 * 8,
                 2 * b * n * d, kind)


def probe_bound(n: int, d: int, b: int, tile: int, row_bytes: float,
                kind: str) -> tuple[float, str]:
    """A probe over the (n // tile) * tile rows it reads, of `row_bytes`
    each, against b f32 (bf16 kind) or int8 queries, writing the
    [b, (n // tile) * 128] f32 output; 2 b n d operations."""
    rows = n // tile * tile
    q_bytes = b * d * (4 if kind == "bf16" else 1)
    return bound(rows * row_bytes + q_bytes + b * (n // tile) * 128 * 4,
                 2 * b * rows * d, kind)


def _operands(kind: str, q: torch.Tensor, rows: torch.Tensor,
              q8: torch.Tensor, view8, view4):
    """(queries, rows, bytes per row) of a probe of `kind`."""
    d = q.shape[1]
    return {"bf16": (q, rows, 2 * d), "int8": (q8, view8.values, d),
            "int4": (q8, view4.values, d / 2)}[kind]


def check_probe(out: torch.Tensor, ref: torch.Tensor, kind: str, mode: str,
                tile: int, where: str) -> tuple[float, float]:
    """Hold a `score_probe` output to its plain version's on the same
    inputs; (max abs error, share of equal bins), or KernelError.

    int8 and int4 must be equal: exact integer sums. bf16 rawmax within
    RAWMAX_TOL: the same bf16 products summed in another order. bf16 pack
    within one score step of the key (2^KEY_SHIFT key units, 2^13 at tile
    8192 where the column takes bit 12), since a sum that differs in its
    last bits can cross the key's truncation boundary, and equal on at
    least PACK_EQUAL_MIN of the bins: a key with a wrong row tile i
    (bits 7-12, below one step and rounded into the f32) fails that."""
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise KernelError(f"score_probe: bad output {tuple(out.shape)} "
                          f"against {tuple(ref.shape)} {where}")
    err = (out - ref).abs().max().item()
    same = (out == ref).float().mean().item()
    if kind != "bf16":
        ok, want = torch.equal(out, ref), "equal"
    elif mode == "rawmax":
        ok, want = err <= RAWMAX_TOL, f"within {RAWMAX_TOL}"
    else:
        step = 1 << max(KEY_SHIFT, (tile - 1).bit_length())
        ok = err <= step and same >= PACK_EQUAL_MIN
        want = f"within {step} key units on {PACK_EQUAL_MIN} of bins equal"
    if not ok:
        raise KernelError(f"score_probe differs from its plain version "
                          f"{where}: max abs error {err:.6g}, {same:.6f} of "
                          f"bins equal (want {want})")
    return err, same


def probe_floors(q, rows, q8, view8, view4, log=print) -> dict:
    """Every probe case of PROBE_CASES: its output held to the plain
    version's (`check_probe`), ms, bound and its share of the bound; at
    FLOOR_TILE, rawmax, also the plain version's time."""
    b, d = q.shape
    n = rows.shape[0]
    out = {}
    for kind, mode, tile in PROBE_CASES:
        qq, rr, row_bytes = _operands(kind, q, rows, q8, view8, view4)
        where = f"{kind} {mode} tile={tile} B={b} N={n} d={d}"

        def probe():
            return score_probe(qq, rr, tile=tile, mode=mode)

        def plain():
            return score_probe_plain(qq, rr, tile=tile, mode=mode)

        err, same = check_probe(probe(), plain(), kind, mode, tile, where)
        ms = cuda_ms(probe, 10, warmup=2)
        bnd = probe_bound(n, d, b, tile, row_bytes,
                          "bf16" if kind == "bf16" else "int8")
        row = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "bound_share": bnd[0] / ms, "max_abs_err": err,
               "equal_bins": same}
        extra = ""
        if mode == "rawmax" and tile == FLOOR_TILE:
            row["plain_ms"] = cuda_ms(plain, 1, 0)
            extra = f"; plain {row['plain_ms']:.3f} ms"
        out[f"{kind}_{mode}_t{tile}"] = row
        log(f"probe {where}: {ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
            f"{bnd[0] / ms:.1%}); against plain: max abs error {err:.3g}, "
            f"{same:.6f} of bins equal{extra}")
    return out


def scan_times(q, rows, valid, q8, qs8, view8, view4, log=print) -> dict:
    """Kernels A, C and D alone (unmerged lists) at each k1 of SCAN_K1,
    with each scan's bound."""
    b, d = q.shape
    n = rows.shape[0]
    calls = {
        "A": (lambda k1: scan.scan_blocks(q, rows, valid, k1), 2 * d, "bf16"),
        "C": (lambda k1: scan.scan_blocks_int8(
            q8, qs8, view8.values, view8.scales, valid, k1), d, "int8"),
        "D": (lambda k1: scan.scan_blocks_int4(
            q8, qs8, view4.values, view4.scales, valid, k1), d / 2, "int8"),
    }
    out = {}
    for name, (fn, row_bytes, kind) in calls.items():
        for k1 in SCAN_K1:
            ms = cuda_ms(lambda: fn(k1), 5)
            bnd = scan_bound(n, d, b, k1, row_bytes, kind)
            out[f"{name}_k{k1}"] = {"ms": ms, "bound_ms": bnd[0],
                                    "bound_by": bnd[1]}
            log(f"kernel {name} B={b} N={n} k1={k1}: {ms:.4f} ms, bound "
                f"{bnd[0]:.4f} ms ({bnd[1]})")
    return out


def library_products(q, rows, q8, view8, view4, log=print) -> dict:
    """One PyTorch product per type over the same rows: the scans' and
    the probes' product without the selection or the bin max."""
    unpacked = quant.unpack_int4(view4.values)
    out = {"bf16": cuda_ms(lambda: q.to(torch.bfloat16) @ rows.T, 10),
           "int8": cuda_ms(lambda: torch._int_mm(q8, view8.values.T), 10),
           "int4": cuda_ms(lambda: torch._int_mm(q8, unpacked.T), 10)}
    del unpacked
    log("library product only: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items())
        + " (torch.matmul bf16; torch._int_mm int8, int4 over unpacked rows)")
    return out


def instance_floors(q, rows, q8, view8, log=print) -> dict:
    """The bf16 and int8 probes at FLOOR_TILE, rawmax, at each k1 of
    SCAN_K1 where kernels A and C take another instance than at k1 = 16
    (64 queries a block past K1_WIDE), so that each scan's selection share
    is read over the floor of the blocks it ran."""
    b, d = q.shape
    n = rows.shape[0]
    out = {}
    for kind, qq, rr, row_bytes in (("bf16", q, rows, 2 * d),
                                    ("int8", q8, view8.values, d)):
        for k1 in SCAN_K1:
            if scan.wg_block_queries(b, k1) == scan.wg_block_queries(b, 16):
                continue
            ms = cuda_ms(lambda: score_probe(qq, rr, tile=FLOOR_TILE, k1=k1),
                         10, warmup=2)
            bnd = probe_bound(n, d, b, FLOOR_TILE, row_bytes, kind)
            out[f"{kind}_rawmax_t{FLOOR_TILE}_k{k1}"] = {
                "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "bound_share": bnd[0] / ms}
            log(f"probe {kind} rawmax tile={FLOOR_TILE} B={b} N={n} d={d} "
                f"as its scan at k1={k1} ({scan.wg_block_queries(b, k1)} "
                f"queries a block): {ms:.4f} ms, bound {bnd[0]:.4f} ms")
    return out


def selection_shares(floors: dict, scans: dict) -> list[dict]:
    """For each scan and k1: its floor (the probe of its type at
    FLOOR_TILE, rawmax; for A and C at the instance it ran), the selection
    share (scan - probe) / scan, and the probe's share of its bound (bound
    / probe)."""
    out = []
    for name, kind in SCANS:
        for k1 in SCAN_K1:
            floor = floors.get(f"{kind}_rawmax_t{FLOOR_TILE}_k{k1}",
                               floors[f"{kind}_rawmax_t{FLOOR_TILE}"])
            s = scans[f"{name}_k{k1}"]
            out.append({"scan": name, "k1": k1, "scan_ms": s["ms"],
                        "scan_bound_ms": s["bound_ms"],
                        "probe_ms": floor["ms"],
                        "probe_bound_ms": floor["bound_ms"],
                        "selection_share": (s["ms"] - floor["ms"]) / s["ms"],
                        "probe_bound_share": floor["bound_share"]})
    return out


def batch_sweep(q, rows, valid, view8, log=print) -> dict:
    """Script 6's sweep: `binned_topk` (kernels A + B + rescore) by batch;
    beside it kernels A and C alone at k1 = 16, each with its floor (the
    bf16 and int8 probes at FLOOR_TILE), at each batch."""
    out = {"binned_topk": {}, "A": {}, "A_floor": {}, "C": {}, "C_floor": {}}
    for b in BATCH_SWEEP:
        qb = q[:b].contiguous()
        q8, qs8 = quant.quantize_rows_device(qb)
        out["binned_topk"][b] = cuda_ms(
            lambda: scan.binned_topk(qb, rows, valid, K), 5)
        out["A"][b] = cuda_ms(lambda: scan.scan_blocks(qb, rows, valid, 16),
                              10)
        out["A_floor"][b] = cuda_ms(lambda: score_probe(
            qb, rows, tile=FLOOR_TILE), 10)
        out["C"][b] = cuda_ms(lambda: scan.scan_blocks_int8(
            q8, qs8, view8.values, view8.scales, valid, 16), 10)
        out["C_floor"][b] = cuda_ms(lambda: score_probe(
            q8, view8.values, tile=FLOOR_TILE), 10)
    for name, by_b in out.items():
        log(f"{name} by batch: " + ", ".join(
            f"B={b} {ms:.4f} ms" for b, ms in by_b.items()))
    return out


def trace_plans(store, q, trace_dir: str, log=print) -> dict:
    """`summarize_device_trace` of four back-to-back `search_device` calls
    of each plan of TRACED_PLANS (forced), after one call outside."""
    out = {}
    for plan in TRACED_PLANS:
        store.search_device(q, K, method=plan)
        where = os.path.join(trace_dir, plan)
        with device_trace(where):
            for _ in range(4):
                store.search_device(q, K, method=plan)
        summ = summarize_device_trace(where, device_filter="GPU", top=6)
        out[plan] = summ
        if "error" in summ:
            log(f"trace {plan}: {summ['error']}")
            continue
        log(f"trace {plan} (4 calls, B={q.shape[0]}): device busy "
            f"{summ['total_ms']:.3f} ms; " + "; ".join(
                f"{name[:60]} {ms:.3f} ms ({fr:.1%})"
                for name, ms, fr in summ["ops"]))
    return out


def dissect(store, q: torch.Tensor, trace_dir: str, log=print) -> dict:
    """The whole 1M dissection on a bf16 store and its int8 and int4 views
    (built here if the store has none yet); q are normalized f32 queries."""
    rows, valid = store.device_arrays
    view8, view4 = store._quant_view(), store._int4_view()
    q = q.to(torch.float32).contiguous()
    q8, qs8 = quant.quantize_rows_device(q)
    floors = probe_floors(q, rows, q8, view8, view4, log)
    scans = scan_times(q, rows, valid, q8, qs8, view8, view4, log)
    report = {"probes": floors, "scans": scans,
              "library": library_products(q, rows, q8, view8, view4, log),
              "shares": selection_shares(
                  {**floors, **instance_floors(q, rows, q8, view8, log)},
                  scans),
              "batch_sweep": batch_sweep(q, rows, valid, view8, log),
              "traces": trace_plans(store, q, trace_dir, log)}
    for r in report["shares"]:
        log(f"kernel {r['scan']} k1={r['k1']}: {r['scan_ms']:.4f} ms against "
            f"its floor {r['probe_ms']:.4f} ms: selection "
            f"{r['selection_share']:.1%} of the scan; the floor at "
            f"{r['probe_bound_share']:.1%} of its bound "
            f"{r['probe_bound_ms']:.4f} ms")
    return report


def capacity_probe(view4, q: torch.Tensor, log=print) -> dict:
    """The int4 probe at FLOOR_TILE over a packed-int4 view (corpus D:
    4,194,304 x 768 at B=1024), held to its plain version on the same
    inputs, beside its bound."""
    q8, _ = quant.quantize_rows_device(quant._l2n(q).contiguous())
    n, d, b = view4.n, q8.shape[1], q8.shape[0]
    where = f"int4 rawmax tile={FLOOR_TILE} B={b} N={n} d={d}"

    def probe():
        return score_probe(q8, view4.values, tile=FLOOR_TILE)

    check_probe(probe(), score_probe_plain(q8, view4.values, tile=FLOOR_TILE),
                "int4", "rawmax", FLOOR_TILE, where)
    ms = cuda_ms(probe, 3, warmup=0)
    bnd = probe_bound(n, d, b, FLOOR_TILE, d / 2, "int8")
    log(f"probe {where}: equal to plain; {ms:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}, {bnd[0] / ms:.1%})")
    return {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}


# ---- the corpora, and running it alone --------------------------------------


def cluster_centers(gen: torch.Generator, n: int = 1024, d: int = 768
                    ) -> torch.Tensor:
    """n unit-normal directions on the card (the bench's centers)."""
    return l2_normalize_t(torch.randn(n, d, device="cuda", generator=gen))


def cluster_rows(centers: torch.Tensor, n: int, gen: torch.Generator,
                 spread: float = 0.35) -> torch.Tensor:
    """Rows around bf16 cluster centers with Gaussian spread, normalized
    (the bench's `gen_block`; spread 0.35 is corpus A)."""
    assign = torch.randint(0, centers.shape[0], (n,), device=centers.device,
                           generator=gen)
    base = centers.to(torch.bfloat16).to(torch.float32)[assign]
    return l2_normalize_t(base + spread * torch.randn(
        n, centers.shape[1], device=centers.device, generator=gen))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", action="store_true",
                    help="also probe a 4,194,304 x 768 packed-int4 view at "
                         "B=1024")
    ap.add_argument("--trace-dir", default=str(
        Path(__file__).resolve().parents[2] / "build" / "dissect_traces"))
    args = ap.parse_args(argv)
    from lattice_tpu_torch.index.chunk_store import ChunkStore
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    centers = cluster_centers(gen)
    rows = torch.cat([cluster_rows(centers, min(1 << 16, args.rows - lo), gen)
                      .to(torch.bfloat16)
                      for lo in range(0, args.rows, 1 << 16)])
    store = ChunkStore.from_device_arrays(
        rows, torch.ones(args.rows, dtype=torch.bool, device="cuda"))
    q = cluster_rows(centers, args.batch, gen)
    report = {"device": smi,
              "dissect": dissect(store, q, args.trace_dir,
                                 lambda *a: print(*a, flush=True))}
    del store, rows
    torch.cuda.empty_cache()
    if args.capacity:
        n4, blk = 1 << 22, 1 << 17
        packed = torch.empty((n4, 384), dtype=torch.int8, device="cuda")
        scales = torch.empty((n4,), dtype=torch.float32, device="cuda")
        for lo in range(0, n4, blk):
            packed[lo:lo + blk], scales[lo:lo + blk] = \
                quant.quantize_rows_int4_device(
                    cluster_rows(centers, blk, gen).to(torch.bfloat16))
        report["capacity"] = capacity_probe(
            quant.Int4View.from_packed(packed, scales),
            cluster_rows(centers, 1024, gen))
    print(json.dumps(report, default=str), flush=True)
    return report


if __name__ == "__main__":
    main()
