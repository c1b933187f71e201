"""Labeled retrieval-quality eval over the golden corpus (torch port).

Port of `lattice_tpu/query/golden_eval.py`. It scores the engine against
a labeled query -> expected-qualified-names set
(`tests/fixtures/golden_eval.jsonl`; the graph-relation expectations —
callers/callees/ancestors/descendants/methods — are derived from the
indexed golden graph and frozen):

- ``hit@5`` / ``hit@10``: fraction of queries whose top-5/10 results
  contain ANY expected qualified name.
- ``MRR@10``: mean reciprocal rank of the first expected hit.

`build_golden_engine` indexes a copy of the golden fixture through the
port's `PipelineOrchestrator` on an explicit device (`"cuda"` by
default, which raises without CUDA). On the CPU, where the stores serve
the plan "flat", the eval gives the reference's numbers: n 104, mrr
0.9148, hit@5 0.9904, hit@10 1.0, search mrr 0.92, deep mrr 0.875, no
misses. On the card the stores serve "quantized", whose rescore scores
the f32 query where "flat" rounds it to bf16: there it gives mrr 0.9164
(search 0.9218, the rest equal), as the JAX package does on that plan.

    python -m lattice_tpu_torch.query.golden_eval [--device D] [--misses]

prints one JSON line, with the reference's timing of its HTTP deep-batch
surface (`http_deep_batch_ms_per_q`, `http_deep_batch_n`): 16 deep
questions in one `/v1/deep_search_batch` round trip through the port's
`ServingHTTPServer`, after one warm round trip. A kernel error, a CUDA
out-of-memory or a path not ported (`core.errors.DEVICE_ERRORS`) raises;
any other failure of that surface becomes `http_deep_batch_error`, as in
the reference.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import tempfile
from pathlib import Path

from lattice_tpu_torch.core.errors import DEVICE_ERRORS

# repo-root/tests/fixtures — the eval set lives next to the corpus it
# labels so editing one forces thinking about the other
_REPO_ROOT = Path(__file__).resolve().parents[2]
CASES_PATH = _REPO_ROOT / "tests" / "fixtures" / "golden_eval.jsonl"
FIXTURE_PATH = _REPO_ROOT / "tests" / "fixtures" / "golden_project"


def load_cases(path: str | Path | None = None) -> list[dict]:
    p = Path(path) if path is not None else CASES_PATH
    cases = []
    with open(p, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                cases.append(json.loads(line))
    return cases


def _rank_of_first_hit(results, expect: set[str], k: int) -> int | None:
    """1-based rank of the first result whose qualified name is
    expected, or None if no hit in the top k."""
    for i, r in enumerate(results[:k]):
        if r.qualified_name in expect:
            return i + 1
    return None


def evaluate(engine, cases: list[dict], k: int = 10) -> dict:
    """Run every case through the engine path it names and score it.

    Each case: {"query": str, "expect": [qualified names...],
    "intent": str (documentation), "path": "search" | "deep"}.
    """
    n = 0
    rr_sum = 0.0
    hit5 = hit10 = 0
    per_path: dict[str, dict] = {}
    misses: list[dict] = []
    for case in cases:
        expect = set(case["expect"])
        path = case.get("path", "search")
        if path == "deep":
            result = engine.deep_search(case["query"], limit=k)
        else:
            result = engine.search_sync(case["query"], limit=k)
        rank = _rank_of_first_hit(result.results, expect, k)
        n += 1
        pp = per_path.setdefault(path, {"n": 0, "rr": 0.0, "hit5": 0})
        pp["n"] += 1
        if rank is not None:
            rr_sum += 1.0 / rank
            pp["rr"] += 1.0 / rank
            hit10 += 1
            if rank <= 5:
                hit5 += 1
                pp["hit5"] += 1
        else:
            misses.append({
                "query": case["query"],
                "intent": case.get("intent"),
                "path": path,
                "got": [r.qualified_name for r in result.results[:5]],
            })
    out = {
        "n": n,
        "mrr": round(rr_sum / max(n, 1), 4),
        "hit_at_5": round(hit5 / max(n, 1), 4),
        "hit_at_10": round(hit10 / max(n, 1), 4),
        "per_path": {
            p: {"n": v["n"], "mrr": round(v["rr"] / max(v["n"], 1), 4),
                "hit_at_5": round(v["hit5"] / max(v["n"], 1), 4)}
            for p, v in per_path.items()
        },
        "misses": misses,
    }
    return out


def build_golden_engine(fixture: str | Path | None = None,
                        dim: int = 256, work_dir: str | None = None,
                        device: str = "cuda"):
    """Index a throwaway copy of the golden fixture (hash embedder —
    the offline default) on `device` and return (engine, pipeline_ctx).
    The engine serves where its stores live."""
    from lattice_tpu_torch.config.settings import Settings
    from lattice_tpu_torch.embeddings.embedder import Embedder
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
    from lattice_tpu_torch.providers.hash_provider import HashEmbedder
    from lattice_tpu_torch.query.engine import QueryEngine

    src = Path(fixture) if fixture is not None else FIXTURE_PATH
    base = Path(work_dir) if work_dir else Path(tempfile.mkdtemp(
        prefix="golden_eval_"))
    tmp = base / "golden"
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(src, tmp)
    settings = Settings()
    settings.metadata.enabled = False
    orch = PipelineOrchestrator(tmp, Embedder(HashEmbedder(dimensions=dim)),
                                project_name="golden_eval",
                                settings=settings, device=device)
    ctx = asyncio.run(orch.run())
    if ctx.errors:
        raise RuntimeError(f"golden index failed: {ctx.errors[:3]}")
    return QueryEngine(ctx.graph_builder.store, ctx.indexer), ctx


def http_deep_batch(engine, cases: list[dict]) -> dict:
    """The deep-batch HTTP surface end to end (reference
    `golden_eval.py:162-193`): the first 16 deep questions in one
    `/v1/deep_search_batch` round trip, timed after a warm one. Returns
    {"http_deep_batch_ms_per_q", "http_deep_batch_n"}."""
    import time
    import urllib.request

    from lattice_tpu_torch.serving.http import ServingHTTPServer
    deep_qs = [c["query"] for c in cases if c["path"] == "deep"][:16]
    body = json.dumps({"queries": deep_qs, "limit": 10}).encode()
    with ServingHTTPServer(engine.indexer.code, engine=engine,
                           max_wait_ms=2) as srv:
        host, port = srv.address

        def post() -> dict:
            req = urllib.request.Request(
                f"http://{host}:{port}/v1/deep_search_batch", data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())
        post()  # warm
        t0 = time.perf_counter()
        out = post()
        ms = (time.perf_counter() - t0) * 1000.0 / len(deep_qs)
    return {"http_deep_batch_ms_per_q": round(ms, 2),
            "http_deep_batch_n": len(out["results"])}


def main(argv: list[str] | None = None) -> None:
    import argparse
    import time

    ap = argparse.ArgumentParser(
        prog="python -m lattice_tpu_torch.query.golden_eval",
        description="Golden-corpus retrieval eval through the port; "
                    "prints one JSON line.")
    ap.add_argument("--device", default="cuda",
                    help="device of the index and the engine (default cuda)")
    ap.add_argument("--misses", action="store_true",
                    help="keep the list of missed cases in the line")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    engine, _ctx = build_golden_engine(device=args.device)
    build_s = time.perf_counter() - t0
    cases = load_cases()
    t0 = time.perf_counter()
    scores = evaluate(engine, cases)
    scores["eval_s"] = round(time.perf_counter() - t0, 1)
    scores["build_s"] = round(build_s, 1)
    scores["device"] = args.device
    try:
        scores.update(http_deep_batch(engine, cases))
    except DEVICE_ERRORS:
        raise
    except Exception as exc:  # noqa: BLE001 — the eval line must print
        scores["http_deep_batch_error"] = repr(exc)[:120]
    scores["n_misses"] = len(scores["misses"])
    if not args.misses:
        scores.pop("misses")
    print(json.dumps(scores), flush=True)


if __name__ == "__main__":
    main()
