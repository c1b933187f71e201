"""lattice CLI, on the port.

A copy of `lattice_tpu/main.py`: argparse subcommands `index / search /
query / status / settings / projects / metadata / watch / serve / mcp`
with progress display, verbose query plan, and the search result table.
Rendering uses `rich` when it is installed and stderr is a terminal, and
plain lines otherwise.

The differences from the reference:
- the device is chosen by name: `--device` (a top-level option) goes to
  the provider factory, the orchestrator and `load_index`. Without it,
  `LATTICE_PLATFORM=cpu` selects "cpu", else the device is "cuda", which
  raises without CUDA: `main` prints `error: ...` and returns 1, and
  nothing is written.
- no XLA compilation cache: the port compiles its kernels once into
  `build/lattice_tpu_torch/`.
- `settings` dumps the dataclass settings (`dataclasses.asdict`) in the
  JSON layout of the reference's `model_dump_json(indent=1)`.
- `serve` prints its address line with a flush, so a process reading its
  stdout through a pipe sees the bound port (`--port 0` picks a free one).
- `train` and `validate-weights` run on `--device` too: `train` fine-tunes
  there (the checkpoint is written with `np.savez`, uncompressed,
  `models/finetune.py`), `validate-weights` checks the checkpoint's
  encoder there. `main` returns 1 on `NotImplementedError`, which only
  a tensor-parallel model axis raises now.

    python -m lattice_tpu_torch.main --device cpu index tests/fixtures/golden_project
    python -m lattice_tpu_torch.main --device cpu search "who calls validate_email" --path ...
    python -m lattice_tpu_torch.main serve --path ... --port 0      # on the card
    python -m lattice_tpu_torch.main --device cpu mcp --path ...
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import shutil
import sys
import time
from pathlib import Path

from lattice_tpu_torch.config.settings import Settings, get_settings
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.providers.factory import (get_embedding_provider,
                                                 get_llm_provider)
from lattice_tpu_torch.storage import persistence

PROJECTS_REGISTRY = Path.home() / ".lattice_projects.json"


def _registry_load() -> dict[str, str]:
    if PROJECTS_REGISTRY.is_file():
        try:
            return json.loads(PROJECTS_REGISTRY.read_text())
        except json.JSONDecodeError:
            return {}
    return {}


def _registry_save(reg: dict[str, str]) -> None:
    PROJECTS_REGISTRY.write_text(json.dumps(reg, indent=1))


def _data_dir(repo_path: Path, settings: Settings) -> Path:
    return repo_path / settings.storage.data_dir


def resolve_device(requested: str | None, settings: Settings) -> str:
    """`--device` if given; else "cpu" when `LATTICE_PLATFORM=cpu` asks
    for it by name; else "cuda"."""
    if requested:
        return requested
    return "cpu" if settings.device.platform == "cpu" else "cuda"


def _make_embedder(settings: Settings, device: str,
                   repo_path: Path | None = None) -> Embedder:
    # a `lattice train` checkpoint in the project data dir is picked up
    # automatically by the unixcoder provider
    finetune_dir = _data_dir(repo_path, settings) if repo_path else None
    provider = get_embedding_provider(settings.ai, finetune_dir=finetune_dir,
                                      device=device)
    return Embedder(provider, batch_size=settings.indexing.embed_batch_size)


def _load_engine(repo_path: Path, settings: Settings, device: str):
    from lattice_tpu_torch.query.engine import QueryEngine
    embedder = _make_embedder(settings, device, repo_path)
    graph, indexer, manifest = persistence.load_index(
        _data_dir(repo_path, settings), embedder, device=device)
    llm = get_llm_provider(settings.ai)
    return QueryEngine(graph, indexer, llm, settings.query), manifest


# ---- commands -----------------------------------------------------------


def run_index(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:144-224`."""
    from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator

    repo_path = Path(args.path).resolve()
    if not repo_path.is_dir():
        print(f"error: {repo_path} is not a directory", file=sys.stderr)
        return 2
    embedder = _make_embedder(settings, args.device, repo_path)
    project = args.project or repo_path.name
    t0 = time.time()

    # rich progress bar when available (reference `main.py:180-214`),
    # plain-line fallback otherwise.
    rich_progress = None
    rich_task = None
    try:
        if sys.stderr.isatty():
            from rich.progress import (
                BarColumn,
                Progress,
                TaskProgressColumn,
                TextColumn,
                TimeElapsedColumn,
            )
            rich_progress = Progress(
                TextColumn("[bold blue]{task.fields[stage]}"),
                BarColumn(), TaskProgressColumn(), TimeElapsedColumn(),
                TextColumn("{task.fields[detail]}"),
            )
            rich_task = rich_progress.add_task(
                "index", total=100.0, stage="scanning", detail="")
    except ImportError:
        rich_progress = None

    last_pct = -5.0

    def on_progress(snapshot) -> None:
        nonlocal last_pct
        detail = (f"{snapshot.files_parsed} parsed · "
                  f"{snapshot.graph_nodes} nodes · "
                  f"{snapshot.chunks_indexed} chunks")
        if rich_progress is not None:
            rich_progress.update(rich_task, completed=snapshot.overall_pct,
                                 stage=snapshot.stage.value, detail=detail)
            return
        if snapshot.overall_pct - last_pct >= 5.0 or snapshot.overall_pct >= 100:
            last_pct = snapshot.overall_pct
            print(f"[{snapshot.overall_pct:5.1f}%] {snapshot.stage.value}: "
                  f"{detail}", flush=True)

    orchestrator = PipelineOrchestrator(
        repo_path, embedder, project_name=project, settings=settings,
        progress_callback=on_progress, force=args.force, device=args.device)
    if rich_progress is not None:
        with rich_progress:
            ctx = asyncio.run(orchestrator.run())
    else:
        ctx = asyncio.run(orchestrator.run())
    store = ctx.graph_builder.store
    persistence.save_index(
        _data_dir(repo_path, settings), store, ctx.indexer,
        project=project, provider=settings.ai.embedding_provider,
        file_hashes={f.relative_path: f.content_hash for f in ctx.files})
    reg = _registry_load()
    reg[project] = str(repo_path)
    _registry_save(reg)
    gstats = store.stats
    print(f"indexed {project}: {gstats['nodes']} nodes, "
          f"{sum(gstats['edges'].values())} edges, "
          f"{len(ctx.indexer.code)} chunks in {time.time() - t0:.1f}s")
    if ctx.errors:
        print(f"{len(ctx.errors)} file errors (first 5):")
        for err in ctx.errors[:5]:
            print(f"  {err}")
    return 0


def run_search(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:647-686` (+ the batched --batch-file)."""
    from lattice_tpu_torch.query.ranking.utils import (
        ranked_results_to_search_results,
    )
    repo_path = Path(args.path).resolve()
    engine, _ = _load_engine(repo_path, settings, args.device)
    if getattr(args, "batch_file", None):
        try:
            raw = (sys.stdin.read() if args.batch_file == "-"
                   else Path(args.batch_file).read_text())
        except OSError as exc:
            print(f"cannot read batch file {args.batch_file}: {exc}")
            return 1
        queries = [ln.strip() for ln in raw.splitlines() if ln.strip()]
        if not queries:
            print("no queries in batch file")
            return 1
        batch = engine.deep_search_batch(queries, limit=args.limit)
        if args.json:
            print(json.dumps([
                {"query": r.query,
                 "intent": r.query_plan.intent.value,
                 "results": ranked_results_to_search_results(r.results)}
                for r in batch], indent=1))
            return 0
        for r in batch:
            print(f"== {r.query}  (intent: {r.query_plan.intent.value})")
            for i, h in enumerate(r.results, 1):
                print(f"  {i:2}. [{h.score:6.3f}] "
                      f"{h.qualified_name or h.name} "
                      f"({h.entity_type}, {h.source.value}) "
                      f"{h.file_path}:{h.start_line}")
        return 0
    if args.query is None:
        print("a query is required (or --batch-file)")
        return 1
    if getattr(args, "deep", False):
        result = engine.deep_search(args.query, limit=args.limit)
    else:
        result = engine.search_sync(args.query, limit=args.limit)
    if args.json:
        print(json.dumps(ranked_results_to_search_results(result.results),
                         indent=1))
        return 0
    if not result.results:
        print("no results")
        return 0
    print(f"intent: {result.query_plan.intent.value}  "
          f"entities: {result.query_plan.entity_names}")
    for i, r in enumerate(result.results, 1):
        loc = f"{r.file_path}:{r.start_line}"
        print(f"{i:2}. [{r.score:6.3f}] {r.qualified_name or r.name} "
              f"({r.entity_type}, {r.source.value}) {loc}")
    if args.verbose:
        print("phase times:", {k: round(v, 1)
                               for k, v in result.phase_times_ms.items()})
    return 0


def run_query(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:584-645`."""
    repo_path = Path(args.path).resolve()
    engine, _ = _load_engine(repo_path, settings, args.device)
    result = engine.query_sync(args.question, limit=args.limit)
    if args.verbose:
        plan = result.query_plan
        print(f"--- plan: intent={plan.intent.value} source={plan.source} "
              f"entities={plan.entity_names} multi_hop={plan.multi_hop} ---")
        print("phase times:", {k: round(v, 1)
                               for k, v in result.phase_times_ms.items()})
        print("---")
    print(result.answer)
    if result.results:
        print("\nsources:")
        for r in result.results[:5]:
            print(f"  {r.file_path}:{r.start_line} "
                  f"({r.qualified_name or r.name})")
    return 0


def run_status(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:688-724`."""
    repo_path = Path(args.path).resolve()
    data_dir = _data_dir(repo_path, settings)
    manifest = persistence.read_manifest(data_dir)
    if manifest is None:
        print(f"no index at {data_dir}")
        return 1
    engine, manifest = _load_engine(repo_path, settings, args.device)
    stats = engine.get_statistics()
    print(f"project: {manifest['project']}")
    print(f"provider: {manifest['provider']} ({manifest['dims']}d, "
          f"{manifest['dtype']})")
    print(f"files indexed: {len(manifest['file_hashes'])}")
    print(f"graph: {stats['graph']['nodes']} nodes, "
          f"edges={stats['graph']['edges']}")
    print(f"vectors: code={stats['vector']['code']['points']}, "
          f"summaries={stats['vector']['summaries']['points']}")
    return 0


def run_settings(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:726-794`."""
    print(json.dumps(dataclasses.asdict(settings), indent=1))
    return 0


def run_projects(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:458-581`."""
    reg = _registry_load()
    if args.projects_cmd == "list":
        if not reg:
            print("no indexed projects")
            return 0
        for name, path in sorted(reg.items()):
            manifest = persistence.read_manifest(
                _data_dir(Path(path), settings))
            n = len(manifest["file_hashes"]) if manifest else 0
            print(f"{name:30} {path} ({n} files)")
        return 0
    if args.projects_cmd == "show":
        path = reg.get(args.name)
        if path is None:
            print(f"unknown project {args.name}", file=sys.stderr)
            return 1
        manifest = persistence.read_manifest(_data_dir(Path(path), settings))
        print(json.dumps({**(manifest or {}), "file_hashes":
                          len((manifest or {}).get("file_hashes", {}))}, indent=1))
        return 0
    if args.projects_cmd == "delete":
        path = reg.pop(args.name, None)
        if path is None:
            print(f"unknown project {args.name}", file=sys.stderr)
            return 1
        data_dir = _data_dir(Path(path), settings)
        if data_dir.is_dir():
            shutil.rmtree(data_dir)
        _registry_save(reg)
        print(f"deleted index for {args.name}")
        return 0
    return 2


def run_metadata(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:226-456`."""
    from lattice_tpu_torch.metadata.generator import MetadataGenerator
    from lattice_tpu_torch.metadata.repository import MetadataRepository

    repo_path = Path(args.path).resolve()
    repo = MetadataRepository(_data_dir(repo_path, settings))
    if args.metadata_cmd == "show":
        meta = repo.get_latest(args.project or repo_path.name)
        if meta is None:
            print("no metadata; run `lattice metadata regenerate`")
            return 1
        print(json.dumps(meta, indent=1))
        return 0
    if args.metadata_cmd == "regenerate":
        generator = MetadataGenerator(
            repo_path, project_name=args.project or repo_path.name,
            repository=repo, llm=get_llm_provider(settings.ai))
        meta = asyncio.run(generator.generate_all())
        print(json.dumps({k: v for k, v in meta.items()
                          if k != "folder_structure"}, indent=1)[:2000])
        return 0
    return 2


def run_train(args: argparse.Namespace, settings: Settings) -> int:
    """Fine-tune UniXcoder on (NL, code) pairs mined from the saved index
    (reference `main.py:319-337`), on `--device`. The checkpoint lands in
    the index's data dir, where the next command's provider loads it."""
    from lattice_tpu_torch.models.finetune import finetune_from_index

    repo_path = Path(args.path).resolve()
    embedder = _make_embedder(settings, args.device)
    _graph, indexer, _manifest = persistence.load_index(
        _data_dir(repo_path, settings), embedder, device=args.device)

    def on_progress(step, total, loss):
        if step % 10 == 0 or step == total:
            print(f"step {step}/{total} loss={loss:.4f}", flush=True)

    report = finetune_from_index(
        indexer.code, indexer.summaries,
        data_dir=_data_dir(repo_path, settings),
        steps=args.steps, batch_size=args.batch_size,
        learning_rate=args.lr, progress=on_progress, device=args.device)
    print(json.dumps(report, indent=1))
    return 0 if report["status"] in ("completed", "skipped") else 1


def run_watch(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:105-109` + watcher (`pipeline/watcher.py`)."""
    from lattice_tpu_torch.pipeline.watcher import watch_repository
    repo_path = Path(args.path).resolve()
    return asyncio.run(watch_repository(repo_path, settings,
                                        device=args.device))


def run_serve(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:348-389`. HTTP serving over the loaded index:
    concurrent requests coalesce into batched device calls
    (`serving/http.py`). SIGTERM drains in-flight work and exits 0."""
    from lattice_tpu_torch.serving.http import ServingHTTPServer
    repo_path = Path(args.path).resolve()
    engine, _ = _load_engine(repo_path, settings, args.device)
    if args.warmup:
        print("warming pad buckets in the background; /healthz reports "
              "warm=true when done", flush=True)
    server = ServingHTTPServer(
        engine.indexer.code, engine.vector_searcher.embedder.embed,
        embed_batch_fn=engine.vector_searcher.embedder.embed_batch,
        engine=engine, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, max_configs=args.max_configs,
        warmup=args.warmup)
    host, port = server.address
    print(f"serving {len(engine.indexer.code)} chunks on "
          f"http://{host}:{port} (POST /v1/search, /v1/search_batch, "
          f"/v1/query; GET /healthz, /v1/stats, /metrics)", flush=True)

    # orchestrators stop containers with SIGTERM; drain in-flight work
    # instead of dying mid-batch. The handler only raises — shutdown()
    # from inside a signal handler would deadlock serve_forever's poll
    # loop (it waits for the very loop the handler interrupted).
    import signal

    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt
    prev = signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        server.shutdown()
    finally:
        signal.signal(signal.SIGTERM, prev)
    return 0


def run_mcp(args: argparse.Namespace, settings: Settings) -> int:
    """Reference: `main.py:594-596`. The MCP JSON-RPC server over stdio;
    its tools load the index on the CLI's device, which is checked before
    the server starts (the tools load lazily, at their first call)."""
    from lattice_tpu_torch.index.chunk_store import _device
    from lattice_tpu_torch.mcp.server import run_stdio_server
    _device(args.device)  # the stores' rule: "cuda" without CUDA raises
    return asyncio.run(run_stdio_server(Path(args.path).resolve(), settings,
                                        args.device))


def run_validate_weights(args: argparse.Namespace,
                         settings: Settings) -> int:
    """One-command real-checkpoint validation (reference `main.py:391-398`)
    on `--device`: mount the weights, run `lattice validate-weights
    <dir>`."""
    from lattice_tpu_torch.models.validate_weights import validate_weights

    report = validate_weights(args.weights_dir, atol=args.atol,
                              device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


# ---- entry --------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lattice",
        description="Hybrid code retrieval (graph + vector) on PyTorch")
    parser.add_argument("--env", default=".env", help="env file for settings")
    parser.add_argument("--device", default=None,
                        help="device of the stores and the encoder (default "
                             "cuda; cpu when LATTICE_PLATFORM=cpu)")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="index a repository")
    p.add_argument("path")
    p.add_argument("--project")
    p.add_argument("--force", action="store_true",
                   help="re-embed unchanged files")

    p = sub.add_parser("search", help="retrieval without synthesis")
    p.add_argument("query", nargs="?", default=None)
    p.add_argument("--path", default=".")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--deep", action="store_true",
                   help="corpus-wide device-fused ranking (every chunk)")
    p.add_argument("--batch-file", default=None, metavar="FILE",
                   help="newline-separated queries ranked corpus-wide in "
                        "one batched device call (implies --deep; '-' "
                        "reads stdin)")
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("query", help="ask a question about the code")
    p.add_argument("question")
    p.add_argument("--path", default=".")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("status", help="index statistics")
    p.add_argument("--path", default=".")

    sub.add_parser("settings", help="dump effective settings")

    p = sub.add_parser("projects", help="manage indexed projects")
    psub = p.add_subparsers(dest="projects_cmd", required=True)
    psub.add_parser("list")
    pp = psub.add_parser("show")
    pp.add_argument("name")
    pp = psub.add_parser("delete")
    pp.add_argument("name")

    p = sub.add_parser("metadata", help="project metadata")
    msub = p.add_subparsers(dest="metadata_cmd", required=True)
    for mc in ("show", "regenerate"):
        mp = msub.add_parser(mc)
        mp.add_argument("--path", default=".")
        mp.add_argument("--project")

    p = sub.add_parser("train", help="contrastively fine-tune the embedder "
                                     "on pairs mined from the index")
    p.add_argument("--path", default=".")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-5)

    p = sub.add_parser("watch", help="watch a repo and reindex on change")
    p.add_argument("path")

    p = sub.add_parser("mcp", help="run the MCP stdio server")
    p.add_argument("--path", default=".")

    p = sub.add_parser("serve", help="HTTP serving: concurrent clients "
                                     "coalesce into batched device calls")
    p.add_argument("--path", default=".")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8463)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=None,
                   help="shed load (HTTP 429) past this queue depth")
    p.add_argument("--max-configs", type=int, default=8,
                   help="distinct (filters, method) frontends kept live")
    p.add_argument("--warmup", action="store_true",
                   help="precompile the default config's pad-bucket shapes "
                        "on a background thread (healthz reports warm=true "
                        "when done)")

    p = sub.add_parser("validate-weights",
                       help="validate a local UniXcoder/RoBERTa checkpoint "
                            "dir: weight mapping, full-config parity, "
                            "real-BPE vs approx tokens, embedding probe")
    p.add_argument("weights_dir")
    p.add_argument("--atol", type=float, default=5e-3)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    settings = Settings.from_env(args.env) if args.env != ".env" else get_settings()
    args.device = resolve_device(args.device, settings)
    # propagate top-level verbose to subcommands that support it
    if not hasattr(args, "verbose"):
        args.verbose = False
    handlers = {
        "index": run_index,
        "search": run_search,
        "query": run_query,
        "status": run_status,
        "settings": run_settings,
        "projects": run_projects,
        "metadata": run_metadata,
        "train": run_train,
        "watch": run_watch,
        "serve": run_serve,
        "mcp": run_mcp,
        "validate-weights": run_validate_weights,
    }
    from lattice_tpu_torch.core.errors import LatticeError
    try:
        return handlers[args.cmd](args, settings)
    except (LatticeError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
