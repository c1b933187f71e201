"""The port's MCP server: JSON-RPC dispatch, the five tools, the stdio
transport; and the same requests through both packages.

Mirror of `tests/test_subsystems.py`'s `TestMCPServer`, `TestMCPIndexTool`
and `TestMCPStdioTransport` against `lattice_tpu_torch.mcp` on the CPU
(`device="cpu"`; the stdio test spawns `python -m lattice_tpu_torch.main
--device cpu mcp`). Then the port against the JAX package: each package
indexes and saves its own copy of the golden fixture, and both
`MCPServer.handle_request` give the same tool schemas and the same tool
results (every field but the phase timings).
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.providers.hash_provider import HashEmbedder

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "fixtures" / "golden_project"


@pytest.fixture()
def workspace(tmp_path, sample_project_path):
    root = tmp_path / "proj"
    shutil.copytree(sample_project_path, root)
    return root


def _settings(dims=128, metadata=False):
    settings = Settings()
    settings.ai.embedding_provider = "hash"
    settings.ai.embedding_dimensions = dims
    settings.metadata.enabled = metadata
    return settings


def _call(server, method, params=None, rid=1):
    return asyncio.run(server.handle_request(
        {"jsonrpc": "2.0", "id": rid, "method": method,
         "params": params or {}}))


def _tool(server, name, arguments, rid=1):
    resp = _call(server, "tools/call", {"name": name,
                                        "arguments": arguments}, rid)
    return resp, json.loads(resp["result"]["content"][0]["text"])


class TestMCPServer:
    @pytest.fixture()
    def server(self, workspace):
        from lattice_tpu_torch.mcp.server import MCPServer
        from lattice_tpu_torch.storage import persistence
        settings = _settings()
        ctx = asyncio.run(PipelineOrchestrator(
            workspace, Embedder(HashEmbedder(dimensions=128)),
            project_name="ws", settings=settings, device="cpu").run())
        persistence.save_index(
            workspace / ".lattice", ctx.graph_builder.store, ctx.indexer,
            project="ws", provider="hash", file_hashes={})
        return MCPServer(workspace, settings, device="cpu")

    def test_initialize_and_list(self, server):
        resp = _call(server, "initialize")
        assert resp["result"]["serverInfo"]["name"] == "lattice-tpu"
        resp = _call(server, "tools/list")
        names = [t["name"] for t in resp["result"]["tools"]]
        assert names == ["index_repository", "query_code_graph",
                         "get_code_snippet", "semantic_search",
                         "deep_search_batch"]

    def test_semantic_search_tool(self, server):
        _, payload = _tool(server, "semantic_search",
                           {"query": "validate email format", "limit": 5})
        assert payload["results"]
        assert any("validate" in r["name"] for r in payload["results"])

    def test_query_tool(self, server):
        _, payload = _tool(server, "query_code_graph",
                           {"question": "who calls validate_email_format?"})
        assert payload["intent"] == "find_usage"
        assert payload["answer"]

    def test_snippet_tool_and_guard(self, server):
        _, payload = _tool(server, "get_code_snippet",
                           {"entity": "UserService"})
        assert "class UserService" in payload["code"]
        _, payload = _tool(server, "get_code_snippet",
                           {"entity": "DoesNotExist"})
        assert "error" in payload

    def test_deep_search_batch_tool(self, server):
        _, payload = _tool(server, "deep_search_batch", {"questions": [
            "who calls validate_email_format?",
            "email address format check"], "limit": 5})
        assert len(payload["answers"]) == 2
        assert payload["answers"][0]["intent"] == "find_usage"
        for ans in payload["answers"]:
            assert ans["results"]
            names = " ".join(r["name"] for r in ans["results"])
            assert "validate" in names or "UserService" in names

    def test_unknown_method(self, server):
        resp = _call(server, "nope/nope")
        assert resp["error"]["code"] == -32601

    def test_engine_loads_on_the_servers_device(self, server):
        engine = server.ctx.engine()
        assert engine.indexer.code.device.type == "cpu"
        assert server.ctx.engine() is engine


class TestMCPIndexTool:
    def test_index_repository_tool(self, workspace):
        from lattice_tpu_torch.mcp.server import MCPServer
        server = MCPServer(workspace, _settings(dims=64), device="cpu")
        _, payload = _tool(server, "index_repository",
                           {"path": str(workspace), "project": "mcp-idx"},
                           rid=7)
        assert payload["project"] == "mcp-idx"
        assert payload["nodes"] > 20
        assert payload["chunks"] > 10
        assert (workspace / ".lattice" / "manifest.json").is_file()
        _, payload = _tool(server, "semantic_search",
                           {"query": "validate email"}, rid=8)
        assert payload["results"]

    def test_index_bad_path_errors(self, workspace):
        from lattice_tpu_torch.mcp.server import MCPServer
        server = MCPServer(workspace, _settings(), device="cpu")
        resp, _ = _tool(server, "index_repository",
                        {"path": "/nonexistent/nope"}, rid=9)
        assert resp["result"]["isError"]

    def test_cuda_default_tools_error_without_cuda(self, workspace,
                                                   monkeypatch):
        """The context's default device is "cuda": without CUDA a tool
        that loads the index answers an error payload, not a CPU index."""
        import torch

        from lattice_tpu_torch.mcp.server import MCPServer
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        server = MCPServer(workspace, _settings())
        assert server.ctx.device == "cuda"
        resp, payload = _tool(server, "index_repository",
                              {"path": str(workspace)})
        assert resp["result"]["isError"] and "CUDA" in payload["error"]


class TestMCPStdioTransport:
    """The real transport end to end: a `lattice mcp` process speaks
    newline-delimited JSON-RPC over stdin/stdout."""

    def test_stdio_initialize_list_call_shutdown(self, tmp_path):
        from lattice_tpu_torch import main as cli
        proj = tmp_path / "proj"
        shutil.copytree(GOLDEN, proj)
        env_file = tmp_path / "mcp.env"
        env_file.write_text("EMBEDDING_PROVIDER=hash\n"
                            "EMBEDDING_DIMENSIONS=64\n")
        env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
        cli.PROJECTS_REGISTRY, saved = (tmp_path / "registry.json",
                                        cli.PROJECTS_REGISTRY)
        try:
            assert cli.main(["--env", str(env_file), "--device", "cpu",
                             "index", str(proj)]) == 0
        finally:
            cli.PROJECTS_REGISTRY = saved
        reqs = "\n".join(json.dumps(r) for r in [
            {"jsonrpc": "2.0", "id": 1, "method": "initialize",
             "params": {}},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list",
             "params": {}},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
             "params": {"name": "semantic_search",
                        "arguments": {"query": "who calls fetchTasks",
                                      "limit": 3}}},
            {"jsonrpc": "2.0", "id": 4, "method": "shutdown",
             "params": {}},
        ]) + "\n"
        out = subprocess.run(
            [sys.executable, "-m", "lattice_tpu_torch.main", "--env",
             str(env_file), "--device", "cpu", "mcp", "--path", str(proj)],
            input=reqs, capture_output=True, text=True, timeout=240,
            env=env, cwd=str(REPO))
        lines = [json.loads(ln) for ln in out.stdout.splitlines()
                 if ln.strip().startswith("{")]
        by_id = {r.get("id"): r for r in lines}
        assert by_id[1]["result"]["serverInfo"]["name"] == "lattice-tpu"
        names = [t["name"] for t in by_id[2]["result"]["tools"]]
        assert "deep_search_batch" in names and len(names) == 5
        call = by_id[3]["result"]
        assert not call["isError"], call
        assert len(json.loads(call["content"][0]["text"])["results"]) == 3
        assert out.returncode == 0, out.stderr[-2000:]


# ---- the port against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """Each package indexes its own copy of the golden fixture (hash
    embedder, dim 256, metadata off) and saves it; an MCPServer of each
    over it (the port's on the CPU)."""
    from lattice_tpu.config.settings import Settings as JaxSettings
    from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
    from lattice_tpu.mcp.server import MCPServer as JaxMCPServer
    from lattice_tpu.pipeline.orchestrator import (
        PipelineOrchestrator as JaxOrchestrator)
    from lattice_tpu.providers.hash_provider import HashEmbedder as JaxHash
    from lattice_tpu.storage import persistence as jax_persistence
    from lattice_tpu_torch.mcp.server import MCPServer
    from lattice_tpu_torch.storage import persistence
    base = tmp_path_factory.mktemp("mcp_pair")
    out = []
    for name, settings_cls, orch_cls, emb, pers, server_cls, kw in (
            ("jax", JaxSettings, JaxOrchestrator,
             JaxEmbedder(JaxHash(dimensions=256)), jax_persistence,
             JaxMCPServer, {}),
            ("port", Settings, PipelineOrchestrator,
             Embedder(HashEmbedder(dimensions=256)), persistence,
             MCPServer, {"device": "cpu"})):
        root = base / name / "golden"
        shutil.copytree(GOLDEN, root)
        settings = settings_cls()
        settings.ai.embedding_provider = "hash"
        settings.ai.embedding_dimensions = 256
        settings.metadata.enabled = False
        ctx = asyncio.run(orch_cls(root, emb, project_name="golden",
                                   settings=settings, **kw).run())
        pers.save_index(root / ".lattice", ctx.graph_builder.store,
                        ctx.indexer, project="golden", provider="hash",
                        file_hashes={})
        out.append(server_cls(root, settings, **kw))
    return tuple(out)


def _without_times(payload):
    if isinstance(payload, dict):
        return {k: _without_times(v) for k, v in payload.items()
                if k != "phase_times_ms"}
    if isinstance(payload, list):
        return [_without_times(v) for v in payload]
    return payload


def test_tool_schemas_equal_jax(both_servers):
    jsrv, psrv = both_servers
    for method in ("initialize", "tools/list", "ping", "nope/nope"):
        assert _call(psrv, method) == _call(jsrv, method)


TOOL_CALLS = [
    ("semantic_search", {"query": "validate email format", "limit": 5}),
    ("semantic_search", {"query": "fetch tasks", "limit": 8,
                         "language": "typescript"}),
    ("query_code_graph", {"question": "who calls validate_email_format?"}),
    ("query_code_graph", {"question": "what does AdminUser extend?",
                          "limit": 5}),
    ("get_code_snippet", {"entity": "UserService", "context_lines": 2}),
    ("get_code_snippet", {"entity": "DoesNotExist"}),
    ("deep_search_batch", {"questions": [
        "who calls validate_email_format?", "email address format check",
        "how are tasks fetched"], "limit": 5}),
    ("deep_search_batch", {"questions": []}),
    ("nope", {}),
]


@pytest.mark.parametrize("name, arguments", TOOL_CALLS,
                         ids=[f"{i}-{c[0]}" for i, c in
                              enumerate(TOOL_CALLS)])
def test_tool_results_equal_jax(both_servers, name, arguments):
    jsrv, psrv = both_servers
    params = {"name": name, "arguments": arguments}
    got = _call(psrv, "tools/call", params)
    want = _call(jsrv, "tools/call", params)
    if "error" in want:
        assert got == want
        return
    assert got["result"]["isError"] == want["result"]["isError"]
    g = json.loads(got["result"]["content"][0]["text"])
    w = json.loads(want["result"]["content"][0]["text"])
    assert _without_times(g) == _without_times(w)
