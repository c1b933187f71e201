"""MCP server: JSON-RPC 2.0 over stdio (torch port).

Port of `lattice_tpu/mcp/server.py` (reference parity target:
`src/lattice/mcp/server.py:100-295`): hand-rolled JSON-RPC (initialize /
tools/list / tools/call / shutdown) with an asyncio stdin reader loop and
per-request error isolation. The tools (`mcp/tools.py`) run on the
port's engine on the device they are given: "cuda" by default, which
raises without CUDA when a tool first loads the index.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
from pathlib import Path

import torch

from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.mcp.tools import (TOOL_HANDLERS, TOOL_SCHEMAS,
                                         ToolContext)

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "lattice-tpu", "version": "0.1.0"}

PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INTERNAL_ERROR = -32603


class MCPServer:
    def __init__(self, repo_path: Path, settings: Settings,
                 device: str | torch.device = "cuda"):
        self.ctx = ToolContext(repo_path, settings, device)
        self._shutdown = asyncio.Event()

    # ---- request handling (reference `server.py:100-241`) --------------

    async def handle_request(self, request: dict) -> dict | None:
        rid = request.get("id")
        method = request.get("method")
        if method is None:
            return self._error(rid, INVALID_REQUEST, "missing method")
        try:
            if method == "initialize":
                return self._result(rid, {
                    "protocolVersion": PROTOCOL_VERSION,
                    "serverInfo": SERVER_INFO,
                    "capabilities": {"tools": {}},
                })
            if method in ("notifications/initialized", "initialized"):
                return None  # notification, no response
            if method == "tools/list":
                return self._result(rid, {"tools": TOOL_SCHEMAS})
            if method == "tools/call":
                return await self._handle_call_tool(rid, request.get("params") or {})
            if method == "shutdown":
                self._shutdown.set()
                return self._result(rid, {})
            if method == "ping":
                return self._result(rid, {})
            return self._error(rid, METHOD_NOT_FOUND, f"unknown method {method}")
        except Exception as exc:
            logger.exception("request failed")
            return self._error(rid, INTERNAL_ERROR, str(exc))

    async def _handle_call_tool(self, rid, params: dict) -> dict:
        name = params.get("name")
        handler = TOOL_HANDLERS.get(name)
        if handler is None:
            return self._error(rid, METHOD_NOT_FOUND, f"unknown tool {name}")
        args = params.get("arguments") or {}
        try:
            payload = await handler(self.ctx, args)
        except Exception as exc:
            logger.exception("tool %s failed", name)
            payload = {"error": str(exc)}
        return self._result(rid, {
            "content": [{"type": "text", "text": json.dumps(payload, indent=1)}],
            "isError": "error" in payload,
        })

    @staticmethod
    def _result(rid, result: dict) -> dict:
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    @staticmethod
    def _error(rid, code: int, message: str) -> dict:
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": code, "message": message}}

    # ---- stdio loop (reference `server.py:259-295`) ---------------------

    async def run_stdio(self) -> int:
        loop = asyncio.get_running_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
        while not self._shutdown.is_set():
            try:
                line = await reader.readline()
            except (EOFError, ConnectionResetError):
                break
            if not line:
                break
            text = line.decode("utf-8").strip()
            if not text:
                continue
            try:
                request = json.loads(text)
            except json.JSONDecodeError:
                response = self._error(None, PARSE_ERROR, "invalid JSON")
                self._write(response)
                continue
            response = await self.handle_request(request)
            if response is not None:
                self._write(response)
        return 0

    @staticmethod
    def _write(response: dict) -> None:
        sys.stdout.write(json.dumps(response) + "\n")
        sys.stdout.flush()


async def run_stdio_server(repo_path: Path, settings: Settings,
                           device: str | torch.device = "cuda") -> int:
    server = MCPServer(repo_path, settings, device)
    return await server.run_stdio()
