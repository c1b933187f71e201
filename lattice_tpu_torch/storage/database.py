"""Generic host metadata database client (a copy of
`lattice_tpu/storage/database.py`).

Parity target: reference `src/lattice/database/postgres.py:14-121`
(`PostgresClient`: asyncpg pool, execute/fetch/fetchrow/fetchval, lazy
connect, async context manager). Postgres is an external docker service in
the reference; host metadata here lives in SQLite, so this client keeps the
same surface over a process-local file. The async face mirrors the
reference's seam (callers `await` the same methods); SQLite calls run in a
worker thread so the event loop stays free.
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
from pathlib import Path
from typing import Any, Iterable

from lattice_tpu_torch.core.errors import StorageError


class LocalDatabase:
    def __init__(self, db_path: str | Path = ":memory:"):
        self.db_path = str(db_path)
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.Lock()

    # ---- lifecycle (reference `postgres.py:41-70`) ----------------------

    def _ensure(self) -> sqlite3.Connection:
        if self._conn is None:
            try:
                self._conn = sqlite3.connect(self.db_path,
                                             check_same_thread=False)
                self._conn.row_factory = sqlite3.Row
            except sqlite3.Error as exc:
                raise StorageError(f"cannot open {self.db_path}",
                                   cause=exc) from exc
        return self._conn

    async def connect(self) -> None:
        await asyncio.to_thread(self._ensure)

    async def close(self) -> None:
        def _close():
            if self._conn is not None:
                self._conn.close()
                self._conn = None
        await asyncio.to_thread(_close)

    async def __aenter__(self) -> "LocalDatabase":
        await self.connect()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # ---- queries (reference `postgres.py:72-121`) -----------------------

    def _run(self, sql: str, params: Iterable[Any]):
        conn = self._ensure()
        with self._lock:
            try:
                cur = conn.execute(sql, tuple(params))
                conn.commit()
                return cur
            except sqlite3.Error as exc:
                raise StorageError(f"query failed: {sql[:80]}",
                                   cause=exc) from exc

    async def execute(self, sql: str, *params: Any) -> int:
        cur = await asyncio.to_thread(self._run, sql, params)
        return cur.rowcount

    async def executescript(self, script: str) -> None:
        def _script():
            conn = self._ensure()
            with self._lock:
                conn.executescript(script)
                conn.commit()
        await asyncio.to_thread(_script)

    async def fetch(self, sql: str, *params: Any) -> list[dict]:
        cur = await asyncio.to_thread(self._run, sql, params)
        return [dict(row) for row in cur.fetchall()]

    async def fetchrow(self, sql: str, *params: Any) -> dict | None:
        cur = await asyncio.to_thread(self._run, sql, params)
        row = cur.fetchone()
        return dict(row) if row is not None else None

    async def fetchval(self, sql: str, *params: Any) -> Any:
        row = await self.fetchrow(sql, *params)
        if row is None:
            return None
        return next(iter(row.values()), None)

    async def health_check(self) -> bool:
        try:
            return await self.fetchval("SELECT 1") == 1
        except StorageError:
            return False
