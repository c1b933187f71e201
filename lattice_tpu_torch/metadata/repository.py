"""Metadata persistence: SQLite with versioning + generation log.

A copy of `lattice_tpu/metadata/repository.py`, its imports pointed at the port.

Parity target: reference `src/lattice/metadata/repository.py:41-178` (upsert
with version counter into Postgres JSONB + generation log) and the schema in
`migrations/001_create_metadata_tables.sql` (project_metadata with JSONB
fields, version counter, status constraint; metadata_generation_log;
indexes). Postgres/asyncpg is an external service the reference runs in
docker; a local SQLite file keeps the same schema shape in-process.
"""

from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path

from lattice_tpu_torch.core.errors import MetadataError

_SCHEMA = """
CREATE TABLE IF NOT EXISTS project_metadata (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    project_name TEXT NOT NULL,
    version INTEGER NOT NULL DEFAULT 1,
    status TEXT NOT NULL DEFAULT 'pending'
        CHECK (status IN ('pending','generating','completed','failed','partial')),
    data TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (project_name, version)
);
CREATE TABLE IF NOT EXISTS metadata_generation_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    project_name TEXT NOT NULL,
    field_name TEXT NOT NULL,
    status TEXT NOT NULL,
    duration_ms REAL,
    error TEXT,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_metadata_project
    ON project_metadata (project_name);
CREATE INDEX IF NOT EXISTS idx_metadata_status
    ON project_metadata (status);
CREATE INDEX IF NOT EXISTS idx_log_project
    ON metadata_generation_log (project_name);
"""


class MetadataRepository:
    def __init__(self, data_dir: str | Path, db_name: str = "metadata.sqlite3"):
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.db_path = self.data_dir / db_name
        self._conn = sqlite3.connect(str(self.db_path))
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # ---- metadata ------------------------------------------------------

    def upsert(self, project_name: str, record: dict,
               status: str = "completed") -> int:
        """Insert a new version (reference `repository.py:41-120`)."""
        now = time.time()
        cur = self._conn.execute(
            "SELECT COALESCE(MAX(version), 0) FROM project_metadata "
            "WHERE project_name = ?", (project_name,))
        version = int(cur.fetchone()[0]) + 1
        try:
            self._conn.execute(
                "INSERT INTO project_metadata "
                "(project_name, version, status, data, created_at, updated_at) "
                "VALUES (?, ?, ?, ?, ?, ?)",
                (project_name, version, status, json.dumps(record), now, now))
            self._conn.commit()
        except sqlite3.Error as exc:
            raise MetadataError("metadata upsert failed", cause=exc) from exc
        return version

    def get_latest(self, project_name: str) -> dict | None:
        cur = self._conn.execute(
            "SELECT data, version, status FROM project_metadata "
            "WHERE project_name = ? ORDER BY version DESC LIMIT 1",
            (project_name,))
        row = cur.fetchone()
        if row is None:
            return None
        data = json.loads(row[0])
        data["version"] = row[1]
        data["status"] = row[2]
        return data

    def list_versions(self, project_name: str) -> list[tuple[int, str, float]]:
        cur = self._conn.execute(
            "SELECT version, status, updated_at FROM project_metadata "
            "WHERE project_name = ? ORDER BY version DESC", (project_name,))
        return [(int(v), s, float(t)) for v, s, t in cur.fetchall()]

    # ---- generation log (reference `repository.py:155-178`) ------------

    def log_generation(self, project_name: str, field_name: str, status: str,
                       duration_ms: float | None = None,
                       error: str | None = None) -> None:
        self._conn.execute(
            "INSERT INTO metadata_generation_log "
            "(project_name, field_name, status, duration_ms, error, created_at) "
            "VALUES (?, ?, ?, ?, ?, ?)",
            (project_name, field_name, status, duration_ms, error, time.time()))
        self._conn.commit()

    def get_log(self, project_name: str, limit: int = 50) -> list[dict]:
        cur = self._conn.execute(
            "SELECT field_name, status, duration_ms, error, created_at "
            "FROM metadata_generation_log WHERE project_name = ? "
            "ORDER BY id DESC LIMIT ?", (project_name, limit))
        return [
            {"field_name": f, "status": s, "duration_ms": d,
             "error": e, "created_at": t}
            for f, s, d, e, t in cur.fetchall()
        ]
