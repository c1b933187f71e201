"""Pipeline progress tracking.

Parity target: reference `src/lattice/pipeline/progress.py:11-209` —
stage-weighted overall percentage (weights 5/15/20/25/10/25), thread-safe
callback fan-out, per-stage `StageProgress`, stats fields (files/entities/
nodes/summaries/chunks).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from lattice_tpu_torch.core.types import PipelineStage

# Reference stage weights (`pipeline/progress.py:11-16`).
STAGE_WEIGHTS: dict[PipelineStage, float] = {
    PipelineStage.SCANNING: 5.0,
    PipelineStage.PARSING: 15.0,
    PipelineStage.GRAPH_BUILDING: 20.0,
    PipelineStage.SUMMARIZING: 25.0,
    PipelineStage.METADATA: 10.0,
    PipelineStage.EMBEDDING: 25.0,
}
_ORDER = list(STAGE_WEIGHTS)


@dataclass(slots=True)
class StageProgress:
    """Reference: `progress.py:19-30`."""

    stage: PipelineStage
    total: int = 0
    done: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0

    @property
    def fraction(self) -> float:
        if self.finished_at:
            return 1.0
        if self.total <= 0:
            return 0.0
        return min(self.done / self.total, 1.0)


@dataclass(slots=True)
class PipelineProgress:
    """Snapshot handed to callbacks. Reference: `progress.py:33-60`."""

    stage: PipelineStage
    overall_pct: float
    stage_pct: float
    message: str = ""
    files_scanned: int = 0
    files_parsed: int = 0
    entities_found: int = 0
    graph_nodes: int = 0
    graph_edges: int = 0
    summaries_created: int = 0
    chunks_indexed: int = 0
    errors: int = 0


class ProgressTracker:
    """Reference: `progress.py:109-209`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._callbacks: list = []
        self._stages: dict[PipelineStage, StageProgress] = {
            s: StageProgress(stage=s) for s in STAGE_WEIGHTS
        }
        self._current: PipelineStage = PipelineStage.SCANNING
        self.stats = {
            "files_scanned": 0, "files_parsed": 0, "entities_found": 0,
            "graph_nodes": 0, "graph_edges": 0, "summaries_created": 0,
            "chunks_indexed": 0, "errors": 0,
        }
        self.started_at: float = 0.0
        self.finished_at: float = 0.0
        self.failed: bool = False

    def add_callback(self, callback) -> None:
        with self._lock:
            self._callbacks.append(callback)

    def start(self) -> None:
        self.started_at = time.time()

    def start_stage(self, stage: PipelineStage, total: int = 0,
                    message: str = "") -> None:
        with self._lock:
            self._current = stage
            sp = self._stages[stage]
            sp.total = total
            sp.done = 0
            sp.started_at = time.time()
        self._emit(message or f"stage {stage.value} started")

    def advance(self, n: int = 1, message: str = "", **stat_updates: int) -> None:
        with self._lock:
            sp = self._stages[self._current]
            sp.done += n
            for key, delta in stat_updates.items():
                if key in self.stats:
                    self.stats[key] += delta
        self._emit(message)

    def finish_stage(self, stage: PipelineStage | None = None) -> None:
        with self._lock:
            sp = self._stages[stage or self._current]
            sp.finished_at = time.time()
        self._emit(f"stage {(stage or self._current).value} done")

    def complete(self) -> None:
        self.finished_at = time.time()
        self._emit("pipeline completed")

    def fail(self, message: str) -> None:
        self.failed = True
        self.finished_at = time.time()
        with self._lock:
            self.stats["errors"] += 1
        self._emit(message)

    @property
    def overall_pct(self) -> float:
        total_weight = sum(STAGE_WEIGHTS.values())
        acc = 0.0
        for stage, weight in STAGE_WEIGHTS.items():
            acc += weight * self._stages[stage].fraction
        return 100.0 * acc / total_weight

    def snapshot(self, message: str = "") -> PipelineProgress:
        sp = self._stages[self._current]
        return PipelineProgress(
            stage=self._current,
            overall_pct=self.overall_pct,
            stage_pct=100.0 * sp.fraction,
            message=message,
            files_scanned=self.stats["files_scanned"],
            files_parsed=self.stats["files_parsed"],
            entities_found=self.stats["entities_found"],
            graph_nodes=self.stats["graph_nodes"],
            graph_edges=self.stats["graph_edges"],
            summaries_created=self.stats["summaries_created"],
            chunks_indexed=self.stats["chunks_indexed"],
            errors=self.stats["errors"],
        )

    def _emit(self, message: str) -> None:
        snap = self.snapshot(message)
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(snap)
            except Exception:
                pass

    @property
    def elapsed_s(self) -> float:
        if not self.started_at:
            return 0.0
        end = self.finished_at or time.time()
        return end - self.started_at
