"""Project models.

A copy of `lattice_tpu/projects/models.py`, its imports pointed at the port.

Parity target: reference `src/lattice/projects/models.py:8-145` —
`Project` / `ProjectIndex` frozen dataclasses with aggregate totals.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True, slots=True)
class Project:
    """Reference: `models.py:8-40`."""

    name: str
    root_path: str
    file_count: int = 0
    node_count: int = 0
    edge_count: int = 0
    chunk_count: int = 0
    provider: str = ""
    dims: int = 0


@dataclass(frozen=True)
class ProjectIndex:
    """Aggregate over all indexed projects. Reference: `models.py:90-145`."""

    projects: tuple[Project, ...] = field(default_factory=tuple)

    @property
    def total_files(self) -> int:
        return sum(p.file_count for p in self.projects)

    @property
    def total_nodes(self) -> int:
        return sum(p.node_count for p in self.projects)

    @property
    def total_chunks(self) -> int:
        return sum(p.chunk_count for p in self.projects)

    def get(self, name: str) -> Project | None:
        for p in self.projects:
            if p.name == name:
                return p
        return None
