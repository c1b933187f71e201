"""Project management: list / inspect / delete indexed projects.

A copy of `lattice_tpu/projects/manager.py`, its imports pointed at the port.

Parity target: reference `src/lattice/projects/` — `ProjectRepository`
list/get/delete over Memgraph incl. cascade + empty-project cleanup
(`repository.py:19-136`), `ProjectCleanupService` deleting Qdrant points by
file-path filter across both collections (`cleanup.py:19-73`), and the
`ProjectManager` facade owning connections (`manager.py:15-123`).

In this framework every project's index is a self-contained directory
(`<repo>/.lattice/`), registered in `~/.lattice_projects.json`; deletion is
a directory removal (the cascade), and cleanup prunes registry entries whose
index directories no longer exist (the empty-project sweep).
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

from lattice_tpu_torch.projects.models import Project, ProjectIndex
from lattice_tpu_torch.storage import persistence

logger = logging.getLogger(__name__)

DEFAULT_REGISTRY = Path.home() / ".lattice_projects.json"


class ProjectRepository:
    """Registry-backed repository (reference `repository.py:19-136`)."""

    def __init__(self, registry_path: Path = DEFAULT_REGISTRY,
                 data_dir_name: str = ".lattice"):
        self.registry_path = registry_path
        self.data_dir_name = data_dir_name

    def _load(self) -> dict[str, str]:
        if self.registry_path.is_file():
            try:
                return json.loads(self.registry_path.read_text())
            except json.JSONDecodeError:
                return {}
        return {}

    def _save(self, reg: dict[str, str]) -> None:
        self.registry_path.write_text(json.dumps(reg, indent=1))

    def register(self, name: str, root_path: str | Path) -> None:
        reg = self._load()
        reg[name] = str(Path(root_path).resolve())
        self._save(reg)

    def _project_from_entry(self, name: str, root: str) -> Project | None:
        data_dir = Path(root) / self.data_dir_name
        manifest = persistence.read_manifest(data_dir)
        if manifest is None:
            return None
        chunk_count = 0
        node_count = edge_count = 0
        try:
            import numpy as np
            npz = data_dir / "code_chunks.npz"
            if npz.is_file():
                chunk_count = int(np.load(npz)["embeddings"].shape[0])
            gnpz = data_dir / "graph.npz"
            if gnpz.is_file():
                arrays = np.load(gnpz)
                node_count = int(arrays["alive"].sum())
                edge_count = int(sum(
                    len(arrays[k]) for k in arrays.files if k.startswith("src_")))
        except Exception as exc:
            logger.debug("stats read failed for %s: %s", name, exc)
        return Project(
            name=name, root_path=root,
            file_count=len(manifest.get("file_hashes", {})),
            node_count=node_count, edge_count=edge_count,
            chunk_count=chunk_count,
            provider=manifest.get("provider", ""),
            dims=int(manifest.get("dims", 0)),
        )

    def list(self) -> ProjectIndex:
        projects = []
        for name, root in sorted(self._load().items()):
            project = self._project_from_entry(name, root)
            if project is not None:
                projects.append(project)
        return ProjectIndex(projects=tuple(projects))

    def get(self, name: str) -> Project | None:
        root = self._load().get(name)
        if root is None:
            return None
        return self._project_from_entry(name, root)

    def delete(self, name: str) -> bool:
        """Cascade delete: index directory + registry entry."""
        reg = self._load()
        root = reg.pop(name, None)
        if root is None:
            return False
        data_dir = Path(root) / self.data_dir_name
        if data_dir.is_dir():
            shutil.rmtree(data_dir)
        self._save(reg)
        return True

    def cleanup_stale(self) -> int:
        """Prune registry entries with no index on disk (empty-project
        cleanup, reference `repository.py:118-136`)."""
        reg = self._load()
        stale = [name for name, root in reg.items()
                 if persistence.read_manifest(
                     Path(root) / self.data_dir_name) is None]
        for name in stale:
            del reg[name]
        if stale:
            self._save(reg)
        return len(stale)


class ProjectCleanupService:
    """Delete one project's vectors by file-path filter (reference
    `cleanup.py:19-73`) — used for partial cleanup without dropping the
    whole index."""

    def __init__(self, indexer):
        self.indexer = indexer

    def delete_files(self, file_paths: list[str]) -> int:
        removed = 0
        for path in file_paths:
            removed += self.indexer.delete_file(path)
        return removed

    def delete_project_vectors(self, project_name: str) -> int:
        removed = self.indexer.code.delete_by_filter(
            {"project_name": project_name})
        removed += self.indexer.summaries.delete_by_filter(
            {"project_name": project_name})
        return removed


class ProjectManager:
    """Facade (reference `manager.py:15-123`)."""

    def __init__(self, registry_path: Path = DEFAULT_REGISTRY):
        self.repository = ProjectRepository(registry_path)

    def list_projects(self) -> ProjectIndex:
        return self.repository.list()

    def get_project(self, name: str) -> Project | None:
        return self.repository.get(name)

    def delete_project(self, name: str) -> bool:
        return self.repository.delete(name)

    def cleanup(self) -> int:
        return self.repository.cleanup_stale()
