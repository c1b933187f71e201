"""Project metadata generation.

A copy of `lattice_tpu/metadata/generator.py`, its imports pointed at the port.

Parity target: reference `src/lattice/metadata/generator.py:28-494` — seven
fields generated in order (folder_structure -> tech_stack -> dependencies ->
entry_points -> core_features -> project_overview -> architecture_diagram),
per-field timing + generation log, retries, repository upsert.

The reference runs an agent-SDK subprocess per field with repo tools
(`generator.py:292-338`); this framework's default generator computes every
field *deterministically* by analyzing the repo directly (no agent, no
network), and uses a configured LLM only to polish the prose fields
(`project_overview`, feature descriptions) when available. Zero-cost,
reproducible, offline — with the same output schema.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
from collections import Counter
from pathlib import Path

from lattice_tpu_torch.config.settings import FileSettings
from lattice_tpu_torch.core.types import EdgeType
from lattice_tpu_torch.metadata.models import (
    CoreFeature,
    DependencyInfo,
    EntryPoint,
    FolderNode,
    MetadataStatus,
    ProjectMetadata,
    TechStack,
)
from lattice_tpu_torch.metadata.repository import MetadataRepository
from lattice_tpu_torch.parsing.scanner import FileScanner

logger = logging.getLogger(__name__)

FIELD_ORDER = (
    "folder_structure", "tech_stack", "dependencies", "entry_points",
    "core_features", "project_overview", "architecture_diagram",
)

_FRAMEWORK_MARKERS = {
    "react": "React", "vue": "Vue", "angular": "Angular", "next": "Next.js",
    "django": "Django", "flask": "Flask", "fastapi": "FastAPI",
    "express": "Express", "jax": "JAX", "flax": "Flax", "torch": "PyTorch",
    "tensorflow": "TensorFlow", "pydantic": "pydantic", "sqlalchemy":
    "SQLAlchemy", "numpy": "NumPy", "pandas": "pandas", "optax": "optax",
}
_TEST_MARKERS = {"pytest": "pytest", "jest": "jest", "mocha": "mocha",
                 "vitest": "vitest", "unittest": "unittest"}


class MetadataGenerator:
    def __init__(self, repo_path: str | Path, project_name: str,
                 repository: MetadataRepository | None = None,
                 llm=None, graph_store=None, max_retries: int = 2):
        self.repo_path = Path(repo_path).resolve()
        self.project_name = project_name
        self.repository = repository
        self.llm = llm
        self.graph_store = graph_store
        self.max_retries = max_retries
        self._scan_cache: list | None = None

    # ---- helpers -------------------------------------------------------

    def _files(self) -> list:
        if self._scan_cache is None:
            self._scan_cache = FileScanner(self.repo_path, FileSettings(
                extensions=[".py", ".pyi", ".js", ".jsx", ".ts", ".tsx",
                            ".mjs", ".cjs", ".rs", ".go", ".java", ".cpp",
                            ".cc", ".h"],
            )).scan_all()
        return self._scan_cache

    def _read(self, rel: str) -> str | None:
        path = self.repo_path / rel
        if path.is_file():
            try:
                return path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                return None
        return None

    # ---- field generators ----------------------------------------------

    def gen_folder_structure(self, max_depth: int = 3,
                             max_children: int = 25) -> FolderNode:
        """Reference field 1 (`generator.py:92-100`)."""
        ignore = {".git", "node_modules", "__pycache__", ".lattice", "venv",
                  ".venv", "dist", "build", ".pytest_cache", ".mypy_cache"}

        def walk(path: Path, depth: int) -> FolderNode:
            node = FolderNode(name=path.name or str(path), type="directory")
            if depth >= max_depth:
                return node
            try:
                entries = sorted(path.iterdir(),
                                 key=lambda p: (p.is_file(), p.name))
            except OSError:
                return node
            for child in entries[:max_children]:
                if child.name.startswith(".") or child.name in ignore:
                    continue
                if child.is_dir():
                    node.children.append(walk(child, depth + 1))
                else:
                    node.children.append(FolderNode(name=child.name, type="file"))
            return node

        return walk(self.repo_path, 0)

    def gen_tech_stack(self) -> TechStack:
        """Reference field 2."""
        stack = TechStack()
        lang_counts = Counter(f.language.value for f in self._files())
        stack.languages = dict(lang_counts.most_common())
        dep_names = {d.name.lower() for d in self.gen_dependencies()}
        for marker, label in _FRAMEWORK_MARKERS.items():
            if any(marker in d for d in dep_names):
                stack.frameworks.append(label)
        for marker, label in _TEST_MARKERS.items():
            if any(marker in d for d in dep_names):
                stack.test_frameworks.append(label)
        for probe, tool in (("pyproject.toml", "setuptools/pyproject"),
                            ("setup.py", "setuptools"),
                            ("package.json", "npm"),
                            ("yarn.lock", "yarn"),
                            ("Cargo.toml", "cargo"),
                            ("Makefile", "make"),
                            ("CMakeLists.txt", "cmake"),
                            ("BUILD", "bazel")):
            if (self.repo_path / probe).exists():
                stack.build_tools.append(tool)
        if "python" in stack.languages:
            stack.runtimes.append("python")
        if {"javascript", "typescript", "tsx", "jsx"} & set(stack.languages):
            stack.runtimes.append("node")
        return stack

    def gen_dependencies(self) -> list[DependencyInfo]:
        """Reference field 3."""
        deps: list[DependencyInfo] = []
        seen: set[str] = set()

        def add(name: str, version: str | None, kind: str, source: str):
            key = name.strip().lower()
            if key and key not in seen:
                seen.add(key)
                deps.append(DependencyInfo(name=name.strip(), version=version,
                                           kind=kind, source=source))

        pyproject = self._read("pyproject.toml")
        if pyproject:
            in_deps = False
            for line in pyproject.splitlines():
                stripped = line.strip()
                if stripped.startswith("dependencies"):
                    in_deps = True
                    continue
                if in_deps:
                    if stripped.startswith("]"):
                        in_deps = False
                        continue
                    m = re.match(r'"([A-Za-z0-9_.\-\[\]]+)\s*([<>=!~^][^"]*)?"',
                                 stripped.rstrip(","))
                    if m:
                        add(m.group(1), m.group(2), "runtime", "pyproject.toml")
        requirements = self._read("requirements.txt")
        if requirements:
            for line in requirements.splitlines():
                line = line.strip()
                if line and not line.startswith(("#", "-")):
                    m = re.match(r"([A-Za-z0-9_.\-\[\]]+)\s*(.*)", line)
                    if m:
                        add(m.group(1), m.group(2) or None, "runtime",
                            "requirements.txt")
        package_json = self._read("package.json")
        if package_json:
            try:
                pkg = json.loads(package_json)
            except json.JSONDecodeError:
                pkg = {}
            for section, kind in (("dependencies", "runtime"),
                                  ("devDependencies", "dev")):
                for name, version in (pkg.get(section) or {}).items():
                    add(name, version, kind, "package.json")
        return deps

    def gen_entry_points(self) -> list[EntryPoint]:
        """Reference field 4."""
        out: list[EntryPoint] = []
        pyproject = self._read("pyproject.toml")
        if pyproject:
            in_scripts = False
            for line in pyproject.splitlines():
                stripped = line.strip()
                if stripped.startswith("[project.scripts]"):
                    in_scripts = True
                    continue
                if in_scripts:
                    if stripped.startswith("["):
                        in_scripts = False
                        continue
                    m = re.match(r'([\w\-]+)\s*=\s*"([^"]+)"', stripped)
                    if m:
                        out.append(EntryPoint(name=m.group(1), path=m.group(2),
                                              kind="cli"))
        package_json = self._read("package.json")
        if package_json:
            try:
                pkg = json.loads(package_json)
            except json.JSONDecodeError:
                pkg = {}
            for name, cmd in (pkg.get("scripts") or {}).items():
                out.append(EntryPoint(name=name, path=cmd, kind="script"))
            if isinstance(pkg.get("bin"), dict):
                for name, path in pkg["bin"].items():
                    out.append(EntryPoint(name=name, path=path, kind="cli"))
        for f in self._files():
            if f.language.value != "python":
                continue
            content = self._read(f.relative_path) or ""
            if '__name__ == "__main__"' in content or \
                    "__name__ == '__main__'" in content:
                out.append(EntryPoint(name=Path(f.relative_path).stem,
                                      path=f.relative_path, kind="main"))
        return out[:25]

    def gen_core_features(self) -> list[CoreFeature]:
        """Reference field 5: most central entities become feature anchors."""
        features: list[CoreFeature] = []
        if self.graph_store is not None:
            store = self.graph_store
            n = store.n_nodes()
            ids = list(range(n))
            degrees = store.degree(ids, EdgeType.CALLS)
            ranked = sorted(
                (i for i in ids if store._alive[i]),
                key=lambda i: -(degrees[i][0] + degrees[i][1]))
            for nid in ranked[:8]:
                rec = store.node(nid)
                if rec.entity_type.value == "file":
                    continue
                features.append(CoreFeature(
                    name=rec.name,
                    description=f"{rec.entity_type.value} "
                                f"{rec.qualified_name} "
                                f"({degrees[nid][1]} callers, "
                                f"{degrees[nid][0]} callees)",
                    key_entities=[rec.qualified_name],
                    files=[rec.file_path],
                ))
        else:
            by_dir: Counter = Counter(
                str(Path(f.relative_path).parent) for f in self._files())
            for directory, count in by_dir.most_common(6):
                features.append(CoreFeature(
                    name=directory or "root",
                    description=f"component directory with {count} source files",
                    files=[directory],
                ))
        return features

    def gen_project_overview(self) -> str:
        """Reference field 6; LLM-polished when a provider exists."""
        readme = None
        for candidate in ("README.md", "README.rst", "readme.md"):
            readme = self._read(candidate)
            if readme:
                break
        files = self._files()
        langs = Counter(f.language.value for f in files)
        base = (f"{self.project_name}: {len(files)} source files "
                f"({', '.join(f'{k}: {v}' for k, v in langs.most_common(4))}).")
        if readme:
            paragraph = next(
                (p.strip() for p in readme.split("\n\n")
                 if p.strip() and not p.strip().startswith("#")), "")
            base = f"{base} {paragraph[:600]}"
        return base

    def gen_architecture_diagram(self) -> str:
        """Reference field 7: mermaid of package-level import edges."""
        edges: Counter = Counter()
        if self.graph_store is not None:
            store = self.graph_store
            src, dst = store.edges(EdgeType.IMPORTS)
            for s, d in zip(src, dst):
                s_pkg = str(Path(store.node(int(s)).file_path).parent)
                d_pkg = str(Path(store.node(int(d)).file_path).parent)
                if s_pkg != d_pkg:
                    edges[(s_pkg or "root", d_pkg or "root")] += 1
        lines = ["graph TD"]
        def nid(name: str) -> str:
            return re.sub(r"[^A-Za-z0-9_]", "_", name) or "root"
        if edges:
            for (s, d), weight in edges.most_common(30):
                lines.append(f'    {nid(s)}["{s}"] -->|{weight}| {nid(d)}["{d}"]')
        else:
            by_dir = Counter(str(Path(f.relative_path).parent)
                             for f in self._files())
            for directory, count in by_dir.most_common(12):
                lines.append(f'    {nid(directory)}["{directory} ({count})"]')
        return "\n".join(lines)

    # ---- orchestration (reference `generator.py:92-232`) ---------------

    async def generate_all(self) -> dict:
        meta = ProjectMetadata(project_name=self.project_name,
                               status=MetadataStatus.GENERATING,
                               generator="local+llm" if self.llm else "local")
        generators = {
            "folder_structure": self.gen_folder_structure,
            "tech_stack": self.gen_tech_stack,
            "dependencies": self.gen_dependencies,
            "entry_points": self.gen_entry_points,
            "core_features": self.gen_core_features,
            "project_overview": self.gen_project_overview,
            "architecture_diagram": self.gen_architecture_diagram,
        }
        failures = 0
        for field in FIELD_ORDER:
            t0 = time.perf_counter()
            error = None
            for attempt in range(self.max_retries + 1):
                try:
                    value = await asyncio.to_thread(generators[field])
                    setattr(meta, field, value)
                    error = None
                    break
                except Exception as exc:
                    error = str(exc)
                    logger.warning("metadata field %s attempt %d failed: %s",
                                   field, attempt, exc)
            duration = (time.perf_counter() - t0) * 1000
            meta.field_timings_ms[field] = duration
            if self.repository is not None:
                self.repository.log_generation(
                    self.project_name, field,
                    "failed" if error else "completed", duration, error)
            if error is not None:
                failures += 1
        if self.llm is not None and meta.project_overview:
            meta.project_overview = await self._polish_overview(
                meta.project_overview)
        meta.status = (MetadataStatus.COMPLETED if failures == 0 else
                       MetadataStatus.PARTIAL if failures < len(FIELD_ORDER)
                       else MetadataStatus.FAILED)
        record = meta.to_record()
        if self.repository is not None:
            meta.version = self.repository.upsert(
                self.project_name, record, status=meta.status.value)
            record["version"] = meta.version
        return record

    async def _polish_overview(self, draft: str) -> str:
        try:
            return (await self.llm.complete([{
                "role": "user",
                "content": ("Rewrite this project overview as 2-3 clear "
                            f"sentences for developers:\n\n{draft}"),
            }])).strip()
        except Exception as exc:
            logger.warning("overview polish failed: %s", exc)
            return draft
