"""Metadata models.

A copy of `lattice_tpu/metadata/models.py` with `dataclasses` in place of
pydantic, which the machine with the card does not have: recursive
`FolderNode`, `CoreFeature`, `TechStack`, `DependencyInfo`, `EntryPoint`,
`ProjectMetadata`, `MetadataStatus`, with the reference's fields and
defaults. `to_dict()` gives the dict that the reference's
`model_dump(mode="json")` gives (enums as their values, nested models as
dicts), which is the JSON the repository stores.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class MetadataStatus(str, enum.Enum):
    """Reference: `models.py:90-97`."""

    PENDING = "pending"
    GENERATING = "generating"
    COMPLETED = "completed"
    FAILED = "failed"
    PARTIAL = "partial"


def _dump(value: Any) -> Any:
    if dataclasses.is_dataclass(value):
        return {f.name: _dump(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_dump(v) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v) for k, v in value.items()}
    return value


class _Model:
    def to_dict(self) -> dict[str, Any]:
        return _dump(self)


@dataclass
class FolderNode(_Model):
    """Recursive folder tree. Reference: `models.py:11-22`."""

    name: str
    type: str = "directory"          # directory | file
    purpose: str | None = None
    children: list["FolderNode"] = field(default_factory=list)


@dataclass
class TechStack(_Model):
    """Reference: `models.py:25-36`."""

    languages: dict[str, int] = field(default_factory=dict)   # lang -> files
    frameworks: list[str] = field(default_factory=list)
    build_tools: list[str] = field(default_factory=list)
    test_frameworks: list[str] = field(default_factory=list)
    runtimes: list[str] = field(default_factory=list)


@dataclass
class DependencyInfo(_Model):
    """Reference: `models.py:39-49`."""

    name: str
    version: str | None = None
    kind: str = "runtime"            # runtime | dev | build
    source: str = ""                 # which manifest declared it


@dataclass
class EntryPoint(_Model):
    """Reference: `models.py:52-61`."""

    name: str
    path: str
    kind: str = "cli"                # cli | main | script | server | export
    description: str | None = None


@dataclass
class CoreFeature(_Model):
    """Reference: `models.py:64-72`."""

    name: str
    description: str
    key_entities: list[str] = field(default_factory=list)
    files: list[str] = field(default_factory=list)


@dataclass
class ProjectMetadata(_Model):
    """Reference: `models.py:75-87` (7 fields + bookkeeping)."""

    project_name: str
    folder_structure: Optional[FolderNode] = None
    tech_stack: Optional[TechStack] = None
    dependencies: list[DependencyInfo] = field(default_factory=list)
    entry_points: list[EntryPoint] = field(default_factory=list)
    core_features: list[CoreFeature] = field(default_factory=list)
    project_overview: str | None = None
    architecture_diagram: str | None = None     # mermaid source
    status: MetadataStatus = MetadataStatus.PENDING
    version: int = 1
    generator: str = "local"
    field_timings_ms: dict[str, float] = field(default_factory=dict)

    def to_record(self) -> dict[str, Any]:
        return self.to_dict()
