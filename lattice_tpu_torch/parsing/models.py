"""Parse-result models.

Parity target: reference `src/lattice/parsing/models.py:8-71` (`ImportInfo`,
recursive `CodeEntity`, `FileInfo`, `ParsedFile` with `all_entities`
flattening walk and type-filtered views). Implemented as dataclasses rather
than pydantic models — these are hot-path host objects created per entity
during indexing, and attribute-slot dataclasses are markedly cheaper.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from lattice_tpu_torch.core.types import EntityType, Language


def module_qname(relative_path: str | Path) -> str:
    """Derive a dotted module qualified name from a repo-relative path.

    Reference semantics: `graph/builder.py:252-259` (strip extension, join
    path parts with '.', drop `__init__` / `index` leaf names). A leading
    `src/` is dropped (standard src-layout): the import system addresses
    such packages without the prefix, so keeping it would orphan every
    absolute import from its module QN (the reference gets this implicitly
    by probing repo dirs, `import_processor.py:61-185`).
    """
    p = Path(relative_path)
    parts = list(p.parts)
    if len(parts) > 1 and parts[0] == "src":
        parts = parts[1:]
    if parts:
        stem = Path(parts[-1]).stem
        parts[-1] = stem
        if stem in ("__init__", "index"):
            parts.pop()
    return ".".join(part for part in parts if part and part != ".")


@dataclass(slots=True)
class ImportInfo:
    """One import statement. Reference: `parsing/models.py:8-13`."""

    module: str                      # source module as written ("os.path", "./utils")
    names: list[str] = field(default_factory=list)   # imported names ([] = whole module)
    alias: str | None = None         # local alias for module or single name
    is_relative: bool = False
    is_wildcard: bool = False
    is_type_only: bool = False       # TS `import type`
    line: int = 0


@dataclass(slots=True)
class CodeEntity:
    """One extracted entity, recursive via `children`.

    Reference: `parsing/models.py:16-32` (qualified_name, signature,
    docstring, code, lines, is_async/static/classmethod, decorators,
    base_classes, calls, children).
    """

    name: str
    entity_type: EntityType
    qualified_name: str = ""
    signature: str = ""
    docstring: str | None = None
    code: str = ""
    start_line: int = 0
    end_line: int = 0
    is_async: bool = False
    is_static: bool = False
    is_classmethod: bool = False
    decorators: list[str] = field(default_factory=list)
    base_classes: list[str] = field(default_factory=list)
    calls: list[str] = field(default_factory=list)
    children: list["CodeEntity"] = field(default_factory=list)

    def walk(self) -> Iterator["CodeEntity"]:
        yield self
        for child in self.children:
            yield from child.walk()


@dataclass(slots=True)
class FileInfo:
    """One scanned file. Reference: `parsing/models.py:35-41`."""

    path: Path
    relative_path: str
    language: Language
    size_bytes: int = 0
    content_hash: str = ""
    mtime: float = 0.0

    @property
    def module_name(self) -> str:
        return module_qname(self.relative_path)


@dataclass(slots=True)
class ParsedFile:
    """Parse result for one file. Reference: `parsing/models.py:44-71`."""

    file_info: FileInfo
    imports: list[ImportInfo] = field(default_factory=list)
    entities: list[CodeEntity] = field(default_factory=list)
    parse_errors: list[str] = field(default_factory=list)

    @property
    def all_entities(self) -> list[CodeEntity]:
        """Flattened recursive walk. Reference: `parsing/models.py:44-59`."""
        out: list[CodeEntity] = []
        for entity in self.entities:
            out.extend(entity.walk())
        return out

    def entities_of_type(self, entity_type: EntityType) -> list[CodeEntity]:
        return [e for e in self.all_entities if e.entity_type == entity_type]

    @property
    def classes(self) -> list[CodeEntity]:
        return self.entities_of_type(EntityType.CLASS)

    @property
    def functions(self) -> list[CodeEntity]:
        return self.entities_of_type(EntityType.FUNCTION)

    @property
    def methods(self) -> list[CodeEntity]:
        return self.entities_of_type(EntityType.METHOD)

    @property
    def interfaces(self) -> list[CodeEntity]:
        return self.entities_of_type(EntityType.INTERFACE)
