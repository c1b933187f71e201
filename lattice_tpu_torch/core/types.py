"""Core enumerations for the lattice-tpu framework.

Parity target: reference `src/lattice/core/types.py:4-66` (Language with
extension mapping, EntityType, QueryType, ResultSource, PipelineStage).
Re-designed (not copied): extension maps live in one table, and integer
codes are assigned to every enum so they can be stored directly in device
arrays (payload columns of the HBM-resident index).
"""

from __future__ import annotations

import enum


class Language(str, enum.Enum):
    """Languages the parsing frontend understands.

    Reference: `core/types.py:4-31`. The reference wires up Python/JS/TS
    variants end-to-end and keeps Rust/Java/Go/C++ configs for call
    resolution only (`parsing/language_config.py:103-269`); we mirror that.
    """

    PYTHON = "python"
    JAVASCRIPT = "javascript"
    JSX = "jsx"
    TYPESCRIPT = "typescript"
    TSX = "tsx"
    RUST = "rust"
    JAVA = "java"
    GO = "go"
    CPP = "cpp"
    UNKNOWN = "unknown"

    @property
    def code(self) -> int:
        """Stable small-int code for device-side payload columns."""
        return _LANGUAGE_CODES[self]

    @classmethod
    def from_extension(cls, ext: str) -> "Language":
        return _EXTENSION_MAP.get(ext.lower(), cls.UNKNOWN)

    @classmethod
    def from_code(cls, code: int) -> "Language":
        return _CODE_TO_LANGUAGE.get(int(code), cls.UNKNOWN)

    @classmethod
    def supported_extensions(cls) -> tuple[str, ...]:
        return tuple(_EXTENSION_MAP.keys())


_EXTENSION_MAP: dict[str, Language] = {
    ".py": Language.PYTHON,
    ".pyi": Language.PYTHON,
    ".js": Language.JAVASCRIPT,
    ".mjs": Language.JAVASCRIPT,
    ".cjs": Language.JAVASCRIPT,
    ".jsx": Language.JSX,
    ".ts": Language.TYPESCRIPT,
    ".mts": Language.TYPESCRIPT,
    ".tsx": Language.TSX,
    ".rs": Language.RUST,
    ".java": Language.JAVA,
    ".go": Language.GO,
    ".cc": Language.CPP,
    ".cpp": Language.CPP,
    ".cxx": Language.CPP,
    ".h": Language.CPP,
    ".hh": Language.CPP,
    ".hpp": Language.CPP,
}

_LANGUAGE_CODES: dict[Language, int] = {
    lang: i for i, lang in enumerate(Language)
}
_CODE_TO_LANGUAGE: dict[int, Language] = {
    i: lang for lang, i in _LANGUAGE_CODES.items()
}


class EntityType(str, enum.Enum):
    """Kinds of code entities extracted from source.

    Reference: `core/types.py:34-43`.
    """

    FILE = "file"
    MODULE = "module"
    CLASS = "class"
    FUNCTION = "function"
    METHOD = "method"
    IMPORT = "import"
    INTERFACE = "interface"
    TYPE_ALIAS = "type_alias"

    @property
    def code(self) -> int:
        return _ENTITY_CODES[self]

    @classmethod
    def from_code(cls, code: int) -> "EntityType":
        return _CODE_TO_ENTITY[int(code)]


_ENTITY_CODES: dict[EntityType, int] = {e: i for i, e in enumerate(EntityType)}
_CODE_TO_ENTITY: dict[int, EntityType] = {i: e for e, i in _ENTITY_CODES.items()}


class QueryType(str, enum.Enum):
    """Coarse query classification. Reference: `core/types.py:46-49`."""

    SEMANTIC = "semantic"
    STRUCTURAL = "structural"
    HYBRID = "hybrid"


class ResultSource(str, enum.Enum):
    """Which retrieval side produced a result. Reference: `core/types.py:52-55`."""

    GRAPH = "graph"
    VECTOR = "vector"
    HYBRID = "hybrid"


class PipelineStage(str, enum.Enum):
    """Indexing pipeline stages in execution order.

    Reference: `core/types.py:58-66`.
    """

    SCANNING = "scanning"
    PARSING = "parsing"
    GRAPH_BUILDING = "graph_building"
    SUMMARIZING = "summarizing"
    METADATA = "metadata"
    EMBEDDING = "embedding"
    COMPLETED = "completed"
    FAILED = "failed"


class EdgeType(str, enum.Enum):
    """Relationship types stored as per-type CSR adjacency in the GraphStore.

    TPU-native addition: the reference keeps these as Memgraph relationship
    labels (`graph/queries.py:140-181`); here each edge type is a pair of
    `(indptr, indices)` arrays in HBM so traversals compile to frontier
    expansion kernels.
    """

    CALLS = "CALLS"
    EXTENDS = "EXTENDS"
    IMPORTS = "IMPORTS"
    DEFINES = "DEFINES"
    DEFINES_METHOD = "DEFINES_METHOD"

    @property
    def code(self) -> int:
        return _EDGE_CODES[self]


_EDGE_CODES: dict[EdgeType, int] = {e: i for i, e in enumerate(EdgeType)}
