"""Layered configuration for lattice_tpu_torch.

A copy of `lattice_tpu/config/settings.py` with `dataclasses` in place of
pydantic, which the machine with the card does not have. The sections,
fields, defaults, flat properties, `.env` parser and env keys are the
reference's, so one `.env` gives both packages the same values. The
reference's validators run in `__post_init__`, at construction, as
pydantic runs them:
- `AISettings`: `embedding_dimensions` in [1, 4096], else `ValueError`;
- `IndexingSettings`: `chunk_overlap_tokens` below `chunk_max_tokens`,
  else `ValueError` (pydantic's `ValidationError` is one too);
- `FileSettings`: an extension without its leading "." is given one.

`DeviceSettings` keeps the reference's fields so that the orchestrator's
store-dtype rule reads the same values; where a store lives is not a
setting here: every entry point takes its `device` by argument.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path


def _load_env_file(path: Path) -> dict[str, str]:
    """Minimal .env parser: KEY=VALUE lines, '#' comments, optional quotes."""
    out: dict[str, str] = {}
    if not path.is_file():
        return out
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip().strip("'\"")
        out[key.strip()] = value
    return out


def _env(env: dict[str, str], key: str, default: str | None = None) -> str | None:
    return os.environ.get(key, env.get(key, default))


@dataclass
class DeviceSettings:
    """The reference's execution block, field for field."""

    platform: str = "auto"          # auto | tpu | cpu
    mesh_shape: tuple[int, ...] = (1,)
    mesh_axes: tuple[str, ...] = ("data",)
    index_dtype: str = "bfloat16"   # dtype of the resident embedding matrix
    use_pallas: bool = True


@dataclass
class AISettings:
    """Provider selection. Reference: `config/settings.py:34-64`."""

    llm_provider: str = "none"            # openai|anthropic|google|ollama|none
    embedding_provider: str = "hash"      # hash|unixcoder|openai|google|ollama
    llm_model: str | None = None
    embedding_model: str | None = None
    embedding_dimensions: int = 768       # UniXcoder dim (reference `unixcoder_provider.py:229`)
    openai_api_key: str | None = None
    anthropic_api_key: str | None = None
    google_api_key: str | None = None
    ollama_base_url: str = "http://localhost:11434"
    unixcoder_weights: str | None = None  # path to HF unixcoder-base dir, optional

    def __post_init__(self) -> None:
        # Reference validator caps dims at 4096 (`settings.py:57-62`).
        if not (1 <= self.embedding_dimensions <= 4096):
            raise ValueError("embedding_dimensions must be in [1, 4096]")


@dataclass
class IndexingSettings:
    """Reference: `config/settings.py:65-89`."""

    batch_size: int = 100
    max_concurrent: int = 5
    chunk_max_tokens: int = 1000
    chunk_overlap_tokens: int = 200
    parse_workers: int = 0  # 0 = min(cpu, 8) like `orchestrator.py:87`
    embed_batch_size: int = 256  # device batch for on-device embedding
    # Optional merges.txt for exact token counting via the C++ BPE engine
    # (tiktoken replacement, SURVEY §2.3); approximate counter otherwise.
    tokenizer_vocab: str | None = None

    def __post_init__(self) -> None:
        # Reference validator: overlap < max tokens (`settings.py:78-87`).
        if self.chunk_overlap_tokens >= self.chunk_max_tokens:
            raise ValueError("chunk_overlap_tokens must be < chunk_max_tokens")


@dataclass
class FileSettings:
    """Reference: `config/settings.py:90-123`."""

    extensions: list[str] = field(default_factory=lambda: [
        ".py", ".pyi", ".js", ".mjs", ".cjs", ".jsx", ".ts", ".mts", ".tsx",
    ])
    ignore_patterns: list[str] = field(default_factory=lambda: [
        "*/node_modules/*", "*/.git/*", "*/__pycache__/*", "*/venv/*",
        "*/.venv/*", "*/dist/*", "*/build/*", "*/.mypy_cache/*",
        "*/.pytest_cache/*", "*.min.js", "*/target/*", "*/.tox/*",
    ])
    max_file_size_mb: float = 4.0

    def __post_init__(self) -> None:
        # Reference validator: extensions must start with '.' (`settings.py:115-121`).
        self.extensions = [e if e.startswith(".") else f".{e}"
                           for e in self.extensions]


@dataclass
class QuerySettings:
    """Reference: `config/settings.py:124-138`."""

    search_limit: int = 15
    max_vector_results: int = 20
    max_centrality_lookups: int = 10
    max_hops: int = 5
    max_results_per_query: int = 50
    max_path_length: int = 10
    max_results_per_file: int = 5


@dataclass
class StorageSettings:
    """Local persistence (replaces PostgresSettings, `config/settings.py:139-165`)."""

    data_dir: str = ".lattice"
    metadata_db: str = "metadata.sqlite3"   # SQLite replaces Postgres JSONB
    index_manifest: str = "manifest.json"


@dataclass
class MetadataSettings:
    """Reference: `config/settings.py:166-180`."""

    enabled: bool = True
    generator: str = "local"   # local (heuristic) | agent (LLM-driven, gated)
    max_budget_usd: float = 1.0


@dataclass
class Settings:
    """Composed settings. Reference: `config/settings.py:181-277`."""

    device: DeviceSettings = field(default_factory=DeviceSettings)
    ai: AISettings = field(default_factory=AISettings)
    indexing: IndexingSettings = field(default_factory=IndexingSettings)
    files: FileSettings = field(default_factory=FileSettings)
    query: QuerySettings = field(default_factory=QuerySettings)
    storage: StorageSettings = field(default_factory=StorageSettings)
    metadata: MetadataSettings = field(default_factory=MetadataSettings)

    # Flat back-compat properties, mirroring `settings.py:216-277`.
    @property
    def embedding_dimensions(self) -> int:
        return self.ai.embedding_dimensions

    @property
    def chunk_max_tokens(self) -> int:
        return self.indexing.chunk_max_tokens

    @property
    def chunk_overlap_tokens(self) -> int:
        return self.indexing.chunk_overlap_tokens

    @property
    def search_limit(self) -> int:
        return self.query.search_limit

    @property
    def max_concurrent(self) -> int:
        return self.indexing.max_concurrent

    @classmethod
    def from_env(cls, env_file: Path | str = ".env") -> "Settings":
        env = _load_env_file(Path(env_file))

        def g(key: str, default: str | None = None) -> str | None:
            return _env(env, key, default)

        def gi(key: str, default: int) -> int:
            raw = g(key)
            return int(raw) if raw is not None else default

        return cls(
            device=DeviceSettings(
                platform=g("LATTICE_PLATFORM", "auto") or "auto",
                index_dtype=g("LATTICE_INDEX_DTYPE", "bfloat16") or "bfloat16",
                use_pallas=(g("LATTICE_USE_PALLAS", "1") or "1") not in ("0", "false"),
            ),
            ai=AISettings(
                llm_provider=g("LLM_PROVIDER", "none") or "none",
                embedding_provider=g("EMBEDDING_PROVIDER", "hash") or "hash",
                llm_model=g("LLM_MODEL"),
                embedding_model=g("EMBEDDING_MODEL"),
                embedding_dimensions=gi("EMBEDDING_DIMENSIONS", 768),
                openai_api_key=g("OPENAI_API_KEY"),
                anthropic_api_key=g("ANTHROPIC_API_KEY"),
                google_api_key=g("GOOGLE_API_KEY"),
                ollama_base_url=g("OLLAMA_BASE_URL", "http://localhost:11434")
                or "http://localhost:11434",
                unixcoder_weights=g("UNIXCODER_WEIGHTS"),
            ),
            indexing=IndexingSettings(
                batch_size=gi("INDEXING_BATCH_SIZE", 100),
                max_concurrent=gi("INDEXING_MAX_CONCURRENT", 5),
                chunk_max_tokens=gi("CHUNK_MAX_TOKENS", 1000),
                chunk_overlap_tokens=gi("CHUNK_OVERLAP_TOKENS", 200),
                embed_batch_size=gi("EMBED_BATCH_SIZE", 256),
                tokenizer_vocab=g("TOKENIZER_VOCAB"),
            ),
            query=QuerySettings(
                search_limit=gi("QUERY_SEARCH_LIMIT", 15),
                max_vector_results=gi("QUERY_MAX_VECTOR_RESULTS", 20),
                max_centrality_lookups=gi("QUERY_MAX_CENTRALITY_LOOKUPS", 10),
            ),
            storage=StorageSettings(
                data_dir=g("LATTICE_DATA_DIR", ".lattice") or ".lattice",
            ),
        )


@lru_cache(maxsize=1)
def get_settings() -> Settings:
    """Singleton accessor. Reference: `config/settings.py:279-281`."""
    return Settings.from_env()


def reset_settings() -> None:
    """Test helper: clear the cached singleton."""
    get_settings.cache_clear()
