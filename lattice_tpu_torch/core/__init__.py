from lattice_tpu_torch.core.types import (
    EdgeType,
    EntityType,
    Language,
    PipelineStage,
    QueryType,
    ResultSource,
)
from lattice_tpu_torch.core.errors import (
    CodeRAGError,
    ConfigurationError,
    EmbeddingError,
    GraphError,
    IndexingError,
    KernelError,
    LatticeError,
    MetadataError,
    ParsingError,
    QueryError,
    StorageError,
    SummarizationError,
    VectorStoreError,
)
from lattice_tpu_torch.core.cache import ASTCache, BoundedCache, FunctionRegistry

__all__ = [
    "ASTCache", "BoundedCache", "CodeRAGError", "ConfigurationError",
    "EdgeType", "EmbeddingError", "EntityType", "FunctionRegistry",
    "GraphError", "IndexingError", "KernelError", "Language", "LatticeError",
    "MetadataError", "ParsingError", "PipelineStage", "QueryError",
    "QueryType", "ResultSource", "StorageError", "SummarizationError",
    "VectorStoreError",
]
