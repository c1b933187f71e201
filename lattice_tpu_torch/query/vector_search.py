"""Semantic search facade (parity name).

Parity target: reference `src/lattice/query/vector_search.py:60-118`
(`VectorSearcher.search_code/search_summaries`). The implementation lives in
`embeddings/indexer.py` next to the store it queries; this module keeps the
reference's import location working.
"""

from lattice_tpu_torch.embeddings.indexer import VectorSearcher, VectorSearchResult

__all__ = ["VectorSearcher", "VectorSearchResult"]
