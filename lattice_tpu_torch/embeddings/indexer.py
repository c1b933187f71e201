"""Vector indexing + search over the two chunk collections (torch port).

Port of `lattice_tpu/embeddings/indexer.py`: two `ChunkStore` instances
(`code`, `summaries`) on one explicit device, `VectorIndexer` to write
them and `VectorSearcher` to read them. `index_file` takes a parsed file
through the reference's steps: content-hash check, `delete_file`,
`CodeChunker.chunk_file`, `Embedder.embed_with_progress`, `ChunkStore.add`.
With an on-device provider (`embed_batch_device`) the vectors reach the
store as a device tensor, with no host round trip.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattice_tpu_torch.embeddings.chunker import CodeChunker
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.index.chunk_store import ChunkStore, query_token_set
from lattice_tpu_torch.parsing.models import ParsedFile


@dataclass(slots=True)
class VectorSearchResult:
    """Reference: typed search result (`embeddings/indexer.py:162-200`)."""

    row: int
    score: float
    name: str
    content: str
    entity_type: str
    file_path: str
    language: str
    start_line: int
    end_line: int
    graph_node_id: str
    docstring: str | None = None
    signature: str | None = None


class VectorIndexer:
    def __init__(self, embedder: Embedder, chunker: CodeChunker | None = None,
                 dtype: str = "float32", initial_capacity: int = 1024,
                 device: str | torch.device = "cuda"):
        self.embedder = embedder
        self.chunker = chunker or CodeChunker()
        self.code = ChunkStore(embedder.dimensions, dtype=dtype,
                               initial_capacity=initial_capacity,
                               device=device)
        self.summaries = ChunkStore(embedder.dimensions, dtype=dtype,
                                    initial_capacity=max(initial_capacity // 4, 8),
                                    device=device)
        self.stats = {"files_indexed": 0, "files_skipped": 0,
                      "chunks_indexed": 0, "summaries_indexed": 0}

    # ---- indexing ------------------------------------------------------

    def file_needs_update(self, file_path: str, content_hash: str) -> bool:
        return self.code.file_needs_update(file_path, content_hash)

    def index_file(self, parsed: ParsedFile, project_name: str | None = None,
                   force: bool = False) -> int:
        """Chunk, embed, and upsert one file. Returns chunks written.

        Reference: `embeddings/indexer.py:46-118`.
        """
        info = parsed.file_info
        if not force and not self.file_needs_update(info.relative_path,
                                                    info.content_hash):
            self.stats["files_skipped"] += 1
            return 0
        self.code.delete_file(info.relative_path)
        chunks = self.chunker.chunk_file(parsed, project_name)
        if not chunks:
            return 0
        vectors = self.embedder.embed_with_progress([c.content for c in chunks])
        payloads = [c.to_payload() for c in chunks]
        self.code.add(vectors, payloads)
        self.stats["files_indexed"] += 1
        self.stats["chunks_indexed"] += len(chunks)
        return len(chunks)

    def index_summary(self, entity_qn: str, summary: str, file_path: str,
                      entity_type: str, language: str = "",
                      project_name: str | None = None,
                      content_hash: str = "") -> None:
        """Reference: `embeddings/indexer.py:120-152`."""
        vec = self.embedder.embed(summary)
        self.summaries.add(vec[None, :], [{
            "content": summary,
            "name": entity_qn,
            "graph_node_id": entity_qn,
            "entity_type": entity_type,
            "file_path": file_path,
            "language": language,
            "project_name": project_name,
            "content_hash": content_hash,
            "start_line": 0,
            "end_line": 0,
        }])
        self.stats["summaries_indexed"] += 1

    def delete_file(self, file_path: str) -> int:
        n = self.code.delete_file(file_path)
        n += self.summaries.delete_file(file_path)
        return n

    def clear(self) -> None:
        self.code.clear()
        self.summaries.clear()


class VectorSearcher:
    """Reference: `embeddings/indexer.py:162-257`."""

    def __init__(self, indexer: VectorIndexer, embedder: Embedder | None = None):
        self.indexer = indexer
        self.embedder = embedder or indexer.embedder

    def _materialize(self, hits) -> list[VectorSearchResult]:
        out = []
        for row, score, payload in hits:
            out.append(VectorSearchResult(
                row=row, score=score,
                name=payload.get("name", ""),
                content=payload.get("content", ""),
                entity_type=payload.get("entity_type", ""),
                file_path=payload.get("file_path", ""),
                language=payload.get("language", ""),
                start_line=payload.get("start_line", 0),
                end_line=payload.get("end_line", 0),
                graph_node_id=payload.get("graph_node_id", ""),
                docstring=payload.get("docstring"),
                signature=payload.get("signature"),
            ))
        return out

    def search_code(self, query: str, limit: int = 15,
                    filters: dict | None = None) -> list[VectorSearchResult]:
        qvec = self.embedder.embed(query)
        hits = self.indexer.code.search(qvec[None, :], k=limit, filters=filters)
        return self._materialize(hits[0])

    def search_lexical(self, query: str, limit: int = 15,
                       filters: dict | None = None
                       ) -> list[VectorSearchResult]:
        """Exact-identifier channel: rows whose entity-name tokens the
        query names in plain words (IDF-weighted name coverage)."""
        tokens = query_token_set(query)
        if not tokens:
            return []
        hits = [(row, score, self.indexer.code.payload(row) or {})
                for row, score in self.indexer.code.lexical_candidates(
                    tokens, limit=limit, filters=filters)]
        return self._materialize(hits)

    def search_summaries(self, query: str, limit: int = 10,
                         filters: dict | None = None) -> list[VectorSearchResult]:
        qvec = self.embedder.embed(query)
        hits = self.indexer.summaries.search(qvec[None, :], k=limit,
                                             filters=filters)
        return self._materialize(hits[0])
