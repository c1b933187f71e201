"""Entity-aligned code chunking.

Parity target: reference `src/lattice/embeddings/chunker.py:13-217`:
- one chunk per entity when it fits the token budget (`:50-53`)
- otherwise a line-accumulating split with a token-budgeted overlap tail,
  chunk names suffixed `_part{n}` (`:135-217`, `:162`)
- whole-file fallback when a file has no entities (`:71-82`)
- `CodeChunk.to_payload()` including `graph_node_id` = entity QN, the
  vector->graph link (`:13-37`)

tiktoken cannot fetch its vocab offline, so counting goes through the
`TokenCounter` seam (`text/tokenizer.py`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any

from lattice_tpu_torch.config.settings import IndexingSettings
from lattice_tpu_torch.core.types import EntityType
from lattice_tpu_torch.parsing.models import CodeEntity, ParsedFile
from lattice_tpu_torch.text.tokenizer import get_token_counter

# Entity kinds that become chunks (imports are graph-only).
_CHUNKABLE = {
    EntityType.CLASS, EntityType.FUNCTION, EntityType.METHOD,
    EntityType.INTERFACE, EntityType.TYPE_ALIAS,
}

# Uncovered-code safety net: a run of this many non-blank, non-comment
# lines claimed by NO entity still becomes a chunk. This guards against
# silent extractor misses (VERDICT r1: a lexer edge case must degrade to
# coarser chunking, never to unsearchable code) — and improves on the
# reference, whose whole-file fallback fires only when a file has zero
# entities (`chunker.py:71-82`), losing module-level code in files that
# have any.
GAP_MIN_LINES = 8


@dataclass(slots=True)
class CodeChunk:
    """Reference: `embeddings/chunker.py:13-37`."""

    content: str
    name: str
    chunk_type: str               # entity type value or "file"
    file_path: str
    language: str
    start_line: int
    end_line: int
    graph_node_id: str            # entity QN linking vector -> graph
    content_hash: str             # file-level hash for incremental indexing
    part: int = 0
    project_name: str | None = None
    docstring: str | None = None
    signature: str | None = None

    def to_payload(self) -> dict[str, Any]:
        return {
            "content": self.content,
            "name": self.name,
            "entity_type": self.chunk_type,
            "file_path": self.file_path,
            "language": self.language,
            "start_line": self.start_line,
            "end_line": self.end_line,
            "graph_node_id": self.graph_node_id,
            "content_hash": self.content_hash,
            "part": self.part,
            "project_name": self.project_name,
            "docstring": self.docstring,
            "signature": self.signature,
        }

    @property
    def chunk_id(self) -> str:
        """Stable id for dedup: file + node + part + content digest."""
        digest = hashlib.sha256(self.content.encode()).hexdigest()[:12]
        return f"{self.file_path}::{self.graph_node_id}::{self.part}::{digest}"


class CodeChunker:
    def __init__(self, settings: IndexingSettings | None = None,
                 token_counter=None):
        settings = settings or IndexingSettings()
        self.max_tokens = settings.chunk_max_tokens
        self.overlap_tokens = settings.chunk_overlap_tokens
        # native C++ BPE when a merges file is configured, approx otherwise
        self.counter = token_counter or get_token_counter(
            settings.tokenizer_vocab)

    def chunk_file(self, parsed: ParsedFile,
                   project_name: str | None = None) -> list[CodeChunk]:
        """Reference: `chunker.py:55-133`."""
        info = parsed.file_info
        chunks: list[CodeChunk] = []
        entities = [e for e in parsed.all_entities if e.entity_type in _CHUNKABLE]
        if not entities:
            # Whole-file fallback (`chunker.py:71-82`).
            try:
                content = info.path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                content = ""
            if content.strip():
                chunks.extend(self._split(
                    content=content,
                    name=info.module_name or info.relative_path,
                    chunk_type="file",
                    start_line=1,
                    graph_node_id=info.module_name,
                    info=info,
                    project_name=project_name,
                ))
            return chunks
        for entity in entities:
            chunks.extend(self.chunk_entity(entity, parsed, project_name))
        chunks.extend(self._gap_chunks(parsed, project_name))
        return chunks

    @staticmethod
    def _is_commentish(line: str) -> bool:
        s = line.strip()
        return (not s or s.startswith(("#", "//", "/*", "*", '"""', "'''"))
                or s in ("}", ");", "};"))

    def _gap_chunks(self, parsed: ParsedFile,
                    project_name: str | None) -> list[CodeChunk]:
        """Chunk substantial source regions no entity claims."""
        info = parsed.file_info
        try:
            content = info.path.read_text(encoding="utf-8", errors="replace")
        except OSError:
            return []
        lines = content.splitlines()
        covered = [False] * (len(lines) + 2)
        for e in parsed.all_entities:
            lo = max(int(e.start_line or 1), 1)
            hi = min(int(e.end_line or lo), len(lines))
            for i in range(lo, hi + 1):
                covered[i] = True
        for imp in parsed.imports:
            if 1 <= imp.line <= len(lines):
                covered[imp.line] = True
        out: list[CodeChunk] = []
        run_start: int | None = None
        for i in range(1, len(lines) + 2):
            uncovered = i <= len(lines) and not covered[i]
            if uncovered and run_start is None:
                run_start = i
            elif not uncovered and run_start is not None:
                seg = lines[run_start - 1:i - 1]
                significant = sum(
                    1 for ln in seg if not self._is_commentish(ln))
                if significant >= GAP_MIN_LINES:
                    out.extend(self._split(
                        content="\n".join(seg),
                        name=f"{info.module_name}.segment_L{run_start}",
                        chunk_type="file",
                        start_line=run_start,
                        graph_node_id=info.module_name,
                        info=info,
                        project_name=project_name,
                    ))
                run_start = None
        return out

    def chunk_entity(self, entity: CodeEntity, parsed: ParsedFile,
                     project_name: str | None = None) -> list[CodeChunk]:
        info = parsed.file_info
        return self._split(
            content=entity.code,
            name=entity.qualified_name or entity.name,
            chunk_type=entity.entity_type.value,
            start_line=entity.start_line,
            graph_node_id=entity.qualified_name,
            info=info,
            project_name=project_name,
            docstring=entity.docstring,
            signature=entity.signature,
        )

    def _split(self, *, content: str, name: str, chunk_type: str,
               start_line: int, graph_node_id: str, info,
               project_name: str | None, docstring: str | None = None,
               signature: str | None = None) -> list[CodeChunk]:
        total = self.counter.count(content)
        lines = content.splitlines()
        if total <= self.max_tokens:
            return [CodeChunk(
                content=content, name=name, chunk_type=chunk_type,
                file_path=info.relative_path, language=info.language.value,
                start_line=start_line,
                end_line=start_line + max(len(lines) - 1, 0),
                graph_node_id=graph_node_id, content_hash=info.content_hash,
                part=0, project_name=project_name, docstring=docstring,
                signature=signature,
            )]
        # Oversized: accumulate lines up to the budget, then start the next
        # part with an overlap tail bounded by overlap_tokens
        # (`chunker.py:135-217`).
        chunks: list[CodeChunk] = []
        cur: list[str] = []
        cur_tokens = 0
        cur_start = start_line
        line_tokens = [self.counter.count(ln) + 1 for ln in lines]

        def flush(next_start_idx: int) -> None:
            nonlocal cur, cur_tokens, cur_start
            if not cur:
                return
            part = len(chunks)
            chunks.append(CodeChunk(
                content="\n".join(cur),
                name=f"{name}_part{part}" if (part or total > self.max_tokens) else name,
                chunk_type=chunk_type,
                file_path=info.relative_path, language=info.language.value,
                start_line=cur_start, end_line=cur_start + len(cur) - 1,
                graph_node_id=graph_node_id, content_hash=info.content_hash,
                part=part, project_name=project_name, docstring=docstring,
                signature=signature,
            ))
            # Overlap tail: last lines totalling <= overlap_tokens.
            tail: list[str] = []
            tail_tokens = 0
            i = len(cur) - 1
            while i >= 0 and tail_tokens + line_tokens_of(cur[i]) <= self.overlap_tokens:
                tail_tokens += line_tokens_of(cur[i])
                tail.append(cur[i])
                i -= 1
            tail.reverse()
            cur_start = cur_start + len(cur) - len(tail)
            cur = tail
            cur_tokens = tail_tokens

        def line_tokens_of(line: str) -> int:
            return self.counter.count(line) + 1

        for idx, (line, lt) in enumerate(zip(lines, line_tokens)):
            if cur_tokens + lt > self.max_tokens and cur:
                flush(idx)
            cur.append(line)
            cur_tokens += lt
        if cur:
            part = len(chunks)
            chunks.append(CodeChunk(
                content="\n".join(cur),
                name=f"{name}_part{part}",
                chunk_type=chunk_type,
                file_path=info.relative_path, language=info.language.value,
                start_line=cur_start, end_line=cur_start + len(cur) - 1,
                graph_node_id=graph_node_id, content_hash=info.content_hash,
                part=part, project_name=project_name, docstring=docstring,
                signature=signature,
            ))
        return chunks
