"""Language-dispatching source parser.

Parity target: reference `src/lattice/parsing/parser.py:21-91` — lazy
per-language parser cache, `parse_file` (read + extract imports/entities),
`parse_content` for in-memory strings (the test workhorse).

tree-sitter is not available in this environment, so the extractors carry
their own parsing strategies (see extractors/*.py); this module keeps the
same dispatch surface, the AST cache, and the error discipline.
"""

from __future__ import annotations

import logging
from pathlib import Path

from lattice_tpu_torch.core.cache import ASTCache
from lattice_tpu_torch.core.errors import ParsingError
from lattice_tpu_torch.core.types import Language
from lattice_tpu_torch.parsing.extractors.base import BaseExtractor
from lattice_tpu_torch.parsing.extractors.javascript import JavaScriptExtractor
from lattice_tpu_torch.parsing.extractors.python import PythonExtractor
from lattice_tpu_torch.parsing.extractors.typescript import TypeScriptExtractor
from lattice_tpu_torch.parsing.models import FileInfo, ParsedFile, module_qname

logger = logging.getLogger(__name__)

# Reference LANGUAGE_MAP: `parsing/parser.py:21-27` (5 wired languages).
EXTRACTOR_CLASSES: dict[Language, type[BaseExtractor]] = {
    Language.PYTHON: PythonExtractor,
    Language.JAVASCRIPT: JavaScriptExtractor,
    Language.JSX: JavaScriptExtractor,
    Language.TYPESCRIPT: TypeScriptExtractor,
    Language.TSX: TypeScriptExtractor,
}


class CodeParser:
    """Parse source files into `ParsedFile` records."""

    def __init__(self, ast_cache: ASTCache | None = None):
        self._extractors: dict[Language, BaseExtractor] = {}
        self.ast_cache = ast_cache if ast_cache is not None else ASTCache()

    def supports(self, language: Language) -> bool:
        return language in EXTRACTOR_CLASSES

    def _extractor(self, language: Language) -> BaseExtractor:
        """Lazy per-language extractor cache (reference `parser.py:39-43`)."""
        ext = self._extractors.get(language)
        if ext is None:
            cls = EXTRACTOR_CLASSES.get(language)
            if cls is None:
                raise ParsingError(f"unsupported language: {language.value}")
            ext = cls()
            self._extractors[language] = ext
        return ext

    def parse_file(self, file_info: FileInfo) -> ParsedFile:
        """Reference: `parsing/parser.py:58-67`."""
        try:
            source = Path(file_info.path).read_text(encoding="utf-8", errors="replace")
        except OSError as exc:
            raise ParsingError(
                f"cannot read {file_info.path}", file_path=str(file_info.path), cause=exc
            ) from exc
        return self._parse(source, file_info)

    def parse_content(self, source: str, language: Language,
                      relative_path: str = "memory.src") -> ParsedFile:
        """Parse an in-memory string. Reference: `parsing/parser.py:69-78`."""
        file_info = FileInfo(
            path=Path(relative_path),
            relative_path=relative_path,
            language=language,
            size_bytes=len(source),
        )
        return self._parse(source, file_info)

    def _parse(self, source: str, file_info: FileInfo) -> ParsedFile:
        # A UTF-8 BOM decoded as text arrives as a leading U+FEFF:
        # `ast.parse` rejects it outright (0 entities for the whole
        # file) and the JS/TS lexer's line-start keyword match misses
        # the first construct. Real repos ship BOM files; strip it.
        if source.startswith("﻿"):
            source = source[1:]
        extractor = self._extractor(file_info.language)
        parsed = ParsedFile(file_info=file_info)
        module_qn = module_qname(file_info.relative_path)
        try:
            parsed.imports = extractor.extract_imports(source)
        except Exception as exc:  # extraction must never take down the pipeline
            logger.warning("import extraction failed for %s: %s", file_info.path, exc)
            parsed.parse_errors.append(f"imports: {exc}")
        try:
            parsed.entities = extractor.extract_entities(source, module_qn)
        except Exception as exc:
            logger.warning("entity extraction failed for %s: %s", file_info.path, exc)
            parsed.parse_errors.append(f"entities: {exc}")
        self.ast_cache.put(Path(file_info.path), (parsed, file_info.language))
        return parsed
