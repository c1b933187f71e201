"""Extractor base class.

Parity target: reference `src/lattice/parsing/extractors/base.py:13-60`
(an ABC over tree-sitter nodes with text/line helpers). tree-sitter is not
available in this environment, so each extractor owns its parsing strategy
(stdlib `ast` for Python; a masking lexer + structural scanner for JS/TS)
and this base only fixes the contract plus shared text utilities.
"""

from __future__ import annotations

import abc

from lattice_tpu_torch.core.types import Language
from lattice_tpu_torch.parsing.models import CodeEntity, ImportInfo


class BaseExtractor(abc.ABC):
    """Contract: given source text + module QN, produce imports and entities.

    Reference ABC methods: `extract_imports`, `extract_entities`
    (`extractors/base.py:10-12`).
    """

    language: Language = Language.UNKNOWN

    @abc.abstractmethod
    def extract_imports(self, source: str) -> list[ImportInfo]: ...

    @abc.abstractmethod
    def extract_entities(self, source: str, module_qn: str) -> list[CodeEntity]: ...

    # ---- shared helpers ------------------------------------------------

    @staticmethod
    def slice_lines(source_lines: list[str], start_line: int, end_line: int) -> str:
        """Return source text for 1-based inclusive line range.

        Reference analog: node text slicing (`extractors/base.py:13-20`).
        """
        return "\n".join(source_lines[start_line - 1:end_line])

    @staticmethod
    def clean_string_literal(text: str) -> str:
        """Strip quotes/prefixes off a string literal.

        Reference: `extractors/base.py:44-53`.
        """
        t = text.strip()
        for prefix in ("r", "b", "u", "f", "rb", "br"):
            if t.lower().startswith(prefix) and len(t) > len(prefix) and t[len(prefix)] in "'\"":
                t = t[len(prefix):]
                break
        for quote in ('"""', "'''", '"', "'", "`"):
            if t.startswith(quote) and t.endswith(quote) and len(t) >= 2 * len(quote):
                return t[len(quote):-len(quote)]
        return t
