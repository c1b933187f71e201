"""TypeScript extractor: extends the JavaScript extractor.

Parity target: reference `src/lattice/parsing/extractors/typescript.py:7-113`
— `import type` dedup, `interface_declaration` -> EntityType.INTERFACE with
extends clause, `type_alias_declaration` -> TYPE_ALIAS.
"""

from __future__ import annotations

import re

from lattice_tpu_torch.core.types import EntityType, Language
from lattice_tpu_torch.parsing.extractors.javascript import (
    JavaScriptExtractor,
    _IDENT,
    _Lines,
    find_matching,
    mask_source,
)
from lattice_tpu_torch.parsing.models import CodeEntity, ImportInfo

_INTERFACE_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:declare\s+)?interface\s+(" + _IDENT + r")"
    r"(?:\s*<[^{]*?>)?"
    r"(?:\s+extends\s+([^{]+?))?\s*\{",
    re.MULTILINE,
)
_TYPE_ALIAS_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:declare\s+)?type\s+(" + _IDENT + r")"
    r"(?:\s*<[^=\n]*?>)?\s*=",
    re.MULTILINE,
)
_ENUM_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:declare\s+)?(?:const\s+)?enum\s+(" + _IDENT + r")\s*\{",
    re.MULTILINE,
)


class TypeScriptExtractor(JavaScriptExtractor):
    language = Language.TYPESCRIPT

    def extract_imports(self, source: str) -> list[ImportInfo]:
        """Dedup `import type` against value imports of the same module.

        Reference: `extractors/typescript.py:7-41`.
        """
        imports = super().extract_imports(source)
        value_modules = {i.module for i in imports if not i.is_type_only}
        out: list[ImportInfo] = []
        for imp in imports:
            if imp.is_type_only and imp.module in value_modules:
                continue
            out.append(imp)
        return out

    def extract_entities(self, source: str, module_qn: str) -> list[CodeEntity]:
        entities = super().extract_entities(source, module_qn)
        masked = mask_source(source)
        lines = _Lines(source)
        source_lines = source.splitlines()

        for m in _INTERFACE_RE.finditer(masked):
            name = m.group(1)
            extends = m.group(2)
            open_pos = masked.find("{", m.end() - 1)
            close = find_matching(masked, open_pos) if open_pos != -1 else -1
            if close == -1:
                close = len(masked) - 1
            start_line = lines.line(m.start())
            end_line = lines.line(close)
            bases = []
            if extends:
                bases = [re.sub(r"<.*", "", b).strip()
                         for b in extends.split(",") if b.strip()]
            entities.append(CodeEntity(
                name=name,
                entity_type=EntityType.INTERFACE,
                qualified_name=f"{module_qn}.{name}" if module_qn else name,
                signature=" ".join(source[m.start():open_pos].split()),
                docstring=self._jsdoc_above(source_lines, start_line),
                code=self.slice_lines(source_lines, start_line, end_line),
                start_line=start_line,
                end_line=end_line,
                base_classes=bases,
            ))

        for m in _TYPE_ALIAS_RE.finditer(masked):
            name = m.group(1)
            start_line = lines.line(m.start())
            # extent: to the terminating ';' at depth 0 (or end of line run)
            end_off = self._entity_extent(masked, m.end())
            end_line = lines.line(max(end_off - 1, m.start()))
            entities.append(CodeEntity(
                name=name,
                entity_type=EntityType.TYPE_ALIAS,
                qualified_name=f"{module_qn}.{name}" if module_qn else name,
                signature=" ".join(source[m.start():end_off].split())[:200],
                docstring=self._jsdoc_above(source_lines, start_line),
                code=self.slice_lines(source_lines, start_line, end_line),
                start_line=start_line,
                end_line=end_line,
            ))

        for m in _ENUM_RE.finditer(masked):
            name = m.group(1)
            open_pos = masked.find("{", m.end() - 1)
            close = find_matching(masked, open_pos) if open_pos != -1 else -1
            if close == -1:
                close = len(masked) - 1
            start_line = lines.line(m.start())
            end_line = lines.line(close)
            entities.append(CodeEntity(
                name=name,
                entity_type=EntityType.TYPE_ALIAS,
                qualified_name=f"{module_qn}.{name}" if module_qn else name,
                signature=" ".join(source[m.start():open_pos].split()),
                code=self.slice_lines(source_lines, start_line, end_line),
                start_line=start_line,
                end_line=end_line,
            ))

        entities.sort(key=lambda e: e.start_line)
        return entities
