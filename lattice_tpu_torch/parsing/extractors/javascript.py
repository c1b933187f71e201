"""JavaScript entity/import extractor.

Parity target: reference `src/lattice/parsing/extractors/javascript.py:10-301`
(tree-sitter based): ES imports incl. default/named/aliased/namespace,
CommonJS `require()`, function declarations, arrow functions bound via
`const`, classes with heritage, methods with `static`, export-statement
unwrapping, JSDoc scanned from the lines above a node, and call collection.

tree-sitter is unavailable here, so this extractor is a two-stage design:

1. a **masking lexer** — a character state machine that blanks out comment
   bodies, string contents, template-literal text (recursing into `${}`),
   and regex literals while preserving every offset and newline, so that
2. a **structural scanner** — regex anchors + brace matching over the
   masked text — can find declarations and their exact extents without
   being fooled by braces or keywords inside strings/comments.

Offsets in the masked text equal offsets in the original, so entity code
and docstrings are sliced from the original source.
"""

from __future__ import annotations

import bisect
import re

from lattice_tpu_torch.core.types import EntityType, Language
from lattice_tpu_torch.parsing.extractors.base import BaseExtractor
from lattice_tpu_torch.parsing.models import CodeEntity, ImportInfo

_IDENT = r"[A-Za-z_$][A-Za-z0-9_$]*"

_KEYWORDS_NOT_CALLS = frozenset({
    "if", "for", "while", "switch", "catch", "return", "typeof", "function",
    "do", "else", "new", "delete", "void", "in", "of", "instanceof", "yield",
    "await", "throw", "case", "with",
})

# Contextual keywords like `of`/`get` ARE valid method names; only control
# keywords can never head a class-body method.
_NOT_METHOD_NAMES = frozenset({
    "if", "for", "while", "switch", "catch", "return", "typeof", "function",
    "do", "else", "new", "delete", "void", "instanceof", "yield",
    "await", "throw", "case", "with", "super",
})

# Context before '/' that makes it a regex literal rather than division.
_REGEX_PREFIX = frozenset("=([{,;:!&|?+-*%^~<>")


def mask_source(source: str) -> str:
    """Blank comments/strings/template text/regex bodies, preserving offsets.

    A mode-stack scanner: `code` (top level and inside `${}` interpolations,
    where expressions stay visible) and `template` (text masked). Template
    literals nest arbitrarily through interpolations.
    """
    n = len(source)
    out = list(source)
    i = 0
    last_significant = ""  # last non-space char in code mode
    # stack entries: ["code"] or ["template"] or ["interp", brace_depth]
    stack: list[list] = [["code"]]

    def blank(a: int, b: int) -> None:
        for j in range(a, b):
            if out[j] != "\n":
                out[j] = " "

    while i < n:
        mode = stack[-1][0]
        c = source[i]

        if mode == "template":
            if c == "\\":
                out[i] = " "
                if i + 1 < n and source[i + 1] != "\n":
                    out[i + 1] = " "
                i += 2
                continue
            if c == "`":
                stack.pop()
                last_significant = "`"
                i += 1
                continue
            if c == "$" and i + 1 < n and source[i + 1] == "{":
                stack.append(["interp", 0])
                i += 2
                continue
            if c != "\n":
                out[i] = " "
            i += 1
            continue

        # code / interp modes share expression scanning
        if c == "/" and i + 1 < n:
            nxt = source[i + 1]
            if nxt == "/":
                j = source.find("\n", i)
                j = n if j == -1 else j
                blank(i, j)
                i = j
                continue
            if nxt == "*":
                j = source.find("*/", i + 2)
                j = n if j == -1 else j + 2
                blank(i, j)
                i = j
                continue
            # Regex literal heuristic: '/' in expression position.
            if last_significant == "" or last_significant in _REGEX_PREFIX:
                j = i + 1
                in_class = False
                while j < n:
                    cj = source[j]
                    if cj == "\\":
                        j += 2
                        continue
                    if cj == "[":
                        in_class = True
                    elif cj == "]":
                        in_class = False
                    elif cj == "/" and not in_class:
                        break
                    elif cj == "\n":
                        break  # not actually a regex
                    j += 1
                if j < n and source[j] == "/":
                    k = j + 1
                    while k < n and source[k].isalpha():
                        k += 1
                    blank(i + 1, j)
                    i = k
                    last_significant = "/"
                    continue
        if c in ("'", '"'):
            j = i + 1
            while j < n:
                if source[j] == "\\":
                    j += 2
                    continue
                if source[j] == c or source[j] == "\n":
                    break
                j += 1
            blank(i + 1, min(j, n))
            i = min(j + 1, n)
            last_significant = c
            continue
        if c == "`":
            stack.append(["template"])
            i += 1
            continue
        if mode == "interp":
            if c == "{":
                stack[-1][1] += 1
            elif c == "}":
                if stack[-1][1] == 0:
                    stack.pop()  # back to template text
                    i += 1
                    continue
                stack[-1][1] -= 1
        if not c.isspace():
            last_significant = c
        i += 1
    return "".join(out)


def find_matching(masked: str, open_pos: int, open_ch: str = "{",
                  close_ch: str = "}") -> int:
    """Index of the brace matching masked[open_pos]; -1 if unbalanced."""
    depth = 0
    for i in range(open_pos, len(masked)):
        c = masked[i]
        if c == open_ch:
            depth += 1
        elif c == close_ch:
            depth -= 1
            if depth == 0:
                return i
    return -1


class _Lines:
    """Offset -> 1-based line number via bisect over newline positions."""

    def __init__(self, source: str):
        self.newlines = [i for i, c in enumerate(source) if c == "\n"]

    def line(self, offset: int) -> int:
        return bisect.bisect_right(self.newlines, offset - 1) + 1


_IMPORT_RE = re.compile(
    r"^[ \t]*import\s+(type\s+)?([^;\n]*?)\s*from\s*(['\"])([^'\"\n]*)\3",
    re.MULTILINE,
)
_IMPORT_BARE_RE = re.compile(r"^[ \t]*import\s*(['\"])([^'\"\n]*)\1", re.MULTILINE)
_REQUIRE_RE = re.compile(
    r"(?:const|let|var)\s+(\{[^}]*\}|" + _IDENT + r")\s*=\s*require\s*\(\s*(['\"])"
    r"([^'\"\n]*)\2\s*\)",
)
_FUNC_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:default\s+)?(async\s+)?function\s*\*?\s*(" + _IDENT + r")\s*\(",
    re.MULTILINE,
)
_ARROW_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:const|let|var)\s+(" + _IDENT + r")\s*(?::[^=\n]+)?=\s*"
    r"(async\s+)?(?:\([^)]*\)|" + _IDENT + r")\s*(?::[^=\n{]+)?=>",
    re.MULTILINE,
)
_CLASS_RE = re.compile(
    r"^[ \t]*(?:export\s+)?(?:default\s+)?(?:abstract\s+)?class\s+(" + _IDENT + r")"
    r"(?:\s*<[^{]*?>)?"
    r"(?:\s+extends\s+([A-Za-z_$][\w$.]*)(?:\s*<[^{]*?>)?)?"
    r"(?:\s+implements\s+([^{]+?))?\s*\{",
    re.MULTILINE,
)
_METHOD_RE = re.compile(
    r"^[ \t]*(static\s+)?(async\s+)?(?:get\s+|set\s+)?\*?\s*(#?" + _IDENT + r")"
    r"\s*(?:<[^(\n]*?>)?\s*\(",
    re.MULTILINE,
)
_CALL_RE = re.compile(
    r"(?<![\w$.])(" + _IDENT + r"(?:\??\.(?:" + _IDENT + r"))*)\s*\(",
)
_NEW_RE = re.compile(r"\bnew\s+(" + _IDENT + r"(?:\." + _IDENT + r")*)")
_DECORATOR_RE = re.compile(r"^[ \t]*@(" + _IDENT + r"(?:\." + _IDENT + r")*)", re.MULTILINE)


class JavaScriptExtractor(BaseExtractor):
    language = Language.JAVASCRIPT

    # ---- imports -------------------------------------------------------

    def extract_imports(self, source: str) -> list[ImportInfo]:
        """ES imports + CommonJS require.

        Reference: `extractors/javascript.py:10-89`.
        """
        masked = mask_source(source)
        lines = _Lines(source)
        imports: list[ImportInfo] = []
        seen_spans: set[tuple[int, int]] = set()
        for m in _IMPORT_RE.finditer(masked):
            seen_spans.add(m.span())
            is_type = bool(m.group(1))
            clause = source[m.start(2):m.end(2)].strip()
            module = source[m.start(4):m.end(4)]
            names, alias = self._parse_import_clause(clause)
            imports.append(ImportInfo(
                module=module, names=names, alias=alias,
                is_relative=module.startswith("."),
                is_type_only=is_type,
                line=lines.line(m.start()),
            ))
        for m in _IMPORT_BARE_RE.finditer(masked):
            if any(a <= m.start() < b for a, b in seen_spans):
                continue
            module = source[m.start(2):m.end(2)]
            imports.append(ImportInfo(
                module=module, is_relative=module.startswith("."),
                line=lines.line(m.start()),
            ))
        for m in _REQUIRE_RE.finditer(masked):
            binding = source[m.start(1):m.end(1)].strip()
            module = source[m.start(3):m.end(3)]
            if binding.startswith("{"):
                names = [self._strip_alias(n)[0] for n in binding[1:-1].split(",") if n.strip()]
                alias = None
            else:
                names, alias = [], binding
            imports.append(ImportInfo(
                module=module, names=names, alias=alias,
                is_relative=module.startswith("."),
                line=lines.line(m.start()),
            ))
        return imports

    @staticmethod
    def _strip_alias(name: str) -> tuple[str, str | None]:
        name = name.strip()
        for sep in (" as ", ":"):
            if sep in name:
                orig, _, local = name.partition(sep)
                return orig.strip(), local.strip()
        return name, None

    def _parse_import_clause(self, clause: str) -> tuple[list[str], str | None]:
        """`Foo, { a, b as c }`, `* as ns`, `{ x }`, `Foo` -> names, alias."""
        names: list[str] = []
        alias: str | None = None
        clause = clause.strip()
        if not clause:
            return names, alias
        star = re.match(r"\*\s+as\s+(" + _IDENT + ")", clause)
        if star:
            return [], star.group(1)
        brace = clause.find("{")
        default_part = clause[:brace] if brace != -1 else clause
        default_part = default_part.strip().rstrip(",").strip()
        if default_part and re.fullmatch(_IDENT, default_part):
            names.append("default")
            alias = default_part
        if brace != -1:
            inner = clause[brace + 1: clause.rfind("}")]
            for item in inner.split(","):
                item = item.strip()
                if not item:
                    continue
                orig, _local = self._strip_alias(item.removeprefix("type ").strip())
                names.append(orig)
        return names, alias

    # ---- entities ------------------------------------------------------

    def extract_entities(self, source: str, module_qn: str) -> list[CodeEntity]:
        masked = mask_source(source)
        lines = _Lines(source)
        source_lines = source.splitlines()
        entities: list[CodeEntity] = []
        claimed: list[tuple[int, int]] = []  # extents claimed by classes

        for m in _CLASS_RE.finditer(masked):
            entity = self._class_entity(m, source, masked, lines, source_lines, module_qn)
            if entity is not None:
                entities.append(entity)
                claimed.append((m.start(), self._class_end_offset(m, masked)))

        def in_claimed(pos: int) -> bool:
            return any(a <= pos < b for a, b in claimed)

        for m in _FUNC_RE.finditer(masked):
            if in_claimed(m.start()):
                continue
            # Extent scan must start AT the open paren so depth stays balanced.
            entities.append(self._function_entity(
                _OffsetMatch(m.start(), m.end() - 1),
                name=m.group(2), is_async=bool(m.group(1)),
                source=source, masked=masked, lines=lines,
                source_lines=source_lines, parent_qn=module_qn,
                entity_type=EntityType.FUNCTION,
            ))
        for m in _ARROW_RE.finditer(masked):
            if in_claimed(m.start()):
                continue
            entities.append(self._function_entity(
                m, name=m.group(1), is_async=bool(m.group(2)),
                source=source, masked=masked, lines=lines,
                source_lines=source_lines, parent_qn=module_qn,
                entity_type=EntityType.FUNCTION,
            ))
        entities.sort(key=lambda e: e.start_line)
        return entities

    def _class_end_offset(self, m: re.Match, masked: str) -> int:
        open_pos = masked.find("{", m.end() - 1)
        close = find_matching(masked, open_pos)
        return close + 1 if close != -1 else len(masked)

    def _entity_extent(self, masked: str, header_end: int) -> int:
        """End offset of a function-ish entity starting at its header.

        If a `{` body follows, match braces; otherwise run to the end of the
        statement (`;` or newline at paren-depth 0).
        """
        i = header_end
        n = len(masked)
        depth = 0
        while i < n:
            c = masked[i]
            if c in "([":
                depth += 1
            elif c in ")]":
                depth -= 1
            elif c == "{" and depth == 0:
                close = find_matching(masked, i)
                return close + 1 if close != -1 else n
            elif c == ";" and depth == 0:
                return i + 1
            elif c == "\n" and depth == 0:
                # Arrow body expression may continue on operators; stop at
                # a newline not preceded by an operator.
                prev = masked[header_end:i].rstrip()
                if prev and prev[-1] not in "=>+-*/,.(&|?:":
                    return i
            i += 1
        return n

    def _jsdoc_above(self, source_lines: list[str], start_line: int) -> str | None:
        """Scan upward for a `/** ... */` block.

        Reference: JSDoc extraction by scanning lines above the node
        (`extractors/javascript.py:267-291`).
        """
        idx = start_line - 2  # line above, 0-based
        while idx >= 0 and (not source_lines[idx].strip()
                            or source_lines[idx].strip().startswith("@")
                            or _DECORATOR_RE.match(source_lines[idx])):
            idx -= 1
        if idx < 0 or not source_lines[idx].strip().endswith("*/"):
            return None
        end = idx
        while idx >= 0 and "/**" not in source_lines[idx]:
            idx -= 1
        if idx < 0:
            return None
        raw = "\n".join(source_lines[idx:end + 1])
        body = re.sub(r"^\s*/\*\*|\*/\s*$", "", raw, flags=re.DOTALL)
        cleaned = [re.sub(r"^\s*\*\s?", "", ln) for ln in body.splitlines()]
        text = "\n".join(cleaned).strip()
        return text or None

    def _decorators_above(self, source_lines: list[str], start_line: int) -> list[str]:
        decs: list[str] = []
        idx = start_line - 2
        while idx >= 0:
            m = _DECORATOR_RE.match(source_lines[idx])
            if m:
                decs.append(m.group(1))
                idx -= 1
            elif not source_lines[idx].strip():
                idx -= 1
            else:
                break
        decs.reverse()
        return decs

    def _function_entity(self, m: re.Match, *, name: str, is_async: bool,
                         source: str, masked: str, lines: _Lines,
                         source_lines: list[str], parent_qn: str,
                         entity_type: EntityType,
                         is_static: bool = False) -> CodeEntity:
        start = m.start()
        end_off = self._entity_extent(masked, m.end())
        start_line = lines.line(start)
        end_line = lines.line(max(end_off - 1, start))
        body_masked = masked[m.end():end_off]
        qn = f"{parent_qn}.{name}" if parent_qn else name
        header = source[start:masked.find("{", m.end() - 1, end_off)] \
            if "{" in masked[m.end() - 1:end_off] else source[start:end_off]
        return CodeEntity(
            name=name,
            entity_type=entity_type,
            qualified_name=qn,
            signature=" ".join(header.split())[:200],
            docstring=self._jsdoc_above(source_lines, start_line),
            code=self.slice_lines(source_lines, start_line, end_line),
            start_line=start_line,
            end_line=end_line,
            is_async=is_async,
            is_static=is_static,
            decorators=self._decorators_above(source_lines, start_line),
            calls=self._collect_calls(body_masked),
        )

    def _class_entity(self, m: re.Match, source: str, masked: str, lines: _Lines,
                      source_lines: list[str], module_qn: str) -> CodeEntity | None:
        name = m.group(1)
        extends = m.group(2)
        implements = m.group(3)
        open_pos = masked.find("{", m.end() - 1)
        if open_pos == -1:
            return None
        close = find_matching(masked, open_pos)
        if close == -1:
            close = len(masked) - 1
        start_line = lines.line(m.start())
        end_line = lines.line(close)
        qn = f"{module_qn}.{name}" if module_qn else name
        bases = [extends] if extends else []
        if implements:
            bases.extend(b.strip() for b in implements.split(",") if b.strip())
        entity = CodeEntity(
            name=name,
            entity_type=EntityType.CLASS,
            qualified_name=qn,
            signature=" ".join(source[m.start():open_pos].split()),
            docstring=self._jsdoc_above(source_lines, start_line),
            code=self.slice_lines(source_lines, start_line, end_line),
            start_line=start_line,
            end_line=end_line,
            decorators=self._decorators_above(source_lines, start_line),
            base_classes=bases,
        )
        entity.children = self._methods(masked, source, lines, source_lines,
                                        open_pos, close, qn)
        return entity

    def _methods(self, masked: str, source: str, lines: _Lines,
                 source_lines: list[str], open_pos: int, close: int,
                 class_qn: str) -> list[CodeEntity]:
        """Find methods at class-body depth 1.

        Reference: methods with `static` keyword (`extractors/javascript.py:238-265`).
        """
        out: list[CodeEntity] = []
        body = masked[open_pos + 1: close]
        base = open_pos + 1
        # Only accept matches at depth 0 within the class body.
        depth_at: list[int] = []
        d = 0
        for ch in body:
            depth_at.append(d)
            if ch in "{([":
                d += 1
            elif ch in "})]":
                d -= 1
        for m in _METHOD_RE.finditer(body):
            if depth_at[m.start(3)] != 0:
                continue
            name = m.group(3)
            if name in _NOT_METHOD_NAMES:
                continue
            # Require a body `{` after the paren list (skips interface-like
            # signatures and control statements).
            paren_close = find_matching(body, m.end() - 1, "(", ")")
            if paren_close == -1:
                continue
            after = body[paren_close + 1:]
            after_stripped = after.lstrip()
            # allow return-type annotation before the brace (TS)
            brace_rel = after.find("{")
            semi_rel = after.find(";")
            if brace_rel == -1 or (semi_rel != -1 and semi_rel < brace_rel):
                continue
            abs_match_start = base + m.start()
            sub = self._function_entity(
                _OffsetMatch(abs_match_start, base + paren_close + 1),
                name=name,
                is_async=bool(m.group(2)),
                source=source, masked=masked, lines=lines,
                source_lines=source_lines, parent_qn=class_qn,
                entity_type=EntityType.METHOD,
                is_static=bool(m.group(1)),
            )
            out.append(sub)
        return out

    def _collect_calls(self, body_masked: str) -> list[str]:
        """Reference: call collection over call_expression nodes
        (`extractors/javascript.py:293-301`) plus `new X()` constructor
        calls, which the reference's type inference also leans on."""
        calls: list[str] = []
        seen: set[str] = set()
        for m in _CALL_RE.finditer(body_masked):
            name = m.group(1).replace("?.", ".")
            head = name.split(".")[0]
            if head in _KEYWORDS_NOT_CALLS or name in _KEYWORDS_NOT_CALLS:
                continue
            if name not in seen:
                seen.add(name)
                calls.append(name)
        for m in _NEW_RE.finditer(body_masked):
            name = m.group(1)
            if name not in seen:
                seen.add(name)
                calls.append(name)
        return calls


class _OffsetMatch:
    """Duck-typed minimal re.Match for internal reuse of _function_entity."""

    def __init__(self, start: int, end: int):
        self._start = start
        self._end = end

    def start(self, *_args) -> int:
        return self._start

    def end(self, *_args) -> int:
        return self._end
