"""Python entity/import extractor built on the stdlib `ast` module.

Parity target: reference `src/lattice/parsing/extractors/python.py:7-217`
(tree-sitter based): plain/aliased/from/relative imports, top-level
functions, classes (incl. decorated), methods nested under classes, base
classes, docstrings, call-site collection, staticmethod/classmethod
detection. Using CPython's own parser is the idiomatic replacement for
tree-sitter here — it is a C parser with full-fidelity Python grammar and
exact line spans.
"""

from __future__ import annotations

import ast

from lattice_tpu_torch.core.types import EntityType, Language
from lattice_tpu_torch.parsing.extractors.base import BaseExtractor
from lattice_tpu_torch.parsing.models import CodeEntity, ImportInfo


def _name_of(node: ast.expr) -> str | None:
    """Render a dotted name from Name/Attribute chains; None otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _name_of(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):  # decorated with call e.g. @lru_cache()
        return _name_of(node.func)
    if isinstance(node, ast.Subscript):  # Generic[T] base class
        return _name_of(node.value)
    return None


def _collect_calls(node: ast.AST) -> list[str]:
    """Collect call-site names inside a function/method body, skipping
    nested function/class definitions (their calls belong to them).

    Reference: call collection over `call` nodes capturing identifier or
    attribute text (`extractors/python.py:209-217`).
    """
    calls: list[str] = []
    seen: set[str] = set()

    def visit(n: ast.AST, top: bool) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not top:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                name = _name_of(child.func)
                if name and name not in seen:
                    seen.add(name)
                    calls.append(name)
            visit(child, False)

    visit(node, True)
    return calls


class PythonExtractor(BaseExtractor):
    language = Language.PYTHON

    def extract_imports(self, source: str) -> list[ImportInfo]:
        """Reference: `extractors/python.py:7-66`."""
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return []
        imports: list[ImportInfo] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports.append(ImportInfo(
                        module=alias.name,
                        alias=alias.asname,
                        line=node.lineno,
                    ))
            elif isinstance(node, ast.ImportFrom):
                module = ("." * node.level) + (node.module or "")
                names = [a.name for a in node.names]
                is_wildcard = names == ["*"]
                alias = None
                if len(node.names) == 1 and node.names[0].asname:
                    alias = node.names[0].asname
                imports.append(ImportInfo(
                    module=module,
                    names=[] if is_wildcard else names,
                    alias=alias,
                    is_relative=node.level > 0,
                    is_wildcard=is_wildcard,
                    line=node.lineno,
                ))
        return imports

    def extract_entities(self, source: str, module_qn: str) -> list[CodeEntity]:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return []
        source_lines = source.splitlines()
        entities: list[CodeEntity] = []
        for node in tree.body:
            entity = self._convert(node, module_qn, source_lines, inside_class=False)
            if entity is not None:
                entities.append(entity)
        return entities

    def _convert(self, node: ast.stmt, parent_qn: str, source_lines: list[str],
                 inside_class: bool) -> CodeEntity | None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return self._function(node, parent_qn, source_lines, inside_class)
        if isinstance(node, ast.ClassDef):
            return self._class(node, parent_qn, source_lines)
        return None

    def _function(self, node: ast.FunctionDef | ast.AsyncFunctionDef,
                  parent_qn: str, source_lines: list[str],
                  inside_class: bool) -> CodeEntity:
        decorators = [d for d in (_name_of(dec) for dec in node.decorator_list) if d]
        qn = f"{parent_qn}.{node.name}" if parent_qn else node.name
        end_line = getattr(node, "end_lineno", node.lineno) or node.lineno
        entity = CodeEntity(
            name=node.name,
            entity_type=EntityType.METHOD if inside_class else EntityType.FUNCTION,
            qualified_name=qn,
            signature=self._signature(node),
            docstring=ast.get_docstring(node),
            code=self.slice_lines(source_lines, node.lineno, end_line),
            start_line=node.lineno,
            end_line=end_line,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            # Reference reads these off decorators (`extractors/python.py:130-131`).
            is_static="staticmethod" in decorators,
            is_classmethod="classmethod" in decorators,
            decorators=decorators,
            calls=_collect_calls(node),
        )
        # Nested defs become children (reference keeps recursion via children).
        for child in node.body:
            sub = self._convert(child, qn, source_lines, inside_class=False)
            if sub is not None:
                entity.children.append(sub)
        return entity

    def _class(self, node: ast.ClassDef, parent_qn: str,
               source_lines: list[str]) -> CodeEntity:
        qn = f"{parent_qn}.{node.name}" if parent_qn else node.name
        decorators = [d for d in (_name_of(dec) for dec in node.decorator_list) if d]
        bases = [b for b in (_name_of(b) for b in node.bases) if b]
        end_line = getattr(node, "end_lineno", node.lineno) or node.lineno
        entity = CodeEntity(
            name=node.name,
            entity_type=EntityType.CLASS,
            qualified_name=qn,
            signature=f"class {node.name}({', '.join(bases)})" if bases else f"class {node.name}",
            docstring=ast.get_docstring(node),
            code=self.slice_lines(source_lines, node.lineno, end_line),
            start_line=node.lineno,
            end_line=end_line,
            decorators=decorators,
            base_classes=bases,
        )
        for child in node.body:
            sub = self._convert(child, qn, source_lines, inside_class=True)
            if sub is not None:
                entity.children.append(sub)
        return entity

    @staticmethod
    def _signature(node: ast.FunctionDef | ast.AsyncFunctionDef) -> str:
        try:
            args = ast.unparse(node.args)
        except Exception:
            args = "..."
        ret = ""
        if node.returns is not None:
            try:
                ret = f" -> {ast.unparse(node.returns)}"
            except Exception:
                ret = ""
        prefix = "async def" if isinstance(node, ast.AsyncFunctionDef) else "def"
        return f"{prefix} {node.name}({args}){ret}"
