"""Type-inference engine: per-function local-variable type maps.

Parity target: reference `src/lattice/parsing/type_inference/engine.py:44-568`
— Python param annotations, name-convention matching scored against known
classes, capitalized constructor calls, `self.x` instance attrs, loop
element types; JS/TS annotations cleaned of generics/unions, `new X()`,
literal types — plus the recursion guard. The reference's second redundant
Python-only engine (`python_inference.py`, SURVEY §2.2) is deliberately not
replicated; this single engine serves the call-resolution cascade.
"""

from __future__ import annotations

import ast
import re
import textwrap

from lattice_tpu_torch.core.cache import FunctionRegistry
from lattice_tpu_torch.core.types import EntityType, Language
from lattice_tpu_torch.parsing.import_processor import ImportProcessor
from lattice_tpu_torch.parsing.models import CodeEntity
from lattice_tpu_torch.parsing.type_inference.models import (
    InferredType,
    TypeInferenceContext,
    TypeSource,
    VariableTypeMap,
)

_NEW_RE = re.compile(
    r"(?:const|let|var)?\s*([A-Za-z_$][\w$]*)\s*(?::\s*[A-Za-z_$][\w$.<>\[\], |]*)?"
    r"=\s*(?:await\s+)?new\s+([A-Za-z_$][\w$.]*)"
)
_TS_PARAM_RE = re.compile(
    r"([A-Za-z_$][\w$]*)\s*\??:\s*([A-Za-z_$][\w$.]*)"
)
_THIS_ATTR_RE = re.compile(
    r"this\.([A-Za-z_$][\w$]*)\s*=\s*(?:await\s+)?new\s+([A-Za-z_$][\w$.]*)"
)


def snake_to_camel(name: str) -> str:
    """user_service -> UserService."""
    return "".join(part.capitalize() for part in name.split("_") if part)


def clean_ts_type(type_text: str) -> str:
    """Strip generics, unions, arrays, optionals from a TS annotation.

    Reference: `engine.py:209-219`.
    """
    t = type_text.strip()
    t = t.split("|")[0].split("&")[0].strip()   # first union/intersection arm
    t = re.sub(r"<.*>?$", "", t).strip()         # drop generic args
    t = t.removesuffix("[]").strip()
    return t


class TypeInferenceEngine:
    def __init__(self, registry: FunctionRegistry,
                 imports: ImportProcessor | None = None):
        self.registry = registry
        self.imports = imports
        self._in_progress: set[str] = set()  # recursion guard (reference `:44,469-479`)
        self._known_simple: set[str] | None = None
        # class_qn -> instance-attribute types gathered from the
        # constructor, shared across every method of the class (reference
        # gathers `self.x` attrs per class, `engine.py:446-460`)
        self._class_attrs: dict[str, VariableTypeMap] = {}

    def register_class_attrs(self, class_qn: str,
                             vmap: VariableTypeMap) -> None:
        if vmap.instance_attrs:
            existing = self._class_attrs.setdefault(class_qn,
                                                    VariableTypeMap())
            for name, inferred in vmap.instance_attrs.items():
                existing.set_attr(name, inferred)

    def class_attr_type(self, class_qn: str | None,
                        attr: str) -> InferredType | None:
        if class_qn is None:
            return None
        vmap = self._class_attrs.get(class_qn)
        return vmap.instance_attrs.get(attr) if vmap else None

    # ---- public --------------------------------------------------------

    def known_class_simple_names(self) -> set[str]:
        if self._known_simple is None:
            self._known_simple = {
                qn.rsplit(".", 1)[-1]
                for qn, etype in self.registry.items()
                if etype in (EntityType.CLASS.value, EntityType.INTERFACE.value)
            }
        return self._known_simple

    def invalidate(self) -> None:
        self._known_simple = None

    def infer_function_types(self, entity: CodeEntity, module_qn: str,
                             language: Language,
                             class_qn: str | None = None) -> VariableTypeMap:
        """Build the variable-type map for one function/method body."""
        key = entity.qualified_name
        if key in self._in_progress:
            return VariableTypeMap()
        self._in_progress.add(key)
        try:
            ctx = TypeInferenceContext(
                module_qn=module_qn, class_qn=class_qn,
                known_classes=self.known_class_simple_names(),
            )
            if language == Language.PYTHON:
                return self._infer_python(entity, ctx)
            return self._infer_js(entity, ctx)
        finally:
            self._in_progress.discard(key)

    def resolve_type_qn(self, simple_name: str, module_qn: str) -> str | None:
        """Map a simple class name to a qualified name via imports/registry."""
        if self.imports is not None:
            hit = self.imports.resolve_name(module_qn, simple_name)
            if hit is not None and hit in self.registry:
                return hit
        sibling = f"{module_qn}.{simple_name}" if module_qn else simple_name
        if sibling in self.registry:
            return sibling
        matches = self.registry.find_by_simple_name(simple_name)
        if len(matches) == 1:
            return matches[0]
        return None

    # ---- python --------------------------------------------------------

    def _infer_python(self, entity: CodeEntity,
                      ctx: TypeInferenceContext) -> VariableTypeMap:
        vmap = VariableTypeMap()
        try:
            tree = ast.parse(textwrap.dedent(entity.code))
        except SyntaxError:
            return vmap
        fn = next(
            (n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))),
            None,
        )
        if fn is None:
            return vmap

        # 1. Parameter annotations (reference `:247-260`).
        all_args = list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs)
        for arg in all_args:
            if arg.annotation is not None:
                type_name = self._py_annotation_name(arg.annotation)
                if type_name:
                    vmap.set(arg.arg, InferredType.of(type_name, TypeSource.ANNOTATION))
            elif arg.arg not in ("self", "cls"):
                # 2. Name-convention match against known classes (`:261-279`).
                camel = snake_to_camel(arg.arg)
                if camel in ctx.known_classes:
                    vmap.set(arg.arg, InferredType.of(camel, TypeSource.NAME_CONVENTION))

        for node in ast.walk(fn):
            # 3. Constructor calls `x = X()` (`:355-366`).
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                value = node.value
                ann = node.annotation if isinstance(node, ast.AnnAssign) else None
                for target in targets:
                    if isinstance(target, ast.Name):
                        if ann is not None:
                            tn = self._py_annotation_name(ann)
                            if tn:
                                vmap.set(target.id, InferredType.of(tn, TypeSource.ANNOTATION))
                                continue
                        inferred = self._py_value_type(value, ctx, vmap)
                        if inferred is not None:
                            vmap.set(target.id, inferred)
                    elif (isinstance(target, ast.Attribute)
                          and isinstance(target.value, ast.Name)
                          and target.value.id == "self"):
                        # 4. `self.x = ...` instance attrs (`:446-460`).
                        inferred = self._py_value_type(value, ctx, vmap)
                        if ann is not None:
                            tn = self._py_annotation_name(ann)
                            if tn:
                                inferred = InferredType.of(tn, TypeSource.ANNOTATION)
                        if inferred is not None:
                            vmap.set_attr(target.attr, inferred)
            # 5. Loop element types (`:384-444`): `for x in self.users` gives
            # nothing without data flow, but `for x in List[T]`-annotated
            # params is handled through the annotation's element type.
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if isinstance(node.target, ast.Name) and isinstance(node.iter, ast.Name):
                    src = vmap.get(node.iter.id)
                    if src is not None and src.type_name.endswith("]"):
                        elem = src.type_name[src.type_name.index("[") + 1:-1]
                        elem = elem.split(",")[0].strip()
                        if elem:
                            vmap.set(node.target.id,
                                     InferredType.of(elem, TypeSource.LOOP_ELEMENT))
        return vmap

    def _py_annotation_name(self, node: ast.expr) -> str | None:
        try:
            text = ast.unparse(node)
        except Exception:
            return None
        text = text.strip().strip("'\"")
        if text.startswith("Optional[") and text.endswith("]"):
            text = text[len("Optional["):-1]
        return text or None

    def _py_value_type(self, value: ast.expr | None,
                       ctx: TypeInferenceContext,
                       vmap: VariableTypeMap | None = None
                       ) -> InferredType | None:
        if value is None:
            return None
        if isinstance(value, ast.Await):
            value = value.value
        if isinstance(value, ast.Name) and vmap is not None:
            # `self.client = client` propagates the (annotated) param type
            known = vmap.get(value.id)
            if known is not None:
                return InferredType.of(known.type_name, TypeSource.ATTRIBUTE)
        if isinstance(value, ast.Call):
            name = self._py_call_name(value.func)
            if name is None:
                return None
            simple = name.rsplit(".", 1)[-1]
            if simple and simple[0].isupper():
                return InferredType.of(name, TypeSource.CONSTRUCTOR)
            return None
        if isinstance(value, ast.Constant):
            ctype = type(value.value).__name__
            if ctype in ("str", "int", "float", "bool", "bytes"):
                return InferredType.of(ctype, TypeSource.LITERAL)
        if isinstance(value, ast.List):
            return InferredType.of("list", TypeSource.LITERAL)
        if isinstance(value, ast.Dict):
            return InferredType.of("dict", TypeSource.LITERAL)
        if isinstance(value, ast.Set):
            return InferredType.of("set", TypeSource.LITERAL)
        return None

    def _py_call_name(self, node: ast.expr) -> str | None:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            base = self._py_call_name(node.value)
            return f"{base}.{node.attr}" if base else node.attr
        return None

    # ---- javascript / typescript ---------------------------------------

    def _infer_js(self, entity: CodeEntity,
                  ctx: TypeInferenceContext) -> VariableTypeMap:
        vmap = VariableTypeMap()
        # TS parameter annotations from the signature (`engine.py:209-219`).
        sig = entity.signature
        paren = sig.find("(")
        if paren != -1:
            close = sig.rfind(")")
            params = sig[paren + 1: close if close > paren else len(sig)]
            for m in _TS_PARAM_RE.finditer(params):
                cleaned = clean_ts_type(m.group(2))
                if cleaned and cleaned[0].isupper():
                    vmap.set(m.group(1), InferredType.of(cleaned, TypeSource.ANNOTATION))
        # `const x = new X()` (`engine.py:181-207`).
        for m in _NEW_RE.finditer(entity.code):
            vmap.set(m.group(1), InferredType.of(m.group(2), TypeSource.CONSTRUCTOR))
        # `this.x = new X()`
        for m in _THIS_ATTR_RE.finditer(entity.code):
            vmap.set_attr(m.group(1), InferredType.of(m.group(2), TypeSource.CONSTRUCTOR))
        return vmap
