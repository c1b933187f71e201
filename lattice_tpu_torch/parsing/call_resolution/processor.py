"""The call-resolution cascade.

Parity target: reference `src/lattice/parsing/call_resolution/processor.py`
(`resolve_call` :66-104 and its eight steps):

1. IIFE shapes (JS)                                  (`:106-124`)
2. `super()` -> method via inheritance BFS           (`:168-225`)
3. C++ operator calls                                (`:147-166`)
4. method chains `a().b().c`                         (`:227-264`)
5. import-map resolution incl. var-typed receivers   (`:281-326`)
6. same-module qualified name                        (`:358-369`)
7. language builtins                                 (`:371-408`)
8. fallback simple-name match ranked by module
   distance (common-prefix metric)                   (`:410-439`)

This implementation also fixes the reference's dead wiring noted in
SURVEY §2.2: import maps here are always built by the pipeline, so step 5
actually runs in production, not just in tests.
"""

from __future__ import annotations

from dataclasses import dataclass

from lattice_tpu_torch.core.cache import FunctionRegistry
from lattice_tpu_torch.core.types import EntityType, Language
from lattice_tpu_torch.parsing.call_resolution import builtins as bt
from lattice_tpu_torch.parsing.import_processor import ImportProcessor
from lattice_tpu_torch.parsing.inheritance_tracker import InheritanceTracker
from lattice_tpu_torch.parsing.models import CodeEntity
from lattice_tpu_torch.parsing.type_inference.engine import TypeInferenceEngine
from lattice_tpu_torch.parsing.type_inference.models import VariableTypeMap


@dataclass(slots=True)
class ResolvedCall:
    """Resolution result: a target QN and/or a method-name fallback.

    The reference materializes both an exact-QN CALLS edge and a
    method-name CALLS edge (`graph/builder.py:261-316`); `method_name`
    carries the latter.
    """

    target_qn: str | None
    method_name: str | None = None
    resolution: str = "exact"   # exact | super | operator | chain | import |
    #                             module | builtin | fuzzy | unresolved
    confidence: float = 1.0


class CallProcessor:
    def __init__(
        self,
        registry: FunctionRegistry,
        imports: ImportProcessor | None = None,
        inheritance: InheritanceTracker | None = None,
        type_engine: TypeInferenceEngine | None = None,
    ):
        self.registry = registry
        self.imports = imports
        self.inheritance = inheritance
        self.type_engine = type_engine or TypeInferenceEngine(registry, imports)
        self._vmap_cache: dict[str, VariableTypeMap] = {}
        self.stats = {"resolved": 0, "unresolved": 0, "by_step": {}}

    # ---- entry point ---------------------------------------------------

    def resolve_call(
        self,
        call_text: str,
        caller: CodeEntity,
        module_qn: str,
        language: Language,
        class_qn: str | None = None,
    ) -> ResolvedCall:
        """Run the cascade for one call site. Reference: `processor.py:66-104`."""
        result = self._cascade(call_text, caller, module_qn, language, class_qn)
        if result.target_qn is not None or result.method_name is not None:
            self.stats["resolved"] += 1
            by = self.stats["by_step"]
            by[result.resolution] = by.get(result.resolution, 0) + 1
        else:
            self.stats["unresolved"] += 1
        return result

    def _cascade(self, call_text: str, caller: CodeEntity, module_qn: str,
                 language: Language, class_qn: str | None) -> ResolvedCall:
        text = call_text.strip()
        if not text:
            return ResolvedCall(None, resolution="unresolved", confidence=0.0)

        # (1) IIFE shapes never resolve to entities (`:106-124`).
        if language in _JS_FAMILY and text.startswith(bt.IIFE_PREFIXES):
            return ResolvedCall(None, resolution="unresolved", confidence=0.0)

        # (2) super() / super().m() / super.m() (`:168-225`).
        if text == "super" or text.startswith("super.") or text.startswith("super()."):
            hit = self._resolve_super(text, caller, class_qn)
            if hit is not None:
                return hit

        # (3) C++ operators (`:147-166`).
        if language == Language.CPP and text in bt.CPP_OPERATORS:
            return ResolvedCall(bt.CPP_OPERATORS[text], resolution="operator")

        # (4) method chains `a().b().c` (`:227-264`).
        if "()." in text:
            hit = self._resolve_chain(text, caller, module_qn, language, class_qn)
            if hit is not None:
                return hit

        # (5) import map + var-typed receivers (`:281-326`).
        hit = self._resolve_via_imports(text, caller, module_qn, language, class_qn)
        if hit is not None:
            return hit

        # (6) same-module QN (`:358-369`).
        simple = text.rsplit(".", 1)[-1] if "." in text else text
        candidate = f"{module_qn}.{text}" if module_qn else text
        if candidate in self.registry:
            return ResolvedCall(candidate, resolution="module")
        # a method on the enclosing class: `self.m()` / bare `m()` in class scope
        if class_qn is not None:
            receiver = text.split(".", 1)[0]
            if receiver in ("self", "this", "cls") and "." in text:
                method = text.split(".", 1)[1].split(".", 1)[0]
                hit2 = self._method_on_class(class_qn, method)
                if hit2 is not None:
                    return hit2

        # (7) language builtins (`:371-408`).
        hit = self._resolve_builtin(text, simple, language)
        if hit is not None:
            return hit

        # (8) fallback simple-name match by module distance (`:410-439`).
        return self._resolve_fuzzy(text, simple, module_qn)

    # ---- steps ---------------------------------------------------------

    def _resolve_super(self, text: str, caller: CodeEntity,
                       class_qn: str | None) -> ResolvedCall | None:
        if class_qn is None or self.inheritance is None:
            return None
        if text == "super":
            # constructor call -> parent __init__/constructor
            for method in ("__init__", "constructor"):
                for parent in self.inheritance.get_parents(class_qn):
                    hit = self.inheritance.find_method(parent, method)
                    if hit is not None:
                        return ResolvedCall(hit, resolution="super")
            parents = self.inheritance.get_parents(class_qn)
            if parents:
                return ResolvedCall(parents[0], resolution="super", confidence=0.8)
            return None
        method = text.removeprefix("super().").removeprefix("super.")
        method = method.split(".", 1)[0].split("(", 1)[0]
        for parent in self.inheritance.get_parents(class_qn):
            hit = self.inheritance.find_method(parent, method)
            if hit is not None:
                return ResolvedCall(hit, resolution="super")
        return ResolvedCall(None, method_name=method, resolution="super",
                            confidence=0.4) if method else None

    def _resolve_chain(self, text: str, caller: CodeEntity, module_qn: str,
                       language: Language, class_qn: str | None) -> ResolvedCall | None:
        """`factory().build().run` -> infer the first call's return type,
        then walk the remaining attributes as methods. Without full return
        types the tail method name still yields a method-name edge."""
        head, _, tail = text.partition("().")
        # resolve head itself as a call to get a constructor-ish type
        head_qn = None
        head_type = self.registry.get_type(f"{module_qn}.{head}") if module_qn else None
        if head_type == EntityType.CLASS.value:
            head_qn = f"{module_qn}.{head}"
        elif head[:1].isupper():
            head_qn = self.type_engine.resolve_type_qn(head, module_qn)
        if head_qn is not None:
            method = tail.split(".", 1)[0].split("(", 1)[0]
            hit = self._method_on_class(head_qn, method)
            if hit is not None:
                hit.resolution = "chain"
                return hit
        tail_method = tail.rsplit(".", 1)[-1].split("(", 1)[0]
        if tail_method:
            return ResolvedCall(None, method_name=tail_method,
                                resolution="chain", confidence=0.3)
        return None

    def _resolve_via_imports(self, text: str, caller: CodeEntity,
                             module_qn: str, language: Language,
                             class_qn: str | None) -> ResolvedCall | None:
        if self.imports is None:
            return None
        receiver, _, rest = text.partition(".")
        # 5a. whole dotted text through the import map (`np.array`,
        # `os.path.join`, imported function `helper`).
        hit = self.imports.resolve_name(module_qn, text)
        if hit is not None:
            if hit in self.registry:
                return ResolvedCall(hit, resolution="import")
            # Imported but not repo-local: a third-party / stdlib call —
            # resolved as external so it neither edges nor pollutes the
            # fuzzy fallback (reference marks these unresolved; SURVEY §2.2
            # notes its import maps never ran in production at all).
            root = hit.split(".", 1)[0]
            if not self.imports.is_local_module(root) \
                    and not self.imports.is_local_module(hit):
                return ResolvedCall(f"ext.{hit}", resolution="external")
        # 5b. var-typed receiver: `user.save()` where user: User, and
        # `self.attr.m()` where __init__ typed the attr — there the
        # receiver is the ATTR (parts[1]) and the method parts[2], not
        # rest's head (which is the attr name and can never be a method
        # of the attr's own type).
        if rest:
            parts = text.split(".")
            if receiver in ("self", "this") and len(parts) >= 3:
                method = parts[2]
            else:
                method = rest.split(".", 1)[0]
            var_type = self._receiver_type(receiver, text, caller, module_qn,
                                           language, class_qn)
            if var_type is not None:
                type_qn = self.type_engine.resolve_type_qn(var_type, module_qn)
                if type_qn is not None:
                    mhit = self._method_on_class(type_qn, method)
                    if mhit is not None:
                        mhit.resolution = "import"
                        return mhit
        # 5c. receiver is an imported class: `UserService.create()`.
        if rest:
            recv_qn = self.imports.resolve_name(module_qn, receiver)
            if recv_qn is not None and recv_qn in self.registry:
                method = rest.split(".", 1)[0]
                mhit = self._method_on_class(recv_qn, method)
                if mhit is not None:
                    mhit.resolution = "import"
                    return mhit
                candidate = f"{recv_qn}.{method}"
                if candidate in self.registry:
                    return ResolvedCall(candidate, resolution="import")
        return None

    def _receiver_type(self, receiver: str, text: str, caller: CodeEntity,
                       module_qn: str, language: Language,
                       class_qn: str | None) -> str | None:
        vmap = self._vmap_for(caller, module_qn, language, class_qn)
        if receiver in ("self", "this"):
            parts = text.split(".")
            if len(parts) >= 3:  # self.attr.method()
                attr = vmap.instance_attrs.get(parts[1])
                if attr is None:
                    # constructor-established attrs shared class-wide
                    attr = self.type_engine.class_attr_type(class_qn, parts[1])
                return attr.type_name if attr else None
            return None
        inferred = vmap.get(receiver)
        return inferred.type_name if inferred else None

    def _vmap_for(self, caller: CodeEntity, module_qn: str,
                  language: Language, class_qn: str | None) -> VariableTypeMap:
        key = caller.qualified_name or caller.name
        vmap = self._vmap_cache.get(key)
        if vmap is None:
            vmap = self.type_engine.infer_function_types(
                caller, module_qn, language, class_qn)
            # Fold in instance attrs inferred from the class __init__ if we
            # have it (reference gathers `self.x` attrs per class).
            self._vmap_cache[key] = vmap
        return vmap

    def _method_on_class(self, class_qn: str, method: str) -> ResolvedCall | None:
        direct = f"{class_qn}.{method}"
        if direct in self.registry:
            return ResolvedCall(direct)
        if self.inheritance is not None:
            inherited = self.inheritance.find_method(class_qn, method)
            if inherited is not None:
                return ResolvedCall(inherited)
        return None

    def _resolve_builtin(self, text: str, simple: str,
                         language: Language) -> ResolvedCall | None:
        if language == Language.PYTHON:
            if text in bt.PYTHON_BUILTINS:
                return ResolvedCall(bt.python_builtin_qn(text), resolution="builtin")
            head = text.split(".", 1)[0]
            if "." in text:
                if head in bt.PYTHON_STDLIB_MODULES:
                    return ResolvedCall(f"ext.{text}", resolution="external")
                if head in bt.PYTHON_LOGGER_RECEIVERS \
                        and simple in bt.PYTHON_LOGGER_METHODS:
                    return ResolvedCall(f"ext.logging.{simple}",
                                        resolution="external", confidence=0.7)
                if simple in bt.PYTHON_COMMON_METHODS:
                    return ResolvedCall(bt.python_builtin_qn(simple),
                                        resolution="builtin", confidence=0.5)
            return None
        if language in _JS_FAMILY:
            head = text.split(".", 1)[0]
            if head in bt.JS_BUILTIN_TYPES or text in bt.JS_BUILTIN_FUNCTIONS:
                return ResolvedCall(bt.js_builtin_qn(text), resolution="builtin")
            if text.endswith(bt.FUNCTION_PROTOTYPE_SUFFIXES):
                return ResolvedCall(bt.js_builtin_qn(simple), resolution="builtin")
            if "." in text and simple in bt.JS_PROTOTYPE_METHODS:
                return ResolvedCall(bt.js_builtin_qn(simple), resolution="builtin",
                                    confidence=0.6)
            return None
        if language == Language.RUST and text in bt.RUST_KEYWORDS:
            return ResolvedCall(None, resolution="unresolved", confidence=0.0)
        if language == Language.JAVA and text in bt.JAVA_KEYWORDS:
            return ResolvedCall(None, resolution="unresolved", confidence=0.0)
        return None

    def _resolve_fuzzy(self, text: str, simple: str,
                       module_qn: str) -> ResolvedCall:
        """Simple-name match ranked by module distance (common dotted-prefix
        length, reference `:410-439`)."""
        matches = self.registry.find_by_simple_name(simple)
        if not matches:
            # keep a method-name edge for `x.method()` shapes so graph
            # queries can still follow by-name links (reference builder
            # MERGEs method-name CALLS edges, `graph/builder.py:300-316`).
            if "." in text:
                return ResolvedCall(None, method_name=simple,
                                    resolution="unresolved", confidence=0.2)
            return ResolvedCall(None, resolution="unresolved", confidence=0.0)
        here = module_qn.split(".")

        def distance(qn: str) -> tuple[int, int]:
            parts = qn.split(".")
            common = 0
            for a, b in zip(parts, here):
                if a != b:
                    break
                common += 1
            return (-common, len(parts))

        best = min(matches, key=distance)
        return ResolvedCall(best, method_name=simple if "." in text else None,
                            resolution="fuzzy", confidence=0.5)

    def clear_cache(self) -> None:
        self._vmap_cache.clear()


_JS_FAMILY = (Language.JAVASCRIPT, Language.JSX, Language.TYPESCRIPT, Language.TSX)
