"""Class inheritance tracking with MRO and method lookup.

Parity target: reference `src/lattice/parsing/inheritance_tracker.py:55-156`:
`class_qn -> [parent_qns]` map; parent resolution via import map -> local
module -> simple-name registry match; BFS-simplified C3 MRO; `find_method`
walking the MRO; recursive `get_subclasses`; stats.
"""

from __future__ import annotations

from collections import deque

from lattice_tpu_torch.core.cache import FunctionRegistry
from lattice_tpu_torch.parsing.import_processor import ImportProcessor


class InheritanceTracker:
    def __init__(self, registry: FunctionRegistry,
                 imports: ImportProcessor | None = None):
        self.registry = registry
        self.imports = imports
        self._parents: dict[str, list[str]] = {}       # class_qn -> parent QNs
        self._raw: dict[str, list[str]] = {}           # class_qn -> unresolved base names
        self._children: dict[str, set[str]] = {}       # class_qn -> direct subclasses
        self._methods: dict[str, set[str]] = {}        # class_qn -> method simple names

    # ---- registration --------------------------------------------------

    def register_class(self, class_qn: str, base_names: list[str],
                       method_names: list[str] | None = None) -> None:
        self._raw[class_qn] = list(base_names)
        if method_names:
            self._methods.setdefault(class_qn, set()).update(method_names)

    def add_method(self, class_qn: str, method_name: str) -> None:
        self._methods.setdefault(class_qn, set()).add(method_name)

    def resolve_all(self) -> None:
        """Resolve raw base names to QNs after all classes are registered."""
        self._parents.clear()
        self._children.clear()
        for class_qn, bases in self._raw.items():
            resolved = []
            for base in bases:
                qn = self._resolve_parent(class_qn, base)
                if qn is not None:
                    resolved.append(qn)
            self._parents[class_qn] = resolved
            for parent in resolved:
                self._children.setdefault(parent, set()).add(class_qn)

    def _resolve_parent(self, class_qn: str, base_name: str) -> str | None:
        """Import map -> same module -> simple-name registry match.

        Reference: `inheritance_tracker.py:125-144`.
        """
        module_qn = class_qn.rsplit(".", 1)[0] if "." in class_qn else ""
        if self.imports is not None:
            hit = self.imports.resolve_name(module_qn, base_name)
            if hit is not None and hit in self.registry:
                return hit
        # same-module sibling class
        simple = base_name.rsplit(".", 1)[-1]
        sibling = f"{module_qn}.{simple}" if module_qn else simple
        if sibling in self.registry:
            return sibling
        # unique simple-name match anywhere in the repo
        matches = self.registry.find_by_simple_name(simple)
        if len(matches) == 1:
            return matches[0]
        if matches:
            # prefer the match sharing the longest module prefix
            def shared(qn: str) -> int:
                a, b = qn.split("."), class_qn.split(".")
                n = 0
                for x, y in zip(a, b):
                    if x != y:
                        break
                    n += 1
                return n
            return max(matches, key=shared)
        return None

    # ---- queries -------------------------------------------------------

    def get_parents(self, class_qn: str) -> list[str]:
        return self._parents.get(class_qn, [])

    def get_mro(self, class_qn: str) -> list[str]:
        """BFS linearization (simplified C3). Reference: `:55-75`."""
        order: list[str] = []
        seen: set[str] = set()
        queue = deque([class_qn])
        while queue:
            qn = queue.popleft()
            if qn in seen:
                continue
            seen.add(qn)
            order.append(qn)
            queue.extend(self._parents.get(qn, []))
        return order

    def find_method(self, class_qn: str, method_name: str) -> str | None:
        """First class along the MRO defining the method. Reference: `:91-100`."""
        for qn in self.get_mro(class_qn):
            if method_name in self._methods.get(qn, ()):  # known method set
                return f"{qn}.{method_name}"
            # fall back to the registry for classes registered without methods
            candidate = f"{qn}.{method_name}"
            if candidate in self.registry:
                return candidate
        return None

    def get_subclasses(self, class_qn: str, recursive: bool = True) -> list[str]:
        """Reference: `:106-114`."""
        direct = sorted(self._children.get(class_qn, ()))
        if not recursive:
            return direct
        out: list[str] = []
        seen: set[str] = set()
        stack = list(direct)
        while stack:
            qn = stack.pop()
            if qn in seen:
                continue
            seen.add(qn)
            out.append(qn)
            stack.extend(self._children.get(qn, ()))
        return sorted(out)

    def is_subclass_of(self, class_qn: str, ancestor_qn: str) -> bool:
        return ancestor_qn in self.get_mro(class_qn)[1:]

    @property
    def stats(self) -> dict:
        """Reference: `:146-156`."""
        return {
            "classes": len(self._raw),
            "resolved_edges": sum(len(v) for v in self._parents.values()),
            "raw_edges": sum(len(v) for v in self._raw.values()),
            "roots": sum(1 for v in self._parents.values() if not v),
        }
