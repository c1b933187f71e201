"""Type-inference data models.

Parity target: reference `src/lattice/parsing/type_inference/models.py:8-120`
(`InferredType` with `TypeSource` provenance + confidence, `VariableTypeMap`
with instance attrs, `TypeInferenceContext`, `MethodCallInfo.from_text`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TypeSource(str, enum.Enum):
    """Provenance of an inferred type. Reference: `models.py:8-16`."""

    ANNOTATION = "annotation"          # explicit type annotation
    CONSTRUCTOR = "constructor"        # x = ClassName(...) / new ClassName()
    RETURN_CHAIN = "return_chain"      # x = factory().build()
    LITERAL = "literal"                # x = "..." / [] / {}
    LOOP_ELEMENT = "loop_element"      # for x in items: ...
    ATTRIBUTE = "attribute"            # self.x assignments
    NAME_CONVENTION = "name_convention"  # user_service -> UserService
    UNKNOWN = "unknown"


# Default confidence per provenance (reference scores name-convention 0.5,
# `python_inference.py:30-690`).
DEFAULT_CONFIDENCE: dict[TypeSource, float] = {
    TypeSource.ANNOTATION: 1.0,
    TypeSource.CONSTRUCTOR: 0.95,
    TypeSource.RETURN_CHAIN: 0.7,
    TypeSource.LITERAL: 0.9,
    TypeSource.LOOP_ELEMENT: 0.7,
    TypeSource.ATTRIBUTE: 0.8,
    TypeSource.NAME_CONVENTION: 0.5,
    TypeSource.UNKNOWN: 0.0,
}


@dataclass(slots=True)
class InferredType:
    """Reference: `models.py:8-35`."""

    type_name: str                     # simple or qualified class name
    source: TypeSource = TypeSource.UNKNOWN
    confidence: float = 0.0

    @classmethod
    def of(cls, type_name: str, source: TypeSource) -> "InferredType":
        return cls(type_name=type_name, source=source,
                   confidence=DEFAULT_CONFIDENCE[source])


@dataclass(slots=True)
class VariableTypeMap:
    """Local variable + instance attribute types for one function scope.

    Reference: `models.py:38-66`.
    """

    variables: dict[str, InferredType] = field(default_factory=dict)
    instance_attrs: dict[str, InferredType] = field(default_factory=dict)

    def set(self, name: str, inferred: InferredType) -> None:
        existing = self.variables.get(name)
        if existing is None or inferred.confidence >= existing.confidence:
            self.variables[name] = inferred

    def set_attr(self, name: str, inferred: InferredType) -> None:
        existing = self.instance_attrs.get(name)
        if existing is None or inferred.confidence >= existing.confidence:
            self.instance_attrs[name] = inferred

    def get(self, name: str) -> InferredType | None:
        if name.startswith("self.") or name.startswith("this."):
            return self.instance_attrs.get(name.split(".", 1)[1])
        return self.variables.get(name)


@dataclass(slots=True)
class TypeInferenceContext:
    """What the engine knows while inferring one function.

    Reference: `models.py:69-90`.
    """

    module_qn: str
    class_qn: str | None = None        # enclosing class for methods
    known_classes: set[str] = field(default_factory=set)  # simple names


@dataclass(slots=True)
class MethodCallInfo:
    """A parsed `receiver.method(...)` chain. Reference: `models.py:93-120`."""

    receiver: str                      # "user", "self.repo", "a().b"
    method: str
    full_text: str

    @classmethod
    def from_text(cls, text: str) -> "MethodCallInfo | None":
        text = text.strip()
        if "." not in text:
            return None
        receiver, _, method = text.rpartition(".")
        if not method or not receiver:
            return None
        return cls(receiver=receiver, method=method, full_text=text)
