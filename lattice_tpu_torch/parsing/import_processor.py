"""Per-module import maps: local name -> qualified name.

Parity target: reference `src/lattice/parsing/import_processor.py:61-341`:
- Python: plain/aliased/from/relative-dot-count/wildcard (wildcards stored
  under `*module` sentinel keys), local-vs-external resolution
- JS/TS: ESM clauses + require + relative path normalization (`../` ->
  parent QN segments)
- `resolve_name` checks the direct map then wildcard-expanded modules
  against the FunctionRegistry.

Design difference: the reference probes the filesystem to decide whether an
import is repo-local (`import_processor.py:61-185`); here locality is decided
against the set of module QNs produced by the scan, which keeps the processor
pure and lets tests feed it synthetic corpora.
"""

from __future__ import annotations

import posixpath

from lattice_tpu_torch.core.cache import FunctionRegistry
from lattice_tpu_torch.core.types import Language
from lattice_tpu_torch.parsing.models import ImportInfo, ParsedFile

WILDCARD_PREFIX = "*"  # sentinel key prefix for `from mod import *`


class ImportProcessor:
    """Builds and queries `{module_qn: {local_name: qualified_name}}`."""

    def __init__(self, registry: FunctionRegistry | None = None):
        self.registry = registry
        self._maps: dict[str, dict[str, str]] = {}
        self._local_modules: set[str] = set()

    # ---- construction --------------------------------------------------

    def set_local_modules(self, module_qns: set[str]) -> None:
        """Declare which module QNs exist in the repo (from the scan)."""
        self._local_modules = set(module_qns)

    def parse_imports(self, parsed: ParsedFile) -> dict[str, str]:
        """Build the import map for one parsed file and remember it."""
        module_qn = parsed.file_info.module_name
        language = parsed.file_info.language
        # JS relative specs resolve against the file's directory (NOT the
        # module QN, whose `index` leaf is dropped).
        dir_path = posixpath.dirname(parsed.file_info.relative_path)
        imap: dict[str, str] = {}
        for imp in parsed.imports:
            if language == Language.PYTHON:
                self._add_python(imap, imp, module_qn)
            elif language in (Language.JAVASCRIPT, Language.JSX,
                              Language.TYPESCRIPT, Language.TSX):
                self._add_js(imap, imp, dir_path)
            elif language == Language.JAVA:
                self._add_java(imap, imp)
        self._maps[module_qn] = imap
        return imap

    def build(self, parsed_files: list[ParsedFile]) -> None:
        self.set_local_modules({
            p.file_info.module_name for p in parsed_files
        })
        for parsed in parsed_files:
            self.parse_imports(parsed)

    # ---- python --------------------------------------------------------

    def _resolve_relative(self, module_qn: str, dotted: str) -> str:
        """`.sibling` / `..pkg.mod` resolved against the importing module.

        Reference: relative-dot-count handling (`import_processor.py:96-130`).
        """
        dots = 0
        while dots < len(dotted) and dotted[dots] == ".":
            dots += 1
        rest = dotted[dots:]
        # package of the current module = QN minus the leaf
        parts = module_qn.split(".")[:-1]
        # each extra dot beyond the first climbs one package
        for _ in range(dots - 1):
            if parts:
                parts.pop()
        if rest:
            parts.extend(rest.split("."))
        return ".".join(parts)

    def _add_python(self, imap: dict[str, str], imp: ImportInfo,
                    module_qn: str) -> None:
        if imp.is_relative:
            target = self._resolve_relative(module_qn, imp.module)
        else:
            target = imp.module
        if imp.is_wildcard:
            imap[WILDCARD_PREFIX + target] = target
            return
        if not imp.names:
            # `import a.b.c [as x]`
            local = imp.alias or imp.module.split(".")[0]
            full = target if imp.alias else imp.module.split(".")[0]
            imap[local] = target if imp.alias else full
            # `import a.b.c` binds `a`, but dotted uses resolve via prefix;
            # also record the full path under its dotted name for lookups.
            if not imp.alias and "." in imp.module:
                imap[imp.module] = target
            return
        # from X import a, b  /  from X import a as c
        if imp.alias and len(imp.names) == 1:
            imap[imp.alias] = f"{target}.{imp.names[0]}"
            return
        for name in imp.names:
            imap[name] = f"{target}.{name}"

    # ---- javascript / typescript --------------------------------------

    def _js_module_qn(self, dir_path: str, spec: str) -> str:
        """Normalize `./x`, `../y/z` against the importing file's directory.

        Reference: relative path normalization (`import_processor.py:187-285`).
        """
        if not spec.startswith("."):
            return spec.replace("/", ".")
        # strip asset extensions (./style.css) before joining
        base, ext = posixpath.splitext(spec)
        if ext in (".css", ".scss", ".json", ".svg", ".png", ".js", ".ts",
                   ".jsx", ".tsx", ".mjs"):
            spec = base
        joined = posixpath.normpath(posixpath.join(dir_path, spec))
        qn = joined.replace("/", ".").lstrip(".")
        if qn.endswith(".index"):
            qn = qn[: -len(".index")]
        return qn

    def _add_js(self, imap: dict[str, str], imp: ImportInfo,
                dir_path: str) -> None:
        target = self._js_module_qn(dir_path, imp.module)
        if imp.alias:
            # default import or namespace alias binds the module itself
            imap[imp.alias] = target
        for name in imp.names:
            if name == "default":
                continue  # bound via alias above
            imap[name] = f"{target}.{name}"

    # ---- java ----------------------------------------------------------

    def _add_java(self, imap: dict[str, str], imp: ImportInfo) -> None:
        """Reference: Java wildcard/scoped imports (`import_processor.py:287-307`)."""
        if imp.is_wildcard or imp.module.endswith(".*"):
            base = imp.module[:-2] if imp.module.endswith(".*") else imp.module
            imap[WILDCARD_PREFIX + base] = base
        else:
            simple = imp.module.rsplit(".", 1)[-1]
            imap[simple] = imp.module

    # ---- queries -------------------------------------------------------

    def get_map(self, module_qn: str) -> dict[str, str]:
        return self._maps.get(module_qn, {})

    def is_local_module(self, qn: str) -> bool:
        if qn in self._local_modules:
            return True
        # package prefix of any local module (`app.services` for app.services.user)
        return any(m.startswith(qn + ".") for m in self._local_modules)

    def resolve_name(self, module_qn: str, name: str) -> str | None:
        """Resolve a local name through direct then wildcard imports.

        Reference: `import_processor.py:329-341`.
        """
        imap = self._maps.get(module_qn)
        if not imap:
            return None
        head, _, rest = name.partition(".")
        direct = imap.get(name) or imap.get(head)
        if direct is not None:
            if direct == imap.get(head) and rest and name not in imap:
                candidate = f"{direct}.{rest}"
            else:
                candidate = direct if name in imap or not rest else f"{direct}.{rest}"
            return candidate
        if self.registry is not None:
            for key, target in imap.items():
                if not key.startswith(WILDCARD_PREFIX):
                    continue
                candidate = f"{target}.{name}"
                if candidate in self.registry:
                    return candidate
        return None

    @property
    def stats(self) -> dict:
        return {
            "modules": len(self._maps),
            "bindings": sum(len(m) for m in self._maps.values()),
            "local_modules": len(self._local_modules),
        }
