"""Graph construction from parsed files into the in-process GraphStore.

Parity target: reference `src/lattice/graph/builder.py` (per-row) and
`graph/batch_builder.py` (buffered UNWIND batches). With the graph
in-process there is no Bolt round-trip to batch over, so the two collapse
into one two-phase builder:

1. **register phase** — every entity into the FunctionRegistry +
   InheritanceTracker, import maps built (this fixes the reference's dead
   import-map wiring, SURVEY §2.2), nodes + DEFINES/DEFINES_METHOD/
   EXTENDS/IMPORTS edges into the GraphStore
   (reference `builder.py:145-189`).
2. **call phase** — the CallProcessor cascade resolves every call site to
   CALLS edges (reference `batch_builder.py:251`, `builder.py:261-316`).
   Like the reference, unresolved `x.method()` shapes still yield by-name
   CALLS edges when the method name matches at most `max_name_fanout`
   known entities (the reference MERGEs method-name CALLS edges,
   `graph/queries.py:177-181`).

`GraphStore.finalize()` then builds the CSR/COO arrays the device kernels
consume — the analog of the reference's flush (`batch_builder.py:296-413`).
"""

from __future__ import annotations

import logging

from lattice_tpu_torch.core.cache import FunctionRegistry
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.parsing.call_resolution.processor import CallProcessor
from lattice_tpu_torch.parsing.import_processor import ImportProcessor
from lattice_tpu_torch.parsing.inheritance_tracker import InheritanceTracker
from lattice_tpu_torch.parsing.models import CodeEntity, ParsedFile
from lattice_tpu_torch.parsing.type_inference.engine import TypeInferenceEngine

logger = logging.getLogger(__name__)

FILE_NODE_PREFIX = "file:"


class GraphBuilder:
    def __init__(self, store: GraphStore | None = None,
                 registry: FunctionRegistry | None = None,
                 max_name_fanout: int = 3):
        self.store = store or GraphStore()
        self.registry = registry or FunctionRegistry()
        self.imports = ImportProcessor(self.registry)
        self.inheritance = InheritanceTracker(self.registry, self.imports)
        self.type_engine = TypeInferenceEngine(self.registry, self.imports)
        self.call_processor = CallProcessor(
            self.registry, self.imports, self.inheritance, self.type_engine)
        self.max_name_fanout = max_name_fanout
        self.stats = {"files": 0, "entities": 0, "calls_created": 0,
                      "calls_by_name": 0, "calls_unresolved": 0,
                      "extends": 0, "imports": 0}

    # ---- project -------------------------------------------------------

    def create_project(self, name: str) -> None:
        """Reference: `builder.py:47` (MERGE project node)."""
        self.store.project = name

    # ---- phase 1: registration ----------------------------------------

    def register_file(self, parsed: ParsedFile) -> None:
        info = parsed.file_info
        file_qn = FILE_NODE_PREFIX + info.relative_path
        file_id = self.store.add_node(
            file_qn, EntityType.FILE, info.relative_path,
            name=info.relative_path.rsplit("/", 1)[-1])
        for entity in parsed.all_entities:
            self._register_entity(entity, file_id, info.relative_path)
        self.imports.parse_imports(parsed)
        self.stats["files"] += 1

    def _register_entity(self, entity: CodeEntity, file_id: int,
                         file_path: str) -> None:
        qn = entity.qualified_name or entity.name
        self.registry.register(qn, entity.entity_type.value)
        nid = self.store.add_node(
            qn, entity.entity_type, file_path,
            start_line=entity.start_line, end_line=entity.end_line,
            name=entity.name)
        self.store.add_edge(file_id, nid, EdgeType.DEFINES)
        self.stats["entities"] += 1
        if entity.entity_type in (EntityType.CLASS, EntityType.INTERFACE):
            methods = [c.name for c in entity.children
                       if c.entity_type == EntityType.METHOD]
            self.inheritance.register_class(qn, entity.base_classes, methods)

    def finish_registration(self, parsed_files: list[ParsedFile]) -> None:
        """Resolve inheritance + wire structural edges after all files."""
        self.imports.set_local_modules(
            {p.file_info.module_name for p in parsed_files})
        self.inheritance.resolve_all()
        self.type_engine.invalidate()
        for parsed in parsed_files:
            info = parsed.file_info
            file_id = self.store.id_of(FILE_NODE_PREFIX + info.relative_path)
            if file_id is None:
                continue
            # DEFINES_METHOD + EXTENDS
            for entity in parsed.all_entities:
                qn = entity.qualified_name or entity.name
                nid = self.store.id_of(qn)
                if nid is None:
                    continue
                if entity.entity_type in (EntityType.CLASS, EntityType.INTERFACE):
                    for child in entity.children:
                        if child.entity_type == EntityType.METHOD:
                            cid = self.store.id_of(child.qualified_name)
                            if cid is not None:
                                self.store.add_edge(nid, cid, EdgeType.DEFINES_METHOD)
                    for parent_qn in self.inheritance.get_parents(qn):
                        pid = self.store.id_of(parent_qn)
                        if pid is not None:
                            self.store.add_edge(nid, pid, EdgeType.EXTENDS)
                            self.stats["extends"] += 1
            # IMPORTS edges file -> file for repo-local imports
            module_map = self.imports.get_map(info.module_name)
            local_targets: set[str] = set()
            for target in module_map.values():
                mod = self._owning_module(target, parsed_files)
                if mod is not None and mod != info.module_name:
                    local_targets.add(mod)
            for mod in local_targets:
                target_file = self._file_of_module(mod, parsed_files)
                if target_file is not None:
                    tid = self.store.id_of(FILE_NODE_PREFIX + target_file)
                    if tid is not None:
                        self.store.add_edge(file_id, tid, EdgeType.IMPORTS)
                        self.stats["imports"] += 1

    def _owning_module(self, qn: str, parsed_files: list[ParsedFile]) -> str | None:
        modules = {p.file_info.module_name for p in parsed_files}
        probe = qn
        while probe:
            if probe in modules:
                return probe
            if "." not in probe:
                return None
            probe = probe.rsplit(".", 1)[0]
        return None

    def _file_of_module(self, module_qn: str,
                        parsed_files: list[ParsedFile]) -> str | None:
        for p in parsed_files:
            if p.file_info.module_name == module_qn:
                return p.file_info.relative_path
        return None

    # ---- phase 2: call edges ------------------------------------------

    def build_calls(self, parsed: ParsedFile) -> None:
        """Reference: `builder.py:261-316` / `batch_builder.py:239-294`."""
        info = parsed.file_info
        language = info.language
        module_qn = info.module_name
        # Share constructor-established instance-attribute types with every
        # method of the class (`self.client = MemgraphClient()` in __init__
        # types `self.client.execute()` elsewhere).
        for cls in parsed.classes:
            init = next((c for c in cls.children
                         if c.name in ("__init__", "constructor")), None)
            if init is not None:
                vmap = self.type_engine.infer_function_types(
                    init, module_qn, language, cls.qualified_name)
                self.type_engine.register_class_attrs(
                    cls.qualified_name, vmap)
        for entity in parsed.all_entities:
            if entity.entity_type not in (EntityType.FUNCTION, EntityType.METHOD):
                continue
            src_id = self.store.id_of(entity.qualified_name or entity.name)
            if src_id is None:
                continue
            class_qn = None
            if entity.entity_type == EntityType.METHOD:
                class_qn = (entity.qualified_name or "").rsplit(".", 1)[0] or None
            for call_text in entity.calls:
                resolved = self.call_processor.resolve_call(
                    call_text, entity, module_qn, language, class_qn)
                if resolved.target_qn is not None:
                    if resolved.target_qn.startswith(
                            ("builtins.", "js.builtin.", "cpp.builtin.",
                             "ext.")):
                        # builtins/externals resolve but produce no graph
                        # edge (reference only links entities in the graph)
                        continue
                    dst_id = self.store.id_of(resolved.target_qn)
                    if dst_id is not None:
                        self.store.add_edge(src_id, dst_id, EdgeType.CALLS)
                        self.stats["calls_created"] += 1
                        continue
                if resolved.method_name:
                    targets = self.registry.find_by_simple_name(resolved.method_name)
                    if 0 < len(targets) <= self.max_name_fanout:
                        for t in targets:
                            tid = self.store.id_of(t)
                            if tid is not None:
                                self.store.add_edge(src_id, tid, EdgeType.CALLS)
                                self.stats["calls_by_name"] += 1
                        continue
                self.stats["calls_unresolved"] += 1

    # ---- one-shot build ------------------------------------------------

    def build(self, parsed_files: list[ParsedFile],
              project: str | None = None) -> GraphStore:
        if project:
            self.create_project(project)
        for parsed in parsed_files:
            self.register_file(parsed)
        self.finish_registration(parsed_files)
        for parsed in parsed_files:
            self.build_calls(parsed)
        self.store.finalize()
        return self.store

    # ---- watch-mode incremental ---------------------------------------

    def rebuild_file(self, old_path: str, parsed: ParsedFile,
                     all_parsed: list[ParsedFile]) -> None:
        """Delete + rebuild one file's nodes and edges.

        Reference: watcher flow `pipeline/watcher.py:208-294` +
        `graph/builder.py:86-143` (delete CALLS for file, rebuild).
        """
        self.registry.remove_by_prefix(parsed.file_info.module_name)
        self.store.remove_file_nodes(old_path)
        self.register_file(parsed)
        self.finish_registration(all_parsed)
        self.call_processor.clear_cache()
        self.build_calls(parsed)
        self.store.finalize()
