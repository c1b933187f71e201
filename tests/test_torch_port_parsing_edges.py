"""The port's parser, chunker and orchestrator against the JAX package's on
the inputs of the JAX package's edge-case tests.

Each case's source goes through both packages:
- the 21 sources of `tests/test_extractors_edge.py`: the `ParsedFile`s
  equal field by field (every entity, the imports, the file's module),
  and so do their chunks and payloads (`CodeChunker` under
  `ApproxTokenCounter`);
- the 5 sources of `tests/test_chunker_gaps.py`: equal chunks (names,
  types, lines, contents, payloads, ids), gap chunks included;
- `tests/test_resilience.py`'s parser fuzz (30 byte salads and 9 broken
  shapes, each in Python, JavaScript and TypeScript), its BOM and CRLF
  variants (equal `ParsedFile`s, lines included), and its two pipeline
  faults: a poisoned second embed batch and an embedder that always
  fails, through both `PipelineOrchestrator`s (errors, tracker state,
  indexer stats).
All comparisons are exact.
"""

import asyncio
import dataclasses
import enum
import shutil
from pathlib import Path

import numpy as np
import pytest

from lattice_tpu.config.settings import Settings as JaxSettings
from lattice_tpu.core.types import Language as JaxLanguage
from lattice_tpu.embeddings.chunker import CodeChunker as JaxChunker
from lattice_tpu.embeddings.embedder import Embedder as JaxEmbedder
from lattice_tpu.parsing.models import FileInfo as JaxFileInfo
from lattice_tpu.parsing.parser import CodeParser as JaxParser
from lattice_tpu.pipeline.orchestrator import \
    PipelineOrchestrator as JaxOrchestrator
from lattice_tpu.text.tokenizer import ApproxTokenCounter as JaxApprox
from lattice_tpu_torch.config.settings import Settings
from lattice_tpu_torch.core.types import Language
from lattice_tpu_torch.embeddings.chunker import GAP_MIN_LINES, CodeChunker
from lattice_tpu_torch.embeddings.embedder import Embedder
from lattice_tpu_torch.parsing.models import FileInfo
from lattice_tpu_torch.parsing.parser import CodeParser
from lattice_tpu_torch.pipeline.orchestrator import PipelineOrchestrator
from lattice_tpu_torch.text.tokenizer import ApproxTokenCounter

PY, JS, TS, TSX = "python", "javascript", "typescript", "tsx"
EXT = {PY: "py", JS: "js", TS: "ts", TSX: "tsx"}

# tests/test_extractors_edge.py, case by case
EXTRACTOR_EDGES = {
    "decorated_class": (PY, "@dataclass(frozen=True)\nclass Point:\n"
                        "    x: int\n"),
    "async_generator_and_lambda": (PY, (
        "async def stream():\n"
        "    async for item in source():\n"
        "        yield transform(item)\n"
        "handler = lambda x: x\n")),
    "property_and_dunder": (PY, (
        "class A:\n"
        "    @property\n"
        "    def size(self):\n"
        "        return len(self._items)\n"
        "    def __repr__(self):\n"
        "        return 'A'\n")),
    "multiple_assignment_and_walrus": (PY, (
        "def go():\n"
        "    a = b = make()\n"
        "    if (n := count()) > 0:\n"
        "        use(n)\n")),
    "class_in_function": (PY, (
        "def factory():\n"
        "    class Inner:\n"
        "        def run(self):\n"
        "            pass\n"
        "    return Inner\n")),
    "template_literal_nesting": (JS, (
        "function f(a) {\n"
        "  const s = `outer ${inner(`nested ${deep(a)}`)} done`;\n"
        "  return s;\n"
        "}\n")),
    "regex_literal_not_confused": (JS, (
        "function clean(s) {\n"
        "  return s.replace(/class {/g, '');\n"
        "}\n"
        "function after() { return 1; }\n")),
    "getter_setter_private": (JS, (
        "class Box {\n"
        "  #items = [];\n"
        "  get size() { return this.#items.length; }\n"
        "  set size(v) { throw new Error('no'); }\n"
        "  #secret() { return 42; }\n"
        "}\n")),
    "generator_methods": (JS, (
        "class Seq {\n"
        "  *items() { yield 1; }\n"
        "  async *stream() { yield await fetchOne(); }\n"
        "}\n")),
    "iife_not_extracted_as_entity": (JS, (
        "(function() { setup(); })();\n"
        "const x = (() => init())();\n")),
    "abstract_class_and_generics": (TS, (
        "export abstract class Repo<T extends Entity> {\n"
        "  abstract find(id: string): Promise<T>;\n"
        "  list(): T[] { return query(this.table); }\n"
        "}\n")),
    "namespace_collision_interface_class": (TS, (
        "export interface Config { url: string }\n"
        "export class Config {\n"
        "  constructor(public url: string) {}\n"
        "}\n")),
    "arrow_with_generic_annotation": (TS, (
        "export const pick = <T,>(xs: T[], i: number): T => xs[i];\n"
        "export const go = async (u: User): Promise<void> => {\n"
        "  await save(u);\n"
        "};\n")),
    "jsx_component": (TSX, (
        "export function Card({ user }: Props) {\n"
        "  return <div onClick={() => select(user)}>{format(user.name)}"
        "</div>;\n"
        "}\n")),
    "regex_containing_escaped_slashes": (JS, (
        "const re = /https:\\/\\/[a-z]+\\/path/g;\n"
        "function after() { return 1; }\n")),
    "regex_containing_quotes": (JS, (
        "const re = /don't \"quote\" me/;\n"
        "function after() { return 2; }\n")),
    "division_not_taken_as_regex": (JS, (
        "function calc(a, b, c) { return a / b / c; }\n"
        "function after() { return 3; }\n")),
    "class_fields_do_not_break_method_scan": (JS, (
        "class Widget {\n"
        "  count = 0;\n"
        "  #secret = \"x\";\n"
        "  static kind = \"widget\";\n"
        "  handler = async (e) => { await this.save(e); };\n"
        "  render() { return this.count; }\n"
        "}\n")),
    "ts_decorators_on_class_and_members": (TS, (
        "@Component({selector: \"app\"})\n"
        "export class AppComponent {\n"
        "  @Input() name: string;\n"
        "  @HostListener(\"click\")\n"
        "  onClick() { return this.name; }\n"
        "}\n")),
    "async_static_generator_methods": (JS, (
        "class Api {\n"
        "  async fetch() { return 1; }\n"
        "  static async create() { return new Api(); }\n"
        "  async *stream() { yield 1; }\n"
        "}\n")),
    "default_export_async_function": (JS, (
        "export default async function main() { return 42; }\n")),
}

# tests/test_chunker_gaps.py's sources
_BODY = "\n".join(f"CONST_{i} = compute({i})"
                  for i in range(GAP_MIN_LINES + 2))
_HEADER = "\n".join(f"# license line {i}" for i in range(GAP_MIN_LINES + 5))
_JS_BODY = "\n".join(f"registry.set('k{i}', () => handler({i}));"
                     for i in range(GAP_MIN_LINES + 2))
_X_BODY = "\n".join(f"x{i} = {i}" for i in range(GAP_MIN_LINES + 2))
CHUNKER_GAPS = {
    "module_level_block_becomes_gap_chunk": (
        PY, f"def covered():\n    return 1\n\n{_BODY}\n"),
    "fully_covered_file_emits_no_gap_chunks": (PY, (
        "import os\n"
        "import sys\n"
        "\n"
        "def a():\n    return os.sep\n"
        "\n"
        "def b():\n    return sys.path\n")),
    "comment_only_gaps_ignored": (
        PY, f"{_HEADER}\n\ndef f():\n    return 1\n"),
    "lexer_miss_degrades_to_gap_chunk": (
        JS, f"function known() {{ return 1; }}\n{_JS_BODY}\n"),
    "gap_line_numbers_are_real_file_lines": (
        PY, f"def covered():\n    return 1\n\n{_X_BODY}\n"),
}


def _fuzz_snippets() -> list[str]:
    """`tests/test_resilience.py`'s fuzz inputs, from its seed."""
    rng = np.random.default_rng(1234)
    out = []
    for _ in range(30):
        raw = bytes(rng.integers(0, 256, rng.integers(1, 400)).tolist())
        out.append(raw.decode("utf-8", errors="replace"))
    return out + [
        "def f(:\n  pass", "class { x = ", "const a = \"unterminated",
        "import \x00\x01", "(((((((((((", "/* never closed",
        "`template ${", "def g():\n\treturn (", "interface X {",
    ]


FUZZ = _fuzz_snippets()

_PY_SRC = ("class Foo:\n"
           "    def bar(self):\n"
           "        return 1\n"
           "def baz():\n"
           "    return Foo()\n")
_TS_SRC = ("export interface Shape {\n"
           "  area(): number;\n"
           "}\n"
           "export class Circle {\n"
           "  area() { return 3.14; }\n"
           "}\n")
# tests/test_resilience.py's TestRealWorldEncodings variants
ENCODINGS = {
    "py_clean": (PY, _PY_SRC),
    "py_bom": (PY, "\ufeff" + _PY_SRC),
    "py_crlf": (PY, _PY_SRC.replace("\n", "\r\n")),
    "ts_clean": (TS, _TS_SRC),
    "ts_bom_crlf": (TS, "\ufeff" + _TS_SRC.replace("\n", "\r\n")),
}


def plain(x):
    """A value with dataclasses, enums and paths turned into plain data, so
    that the two packages' objects compare (as in
    `tests/test_torch_port_parsing.py`)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, Path):
        return str(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def parsers():
    return JaxParser(), CodeParser()


def _parse_both(parsers, language: str, source: str, name: str):
    jax_parser, port_parser = parsers
    return (jax_parser.parse_content(source, JaxLanguage(language), name),
            port_parser.parse_content(source, Language(language), name))


def _same_parsed(a, b) -> None:
    assert plain(b.file_info) == plain(a.file_info)
    assert b.file_info.module_name == a.file_info.module_name
    assert plain(b.imports) == plain(a.imports)
    assert plain(b.entities) == plain(a.entities)
    assert [(e.qualified_name, e.entity_type.value, e.start_line,
             e.end_line) for e in b.all_entities] == \
        [(e.qualified_name, e.entity_type.value, e.start_line, e.end_line)
         for e in a.all_entities]


def _chunks_both(tmp_path, parsers, language: str, source: str, name: str):
    """Both packages' chunks of `source` written at `tmp_path / name`, as
    `tests/test_chunker_gaps.py` chunks it."""
    path = tmp_path / name
    path.write_text(source)
    a, b = _parse_both(parsers, language, source, name)
    a.file_info = JaxFileInfo(path=path, relative_path=name,
                              language=JaxLanguage(language),
                              size_bytes=len(source))
    b.file_info = FileInfo(path=path, relative_path=name,
                           language=Language(language),
                           size_bytes=len(source))
    return (JaxChunker(token_counter=JaxApprox()).chunk_file(a, "proj"),
            CodeChunker(token_counter=ApproxTokenCounter()).chunk_file(
                b, "proj"))


def _same_chunks(want, got) -> None:
    assert [c.to_payload() for c in got] == [c.to_payload() for c in want]
    assert [c.chunk_id for c in got] == [c.chunk_id for c in want]
    assert [(c.name, c.chunk_type, c.start_line, c.end_line, c.content)
            for c in got] == [(c.name, c.chunk_type, c.start_line,
                               c.end_line, c.content) for c in want]


@pytest.mark.parametrize("case", sorted(EXTRACTOR_EDGES))
def test_extractor_edge_matches(parsers, tmp_path, case):
    language, source = EXTRACTOR_EDGES[case]
    name = f"m.{EXT[language]}"
    _same_parsed(*_parse_both(parsers, language, source, name))
    _same_chunks(*_chunks_both(tmp_path, parsers, language, source, name))


@pytest.mark.parametrize("case", sorted(CHUNKER_GAPS))
def test_chunker_gap_matches(parsers, tmp_path, case):
    language, source = CHUNKER_GAPS[case]
    name = f"mod.{EXT[language]}"
    want, got = _chunks_both(tmp_path, parsers, language, source, name)
    _same_chunks(want, got)
    # the JAX test's own claim holds for the port's chunks too
    gaps = [c for c in got if "segment_L" in c.name]
    assert bool(gaps) == (case not in (
        "fully_covered_file_emits_no_gap_chunks",
        "comment_only_gaps_ignored"))


@pytest.mark.parametrize("language", [PY, JS, TS])
@pytest.mark.parametrize("i", range(len(FUZZ)))
def test_parser_fuzz_matches(parsers, language, i):
    """Neither package raises; both degrade to the same `ParsedFile`."""
    _same_parsed(*_parse_both(parsers, language, FUZZ[i], f"fuzz_{i}.x"))


@pytest.mark.parametrize("case", sorted(ENCODINGS))
def test_bom_and_crlf_match(parsers, case):
    language, source = ENCODINGS[case]
    a, b = _parse_both(parsers, language, source,
                       f"{case}.{EXT[language]}")
    _same_parsed(a, b)
    clean = ENCODINGS[f"{case[:2]}_clean"][1]
    ref = parsers[1].parse_content(clean, Language(language), "c.x")
    assert sorted(e.name for e in b.all_entities) == \
        sorted(e.name for e in ref.all_entities)


class _PoisonEmbedder:
    """`tests/test_resilience.py`'s: the second embed batch raises."""
    dimensions = 32

    def __init__(self):
        self.calls = 0

    def embed(self, text):
        return self.embed_batch([text])[0]

    def embed_batch(self, texts):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("embed blew up")
        return [np.ones(32, dtype=np.float32).tolist() for _ in texts]


class _DeadEmbedder:
    dimensions = 8

    def embed(self, text):
        raise RuntimeError("nope")

    def embed_batch(self, texts):
        raise RuntimeError("nope")


def _run_both(jax_root, port_root, embedder_cls, metadata: bool):
    jax_settings, port_settings = JaxSettings(), Settings()
    jax_settings.metadata.enabled = port_settings.metadata.enabled = metadata
    jax_ctx = asyncio.run(JaxOrchestrator(
        jax_root, JaxEmbedder(embedder_cls()), project_name="faulty",
        settings=jax_settings).run())
    port_ctx = asyncio.run(PipelineOrchestrator(
        port_root, Embedder(embedder_cls()), project_name="faulty",
        settings=port_settings, device="cpu").run())
    return jax_ctx, port_ctx


def _same_outcome(jax_ctx, port_ctx) -> None:
    assert port_ctx.errors == jax_ctx.errors
    assert port_ctx.tracker.failed == jax_ctx.tracker.failed
    assert port_ctx.indexer.stats == jax_ctx.indexer.stats
    assert port_ctx.graph_builder.store.stats == \
        jax_ctx.graph_builder.store.stats


def test_per_file_embed_error_skipped_matches(tmp_path, sample_project_path):
    roots = []
    for side in ("jax", "port"):
        roots.append(tmp_path / side / "proj")
        shutil.copytree(sample_project_path, roots[-1])
    jax_ctx, port_ctx = _run_both(*roots, _PoisonEmbedder, metadata=False)
    _same_outcome(jax_ctx, port_ctx)
    assert port_ctx.tracker.failed is False
    assert any("embed" in e for e in port_ctx.errors)
    assert port_ctx.indexer.stats["files_indexed"] >= 1


def test_stage_failure_tagged_matches(tmp_path):
    roots = []
    for side in ("jax", "port"):
        roots.append(tmp_path / side)
        roots[-1].mkdir()
        (roots[-1] / "a.py").write_text("def f():\n    pass\n")
    jax_ctx, port_ctx = _run_both(*roots, _DeadEmbedder, metadata=True)
    _same_outcome(jax_ctx, port_ctx)
    assert any("embed" in e for e in port_ctx.errors)
