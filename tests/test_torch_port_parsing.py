"""The port's host parsing stack against the JAX package's, file by file.

For every file of the golden fixture and of `lattice_tpu/parsing/` (the
reference's own parser as a corpus), each package scans, parses and
builds its graph on its own:
- the port's `ParsedFile` equals the reference's, field by field: every
  entity (qualified name, type, lines, docstring, signature, code,
  decorators, bases, calls, children), the imports, the file's module
  name, language and content hash;
- `CallProcessor.resolve_call` gives the same resolution for every call
  site of every function and method;
- `CodeChunker` under `ApproxTokenCounter` gives the same chunks and
  payloads.
Then the settings (`Settings.from_env` on a written `.env`, the
validators) and, where `g++` is present, the C++ host library of each
package on the same inputs: SHA-256, the BPE count and the bounded BFS.
"""

import dataclasses
import enum
import shutil
from pathlib import Path

import numpy as np
import pytest

from lattice_tpu.config import settings as jax_settings
from lattice_tpu.embeddings.chunker import CodeChunker as JaxChunker
from lattice_tpu.graph.builder import GraphBuilder as JaxBuilder
from lattice_tpu.index.graph_store import GraphStore as JaxGraphStore
from lattice_tpu.parsing.parser import CodeParser as JaxParser
from lattice_tpu.parsing.scanner import FileScanner as JaxScanner
from lattice_tpu.text.tokenizer import ApproxTokenCounter as JaxApprox
from lattice_tpu.utils import native as jax_native
from lattice_tpu_torch.config import settings as port_settings
from lattice_tpu_torch.core.types import EdgeType, EntityType
from lattice_tpu_torch.embeddings.chunker import CodeChunker
from lattice_tpu_torch.graph.builder import GraphBuilder
from lattice_tpu_torch.index.graph_store import GraphStore
from lattice_tpu_torch.parsing.parser import CodeParser
from lattice_tpu_torch.parsing.scanner import FileScanner
from lattice_tpu_torch.text.tokenizer import (ApproxTokenCounter,
                                              get_token_counter)
from lattice_tpu_torch.utils import native as port_native

REPO = Path(__file__).resolve().parent.parent
CORPORA = {"golden": REPO / "tests" / "fixtures" / "golden_project",
           "parsing": REPO / "lattice_tpu" / "parsing"}
FILES = sorted(
    (name, str(p.relative_to(root)))
    for name, root in CORPORA.items() for p in root.rglob("*")
    if p.suffix in (".py", ".js", ".ts", ".tsx") and "__pycache__" not in p.parts)


def plain(x):
    """A value with dataclasses, enums and paths turned into plain data,
    so that the two packages' objects compare."""
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


def _index(root, scanner, parser, builder):
    parsed = [parser.parse_file(fi) for fi in scanner(root).scan_all()
              if parser.supports(fi.language)]
    graph = builder()
    graph.build(parsed, project="p")
    return {p.file_info.relative_path: p for p in parsed}, graph


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, root in CORPORA.items():
        out[name] = (_index(root, JaxScanner, JaxParser(), JaxBuilder),
                     _index(root, FileScanner, CodeParser(), GraphBuilder))
    return out


def test_every_file_is_parsed(corpora):
    for name, ((jp, _), (pp, _)) in corpora.items():
        assert sorted(pp) == sorted(jp)
        assert sorted((n, f) for n, f in FILES if n == name) == \
            sorted((name, f) for f in pp)
    assert len(corpora["golden"][1][0]) == 68


@pytest.mark.parametrize("corpus,path", FILES)
def test_parsed_file_matches(corpora, corpus, path):
    (jp, _), (pp, _) = corpora[corpus]
    a, b = jp[path], pp[path]
    assert plain(b.file_info) == plain(a.file_info)
    assert b.file_info.module_name == a.file_info.module_name
    assert len(b.file_info.content_hash) == 64
    assert plain(b.imports) == plain(a.imports)
    assert plain(b.entities) == plain(a.entities)
    assert [(e.qualified_name, e.entity_type.value) for e in b.all_entities] \
        == [(e.qualified_name, e.entity_type.value) for e in a.all_entities]


def _resolutions(parsed, builder):
    info = parsed.file_info
    out = []
    builder.call_processor.clear_cache()
    for entity in parsed.all_entities:
        if entity.entity_type.value not in ("function", "method"):
            continue
        class_qn = None
        if entity.entity_type.value == "method":
            class_qn = (entity.qualified_name or "").rsplit(".", 1)[0] or None
        for call in entity.calls:
            out.append((entity.qualified_name, call, plain(
                builder.call_processor.resolve_call(
                    call, entity, info.module_name, info.language,
                    class_qn))))
    return out


@pytest.mark.parametrize("corpus,path", FILES)
def test_call_resolution_matches(corpora, corpus, path):
    (jp, jb), (pp, pb) = corpora[corpus]
    assert _resolutions(pp[path], pb) == _resolutions(jp[path], jb)


@pytest.mark.parametrize("corpus,path", FILES)
def test_chunks_match(corpora, corpus, path):
    (jp, _), (pp, _) = corpora[corpus]
    a = JaxChunker(token_counter=JaxApprox()).chunk_file(jp[path], "proj")
    b = CodeChunker(token_counter=ApproxTokenCounter()).chunk_file(
        pp[path], "proj")
    assert [c.to_payload() for c in b] == [c.to_payload() for c in a]
    assert [c.chunk_id for c in b] == [c.chunk_id for c in a]


def test_graphs_match(corpora):
    for (_, jb), (_, pb) in corpora.values():
        js, ps = jb.store, pb.store
        assert ps.stats == js.stats and pb.stats == jb.stats
        assert ps._qns == js._qns and ps._types == js._types
        for et in EdgeType:
            for a, b in zip(js.edges(et), ps.edges(et)):
                assert np.array_equal(a, b)


def test_settings_from_env_match(tmp_path, monkeypatch):
    for key in ("LATTICE_PLATFORM", "LATTICE_INDEX_DTYPE", "EMBEDDING_PROVIDER",
                "EMBEDDING_DIMENSIONS", "CHUNK_MAX_TOKENS",
                "CHUNK_OVERLAP_TOKENS", "QUERY_SEARCH_LIMIT",
                "LATTICE_DATA_DIR", "LATTICE_USE_PALLAS", "TOKENIZER_VOCAB"):
        monkeypatch.delenv(key, raising=False)
    env = tmp_path / ".env"
    env.write_text("# written by the test\nLATTICE_PLATFORM=cpu\n"
                   "LATTICE_INDEX_DTYPE='float32'\nEMBEDDING_PROVIDER=\"hash\"\n"
                   "EMBEDDING_DIMENSIONS=384\nCHUNK_MAX_TOKENS=512\n"
                   "CHUNK_OVERLAP_TOKENS=64\nQUERY_SEARCH_LIMIT=7\n"
                   "LATTICE_DATA_DIR=.idx\nLATTICE_USE_PALLAS=false\n"
                   "not a setting\n")
    monkeypatch.setenv("QUERY_SEARCH_LIMIT", "9")    # the environment wins
    a = jax_settings.Settings.from_env(env).model_dump()
    b = plain(port_settings.Settings.from_env(env))
    assert b == plain(a)
    assert b["indexing"]["chunk_max_tokens"] == 512
    assert b["query"]["search_limit"] == 9 and b["device"]["use_pallas"] is False
    assert plain(port_settings.Settings()) == plain(
        jax_settings.Settings().model_dump())
    p = port_settings.Settings.from_env(env)
    assert (p.embedding_dimensions, p.chunk_max_tokens, p.chunk_overlap_tokens,
            p.search_limit, p.max_concurrent) == (384, 512, 64, 9, 5)


@pytest.mark.parametrize("max_tokens,overlap", [(100, 100), (100, 250),
                                                (1000, 1000)])
def test_settings_reject_the_same_overlap(max_tokens, overlap):
    with pytest.raises(ValueError):
        jax_settings.IndexingSettings(chunk_max_tokens=max_tokens,
                                      chunk_overlap_tokens=overlap)
    with pytest.raises(ValueError):
        port_settings.IndexingSettings(chunk_max_tokens=max_tokens,
                                       chunk_overlap_tokens=overlap)
    with pytest.raises(ValueError):
        port_settings.AISettings(embedding_dimensions=4097)
    ok = port_settings.IndexingSettings(chunk_max_tokens=max_tokens,
                                        chunk_overlap_tokens=max_tokens - 1)
    assert ok.chunk_overlap_tokens == max_tokens - 1


def test_settings_normalise_extensions():
    exts = ["py", ".js", "tsx"]
    assert port_settings.FileSettings(extensions=exts).extensions == \
        jax_settings.FileSettings(extensions=exts).extensions == \
        [".py", ".js", ".tsx"]
    assert port_settings.get_settings() is port_settings.get_settings()
    port_settings.reset_settings()


# ---- the C++ host library ---------------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the C++ host library")


@pytest.fixture(scope="module")
def libs():
    return jax_native.get_lib(), port_native.get_lib()


@needs_gxx
def test_native_library_builds_under_build(libs):
    assert all(lib is not None for lib in libs)
    path = port_native.library_path()
    assert path.is_file() and path.parent.parent == port_native.BUILD_ROOT
    assert port_native.BUILD_ROOT == REPO / "build" / "lattice_tpu_torch" / \
        "native"


@needs_gxx
@pytest.mark.parametrize("corpus,path", FILES[::7])
def test_native_sha256_matches(libs, corpus, path):
    full = str(CORPORA[corpus] / path)
    assert port_native.sha256_file(full) == jax_native.sha256_file(full)
    data = Path(full).read_bytes()
    assert port_native.sha256_bytes(data) == jax_native.sha256_bytes(data)


@needs_gxx
def test_native_bpe_count_matches(libs, tmp_path):
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: test\nh e\nt he\nl o\nlo w\nĠ t\nd e\nde f\n")
    a = jax_native.BPECounter(str(merges))
    b = port_native.BPECounter(str(merges))
    counter = get_token_counter(str(merges))
    assert counter.name == "native-bpe"
    assert get_token_counter(None).name == ApproxTokenCounter.name
    assert get_token_counter(str(tmp_path / "none.txt")).name == \
        ApproxTokenCounter.name
    texts = ["the low lox", "", "def f(x):\n    return the_low(x)\n"]
    texts += [(CORPORA[c] / p).read_text() for c, p in FILES[::11]]
    for t in texts:
        assert b.count(t) == a.count(t) == counter.count(t)


@needs_gxx
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_bfs_matches(libs, seed, monkeypatch):
    from lattice_tpu.core.types import EdgeType as JaxEdge
    from lattice_tpu.core.types import EntityType as JaxEntity
    rng = np.random.default_rng(seed)
    n, e = 400, 1600
    edges = rng.integers(0, n, size=(e, 2))
    stores = []
    for cls, et, kind in ((JaxGraphStore, JaxEdge.CALLS, JaxEntity.FUNCTION),
                          (GraphStore, EdgeType.CALLS, EntityType.FUNCTION)):
        s = cls()
        for i in range(n):
            s.add_node(f"m.f{i}", kind, file_path=f"f{i % 9}.py")
        for a, b in edges:
            s.add_edge(int(a), int(b), et)
        s.remove_file_nodes("f3.py")       # tombstones: dead nodes skipped
        s.finalize()
        stores.append((s, et))
    (js, jet), (ps, pet) = stores
    seeds = [rng.integers(0, n, size=3).tolist() for _ in range(8)]
    for hops, limit in ((1, 0), (3, 0), (5, 20), (8, 50)):
        for rev in (False, True):
            for ss in seeds:
                a = js._host_bfs(ss, jet, hops, reverse=rev, limit=limit)
                b = ps._host_bfs(ss, pet, hops, reverse=rev, limit=limit)
                assert np.array_equal(a[0], b[0])
                assert np.array_equal(a[1], b[1])
                assert ps.k_hop(ss, pet, hops, reverse=rev, limit=limit) \
                    == js.k_hop(ss, jet, hops, reverse=rev, limit=limit)
            pairs = zip(js._host_bfs_batch(seeds, jet, hops, reverse=rev,
                                           limit=limit, force_batch=True),
                        ps._host_bfs_batch(seeds, pet, hops, reverse=rev,
                                           limit=limit, force_batch=True))
            for (ja, jd), (pa, pd) in pairs:
                assert np.array_equal(ja, pa) and np.array_equal(jd, pd)
            assert ps.k_hop_batch(seeds, pet, hops, reverse=rev,
                                  limit=limit) == \
                js.k_hop_batch(seeds, jet, hops, reverse=rev, limit=limit)
    # the NumPy walk over the port's csr_expand, with the library hidden,
    # gives the unbounded walks the same answer
    monkeypatch.setattr(port_native, "get_lib", lambda: None)
    for ss in seeds:
        for hops in (1, 3, 6):
            a = js._host_bfs(ss, jet, hops)
            b = ps._host_bfs(ss, pet, hops)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
