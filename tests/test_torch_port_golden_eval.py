"""The golden eval through the port, end to end, against the JAX package.

Both packages' `build_golden_engine` index the golden fixture (hash
embedder at dim 256; the port's on `device="cpu"`). Each of the 104
cases goes through the engine path it names (`search_sync` or
`deep_search`) in both: the top-10 qualified names equal and in order,
scores within 1e-5, the same first-hit rank. The port's `evaluate` gives
the JAX package's dict: n 104, mrr 0.9148, hit@5 0.9904, hit@10 1.0,
search mrr 0.92, deep mrr 0.875, no misses. With both packages' stores
served through "quantized", the card's auto plan, every case agrees as
well, at mrr 0.9164 (search 0.9218, deep 0.875): the numbers
`chip_smoke.py` holds the card to. `query_sync` answers agree on 8
cases. Then a copy of `lattice_tpu/query/` and `lattice_tpu/index/`
is indexed through both orchestrators and 16 questions about it go
through `search_sync` and `deep_search` in both, alike.
"""

import asyncio
import functools
import shutil
from pathlib import Path

import pytest

from chip_smoke import GOLDEN_EVAL, answer_cases
from lattice_tpu.query import golden_eval as jge
from lattice_tpu_torch.query import golden_eval as pge

REPO = Path(__file__).resolve().parent.parent
CASES = jge.load_cases()
K = 10
SCORE_TOL = 1e-5
ANSWER_CASES = answer_cases(CASES)   # 4 `search` and 4 `deep` cases
REPO_QUESTIONS = [
    "where is plan_heuristic defined?",
    "where is build_golden_engine defined?",
    "where is GraphStore defined?",
    "who calls execute_query_plan?",
    "who calls rank_results?",
    "who calls lexical_candidates?",
    "what does QueryEngine call?",
    "what does ContextBuilder call?",
    "what methods does HybridRanker have?",
    "what methods does ChunkStore have?",
    "what does golden_eval.py import?",
    "call chain from query_sync to rank_results",
    "how is the lexical channel implemented?",
    "explain how deep_search ranks every chunk",
    "find code similar to the result scorer",
    "inverted index of payload fields",
]


def _run(engine, case) -> list:
    if case["path"] == "deep":
        return engine.deep_search(case["query"], limit=K).results
    return engine.search_sync(case["query"], limit=K).results


def _same_results(a, b, where) -> None:
    """Top-10 qualified names equal and in order, scores within 1e-5."""
    assert [r.qualified_name for r in a[:K]] == \
        [r.qualified_name for r in b[:K]], where
    for x, y in zip(a[:K], b[:K]):
        assert abs(x.score - y.score) <= SCORE_TOL, (where, x.score, y.score)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, _ = jge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("jax")))
    peng, _ = pge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("port")), device="cpu")
    return jeng, peng


@pytest.fixture(scope="module")
def results(engines):
    jeng, peng = engines
    return [(_run(jeng, c), _run(peng, c)) for c in CASES]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_case_matches_jax(results, i):
    case = CASES[i]
    j, p = results[i]
    _same_results(p, j, case["query"])
    expect = set(case["expect"])
    assert jge._rank_of_first_hit(p, expect, K) == \
        jge._rank_of_first_hit(j, expect, K) is not None, case["query"]


def test_evaluate_gives_the_reference_numbers(engines):
    jeng, peng = engines
    assert len(CASES) == 104
    got = pge.evaluate(peng, pge.load_cases())
    assert got == jge.evaluate(jeng, CASES)
    assert got == GOLDEN_EVAL["flat"]


def test_quantized_plan_matches_jax(engines, monkeypatch):
    """Served through "quantized" (the auto plan of a store on the card:
    an int8 first stage, then the exact rescore with the f32 query),
    both packages give the same top 10 for every case and the same
    numbers, `GOLDEN_EVAL["quantized"]`, which `chip_smoke.py` holds the
    card to."""
    for engine in engines:
        for store in (engine.indexer.code, engine.indexer.summaries):
            monkeypatch.setattr(store, "search", functools.partial(
                store.search, method="quantized"))
    jeng, peng = engines
    for case in CASES:
        _same_results(_run(peng, case), _run(jeng, case), case["query"])
    got = pge.evaluate(peng, CASES)
    assert got == jge.evaluate(jeng, CASES) == GOLDEN_EVAL["quantized"]


def test_query_sync_answers_match_jax(engines):
    jeng, peng = engines
    assert len(ANSWER_CASES) == 8
    for i in ANSWER_CASES:
        text = CASES[i]["query"]
        j, p = jeng.query_sync(text, limit=K), peng.query_sync(text, limit=K)
        assert p.answer == j.answer, text
        assert "Top results:" in p.answer, text
        _same_results(p.results, j.results, text)
        assert set(p.phase_times_ms) == set(j.phase_times_ms)


def _index_copy(pkg: str, root: Path):
    """A copy of `lattice_tpu/query/` and `lattice_tpu/index/` under a
    repository root, indexed by `pkg`'s orchestrator (hash embedder, dim
    256, metadata off); returns its engine."""
    import importlib
    settings_m = importlib.import_module(f"{pkg}.config.settings")
    embedder_m = importlib.import_module(f"{pkg}.embeddings.embedder")
    hash_m = importlib.import_module(f"{pkg}.providers.hash_provider")
    orch_m = importlib.import_module(f"{pkg}.pipeline.orchestrator")
    engine_m = importlib.import_module(f"{pkg}.query.engine")
    repo = root / "repo"
    for sub in ("query", "index"):
        shutil.copytree(REPO / "lattice_tpu" / sub, repo / "lattice_tpu" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "lattice_tpu" / "__init__.py",
                repo / "lattice_tpu" / "__init__.py")
    settings = settings_m.Settings()
    settings.metadata.enabled = False
    kw = {"device": "cpu"} if pkg == "lattice_tpu_torch" else {}
    orch = orch_m.PipelineOrchestrator(
        repo, embedder_m.Embedder(hash_m.HashEmbedder(dimensions=256)),
        project_name="lattice_tpu", settings=settings, **kw)
    ctx = asyncio.run(orch.run())
    assert ctx.errors == []
    return engine_m.QueryEngine(ctx.graph_builder.store, ctx.indexer)


def test_real_package_copy_answers_alike(tmp_path):
    jeng = _index_copy("lattice_tpu", tmp_path / "jax")
    peng = _index_copy("lattice_tpu_torch", tmp_path / "port")
    assert peng.graph_store.stats == jeng.graph_store.stats
    assert peng.indexer.stats == jeng.indexer.stats
    assert len(REPO_QUESTIONS) == 16
    for q in REPO_QUESTIONS:
        j, p = jeng.search_sync(q, limit=K), peng.search_sync(q, limit=K)
        assert p.results, q
        _same_results(p.results, j.results, q)
        assert p.query_plan.intent == j.query_plan.intent
        j, p = jeng.deep_search(q, limit=K), peng.deep_search(q, limit=K)
        assert p.results, q
        _same_results(p.results, j.results, q)
