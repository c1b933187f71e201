"""The port's query side against the JAX package, module by module.

Same inputs, made from a seed with numpy or read from the golden set,
through both packages:
- `QueryPlanner.plan_heuristic` and `plan_query` (no provider, and stub
  providers that answer fixed JSON, fenced JSON, prose, a bad intent, or
  raise) on the 104 golden query texts and every planner phrase of the
  JAX package's tests: the same plan, field for field.
- `fused_rank` at N in {1, 37, 4099}, k in {1, 10, 64} on columns with
  UNREACHED rows, NEG_INF vector rows, rows with neither, exact ties and
  degrees above the cap (JAX's `fused_rank` jitted on the CPU): fused
  scores within 1e-6, ids equal except between candidates whose scores
  lie within 1e-6 of each other, the same against `rank_oracle`; the
  port's ties rank the lower row first; `pack_weights` bit-equal.
- On both packages' golden indexes (the port's on the CPU),
  `GraphReasoningEngine.execute_query_plan` for each golden plan (nodes,
  depths, relationships, centrality), then `HybridRanker.rank_results`
  on the same vector hits, `ContextBuilder.build_enriched_context`,
  `format_context_for_llm` and `ResponseGenerator.extractive_answer`:
  equal results, scores and text.
"""

import ast
import asyncio
import dataclasses
import enum
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_tpu.ops import graph_kernels as jgk
from lattice_tpu.ops import ranking as jrank
from lattice_tpu.query import golden_eval as jge
from lattice_tpu.query.context.builder import \
    format_context_for_llm as jformat
from lattice_tpu.query.query_planner import QueryPlanner as JPlanner
from lattice_tpu_torch.embeddings.indexer import \
    VectorSearchResult as PVectorResult
from lattice_tpu_torch.ops import graph_kernels as pgk
from lattice_tpu_torch.ops import ranking as prank
from lattice_tpu_torch.query import golden_eval as pge
from lattice_tpu_torch.query.context.builder import \
    format_context_for_llm as pformat
from lattice_tpu_torch.query.query_planner import QueryPlanner as PPlanner

TESTS = Path(__file__).resolve().parent
TOL = 1e-6
CASES = jge.load_cases()


def _plain(obj):
    """A dataclass tree as dicts and lists, enums as their values, so
    objects of the two packages compare with `==`."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _planner_phrases() -> list[str]:
    """Every string the JAX package's tests hand to the planner: the
    first argument of `plan_heuristic` / `plan_query` calls and the query
    of each (query, QueryIntent.X) parametrize pair."""
    out: list[str] = []
    for path in sorted(TESTS.glob("test_*.py")):
        if path.name.startswith("test_torch_port"):
            continue
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("plan_heuristic", "plan_query")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append(node.args[0].value)
            elif (isinstance(node, ast.Tuple) and len(node.elts) == 2
                  and isinstance(node.elts[0], ast.Constant)
                  and isinstance(node.elts[0].value, str)
                  and isinstance(node.elts[1], ast.Attribute)
                  and isinstance(node.elts[1].value, ast.Name)
                  and node.elts[1].value.id == "QueryIntent"):
                out.append(node.elts[0].value)
    return list(dict.fromkeys(out))


PHRASES = [c["query"] for c in CASES] + _planner_phrases()


class _Stub:
    """An LLM provider whose `complete` answers one fixed text."""

    def __init__(self, answer):
        self.answer = answer

    async def complete(self, messages):
        if isinstance(self.answer, Exception):
            raise self.answer
        return self.answer


STUBS = {
    "none": None,
    "json": json.dumps({
        "intent": "find_usage", "multi_hop": True,
        "entities": [{"name": "DeliveryQueue.drain", "type": "method"},
                     {"name": "validate_email", "type": None}, {"x": 1}],
        "relationships": [{"source": "a", "target": "b"}, "junk"]}),
    "fenced": "Sure:\n```json\n" + json.dumps({
        "intent": "find_hierarchy",
        "entities": [{"name": "BaseService", "type": "class"}]}) + "\n```",
    "prose": "I think it is {\"intent\": \"explain_code\", \"entities\": []}"
             " and that is all.",
    "bad_intent": json.dumps({"intent": "no_such_intent", "entities": []}),
    "garbage": "no json here",
    "raises": RuntimeError("provider down"),
}


def test_phrases_cover_the_golden_set_and_the_jax_tests():
    assert len(CASES) == 104
    assert len(PHRASES) > len(CASES) + 30


def test_plan_heuristic_matches_jax():
    jp, pp = JPlanner(), PPlanner()
    for text in PHRASES:
        assert _plain(pp.plan_heuristic(text)) == \
            _plain(jp.plan_heuristic(text)), text


@pytest.mark.parametrize("stub", sorted(STUBS))
def test_plan_query_matches_jax(stub):
    answer = STUBS[stub]
    jp = JPlanner(None if answer is None else _Stub(answer))
    pp = PPlanner(None if answer is None else _Stub(answer))

    async def both():
        return [(await jp.plan_query(t), await pp.plan_query(t))
                for t in PHRASES]

    for text, (j, p) in zip(PHRASES, asyncio.run(both())):
        assert _plain(p) == _plain(j), (stub, text)
        if answer is None:
            assert _plain(p) == _plain(pp.plan_heuristic(text)), text
    if stub in ("json", "fenced", "prose", "bad_intent"):
        assert p.source == "llm"


# ---- the fuse ---------------------------------------------------------


def fuse_columns(n: int, seed: int) -> tuple[np.ndarray, ...]:
    """[N] columns with every kind of row: UNREACHED (no graph evidence),
    NEG_INF vector scores, rows with neither, negative cosines, exact
    copies of other rows (ties) and degrees past the cap."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 6, n).astype(np.int32)
    depth[rng.random(n) < 0.35] = jgk.UNREACHED
    relevance = rng.choice(np.float32([0.0, 0.3, 0.5, 0.8, 1.0]), n)
    vec = (rng.random(n) * 2 - 1).astype(np.float32)
    vec[rng.random(n) < 0.35] = -1e30
    neither = rng.random(n) < 0.1
    depth[neither] = jgk.UNREACHED
    vec[neither] = -1e30
    match = np.where(rng.random(n) < 0.15,
                     rng.random(n), 0.0).astype(np.float32)
    match[rng.random(n) < 0.05] = 1.0
    degree = rng.integers(0, 200, n).astype(np.int32)
    quality = rng.choice(np.float32([0.0, 0.5, 1.0]), n)
    cols = [depth, relevance, vec, match, degree, quality]
    if n > 4:  # a quarter of the rows copy another row: exact ties
        src = rng.integers(0, n, n // 4)
        dst = rng.integers(0, n, n // 4)
        for c in cols:
            c[dst] = c[src]
    return tuple(cols)


WEIGHTS = [jrank.FuseWeights(),
           jrank.FuseWeights(0.7, 0.3, 0.25, 0.15, 0.4, 1.2, 0.75, 20.0)]


def _check_ids(ids, scores, ref_ids, full):
    """Ids equal slot by slot, except where the other list's id scores
    within TOL of this slot's score (a near-tie)."""
    for slot, (a, b) in enumerate(zip(ids, ref_ids)):
        if a != b:
            assert abs(full[b] - scores[slot]) <= TOL, (slot, a, b)


@pytest.mark.parametrize("n", [1, 37, 4099])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_fused_rank_matches_jax_and_oracle(n, k):
    for seed, w in enumerate(WEIGHTS * 2):
        cols = fuse_columns(n, 1000 * n + 10 * k + seed)
        wj = jrank.pack_weights(w)
        js, ji = jrank.fused_rank(*(jnp.asarray(c) for c in cols),
                                  jnp.asarray(wj), k)
        js, ji = np.asarray(js), np.asarray(ji)
        pt = [torch.from_numpy(c) for c in cols]
        wp = torch.from_numpy(prank.pack_weights(prank.FuseWeights(
            *dataclasses.astuple(w))))
        ps, pi = prank.fused_rank(*pt, wp, k)
        assert ps.dtype == torch.float32 and pi.dtype == torch.int32
        ps, pi = ps.numpy(), pi.numpy()
        assert ps.shape == pi.shape == (min(k, n),)
        full = prank._fuse_scores(*pt, wp).numpy()
        jfull = np.asarray(jrank._fuse_scores(
            *(jnp.asarray(c) for c in cols), jnp.asarray(wj)))
        np.testing.assert_allclose(full, jfull, rtol=0, atol=TOL)
        np.testing.assert_allclose(ps, js, rtol=0, atol=TOL)
        _check_ids(pi, ps, ji, full)
        os_, oi = jrank.rank_oracle(*cols, w, k)
        pos_, poi = prank.rank_oracle(*cols, prank.FuseWeights(
            *dataclasses.astuple(w)), k)
        np.testing.assert_array_equal(poi, oi)
        np.testing.assert_array_equal(pos_, os_)
        # the oracle sums in f64: compare at f32, where NEG_INF rounds
        np.testing.assert_allclose(ps, os_.astype(np.float32), rtol=0,
                                   atol=TOL)
        _check_ids(pi, ps, oi, full)
        # the port's ties rank the lower row first
        for a in range(len(ps) - 1):
            if ps[a] == ps[a + 1]:
                assert pi[a] < pi[a + 1], (a, pi[a], pi[a + 1])


def test_fuse_sentinels_and_signed_zero():
    """UNREACHED, NEG_INF and geometric buckets are the reference's. A row
    with evidence whose every term is zero scores +0.0 in both packages
    (a -0.0 cosine is clamped, then summed with +0.0 terms); a row with
    neither side is NEG_INF, never a zero."""
    assert pgk.UNREACHED == jgk.UNREACHED == 2**30
    assert pgk.UNREACHED.dtype == np.int32
    assert prank.NEG_INF == jrank.NEG_INF == -1e30
    for n in (0, 1, 1023, 1024, 1025, 70_000):
        for floor in (8, 64, 512, 1024):
            assert pgk.geometric_bucket(n, floor) == \
                jgk.geometric_bucket(n, floor)
    depth = np.int32([jgk.UNREACHED, jgk.UNREACHED, 0])
    vec = np.float32([-0.0, -1e30, -1e30])
    zeros = np.zeros(3, np.float32)
    w = jrank.FuseWeights(graph_weight=0.0, context_weight=0.0)
    cols = (depth, zeros, vec, zeros, np.zeros(3, np.int32), zeros)
    p = prank._fuse_scores(*(torch.from_numpy(c) for c in cols),
                           torch.from_numpy(prank.pack_weights(
                               prank.FuseWeights(*dataclasses.astuple(w)))))
    j = np.asarray(jrank._fuse_scores(*(jnp.asarray(c) for c in cols),
                                      jnp.asarray(jrank.pack_weights(w))))
    assert p[0].item() == 0.0 and not torch.signbit(p[0])
    assert j[0] == 0.0 and not np.signbit(j[0])
    assert p[1].item() == float(np.float32(-1e30)) == float(j[1])
    assert p[2].item() == 0.0 and not torch.signbit(p[2])


def test_pack_weights_bit_equal():
    for w in WEIGHTS + [jrank.FuseWeights(0.1, 0.9, 1e-7, 3.3, 0.0, 1.0,
                                          0.999, 7.0)]:
        a = jrank.pack_weights(w)
        b = prank.pack_weights(prank.FuseWeights(*dataclasses.astuple(w)))
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fused_rank_stays_on_its_inputs_device():
    cols = [torch.from_numpy(c) for c in fuse_columns(37, 5)]
    w = torch.from_numpy(prank.pack_weights(prank.FuseWeights()))
    s, i = prank.fused_rank(*cols, w, 10)
    assert s.device == i.device == cols[0].device


# ---- the host stages on the golden indexes ------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, _ = jge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("jax")))
    peng, _ = pge.build_golden_engine(
        work_dir=str(tmp_path_factory.mktemp("port")), device="cpu")
    return jeng, peng


@pytest.fixture(scope="module")
def stages(engines):
    """Each golden case through both packages' host stages, the port's
    ranker fed the JAX vector phase's hits (same inputs)."""
    jeng, peng = engines
    out = []
    for case in CASES:
        jplan = jeng.planner.plan_heuristic(case["query"])
        pplan = peng.planner.plan_heuristic(case["query"])
        jctx, pctx = jeng._graph_phase(jplan), peng._graph_phase(pplan)
        jvec = jeng._vector_phase(jplan, 20)
        pvec = [PVectorResult(**dataclasses.asdict(v)) for v in jvec]
        jranked = jeng.ranker.rank_results(jctx, jvec, jplan, limit=10)
        pranked = peng.ranker.rank_results(pctx, pvec, pplan, limit=10)
        jenr = jeng.context_builder.build_enriched_context(jplan, jctx,
                                                           jranked)
        penr = peng.context_builder.build_enriched_context(pplan, pctx,
                                                           pranked)
        out.append({
            "case": case, "plans": (jplan, pplan), "ctx": (jctx, pctx),
            "ranked": (jranked, pranked), "enriched": (jenr, penr),
            "text": (jformat(jenr), pformat(penr)),
            "answer": (jeng.responder.extractive_answer(jplan, jenr, jranked),
                       peng.responder.extractive_answer(pplan, penr,
                                                        pranked)),
        })
    return out


def test_golden_indexes_agree(engines):
    jeng, peng = engines
    assert peng.graph_store.stats == jeng.graph_store.stats
    assert peng.indexer.code._payloads == jeng.indexer.code._payloads
    assert peng.indexer.code.device.type == "cpu"


def test_graph_reasoning_matches_jax(stages):
    nonempty = 0
    for st in stages:
        j, p = st["ctx"]
        assert _plain(p) == _plain(j), st["case"]["query"]
        nonempty += not p.is_empty
    assert nonempty >= 60


def test_centrality_lookup_matches_jax(engines):
    jeng, peng = engines
    ids = list(range(0, peng.graph_store.n_nodes(), 7))
    assert peng.graph_engine.get_centrality(ids) == \
        jeng.graph_engine.get_centrality(ids)


def test_hybrid_ranker_matches_jax(stages):
    for st in stages:
        j, p = st["ranked"]
        assert _plain(p) == _plain(j), st["case"]["query"]
        assert p, st["case"]["query"]


def test_context_builder_matches_jax(stages):
    for st in stages:
        j, p = st["enriched"]
        assert _plain(p) == _plain(j), st["case"]["query"]
        assert st["text"][1] == st["text"][0], st["case"]["query"]


def test_extractive_answer_matches_jax(stages):
    for st in stages:
        assert st["answer"][1] == st["answer"][0], st["case"]["query"]
        assert "Top results:" in st["answer"][1]
