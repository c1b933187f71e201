"""The port's `utils/tracing.py` against the JAX package's, and its hot
path.

`Tracer`'s always-on spans are the JAX package's: the same spans give the
same report in both packages. Its hot spans and counters record only
while tracing is on (a `torch.profiler` session, `enable()`,
`LATTICE_TRACE=1`), keep self time, and lie in the profiler's Chrome trace
as nested annotations; the search and encoder paths record theirs once a
call. The device-trace reader reads `torch.profiler`'s Chrome trace in
place of an XSpace capture: a trace of a small CPU region summarizes to a
non-negative total (as `tests/test_subsystems.py`'s
`TestDeviceTraceSummary` checks of the JAX reader), a missing directory
gives {"error": ...}, and a written trace with CUDA kernel events sums
them by name.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile

from lattice_tpu.utils import tracing as jax_tracing
from lattice_tpu_torch.utils import tracing
from lattice_tpu_torch.utils.tracing import (device_trace, get_tracer,
                                             summarize_device_trace)

ROOT = Path(__file__).resolve().parents[1]
SEARCH_STAGES = ("search.quantize", "search.first_stage", "search.rescore")


def test_span_aggregation():
    """`tests/test_graph_store.py`'s `TestTracer`, on the port's copy."""
    tracer = tracing.Tracer()
    for _ in range(3):
        with tracer.span("phase.x"):
            pass
    report = tracer.report()
    assert report["phase.x"]["count"] == 3
    assert report["phase.x"]["total_ms"] >= 0
    tracer.reset()
    assert tracer.report() == {}


def test_report_has_the_jax_packages_shape():
    mine, ref = tracing.Tracer(), jax_tracing.Tracer()
    for tracer in (mine, ref):
        for name in ("b.scan", "a.plan", "b.scan"):
            with tracer.span(name):
                pass
        tracer.spans["a.plan"].record(2.5)
    got, want = mine.report(), ref.report()
    assert list(got) == list(want) == ["a.plan", "b.scan"]
    for name in got:
        assert set(got[name]) == set(want[name])
        assert got[name]["count"] == want[name]["count"]
    assert got["a.plan"]["max_ms"] == want["a.plan"]["max_ms"] == 2.5


def test_global_tracer_is_one_object():
    assert get_tracer() is get_tracer()
    assert isinstance(get_tracer(), tracing.Tracer)


def test_cpu_capture_parses(tmp_path):
    with device_trace(str(tmp_path)):
        x = torch.ones((256, 256))
        float((x @ x).sum())
    out = summarize_device_trace(str(tmp_path))
    assert "error" not in out
    assert any("CPU" in p for p in out["planes"])
    assert out["total_ms"] >= 0.0
    # no card here: no device events
    assert not torch.cuda.is_available() and out["ops"] == []


def test_missing_capture(tmp_path):
    assert "error" in summarize_device_trace(str(tmp_path / "nope"))


def _kernel(name, dur, stream=7, device=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": device,
            "tid": stream, "ts": 0.0, "dur": dur,
            "args": {"device": device, "stream": stream}}


@pytest.fixture
def written_trace(tmp_path):
    """A trace as torch.profiler writes one on the card: host ops, kernels
    on two streams, a memcpy."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 900.0},
        _kernel("void (anonymous namespace)::scan_topk_kernel<2, 64, 128>"
                "(signed char const*)", 3000.0),
        _kernel("void (anonymous namespace)::score_probe_kernel<0, true>()",
                600.0),
        _kernel("void (anonymous namespace)::score_probe_kernel<3, false>()",
                400.0),
        _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128",
                500.0),
        _kernel("void at::native::vectorized_elementwise_kernel<4>()", 400.0),
        _kernel("void at::native::vectorized_elementwise_kernel<4>()", 100.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 5.0, cat="gpu_memcpy"),
        _kernel("void at::native::bitonicSortKVInPlace<float>()", 50.0,
                stream=9),
    ]
    (tmp_path / "1.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    return str(tmp_path)


def test_summary_sums_device_time_by_name(written_trace):
    out = summarize_device_trace(written_trace, top=3)
    assert out["planes"] == ["/device:GPU:0", "/host:CPU"]
    assert out["total_ms"] == pytest.approx(5.055)
    names = [n for n, _, _ in out["ops"]]
    assert len(names) == 3 and "scan_topk_kernel" in names[0]
    assert out["ops"][2][1] == pytest.approx(0.5)    # both elementwise
    assert out["ops"][0][2] == pytest.approx(3000 / 5055)
    assert summarize_device_trace(written_trace, "GPU:1")["total_ms"] == 0


def test_newest_trace_is_read(written_trace, tmp_path):
    (tmp_path / "2.pt.trace.json").write_text(json.dumps({"traceEvents": [
        _kernel("void (anonymous namespace)::ivf_probe_kernel()", 10.0)]}))
    out = summarize_device_trace(written_trace)
    assert out["total_ms"] == pytest.approx(0.01)


# ---- the hot path --------------------------------------------------------


@pytest.fixture
def traced():
    """The process tracer, emptied, and emptied again after the test."""
    tracer = get_tracer()
    tracer.reset()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


def test_hot_span_off_records_nothing():
    tracer = tracing.Tracer()
    assert not tracer.on
    first, second = tracer.hot("a"), tracer.hot("b")
    assert first is second is tracing._OFF
    with tracer.hot("a"):
        tracer.count("c", 3)
    assert tracer.snapshot() == {"spans": {}, "counters": {}}
    with tracer.span("cold"):    # the always-on span still records
        pass
    assert tracer.report()["cold"]["count"] == 1


def test_hot_span_under_the_profiler_nests_in_the_trace(tmp_path):
    tracer = tracing.Tracer()
    with profile() as prof:
        assert tracer.on
        with tracer.hot("outer"):
            with tracer.hot("inner"):
                torch.ones(64).sum()
    assert not tracer.on
    assert {k: v["count"] for k, v in tracer.snapshot()["spans"].items()} \
        == {"inner": 1, "outer": 1}
    path = tmp_path / "t.pt.trace.json"
    prof.export_chrome_trace(str(path))
    ann = {ev["name"]: ev for ev in json.loads(path.read_text())["traceEvents"]
           if ev.get("cat") == "user_annotation"}
    outer, inner = ann["outer"], ann["inner"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_enable_turns_recording_on():
    tracer = tracing.Tracer()
    tracer.enable()
    with tracer.hot("a"):
        tracer.count("n", 2)
    tracer.disable()
    with tracer.hot("a"):
        tracer.count("n", 5)
    snap = tracer.snapshot()
    assert snap["spans"]["a"]["count"] == 1 and snap["counters"] == {"n": 2}


def test_lattice_trace_turns_the_process_tracer_on():
    code = ("from lattice_tpu_torch.utils.tracing import get_tracer\n"
            "t = get_tracer()\n"
            "with t.hot('a'):\n"
            "    t.count('n', 4)\n"
            "print(t.on, t.snapshot()['spans']['a']['count'],"
            " t.snapshot()['counters']['n'])\n")
    env = {**os.environ, tracing.TRACE_ENV: "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1", "4"]


def test_self_time_is_the_span_less_its_children(monkeypatch):
    ticks = iter([0.0, 1.0, 4.0, 5.0, 5.5, 10.0])
    monkeypatch.setattr(tracing, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    tracer = tracing.Tracer()
    tracer.enable()
    with tracer.span("outer"):          # 0 .. 10 s
        with tracer.hot("child"):       # 1 .. 4
            pass
        with tracer.hot("child"):       # 5 .. 5.5
            pass
    spans = tracer.snapshot()["spans"]
    assert spans["outer"]["total_ms"] == 10_000
    assert spans["outer"]["self_ms"] == 10_000 - 3_000 - 500
    assert spans["child"]["count"] == 2
    assert spans["child"]["self_ms"] == spans["child"]["total_ms"] == 3_500
    assert spans["child"]["max_ms"] == 3_000


def test_a_span_closed_out_of_order_leaves_no_frame():
    """Two coroutines of one thread may close their spans out of order."""
    tracer = tracing.Tracer()
    first, second = tracer.span("first"), tracer.span("second")
    first.__enter__()
    second.__enter__()
    first.__exit__(None, None, None)
    second.__exit__(None, None, None)
    assert tracer._open.stack == []
    assert {k: v["count"] for k, v in tracer.snapshot()["spans"].items()} \
        == {"first": 1, "second": 1}


def test_counters_add():
    tracer = tracing.Tracer()
    tracer.enable()
    for n in (3, np.int64(4), 0):
        tracer.count("tokens", n)
    tracer.count("other", 1)
    assert tracer.snapshot()["counters"] == {"other": 1, "tokens": 7}
    assert isinstance(tracer.snapshot()["counters"]["tokens"], int)
    tracer.reset()
    assert tracer.snapshot() == {"spans": {}, "counters": {}}


def _rows(n=2048, d=64, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.functional.normalize(torch.randn(n, d, generator=g),
                                         dim=1)


def _counts(tracer):
    return {k: v["count"] for k, v in tracer.snapshot()["spans"].items()}


def test_quantized_view_records_its_stages_once_a_call(traced):
    from lattice_tpu_torch.ops.quant import QuantizedView
    rows = _rows()
    view = QuantizedView(rows)
    valid = torch.ones(rows.shape[0], dtype=torch.bool)
    q = torch.randn(8, rows.shape[1],
                    generator=torch.Generator().manual_seed(1))
    view.search_device(q, valid, 5, full_precision=rows)    # untraced
    assert _counts(traced) == {}
    with profile():
        for _ in range(3):
            view.search_device(q, valid, 5, full_precision=rows)
    assert _counts(traced) == {name: 3 for name in SEARCH_STAGES}


def test_store_search_device_records_five_spans_once_a_call(traced, tmp_path):
    from lattice_tpu_torch.index.chunk_store import ChunkStore
    rows = _rows()
    store = ChunkStore(dim=rows.shape[1], device="cpu")
    store.add(rows.numpy(), [{"file_path": f"f{i}.py"}
                             for i in range(rows.shape[0])])
    q = torch.randn(8, rows.shape[1],
                    generator=torch.Generator().manual_seed(2))
    want = store.search_device(q, 5, method="quantized")
    with profile() as prof:
        for _ in range(3):
            got = store.search_device(q, 5, method="quantized")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert _counts(traced) == {name: 3 for name in
                               ("search.device", "search.plan")
                               + SEARCH_STAGES}
    spans = traced.snapshot()["spans"]
    inner = sum(spans[n]["total_ms"] for n in ("search.plan",) + SEARCH_STAGES)
    assert spans["search.device"]["self_ms"] == pytest.approx(
        spans["search.device"]["total_ms"] - inner)
    path = tmp_path / "s.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [ev for ev in events if ev.get("cat") == "user_annotation"]
    outer = [ev for ev in ann if ev["name"] == "search.device"]
    assert len(outer) == 3
    for ev in ann:
        if ev["name"].startswith("search.") and ev["name"] != "search.device":
            assert any(o["ts"] <= ev["ts"] and ev["ts"] + ev["dur"]
                       <= o["ts"] + o["dur"] for o in outer), ev["name"]


def test_encode_device_counts_live_and_padded_tokens(traced):
    from lattice_tpu_torch.models import unixcoder as um
    model = um.UniXcoderModel(um.UniXcoderConfig(
        vocab_size=512, hidden_size=128, num_layers=1, num_heads=2,
        intermediate_size=256, max_position_embeddings=130),
        seed=7, device="cpu")
    rng = np.random.default_rng(5)
    batches = []
    for b, width in ((3, 40), (5, 100)):
        lengths = rng.integers(4, width + 1, size=b)
        lengths[0] = width
        mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int64)
        ids = np.where(mask == 1, rng.integers(3, 512, size=(b, width)), 1)
        batches.append((ids, mask))
    traced.enable()
    for ids, mask in batches:
        model.encode_device(ids, mask)
    # the device-tensor path at a bucket length reads no mask back
    ids, mask = batches[0]
    pad = model.bucket_length(ids.shape[1]) - ids.shape[1]
    model.encode_device(torch.from_numpy(np.pad(ids, ((0, 0), (0, pad)),
                                                constant_values=1)),
                        torch.from_numpy(np.pad(mask, ((0, 0), (0, pad)))))
    counters = traced.snapshot()["counters"]
    assert counters["encode.tokens_live"] == sum(int(m.sum())
                                                 for _, m in batches)
    # each forward's rows x its bucket: the first batch in one group at 64,
    # the second (rows of 100, 97, 25, 38, 66 tokens) split into 3 rows at
    # 128 and 2 at 64
    assert counters["encode.tokens_padded"] == 3 * 64 + 3 * 128 + 2 * 64
    assert counters["encode.sub_batches"] == 1 + 2
    assert _counts(traced) == {"encode.host_prep": 2}
