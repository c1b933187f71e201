"""The port's `utils/tracing.py` against the JAX package's.

`Tracer` is a copy: the same spans give the same report in both packages.
The device-trace readers read `torch.profiler`'s Chrome trace in place of
an XSpace capture: a trace of a small CPU region summarizes to a
non-negative total (as `tests/test_subsystems.py`'s `TestDeviceTraceSummary`
checks of the JAX reader), a missing directory gives {"error": ...}, and a
written trace with CUDA kernel events sums and buckets them by name.
"""

import json

import pytest
import torch

from lattice_tpu.utils import tracing as jax_tracing
from lattice_tpu_torch.utils import tracing
from lattice_tpu_torch.utils.tracing import (categorize_device_trace,
                                             device_trace, get_tracer,
                                             summarize_device_trace)


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
    assert "error" in categorize_device_trace(str(tmp_path / "nope"))


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


def test_categories_of_the_busiest_stream(written_trace):
    out = categorize_device_trace(written_trace)
    assert out["line"] == "/device:GPU:0//stream 7"
    assert out["total_ms"] == pytest.approx(5.005)
    assert out["categories"] == {"custom-call": 4.0, "matmul": 0.5,
                                 "elementwise": 0.5, "other": 0.005}
    assert sum(fr for _, _, fr in out["ops"]) == pytest.approx(1.0)


def test_newest_trace_is_read(written_trace, tmp_path):
    (tmp_path / "2.pt.trace.json").write_text(json.dumps({"traceEvents": [
        _kernel("void (anonymous namespace)::ivf_probe_kernel()", 10.0)]}))
    out = summarize_device_trace(written_trace)
    assert out["total_ms"] == pytest.approx(0.01)
    assert categorize_device_trace(written_trace)["categories"] == {
        "custom-call": 0.01}
