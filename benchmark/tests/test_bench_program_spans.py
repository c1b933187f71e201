"""The readers of the program's own spans and counters: None where the
program never recorded them (the parent of the change that added them),
the span's total over the traced, answered calls where it did; the live
share from the counters equal to the traced calls' masks; and an idle gap
inside a program span named by that span in the trace's breakdown."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, run
from lattice_tpu_torch.utils.tracing import get_tracer

SEARCH, ENCODE = "code1m.b256-k10", "unixcoder-base.index-b128"

SPAN_READERS = {
    "search_plan_ms": "search.plan",
    "search_quantize_ms": "search.quantize",
    "search_first_stage_ms": "search.first_stage",
    "search_rescore_ms": "search.rescore",
    "encode_host_prep_ms": "encode.host_prep",
}
READERS = (*SPAN_READERS, "encode_live_token_share")


@pytest.fixture
def tracer():
    tracer = get_tracer()
    tracer.reset()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


def _ctx(calls):
    """A window of (traced, units) calls."""
    return SimpleNamespace(window=run.Window(seconds=1.0, calls=[
        run.Call(i, i * 0.01, 0.001, i * 0.01 + 0.005, units, traced)
        for i, (traced, units) in enumerate(calls)]))


CALLS = [(False, 256)] * 3 + [(True, 256)] * 4 + [(True, 0)] + [(False, 256)]


@pytest.mark.parametrize("metric", READERS)
def test_no_span_reads_none(metric, tracer):
    assert run.load_named("metrics", metric).read(_ctx(CALLS)) is None


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_the_span_over_the_traced_answered_calls(metric, tracer):
    stats = tracer.spans[SPAN_READERS[metric]]
    for ms in (0.25, 0.5, 0.125, 0.375, 0.0625):
        stats.record(ms)
    got = run.load_named("metrics", metric).read(_ctx(CALLS))
    assert got == pytest.approx(1.3125 / 4)
    assert run.load_named("metrics", metric).read(
        _ctx([(False, 256), (True, 0)])) is None


def test_live_share_from_the_counters(tracer):
    read = run.load_named("metrics", "encode_live_token_share").read
    tracer.enable()
    tracer.count("encode.tokens_live", 417)
    assert read(_ctx(CALLS)) is None
    tracer.count("encode.tokens_padded", 1000)
    assert read(_ctx(CALLS)) == pytest.approx(41.7)


def _traced_window(cell, tiny, seconds=0.5):
    """A traced window of the cell at its CPU size: (ctx, state)."""
    loaded = run.load_cell(cell, 2**31 + 7, "cpu", overrides=tiny[cell])
    driver, loop = run.prepare(loaded)
    state = driver.setup(loaded)
    win = loop(state, seconds, loaded.traffic["trace_seconds"], "cpu",
               loaded.traffic["batch"])
    return SimpleNamespace(cell=loaded, config=loaded.config,
                           traffic=loaded.traffic, window=win,
                           state=state), state


def test_the_live_share_is_the_traced_masks(tiny, tracer):
    ctx, state = _traced_window(ENCODE, tiny)
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    assert traced
    live = padded = 0
    for c in traced:
        mask = state.inputs_of(c.index)[1]
        live += int(mask.sum())
        padded += mask.shape[0] * state.model.bucket_length(mask.shape[1])
    got = run.load_named("metrics", "encode_live_token_share").read(ctx)
    assert got == pytest.approx(100.0 * live / padded, abs=1e-9)
    assert tracer.spans["encode.host_prep"].count == len(traced)
    assert run.load_named("metrics", "encode_host_prep_ms").read(ctx) > 0


def test_the_search_stages_once_a_traced_call(tiny, tracer):
    ctx, _ = _traced_window(SEARCH, tiny)
    traced = [c for c in ctx.window.calls if c.traced and c.units]
    assert traced
    for name in ("search.device", *list(SPAN_READERS.values())[:4]):
        assert tracer.spans[name].count == len(traced), name
    stages = sum(run.load_named("metrics", m).read(ctx)
                 for m in list(SPAN_READERS)[:4])
    device = tracer.spans["search.device"].total_ms / len(traced)
    assert 0 < stages < device


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


def test_an_idle_gap_is_named_by_the_program_span():
    """The card idles from 100 to 300 us while the host is inside
    `search.plan`, nested in the benchmark's call span; then from 500 to
    900 inside the call's own Python."""
    events = [
        _x(devtrace.WINDOW_SPAN, 0, 1000),
        _x("bench.search_device", 50, 900),
        _x("search.device", 60, 400),
        _x("search.plan", 90, 250),
        _x("aten::empty", 400, 5, cat="cpu_op"),
        _x("k1", 0, 100, cat="kernel", device=0, stream=7),
        _x("k2", 300, 200, cat="kernel", device=0, stream=7),
        _x("k3", 900, 100, cat="kernel", device=0, stream=7),
    ]
    win = devtrace.read_window(events)
    assert win.busy_s == pytest.approx(400e-6)
    assert win.idle_by_host_s == pytest.approx(
        {"search.plan": 200e-6, "bench.search_device": 400e-6})
