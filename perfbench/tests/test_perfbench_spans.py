"""The readers of the program's spans (``core/program_spans.py``) on
hand-built captures and spans: device time put down to the range that
launched it, from any thread; the device's idle time put down to the spans
over it, clipped to the slice; spans read within the slice; nothing read
where the program keeps no spans."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench.core import harness, program_spans
from perfbench.core import trace as tr
from perfbench.core.program_spans import Span


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _run(events, **counters):
    scope = _ev("user_annotation", tr.SLICE, 1000, 10000)
    return types.SimpleNamespace(trace=tr.Trace([scope, *events]), counters=counters)


def _kernel(ts, dur, corr):
    return _ev("kernel", "k", ts, dur, tid=7, correlation=corr)


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 3, tid=tid, correlation=corr)


def test_device_time_goes_to_the_range_that_launched_it():
    events = [
        _ev("user_annotation", "train.forward", 1100, 200),
        _ev("user_annotation", "train.backward", 1300, 400),
        _ev("user_annotation", "train.forward", 5000, 200),
        _launch(1150, 1), _kernel(1160, 50, 1),
        # backward launches from autograd's thread, run after the range closed
        _launch(1400, 2, tid=9), _kernel(1800, 300, 2),
        _launch(5100, 3), _kernel(5110, 70, 3),
        _launch(3000, 4), _kernel(3010, 1000, 4),  # inside no range
        _kernel(6000, 500, 99),  # no launch in the slice
    ]
    run = _run(events, steps_in_slice=2)
    assert program_spans.device_ms_per_step(run, "train.forward") == pytest.approx(0.060)
    assert program_spans.device_ms_per_step(run, "train.backward") == pytest.approx(0.150)
    assert program_spans.device_ms_per_step(run, "train.optimizer") is None
    assert program_spans.device_ms_per_step(_run(events), "train.forward") is None


def test_idle_time_goes_to_the_spans_over_it(monkeypatch):
    run = _run([_kernel(2000, 1000, 1), _kernel(6000, 1000, 2)])  # idle 8000 of 10000 us
    spans = [Span("serve.assemble", 5, 1500, 2500, {}), Span("serve.copy", 5, 4000, 5000, {}),
             Span("serve.collect", 5, 7000, 9000, {}),
             Span("serve.reply", 5, 500, 1200, {})]  # clipped to the slice: 200 us
    monkeypatch.setattr(program_spans, "recorded", lambda base_ns=None: spans)
    got = program_spans.idle_share_pct(run, ("serve.assemble", "serve.copy", "serve.reply"))
    assert got == pytest.approx(100.0 * (500 + 1000 + 200) / 8000)
    assert program_spans.idle_share_pct(run, ("serve.collect",)) == pytest.approx(25.0)
    assert program_spans.idle_share_pct(run, ("decode.wait",)) is None
    assert program_spans.idle_share_pct(_run([]), ("serve.copy",)) is None  # no device


def test_spans_are_read_within_the_slice(monkeypatch):
    spans = [Span("decode.stack", 1, 900, 1900, {}), Span("decode.stack", 1, 3000, 5000, {}),
             Span("decode.stack", 1, 10500, 11500, {}),  # ends after the slice
             Span("prefetch.pin", 1, 2000, 2500, {})]
    spans += [Span("serve.queue", 1, 2000, 2000 + 1000 * k, {"request": k})
              for k in range(1, 21)]
    monkeypatch.setattr(program_spans, "recorded", lambda base_ns=None: spans)
    run = _run([])
    assert program_spans.mean_ms(run, "decode.stack") == pytest.approx(1.5)
    assert program_spans.mean_ms(run, "decode.stack", "prefetch.pin") == pytest.approx(2.0)
    assert program_spans.mean_ms(run, "decode.stack", "decode.wait") is None
    # durations 1..20 ms, those ending by 11000 us taken: 1..9 ms
    assert program_spans.p95_ms(run, "serve.queue") == pytest.approx(9.0)


def test_recorded_spans_are_put_on_the_capture_clock():
    from asltpu_torch.utils import profiling

    profiling.RECORDER.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.record_span("decode.clip", 10_000_000, 12_500_000, pid=3, tid=4,
                                  batch=2)
        (s,) = program_spans.recorded(base_ns=9_000_000)
        assert (s.name, s.tid, s.start, s.end, s.ids) == ("decode.clip", 4, 1000.0, 3500.0,
                                                          {"batch": 2})
        profiling.RECORDER.dropped = 1
        assert program_spans.recorded(base_ns=0) is None
    finally:
        profiling.RECORDER.clear()


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from asltpu_torch.utils import profiling

    run = _run([_kernel(2000, 1000, 1)], steps_in_slice=1)
    monkeypatch.delattr(profiling, "RECORDER")
    assert program_spans.recorded() is None
    man = harness.manifest()
    new = [m for m in man["per_layer"] if m["source"] == "program_span"]
    assert len(new) == 11
    run = harness.Run(ctx=None, outcome=harness.Outcome(
        e2e={}, attempted=0, failed=0, checks={}, counters={"steps_in_slice": 1},
        memory_peak_bytes=0, trace=run.trace))
    assert harness.read_per_layer(run, new) == {}
