"""The program's own spans, and the per-layer numbers read from them and
from the capture's ranges.

The program (``asltpu_torch.utils.profiling``) keeps a span at each of its
layer boundaries, on every thread, while a capture is open: the server's
batcher, the stream's prefetch thread and decode workers, which the
harness's capture of its own thread does not see. Each is stamped on
``time.time_ns()``, the clock from which a chrome trace counts its
microseconds (its ``baseTimeNanoseconds``, one per process): converted,
the spans lie on the capture's clock, beside the device's activity.

Every reader returns None where its run holds nothing to read: no trace,
a program without the recorder (an older build) or without the span, or
a recorder that dropped records."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.core import stats

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class Span:
    """A program span on the capture's clock (microseconds)."""

    name: str
    tid: int
    start: float
    end: float
    ids: Dict[str, int]

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e3


def recorded(base_ns: Optional[int] = None) -> Optional[List[Span]]:
    """Every span the program's recorder holds, converted to the capture's
    microseconds with ``base_ns`` (the process's trace base by default);
    None where the program has no recorder or it dropped records."""
    try:
        from asltpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not hasattr(profiling, "trace_base_ns") or rec.dropped:
        return None
    base = profiling.trace_base_ns() if base_ns is None else base_ns
    return [Span(s.name, s.tid, (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3, s.ids)
            for s in rec.spans()]


def in_slice(run, name: str, spans: Optional[List[Span]] = None) -> Optional[List[Span]]:
    """The spans ``name`` that end within the traced slice; None where
    there are none to read."""
    if run.trace is None:
        return None
    spans = recorded() if spans is None else spans
    if spans is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    out = [s for s in spans if s.name == name and lo <= s.end <= hi]
    return out or None


def mean_ms(run, *names: str) -> Optional[float]:
    """The sum over ``names`` of each one's mean duration in the slice, in
    ms; None where any of them has no span there."""
    spans = recorded() if run.trace is not None else None
    total = 0.0
    for name in names:
        got = in_slice(run, name, spans)
        if got is None:
            return None
        total += sum(s.ms for s in got) / len(got)
    return total


def p95_ms(run, name: str) -> Optional[float]:
    """Nearest-rank 95th percentile of the durations of ``name`` in the
    slice, in ms."""
    got = in_slice(run, name)
    return None if got is None else stats.percentile([s.ms for s in got], 95)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted (start, end) covering the same points."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap(xs: Sequence[Tuple[float, float]], ys: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two disjoint sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The slice's stretches with nothing on the device."""
    edges = [trace.lo] + [x for ab in trace.busy_intervals() for x in ab] + [trace.hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_share_pct(run, names: Sequence[str]) -> Optional[float]:
    """Share of the device's idle time in the slice during which the
    program was inside any span of ``names``, in %."""
    if run.trace is None or not run.trace.device:
        return None
    spans = recorded()
    if spans is None or not any(s.name in names for s in spans):
        return None
    lo, hi = run.trace.lo, run.trace.hi
    inside = union((max(s.start, lo), min(s.end, hi)) for s in spans if s.name in names)
    idle = idle_intervals(run.trace)
    total = sum(b - a for a, b in idle)
    return 100.0 * overlap(idle, inside) / total if total > 0 else None


def device_ms_per_step(run, name: str) -> Optional[float]:
    """Device time (kernels, copies, sets) a step of the slice spent on the
    work launched inside the range ``name`` of the capture, in ms: each
    device event is matched to its launch (a runtime or driver call, by
    ``args.correlation``, from any thread) and counted where the launch
    falls inside one of the range's occurrences."""
    tr, steps = run.trace, run.counters.get("steps_in_slice")
    if tr is None or not tr.device or not steps:
        return None
    ranges = union((e["ts"], e["ts"] + e.get("dur", 0)) for e in tr.events
                   if e.get("cat") == "user_annotation" and e.get("name") == name)
    if not ranges:
        return None
    launched = {e["args"]["correlation"]: e["ts"] for e in tr.events
                if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    starts = [a for a, _ in ranges]
    total = 0.0
    for e in tr.device:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= ranges[k][1]:
            total += e.get("dur", 0)
    return total / 1e3 / steps
