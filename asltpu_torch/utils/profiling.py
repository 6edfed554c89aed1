"""Profiling helpers: a ``torch.profiler`` trace, named ranges, the
program's spans and the NaN-debug mode. Counterpart of
``asltpu/utils/profiling.py``.

Spans (:func:`span`, :func:`record_span`) mark the program's layer
boundaries on every thread, the ones a capture does not see among them
(the server's batcher, the prefetch thread, decode workers). Each is kept
in :data:`RECORDER` only while a ``torch.profiler`` capture is open in the
process (:func:`recording`), stamped with ``time.time_ns()``, the clock
the capture's chrome trace counts from its ``baseTimeNanoseconds``
(:func:`to_capture_us`); :func:`trace` writes them into its capture.

torch is imported inside each helper, so importing this module (and
``asltpu_torch.utils``) stays torch-free for the CLI's entry module and
the decode workers; a process that never imported torch records nothing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import sys
import tempfile
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

# Records the recorder keeps; past it the oldest go, counted in ``dropped``.
SPAN_CAP = 1 << 16
SPAN_CAT = "asltpu_span"


class Span(NamedTuple):
    """One recorded span: ``start_ns``/``end_ns`` on ``time.time_ns()``;
    ``pid``/``tid`` the process and OS thread (``threading.get_native_id``)
    it ran on; ``id`` its own, ``parent`` the id of the span around it (or
    None); ``ids`` what it shares with the spans of one request or batch
    (``request=``, ``batch=``)."""

    name: str
    pid: int
    tid: int
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    ids: Dict[str, int]


class SpanRecorder:
    """A bounded in-memory buffer of :class:`Span` records, safe to append
    to from any thread."""

    def __init__(self, cap: int = SPAN_CAP):
        self._records: "collections.deque[Span]" = collections.deque(maxlen=cap)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open = threading.local()  # each thread's stack of open span ids
        self.dropped = 0

    def new_id(self) -> int:
        return next(self._ids)

    def open_ids(self) -> List[int]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


# The process's recorder: a capture is process-wide, and so are its spans.
RECORDER = SpanRecorder()


def recording() -> bool:
    """True while a ``torch.profiler`` capture is recording anywhere in the
    process, read from torch's process-wide flag
    (``torch.autograd.profiler._is_profiler_enabled``; the thread-local
    ``torch._C._autograd._profiler_enabled()`` reads False off the
    capturing thread). False in a process that has not imported torch."""
    p = sys.modules.get("torch.autograd.profiler")
    return p is not None and getattr(p, "_is_profiler_enabled", False)


class span:
    """A span around the body: always a ``torch.profiler.record_function``
    range of ``name`` (seen by any capture of this thread), and, while
    :func:`recording`, a :class:`Span` in :data:`RECORDER`, a child of the
    innermost span open on this thread::

        with span("serve.assemble", batch=7):
            ...

    Off, it costs one flag read beside the ``record_function``."""

    __slots__ = ("name", "ids", "_rf", "_id", "_parent", "_start")

    def __init__(self, name: str, **ids: int):
        self.name = name
        self.ids = ids
        self._rf = None
        self._id = None

    def __enter__(self) -> "span":
        p = sys.modules.get("torch.autograd.profiler")
        if p is None:  # no torch in this process: nothing can capture
            return self
        self._rf = p.record_function(self.name)
        self._rf.__enter__()
        if recording():
            stack = RECORDER.open_ids()
            self._parent = stack[-1] if stack else None
            self._id = RECORDER.new_id()
            stack.append(self._id)
            self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns() if self._id is not None else 0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._id is not None:
            RECORDER.open_ids().pop()
            RECORDER.add(Span(self.name, os.getpid(), threading.get_native_id(), self._start,
                              end, self._id, self._parent, self.ids))


def record_span(name: str, start_ns: int, end_ns: int, pid: Optional[int] = None,
                tid: Optional[int] = None, parent: Optional[int] = None,
                **ids: int) -> Optional[int]:
    """Record a span from two ``time.time_ns()`` stamps already taken (a
    request's wait in a queue, a decode in a worker), on the calling
    process and thread unless ``pid``/``tid`` name another. Returns its id
    (a ``parent`` for others), or None where nothing is :func:`recording`."""
    if not recording():
        return None
    sid = RECORDER.new_id()
    RECORDER.add(Span(name, os.getpid() if pid is None else pid,
                      threading.get_native_id() if tid is None else tid,
                      start_ns, end_ns, sid, parent, ids))
    return sid


def recorded_spans() -> List[Span]:
    """The spans :data:`RECORDER` holds, oldest first."""
    return RECORDER.spans()


def to_capture_us(ns: int, base_ns: int) -> float:
    """A ``time.time_ns()`` stamp on a chrome trace's clock: microseconds
    from its ``baseTimeNanoseconds``."""
    return (ns - base_ns) / 1e3


_base_ns: Optional[int] = None


def trace_base_ns() -> int:
    """This process's chrome-trace ``baseTimeNanoseconds`` (one per process),
    read once from a CPU-only capture of one range, exported to a
    temporary file. Call it with no capture open."""
    global _base_ns
    if _base_ns is None:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("asltpu_torch.trace_base"):
                pass
        fd, path = tempfile.mkstemp(prefix="asltpu_torch-base-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                _base_ns = int(json.load(f)["baseTimeNanoseconds"])
        finally:
            os.unlink(path)
    return _base_ns


def _span_events(spans: List[Span], base_ns: int) -> List[dict]:
    """``spans`` as chrome-trace complete events on a capture's clock."""
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": s.pid, "tid": s.tid,
             "ts": to_capture_us(s.start_ns, base_ns), "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, **s.ids}} for s in spans]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the host and, where there is one, the card, and write a trace
    viewable in TensorBoard or Perfetto under ``log_dir``::

        with trace("/tmp/asltpu_torch_trace"):
            fn(...)

    On a card the profiler first runs a warm-up step whose records it
    drops, and the capture opens on a device round trip of a few small
    kernels: CUPTI can lose the first device records after recording
    starts (on an H100, up to the first 7, the first call's copy and
    kernels among them), and these take the loss. Mark the work to read
    out of the capture with :func:`named_scope`. The program's spans of
    the capture, of every thread and decode worker, are written into its
    file as events of category ``asltpu_span`` on its clock.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    opened: List[int] = []

    def write(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        mine = [s for s in recorded_spans() if s.start_ns >= opened[0]]
        if mine:
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(_span_events(mine, int(doc["baseTimeNanoseconds"])))
            with open(path, "w") as f:
                json.dump(doc, f)

    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=write) as prof:
        if cuda:
            _device_round_trip()
        prof.step()
        opened.append(time.time_ns())
        if cuda:
            _device_round_trip()
        yield


def _device_round_trip(kernels: int = 16) -> None:
    import torch

    x = torch.zeros(8, device="cuda")
    for _ in range(kernels):
        x.add_(1)
    x.sum().item()


def named_scope(name: str):
    """A named range in the trace (``torch.profiler.record_function``), the
    counterpart of ``jax.named_scope``."""
    import torch

    return torch.profiler.record_function(name)


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd's anomaly detection: a backward that produces NaN raises,
    naming the forward op that made it (the CLI's ``--debug-nans``)."""
    import torch

    torch.autograd.set_detect_anomaly(enable)
