"""A ``torch.profiler`` capture of the card and what the readers take from it.

The capture's discipline is the program's (its ``utils.profiling.trace``),
copied here so that no later change to the program changes the yardstick:
the profiler's warm-up step is dropped, and the capture opens on a device
round trip of a few small kernels, since CUPTI can lose the first device
records after recording starts. The harness marks the measured slice with
a named range of its own, and every reading is taken within it."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "perfbench.slice"
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _round_trip(kernels: int = 16) -> None:
    import torch

    x = torch.zeros(8, device="cuda")
    for _ in range(kernels):
        x.add_(1)
    x.sum().item()


@contextlib.contextmanager
def capture(holder: dict, device) -> Iterator[None]:
    """Trace the host and the card (the host alone where ``device`` is the
    CPU) around the body, which ends on a synchronisation; on exit
    ``holder["profile"]`` holds the capture for :func:`read`, which the
    caller runs once the window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # The host's operators of this thread, the device's work of every thread
    # (the server's batcher launches from its own). Profiling every thread's
    # operators, or their shapes, takes seconds to start on the card's
    # machine and holds the batcher up meanwhile.
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: None) as prof:
        if cuda:
            _round_trip()
        prof.step()
        if cuda:
            _round_trip()
        with record_function(SLICE):
            yield
            if cuda:
                torch.cuda.synchronize()
    holder["profile"] = prof


def prime(device) -> None:
    """Start and stop the profiler once, so that a capture in the window
    does not pay its first start: on the card's machine that takes
    seconds, and holds every other thread of the process up meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    if device.type == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            _round_trip()


def read(holder: dict) -> Optional["Trace"]:
    """The :class:`Trace` of a :func:`capture` (None where there was none),
    through a chrome trace in a temporary file under ``TMPDIR``, removed
    once read."""
    prof = holder.get("profile")
    if prof is None:
        return None
    fd, path = tempfile.mkstemp(prefix="perfbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


class Trace:
    """The complete events of a chrome trace, read within the slice."""

    def __init__(self, events: List[dict]):
        events = [e for e in events if e.get("ph") == "X"]
        scopes = [e for e in events if e.get("name") == SLICE
                  and e.get("cat") in ("user_annotation", "cpu_instant_event", "python_function")]
        if not scopes:
            raise ValueError(f"the trace holds no {SLICE} range")
        scope = max(scopes, key=lambda e: e.get("dur", 0))
        self.lo, self.hi = scope["ts"], scope["ts"] + scope["dur"]
        self.events = [e for e in events if self.lo <= e["ts"] <= self.hi]
        self.device = sorted((e for e in self.events if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity (kernels, copies, sets) as
        disjoint (start, end) in microseconds, clipped to the slice."""
        out: List[Tuple[float, float]] = []
        for e in self.device:
            a, b = e["ts"], min(e["ts"] + e.get("dur", 0), self.hi)
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, name_part: str) -> Tuple[int, float]:
        """(count, summed seconds) of the kernels whose name holds
        ``name_part``."""
        ks = [e for e in self.device if e.get("cat") == "kernel" and name_part in e["name"]]
        return len(ks), sum(e.get("dur", 0) for e in ks) / 1e6

    def launches(self) -> int:
        """Kernel launches the host made in the slice."""
        return sum(1 for e in self.events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in LAUNCH_NAMES)

    def top_device_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches with nothing on the device, each named
        by the shortest host event that spans its middle (what the host was
        doing), or "no host event"."""
        busy = self.busy_intervals()
        edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        host = [e for e in self.events if e.get("cat") in ("cpu_op", "user_annotation",
                                                           "python_function", "cuda_runtime")
                and e.get("name") != SLICE]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            spanning = [e for e in host if e["ts"] <= mid <= e["ts"] + e.get("dur", 0)]
            name = min(spanning, key=lambda e: e.get("dur", 0))["name"] if spanning \
                else "no host event"
            out.append([name, length / 1e6])
        return out


def share_of(trace: Optional[Trace]) -> Optional[float]:
    """The device's idle share of the slice in %, None without a trace or
    with no device activity in it."""
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
