"""The readers that the per-layer metric files name. Each takes a
:class:`~perfbench.core.harness.Run` and returns a number, or None where
its run holds nothing to read (never 0 for a share)."""

from __future__ import annotations

from typing import Optional

from perfbench.core import arith
from perfbench.core import trace as tr

PREPROCESS_RGB_KERNEL = "preprocess_rgb_kernel"


def device_idle_pct(run) -> Optional[float]:
    """Share of the traced slice with no kernel, copy or set on the card."""
    return tr.share_of(run.trace)


def mfu_pct(run) -> Optional[float]:
    """Clips done in the window times the reference's operations per clip,
    over the window, against the card's bf16 peak."""
    c = run.counters
    if not c.get("clips"):
        return None
    return arith.share_pct(arith.bound_seconds(flops=c["clips"] * c["flops_per_clip"]),
                           c["window_s"])


def preprocess_rgb_roofline_pct(run) -> Optional[float]:
    """The rgb preprocess kernel's share of its byte bound: the bytes its
    launches in the slice have to move (the driver counts the launches and
    their frames; the configuration gives the staging, resize and crop) at
    the memory's peak, over the kernels' summed device time. Each kernel
    the trace holds is counted at the launches' mean size."""
    c = run.counters
    if run.trace is None or not c.get("slice_launches"):
        return None
    count, seconds = run.trace.kernel_seconds(PREPROCESS_RGB_KERNEL)
    if not count or seconds <= 0:
        return None
    pp = run.ctx.config["preprocess"]
    per_frame = arith.preprocess_rgb_bytes(1, tuple(pp["staging_size"]), pp["resize_short"],
                                           pp["crop"], 2 if pp["out_dtype"] == "bfloat16" else 4)
    nbytes = per_frame * c["slice_frames"] * count / c["slice_launches"]
    return arith.share_pct(arith.bound_seconds(nbytes=nbytes), seconds)


def counter(name: str):
    def read(run) -> Optional[float]:
        return run.counters.get(name)
    return read


def avg_batch(run) -> Optional[float]:
    """Requests per batch the server ran in the window."""
    c = run.counters
    return c["requests"] / c["batches"] if c.get("batches") else None


def padded_pct(run) -> Optional[float]:
    """Share of the batches' slots that were padding, in the window."""
    c = run.counters
    slots = c.get("requests", 0) + c.get("padded_slots", 0)
    return 100.0 * c["padded_slots"] / slots if slots else None


def launches_per_step(run) -> Optional[float]:
    """Kernel launches the host made in the traced slice, per step in it."""
    if run.trace is None or not run.trace.device or not run.counters.get("steps_in_slice"):
        return None
    return run.trace.launches() / run.counters["steps_in_slice"]
