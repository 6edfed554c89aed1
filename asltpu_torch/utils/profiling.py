"""Profiling helpers: a ``torch.profiler`` trace, named ranges and the
NaN-debug mode. Counterpart of ``asltpu/utils/profiling.py``.

torch is imported inside each helper, so importing this module (and
``asltpu_torch.utils``) stays torch-free for the CLI's entry module.
"""

from __future__ import annotations

import contextlib
from typing import Iterator


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
    out of the capture with :func:`named_scope`.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            _device_round_trip()
        prof.step()
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
