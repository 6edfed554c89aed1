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
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
