"""Host-side sampling and resize geometry, shared by decode (host) and
preprocess (device). Counterpart of the numpy half of
``asltpu/ops/preprocess.py`` (``uniform_sample_indices``, ``resize_plan``).

numpy only: the decode workers import this module, and a worker that
imported torch would pay its start-up for nothing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def uniform_sample_indices(num_raw_frames: int, num_out: int) -> np.ndarray:
    """Uniform temporal sampling: pick `num_out` frame indices evenly spanning
    ``[0, num_raw_frames)`` (center-of-segment convention). Host-side helper —
    runs before decode so the decoder only converts sampled frames.
    """
    if num_raw_frames <= 0:
        raise ValueError("num_raw_frames must be positive")
    # Center of each of `num_out` equal segments; clips shorter than num_out
    # repeat frames.
    idx = (np.arange(num_out, dtype=np.float64) + 0.5) * num_raw_frames / num_out
    return np.minimum(idx.astype(np.int64), num_raw_frames - 1)


def resize_plan(in_hw: Tuple[int, int], resize_short: int) -> Tuple[int, int]:
    """Target (H, W) after aspect-preserving short-side resize. Rounds with
    Python's ``round`` (half to even), as the JAX package and its host
    staging do; decode staging and the sampling tables all derive from it."""
    h, w = in_hw
    if h <= w:
        return resize_short, int(round(w * resize_short / h))
    return int(round(h * resize_short / w)), resize_short
