"""The yardstick's arithmetic: the card's published peaks, the bytes a
preprocess launch has to move, and the operations of a clip counted on
the plain reference (never on the program, whose kernels a counter
cannot see)."""

from __future__ import annotations

import math
from typing import Tuple

# One NVIDIA H100 SXM, the data sheet's dense rates at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def resize_plan(in_hw: Tuple[int, int], short: int) -> Tuple[int, int]:
    h, w = in_hw
    if h <= w:
        return short, int(round(w * short / h))
    return int(round(h * short / w)), short


def _taps(n_in: int, n_out: int, start: int, count: int) -> int:
    """How many source rows (or columns) of ``n_in`` carry a nonzero weight
    in half-pixel bilinear taps for outputs ``start .. start + count − 1``
    of a resize to ``n_out``."""
    used = set()
    for i in range(start, start + count):
        src = (i + 0.5) * n_in / n_out - 0.5
        lo = math.floor(src)
        frac = src - lo
        for j, wgt in ((lo, 1.0 - frac), (lo + 1, frac)):
            if wgt > 0:
                used.add(min(max(j, 0), n_in - 1))
    return len(used)


def preprocess_rgb_bytes(frames: int, staged_hw: Tuple[int, int], resize_short: int,
                         crop: int, out_bytes: int = 2) -> int:
    """The least bytes a resize + centre crop + normalise of ``frames``
    staged uint8 RGB frames moves: each input byte that a tap weighs read
    once, each output element written once."""
    hs, ws = staged_hw
    rh, rw = resize_plan(staged_hw, resize_short)
    rows = _taps(hs, rh, (rh - crop) // 2, crop)
    cols = _taps(ws, rw, (rw - crop) // 2, crop)
    return frames * 3 * (rows * cols + crop * crop * out_bytes)


def bound_seconds(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory's peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def flops_of(fn, *args) -> int:
    """Operations of ``fn(*args)`` by torch's ``FlopCounterMode`` (2 per
    multiply-add of convolutions and matmuls, forward and backward). Run
    it on tensors on the ``meta`` device: nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return counter.get_total_flops()


def share_pct(bound_s: float, measured_s: float) -> float:
    """A share of a roofline or a peak, in %."""
    if measured_s <= 0:
        raise ValueError(f"measured time must be positive, got {measured_s}")
    return 100.0 * bound_s / measured_s
