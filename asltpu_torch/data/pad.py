"""Batch padding to a fixed batch size (one implementation). Counterpart of
``asltpu/data/pad.py``: streaming inference pads a short last batch up to
the batch size and slices the results back to the kept count."""

from __future__ import annotations

from typing import Union

import numpy as np


def pad_to_batch(
    arr: np.ndarray, batch: int, fill: Union[str, int, float] = "repeat"
) -> np.ndarray:
    """Pad axis 0 of ``arr`` up to ``batch`` rows.

    ``fill="repeat"``: repeat the last row — the padding for data rows,
    where pad rows must be valid model inputs; callers slice outputs back to
    the kept count.

    ``fill=<scalar>``: pad with a constant, e.g. ``-1`` for label rows.

    A full batch is returned unchanged (same object — no copy).
    Raises ``ValueError`` on an empty array with ``fill="repeat"`` and on an
    array already longer than ``batch``.
    """
    n = arr.shape[0]
    if n == batch:
        return arr
    if n > batch:
        raise ValueError(f"batch has {n} rows, more than batch size {batch}")
    pad = batch - n
    if isinstance(fill, str):
        if fill != "repeat":
            raise ValueError(f"fill must be 'repeat' or a scalar, got {fill!r}")
        if n == 0:
            raise ValueError("cannot repeat-pad an empty batch")
        return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    return np.concatenate(
        [arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)]
    )
