"""Dataset-free fixtures for tests and the bench: deterministic synthetic
mp4s written with OpenCV, and landmark sequences. Counterpart of
``write_video`` and ``synthetic_landmarks`` in ``asltpu/data/synthetic.py``:
the same values for the same seed.

OpenCV is imported when a video is written, not when this module is, and
nothing here imports torch: the bench's writer processes import only this.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def write_video(
    path: str,
    num_frames: int = 24,
    size: Tuple[int, int] = (128, 128),
    fps: int = 25,
    seed: int = 0,
) -> np.ndarray:
    """Write a deterministic synthetic mp4 of ``size`` = (H, W); returns the
    RGB frames [T, H, W, 3] uint8 that were encoded (before codec loss).
    The content is a smooth moving gradient: codec-friendly, where random
    noise would leave no decode tolerance."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("writing a video needs OpenCV (the cv2 module), "
                           "which is not installed") from e
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.uniform(0.02, 0.08, size=3)
    t = np.arange(num_frames, dtype=np.float32)[:, None, None, None]
    img = 127.5 + 110 * np.sin(freq * (xx + yy)[None, :, :, None] + phase + 0.3 * t)
    frames = np.clip(img, 0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    try:
        for frame in frames:
            writer.write(frame[..., ::-1])  # RGB → BGR for the encoder
    finally:
        writer.release()
    return frames


def synthetic_landmarks(batch: int, num_frames: int, seed: int = 0) -> np.ndarray:
    """Plausible 543-landmark sequences [batch, T, 543, 3] float32: smooth
    trajectories in [0,1]², with the left-hand block zeroed in about a
    fifth of the frames (the missing-detection convention)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, size=(batch, 1, 543, 3)).astype(np.float32)
    drift = rng.normal(0, 0.003, size=(batch, num_frames, 543, 3)).astype(
        np.float32
    ).cumsum(axis=1)
    lm = np.clip(base + drift, 0.0, 1.0)
    mask = rng.random((batch, num_frames)) < 0.2
    lm[mask, 501:522, :] = 0.0
    return lm
