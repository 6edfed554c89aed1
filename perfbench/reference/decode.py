"""Plain reference of host decode and staging: every frame of the file read
with OpenCV, the clip's frames sampled uniformly (the centre of each of T
equal segments), each resized with its short side to the staging size
(bilinear, half-pixel) and centre-cropped to it, BGR turned to RGB.

numpy and cv2 only."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_indices(n_frames: int, t: int) -> np.ndarray:
    """The frame at the centre of each of ``t`` equal segments of
    ``n_frames``."""
    idx = np.floor((np.arange(t) + 0.5) * n_frames / t).astype(np.int64)
    return np.minimum(idx, n_frames - 1)


def stage(frame_bgr: np.ndarray, staging: Tuple[int, int]) -> np.ndarray:
    import cv2

    hs, ws = staging
    short = min(hs, ws)
    h, w = frame_bgr.shape[:2]
    if h <= w:
        rh, rw = short, int(round(w * short / h))
    else:
        rh, rw = int(round(h * short / w)), short
    rh, rw = max(rh, hs), max(rw, ws)
    if (rh, rw) != (h, w):
        frame_bgr = cv2.resize(frame_bgr, (rw, rh), interpolation=cv2.INTER_LINEAR)
    y0, x0 = (rh - hs) // 2, (rw - ws) // 2
    return frame_bgr[y0:y0 + hs, x0:x0 + ws, ::-1]


def load_clip(path: str, t: int, staging: Tuple[int, int]) -> np.ndarray:
    """A video file → staged uint8 RGB frames [t, Hs, Ws, 3]."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames in {path}")
    return np.stack([stage(frames[i], staging) for i in sample_indices(len(frames), t)])
