"""The mp4 corpus: seeded synthetic videos written in parallel. numpy and
cv2 only, so the writer processes start without torch.

:func:`write_video` is a frozen copy of the program's own synthetic
writer, so the corpus stays what it was when the benchmark was set up:
a smooth moving gradient per file, mp4v-encoded."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Tuple

import numpy as np


def write_video(path: str, num_frames: int = 24, size: Tuple[int, int] = (128, 128),
                fps: int = 25, seed: int = 0) -> None:
    """Write a deterministic synthetic mp4 of ``size`` = (H, W)."""
    import cv2

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


def _limit_threads() -> None:
    import cv2

    cv2.setNumThreads(1)


def start_corpus(root: str, n: int, size: Tuple[int, int], frames: int,
                 workers: int) -> Tuple[ProcessPoolExecutor, List[str], list]:
    """Start writing ``n`` files under ``root`` on ``workers`` spawned
    processes, file ``i`` from seed ``i``: every run decodes the same
    corpus, in an order of its own seed. Returns the pool, the paths and
    the futures: read every future, then shut the pool down."""
    os.makedirs(root, exist_ok=True)
    seeds = range(n)
    paths = [os.path.join(root, f"clip{i:03d}.mp4") for i in range(n)]
    pool = ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"),
                               initializer=_limit_threads)
    futures = [pool.submit(write_video, p, frames, size, 25, int(s))
               for p, s in zip(paths, seeds)]
    return pool, paths, futures
