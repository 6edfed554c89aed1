"""Dataset-free fixtures for tests, the bench and the learning proofs:
deterministic synthetic mp4s written with OpenCV, WLASL-shaped datasets of
them, and landmark sequences. Counterpart of ``asltpu/data/synthetic.py``:
for the same arguments it writes the same mp4 bytes and index JSON and
returns the same arrays and timelines, with one exception. The validation
nuisance seeds of :func:`make_separable_wlasl` and
:func:`make_separable_wlasl_grid` start at ``max(10_000, n_classes·1000)``
(:func:`split_seeds`), so above 10 classes they stay disjoint from every
train seed; up to 10 classes that base is the JAX package's 10,000.

OpenCV is imported when a video is written, not when this module is, and
nothing here imports torch: the bench's writer processes import only this.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from asltpu_torch.config import IMAGENET_MEAN, IMAGENET_STD


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("writing a video needs OpenCV (the cv2 module), "
                           "which is not installed") from e
    return cv2


def _mp4_writer(path: str, fps: int, w: int, h: int):
    """An opened mp4v ``cv2.VideoWriter`` of ``w`` × ``h`` frames."""
    cv2 = _cv2()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    return writer


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
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    freq = rng.uniform(0.02, 0.08, size=3)
    t = np.arange(num_frames, dtype=np.float32)[:, None, None, None]
    img = 127.5 + 110 * np.sin(freq * (xx + yy)[None, :, :, None] + phase + 0.3 * t)
    frames = np.clip(img, 0, 255).astype(np.uint8)
    writer = _mp4_writer(path, fps, w, h)
    try:
        for frame in frames:
            writer.write(frame[..., ::-1])  # RGB → BGR for the encoder
    finally:
        writer.release()
    return frames


def _index_entry(video_id: str, split: str) -> dict:
    return {"video_id": video_id, "split": split, "frame_start": 1,
            "frame_end": -1, "fps": 25}


def _write_index(root: str, name: str, entries: list) -> str:
    index_path = os.path.join(root, name)
    with open(index_path, "w") as f:
        json.dump(entries, f)
    return index_path


def make_synthetic_wlasl(
    root: str,
    num_glosses: int = 100,
    clips_per_gloss: int = 1,
    num_frames: int = 24,
    size: Tuple[int, int] = (128, 128),
    splits: Optional[List[str]] = None,
) -> Tuple[str, str]:
    """A tiny WLASL-shaped dataset under ``root``: clip ``c`` of each gloss
    goes to ``splits[c % len(splits)]`` (default ``["train"]``), and every
    listed instance has its video on disk (:func:`write_video`, seeded by
    the running video id). Returns (index_json_path, video_dir)."""
    video_dir = os.path.join(root, "videos")
    os.makedirs(video_dir, exist_ok=True)
    splits = splits or ["train"]
    entries = []
    vid = 0
    for g in range(num_glosses):
        instances = []
        for c in range(clips_per_gloss):
            video_id = f"{vid:05d}"
            write_video(os.path.join(video_dir, video_id + ".mp4"),
                        num_frames=num_frames, size=size, seed=vid)
            instances.append(_index_entry(video_id, splits[c % len(splits)]))
            vid += 1
        entries.append({"gloss": f"gloss_{g:04d}", "instances": instances})
    return _write_index(root, "WLASL_synthetic.json", entries), video_dir


def write_separable_video(
    path: str,
    gloss_id: int,
    num_glosses: int,
    num_frames: int = 24,
    size: Tuple[int, int] = (96, 96),
    fps: int = 25,
    seed: int = 0,
    hue_rate: float = 0.0,
    hard: bool = False,
) -> None:
    """Write a video whose gloss is decodable from its content: the
    learnable task of the learning proofs, which show that the whole path
    (loader → augment → step → eval) drives a model from chance to high
    held-out accuracy, where a subtly wrong gradient or label path still
    lets the loss fall.

    The class signal is a hue direction: mean channel values
    ``127.5 + 60·w_c`` with ``w = cos(θ), cos(θ − 2π/3), cos(θ + 2π/3)`` and
    ``θ = 2π·gloss/num_glosses``. It survives the production path: mp4's
    4:2:0 chroma subsampling (a mean colour, not a texture), uniform
    temporal sampling (static in time), random resized crop and flip
    (global), brightness jitter (shifts the channels equally) and contrast
    jitter (scales their differences, keeping the direction). Everything
    else is per-clip nuisance drawn from ``seed`` (texture orientation,
    frequency, motion, amplitude), so a model cannot fit clip identity.

    ``hue_rate`` (radians a frame) turns the hue over time, ``θ(t) = θ₀ +
    hue_rate·t``: a label that encodes the rate too
    (:func:`make_separable_wlasl_grid`) needs a model that reads colour
    over the sampled frames in order. ``hard=True`` adds per-channel gain
    (±12%), a brightness offset (±18), a stronger texture (amplitude up to
    45) and a moving dark disc over about 4–13% of the pixels.
    """
    h, w = size
    rng = np.random.default_rng(seed)
    theta0 = 2 * np.pi * gloss_id / num_glosses
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi)
    freq = rng.uniform(0.03, 0.10)
    motion = rng.uniform(-0.6, 0.6)
    tex_amp = rng.uniform(15, 45 if hard else 35)
    axis = rng.uniform(0, np.pi)
    proj = np.cos(axis) * xx + np.sin(axis) * yy
    if hard:
        gain = rng.uniform(0.88, 1.12, size=3).astype(np.float32)
        bright = rng.uniform(-18.0, 18.0)
        occ_r = rng.uniform(0.12, 0.20) * min(h, w)
        occ_xy = rng.uniform(0.25, 0.75, size=2) * np.array([w, h])
        occ_v = rng.uniform(-0.015, 0.015, size=2) * np.array([w, h])
    else:
        gain = np.ones(3, np.float32)
        bright = 0.0
    frames = np.empty((num_frames, h, w, 3), dtype=np.uint8)
    for t in range(num_frames):
        weights = _hue_weights(theta0 + hue_rate * t)
        tex = tex_amp * np.sin(freq * proj + phi + motion * t)
        for c in range(3):
            img = 127.5 + (60.0 * weights[c] + tex + bright) * gain[c]
            frames[t, ..., c] = np.clip(img, 0, 255).astype(np.uint8)
        if hard:
            cx, cy = occ_xy + occ_v * t
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 < occ_r**2
            frames[t][mask] = 40
    writer = _mp4_writer(path, fps, w, h)
    try:
        for frame in frames:
            writer.write(frame[..., ::-1])
    finally:
        writer.release()


def _hue_weights(theta: float) -> np.ndarray:
    return np.array([np.cos(theta), np.cos(theta - 2 * np.pi / 3),
                     np.cos(theta + 2 * np.pi / 3)], np.float32)


def split_seeds(n_classes: int) -> Tuple[Tuple[str, int], Tuple[str, int]]:
    """(split, seed base) of the separable datasets: instance ``c`` of class
    ``k`` is seeded ``base + k·1000 + c``. The val base is
    ``max(10_000, n_classes·1000)``: the JAX package's 10,000 up to 10
    classes, and past every train seed above that, where the JAX package's
    val seeds of class k equal the train seeds of class k + 10."""
    return ("train", 0), ("val", max(10_000, n_classes * 1000))


def make_separable_wlasl(
    root: str,
    num_glosses: int = 6,
    train_per_gloss: int = 8,
    val_per_gloss: int = 4,
    num_frames: int = 24,
    size: Tuple[int, int] = (96, 96),
) -> Tuple[str, str]:
    """A WLASL-shaped dataset of :func:`write_separable_video` clips with a
    held-out ``val`` split whose nuisance seeds are disjoint from the
    train split's (:func:`split_seeds`), so val accuracy measures the class
    signal, not clip memorisation. Returns (index_json_path, video_dir)."""
    video_dir = os.path.join(root, "videos")
    os.makedirs(video_dir, exist_ok=True)
    counts = {"train": train_per_gloss, "val": val_per_gloss}
    entries = []
    vid = 0
    for g in range(num_glosses):
        instances = []
        for split, seed_base in split_seeds(num_glosses):
            for c in range(counts[split]):
                video_id = f"{vid:05d}"
                write_separable_video(
                    os.path.join(video_dir, video_id + ".mp4"), gloss_id=g,
                    num_glosses=num_glosses, num_frames=num_frames, size=size,
                    seed=seed_base + g * 1000 + c)
                instances.append(_index_entry(video_id, split))
                vid += 1
        entries.append({"gloss": f"gloss_{g:04d}", "instances": instances})
    return _write_index(root, "WLASL_separable.json", entries), video_dir


def rate_wheel(num_rate: int, unit: float = 0.17) -> np.ndarray:
    """The hue-rotation rates (radians a frame) of the grid task:
    ``num_rate`` values symmetric about zero, with no zero member for even
    counts (4 → −0.255, −0.085, +0.085, +0.255). Telling the signs apart
    needs temporal order; telling the magnitudes apart needs hue read at
    more than two sampled frames."""
    offs = np.arange(num_rate, dtype=np.float32) - (num_rate - 1) / 2.0
    return offs * unit


def make_separable_wlasl_grid(
    root: str,
    num_hue: int = 13,
    num_rate: int = 4,
    train_per_class: int = 8,
    val_per_class: int = 4,
    num_frames: int = 24,
    size: Tuple[int, int] = (96, 96),
    hard: bool = True,
) -> Tuple[str, str]:
    """The 52-class accuracy anchor: a WLASL-shaped dataset whose
    ``num_hue × num_rate`` classes factor as (base hue, hue-rotation rate),
    class ``k = hue·num_rate + rate``. The hue bins lie 2π/13 ≈ 27.7°
    apart, and the rate makes the task temporal: a model that pools frames
    without order confuses the ±rate pairs. Val seeds as in
    :func:`make_separable_wlasl`. Returns (index_json_path, video_dir)."""
    video_dir = os.path.join(root, "videos")
    os.makedirs(video_dir, exist_ok=True)
    rates = rate_wheel(num_rate)
    n_classes = num_hue * num_rate
    counts = {"train": train_per_class, "val": val_per_class}
    entries = []
    vid = 0
    for k in range(n_classes):
        hue_k, rate_k = divmod(k, num_rate)
        instances = []
        for split, seed_base in split_seeds(n_classes):
            for c in range(counts[split]):
                video_id = f"{vid:05d}"
                write_separable_video(
                    os.path.join(video_dir, video_id + ".mp4"), gloss_id=hue_k,
                    num_glosses=num_hue, num_frames=num_frames, size=size,
                    seed=seed_base + k * 1000 + c, hue_rate=float(rates[rate_k]),
                    hard=hard)
                instances.append(_index_entry(video_id, split))
                vid += 1
        entries.append({"gloss": f"gloss_{k:04d}", "instances": instances})
    return _write_index(root, "WLASL_separable_grid.json", entries), video_dir


def write_separable_session(
    path: str,
    gloss_sequence: List[int],
    num_glosses: int,
    frames_per_sign: int = 24,
    size: Tuple[int, int] = (96, 96),
    fps: int = 25,
    seed: int = 0,
) -> List[Tuple[int, int, int]]:
    """Write one continuous signing session: the signs of
    ``gloss_sequence`` back to back in one mp4 with no boundary marks, each
    carrying :func:`write_separable_video`'s class signal with its own
    nuisance draw, so a recogniser must read the signal window by window
    (:func:`asltpu_torch.windows.predict_windows`).

    Returns the true timeline ``[(gloss_id, start_frame, end_frame)]``,
    1-based inclusive frames (the convention of clip records and window
    predictions)."""
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    writer = _mp4_writer(path, fps, w, h)
    timeline: List[Tuple[int, int, int]] = []
    frame = 1
    try:
        for gloss_id in gloss_sequence:
            weights = _hue_weights(2 * np.pi * gloss_id / num_glosses)
            phi = rng.uniform(0, 2 * np.pi)
            freq = rng.uniform(0.03, 0.10)
            motion = rng.uniform(-0.6, 0.6)
            tex_amp = rng.uniform(15, 35)
            axis = rng.uniform(0, np.pi)
            proj = np.cos(axis) * xx + np.sin(axis) * yy
            for t in range(frames_per_sign):
                tex = tex_amp * np.sin(freq * proj + phi + motion * t)
                img = np.empty((h, w, 3), dtype=np.uint8)
                for c in range(3):
                    img[..., c] = np.clip(127.5 + 60.0 * weights[c] + tex, 0, 255).astype(np.uint8)
                writer.write(img[..., ::-1])  # RGB → BGR for the encoder
            timeline.append((gloss_id, frame, frame + frames_per_sign - 1))
            frame += frames_per_sign
    finally:
        writer.release()
    return timeline


def make_separable_landmarks(
    num_classes: int,
    clips_per_class: int,
    num_frames: int = 16,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-separable Holistic sequences for the landmark family's
    learning proof: gloss k is the direction (angle 2πk/C) in which the
    right hand drifts relative to the body. The signal survives
    ``normalize_landmarks`` (recentring on the mid-shoulder point and
    shoulder-width scaling cancel exactly the per-clip translation, drift
    and scale drawn below, and pass relative hand motion), and it is purely
    temporal, so a model must integrate motion over T. Other nuisances:
    start radius, drift speed, coordinate noise and left-hand frames missing
    (all zero, the MediaPipe convention).

    Returns (landmarks [N, T, 543, 3] float32, labels [N] int32), shuffled.
    Disjoint ``seed`` values give a train and a held-out val split."""
    rng = np.random.default_rng(seed)
    n = num_classes * clips_per_class
    labels = np.repeat(np.arange(num_classes), clips_per_class)
    lm = np.zeros((n, num_frames, 543, 3), np.float32)
    for i, k in enumerate(labels):
        lm[i] = _separable_landmark_seq(rng, 2 * np.pi * k / num_classes, num_frames)
    perm = rng.permutation(n)
    return lm[perm], labels[perm].astype(np.int32)


def _separable_landmark_seq(rng: np.random.Generator, theta: float,
                            num_frames: int) -> np.ndarray:
    """One [T, 543, 3] sequence whose class signal is a right-hand drift
    along ``theta`` (:func:`make_separable_landmarks` says why each nuisance
    is drawn)."""
    t01 = np.arange(num_frames, dtype=np.float32) / max(num_frames - 1, 1)
    # A static body: the pose cluster with real shoulders (indices 11 and
    # 12, the normalisation's reference), the face, both hands at rest.
    body = np.zeros((543, 3), np.float32)
    body[:33] = rng.uniform(0.45, 0.55, size=(33, 3))
    body[11] = (0.35, 0.40, 0.0)  # left shoulder
    body[12] = (0.65, 0.40, 0.0)  # right shoulder
    body[33:501] = rng.uniform(0.46, 0.54, size=(468, 3))
    body[501:522] = rng.uniform(0.38, 0.42, size=(21, 3))  # left hand
    body[522:543] = rng.uniform(0.58, 0.62, size=(21, 3))  # right hand
    seq = np.repeat(body[None], num_frames, axis=0)
    # The class signal: the right hand drifts outward along theta.
    radius = rng.uniform(0.04, 0.08) + rng.uniform(0.18, 0.30) * t01
    seq[:, 522:543, 0] += (radius * np.cos(theta))[:, None]
    seq[:, 522:543, 1] += (radius * np.sin(theta))[:, None]
    # What the normalisation must cancel: global scale, translation and a
    # smooth camera drift; and coordinate noise.
    seq += rng.normal(0, 0.004, size=seq.shape).astype(np.float32)
    seq *= rng.uniform(0.7, 1.3)
    seq += rng.uniform(-0.1, 0.1, size=(1, 1, 3))
    seq += rng.normal(0, 0.002, size=(num_frames, 1, 3)).cumsum(axis=0)
    # The left hand missing in about a fifth of the frames, after the
    # transforms, so its rows are exactly zero.
    seq[rng.random(num_frames) < 0.2, 501:522, :] = 0.0
    return seq


def make_separable_fusion(
    num_hue: int,
    num_drift: int,
    clips_per_class: int,
    num_frames: int = 8,
    size: Tuple[int, int] = (32, 32),
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A cross-modal task only a working fusion model solves: the label is
    ``hue_class·num_drift + drift_class``, the hue only in the RGB clip
    (:func:`write_separable_video`'s colour signal, as preprocessed
    tensors) and the drift only in the landmarks
    (:func:`make_separable_landmarks`'s signal). Reading one stream caps
    accuracy at ``1/num_drift`` (RGB) or ``1/num_hue`` (landmarks).

    Returns (clips [N, T, H, W, 3] float32 in the preprocess output space,
    ImageNet mean/std normalised; landmarks [N, T, 543, 3] float32; labels
    [N] int32), shuffled. Disjoint ``seed`` values give independent
    nuisance draws."""
    rng = np.random.default_rng(seed)
    h, w = size
    n = num_hue * num_drift * clips_per_class
    labels = np.repeat(np.arange(num_hue * num_drift), clips_per_class)
    clips = np.empty((n, num_frames, h, w, 3), np.float32)
    lm = np.empty((n, num_frames, 543, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    for i, label in enumerate(labels):
        hue_k, drift_k = divmod(int(label), num_drift)
        # RGB: the hue direction plus a moving texture, in [0, 1].
        weights = _hue_weights(2 * np.pi * hue_k / num_hue)
        phi = rng.uniform(0, 2 * np.pi)
        freq = rng.uniform(0.03, 0.10)
        motion = rng.uniform(-0.6, 0.6)
        tex_amp = rng.uniform(0.06, 0.14)
        axis = rng.uniform(0, np.pi)
        proj = np.cos(axis) * xx + np.sin(axis) * yy
        for t in range(num_frames):
            tex = tex_amp * np.sin(freq * proj + phi + motion * t)
            img01 = np.clip(0.5 + 0.235 * weights[None, None, :] + tex[..., None], 0, 1)
            clips[i, t] = (img01 - mean) / std
        lm[i] = _separable_landmark_seq(rng, 2 * np.pi * drift_k / num_drift, num_frames)
    perm = rng.permutation(n)
    return clips[perm], lm[perm], labels[perm].astype(np.int32)


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
