"""Pose/landmark front-end: 543-landmark per-frame features in the
MediaPipe Holistic layout (33 pose + 468 face + 21 left-hand + 21
right-hand = 543 × (x, y, z); missing detections are all-zero rows).
Counterpart of ``asltpu/data/landmarks.py``.

Extraction is a pluggable host stage with three providers:

  - :class:`MediaPipeExtractor` — live extraction where the ``mediapipe``
    package is installed (a clear error otherwise).
  - :class:`LandmarkStore` — precomputed ``<video_id>.npy`` files, the
    standard WLASL research workflow (extract once, train many).
  - :class:`SyntheticExtractor` — deterministic fixtures for tests and the
    bench.

Normalisation runs on the device, inside the model
(:func:`asltpu_torch.models.bilstm.normalize_landmarks`). numpy only.
"""

from __future__ import annotations

import os
from typing import Optional, Protocol

import numpy as np

from asltpu_torch.config import LANDMARK_DIM, NUM_LANDMARKS
from asltpu_torch.data.staging import uniform_sample_indices

# Block layout of the 543-landmark vector (MediaPipe Holistic order).
POSE_SLICE = slice(0, 33)
FACE_SLICE = slice(33, 501)
LEFT_HAND_SLICE = slice(501, 522)
RIGHT_HAND_SLICE = slice(522, 543)


class LandmarkExtractor(Protocol):
    def extract(self, frames_rgb: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 RGB → [T, 543, 3] float32 landmarks."""
        ...


class MediaPipeExtractor:
    """Live MediaPipe Holistic extraction (host C++ graph)."""

    def __init__(self, **holistic_kwargs):
        try:
            import mediapipe as mp
        except ImportError as e:
            raise RuntimeError(
                "mediapipe is not installed in this environment; use a "
                "LandmarkStore with precomputed .npy landmarks instead"
            ) from e
        self._holistic = mp.solutions.holistic.Holistic(**holistic_kwargs)

    def extract(self, frames_rgb: np.ndarray) -> np.ndarray:
        t = frames_rgb.shape[0]
        out = np.zeros((t, NUM_LANDMARKS, LANDMARK_DIM), np.float32)
        for i in range(t):
            res = self._holistic.process(frames_rgb[i])
            for sl, lm in (
                (POSE_SLICE, res.pose_landmarks),
                (FACE_SLICE, res.face_landmarks),
                (LEFT_HAND_SLICE, res.left_hand_landmarks),
                (RIGHT_HAND_SLICE, res.right_hand_landmarks),
            ):
                if lm is not None:
                    out[i, sl] = [(p.x, p.y, p.z) for p in lm.landmark]
        return out


class SyntheticExtractor:
    """Deterministic landmarks for tests and benches, seeded by the clip's
    frame count."""

    def __init__(self, num_frames: int, seed: int = 0):
        self.num_frames = num_frames
        self.seed = seed

    def extract(self, frames_rgb: np.ndarray) -> np.ndarray:
        from asltpu_torch.data.synthetic import synthetic_landmarks

        seed = self.seed + frames_rgb.shape[0]
        return synthetic_landmarks(1, frames_rgb.shape[0], seed=seed)[0]


class LandmarkStore:
    """Precomputed landmarks: ``<dir>/<video_id>.npy`` each [T_raw, 543, 3].

    ``get(video_id, num_frames)`` applies the same uniform temporal sampling
    as the video decode path, so landmark frames align with RGB frames.
    """

    def __init__(self, directory: str):
        self.directory = directory

    def path_for(self, video_id: str) -> str:
        return os.path.join(self.directory, f"{video_id}.npy")

    def has(self, video_id: str) -> bool:
        return os.path.exists(self.path_for(video_id))

    def get(self, video_id: str, num_frames: Optional[int] = None) -> np.ndarray:
        lm = np.load(self.path_for(video_id))
        if lm.ndim != 3 or lm.shape[1:] != (NUM_LANDMARKS, LANDMARK_DIM):
            raise ValueError(
                f"{self.path_for(video_id)}: expected [T, 543, 3], got {lm.shape}"
            )
        if num_frames is not None and lm.shape[0] != num_frames:
            lm = lm[uniform_sample_indices(lm.shape[0], num_frames)]
        return lm.astype(np.float32)

    def put(self, video_id: str, landmarks: np.ndarray):
        os.makedirs(self.directory, exist_ok=True)
        np.save(self.path_for(video_id), landmarks.astype(np.float32))

    def for_path(self, num_frames: int):
        """Adapter for ``stream_predict(landmarks_for=...)``: a video path's
        basename without its extension is the video_id."""

        def fn(video_path: str) -> np.ndarray:
            vid = os.path.splitext(os.path.basename(video_path))[0]
            return self.get(vid, num_frames)

        return fn


def precompute_landmarks(
    records,
    store: LandmarkStore,
    extractor: LandmarkExtractor,
    staging_size=(256, 256),
    overwrite: bool = False,
) -> int:
    """Dataset-prep pass: extract and store landmarks for every record with
    a video on disk. Returns the number written.

    The record's frame segment is honoured (the RGB lanes decode only that
    segment, so whole-video landmarks would misalign in time); its signer
    box is not (holistic detection wants the full frame, and coordinates
    stay in full-frame units)."""
    from asltpu_torch.data.decode import decode_sampled_frames

    n = 0
    for rec in records:
        if not rec.path or (store.has(rec.video_id) and not overwrite):
            continue
        frames = decode_sampled_frames(
            rec.path, 64, staging_size,
            frame_start=getattr(rec, "frame_start", 1),
            frame_end=getattr(rec, "frame_end", -1),
        )
        store.put(rec.video_id, extractor.extract(frames))
        n += 1
    return n
