"""Continuous-video recognition: sliding-window gloss predictions.
Counterpart of ``asltpu/windows.py``.

The five configs classify one trimmed clip. A deployed recognizer sees
continuous signing: minutes of video, many signs, no segment boundaries.
Each window is a :class:`~asltpu_torch.data.wlasl.ClipRecord` frame
segment of the one video, so only its sampled frames are decoded, and the
windows stream through :func:`asltpu_torch.api.stream_predict` in batches:

    model = api.load_model("mobilenet_gru")
    wins = predict_windows(model, "signing_session.mp4",
                           window_seconds=2.0, gloss_names=names)
    for seg in merge_windows(wins, min_prob=0.4):
        print(seg.gloss, seg.start_s, seg.end_s, seg.mean_prob)

CLI: ``python -m asltpu_torch.cli predict --windows 2.0 [--window-stride
1.0] [--min-prob 0.4]``.

RGB models (``mobilenet_gru``, ``resnet_transformer``, ``i3d``) window the
video alone; ``two_stream`` also takes ``landmark_stream=``, the session's
per-frame landmarks, sliced and resampled per window beside the RGB;
``pose_bilstm`` windows a landmark stream with
:func:`predict_windows_landmarks` and decodes no video.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from asltpu_torch.api import Model, gloss_label, stream_predict
from asltpu_torch.data.decode import probe_video
from asltpu_torch.data.pad import pad_to_batch
from asltpu_torch.data.staging import uniform_sample_indices
from asltpu_torch.data.wlasl import ClipRecord


@dataclasses.dataclass(frozen=True)
class WindowPrediction:
    """One sliding window's prediction. Frames are 1-based inclusive (the
    ClipRecord convention); times are seconds from the video's start
    (``end_s`` = the end of the last frame)."""

    index: int
    start_frame: int
    end_frame: int
    start_s: float
    end_s: float
    gloss_id: int
    # The display gloss: a name when gloss_names were given, else the class
    # id (gloss_label's contract, shared with predict and stream_predict).
    gloss: object
    prob: float  # softmax probability of the argmax class


@dataclasses.dataclass(frozen=True)
class GlossSegment:
    """A maximal run of consecutive windows with one argmax gloss.
    ``gloss_id == -1`` (gloss None) marks an uncertain run: windows whose
    top probability fell below the caller's ``min_prob``."""

    gloss_id: int
    gloss: Optional[str]
    start_frame: int
    end_frame: int
    start_s: float
    end_s: float
    num_windows: int
    mean_prob: float


def enumerate_windows(
    total_frames: int, window_frames: int, stride_frames: int
) -> List[Tuple[int, int]]:
    """1-based inclusive (start, end) sliding windows covering
    ``total_frames``. The last window is moved back to end at the last
    frame (never cut short), so the tail is covered at full window length;
    a video shorter than one window gives one window over all of it."""
    if total_frames <= 0:
        return []
    if window_frames <= 0 or stride_frames <= 0:
        raise ValueError(
            f"window/stride must be positive, got window={window_frames} "
            f"stride={stride_frames}"
        )
    w = min(window_frames, total_frames)
    out = [(s, s + w - 1) for s in range(1, total_frames - w + 2, stride_frames)]
    if out[-1][1] < total_frames:
        out.append((total_frames - w + 1, total_frames))
    return out


def _resolve_plan(total: int, fps: float, window_seconds, window_frames,
                  stride_seconds, stride_frames) -> List[Tuple[int, int]]:
    """The window plan: seconds → frames through ``fps``; the stride is
    half the window (50% overlap) unless given."""
    if (window_seconds is None) == (window_frames is None):
        raise ValueError("pass exactly one of window_seconds/window_frames")
    if stride_seconds is not None and stride_frames is not None:
        raise ValueError("pass at most one of stride_seconds/stride_frames")
    if window_frames is None:
        window_frames = max(1, int(round(window_seconds * fps)))
    if stride_frames is None:
        stride_frames = (
            max(1, int(round(stride_seconds * fps)))
            if stride_seconds is not None
            else max(1, window_frames // 2)
        )
    return enumerate_windows(total, window_frames, stride_frames)


def _window_prediction(i, span, fps, logits, gloss) -> WindowPrediction:
    """One window's prediction from its logits; the softmax runs in float64
    on the host."""
    z = np.asarray(logits, np.float64)
    p = np.exp(z - z.max())
    p /= p.sum()
    gid = int(z.argmax())
    s, e = span
    return WindowPrediction(
        index=i, start_frame=s, end_frame=e,
        start_s=(s - 1) / fps, end_s=e / fps,
        gloss_id=gid, gloss=gloss, prob=float(p[gid]),
    )


def _check_landmarks(lm: np.ndarray, name: str) -> np.ndarray:
    lm = np.asarray(lm, np.float32)
    if lm.ndim != 3 or lm.shape[1:] != (543, 3):
        raise ValueError(f"expected [T, 543, 3] {name}, got {list(lm.shape)}")
    return lm


def predict_windows(
    model: Model,
    path: str,
    *,
    window_seconds: Optional[float] = None,
    window_frames: Optional[int] = None,
    stride_seconds: Optional[float] = None,
    stride_frames: Optional[int] = None,
    batch_size: int = 8,
    gloss_names: Optional[Sequence[str]] = None,
    decode_backend: str = "auto",
    decode_fast: bool = False,
    num_decode_workers: int = 4,
    landmark_stream: Optional[np.ndarray] = None,
) -> List[WindowPrediction]:
    """Classify every sliding window of one continuous video, in the order
    of the windows' starts. The window is given in seconds (converted with
    the container's fps) or in frames; the stride defaults to half the
    window. Each window decodes only its ``num_frames`` sampled frames, and
    the windows go through ``stream_predict`` in batches of
    ``batch_size``.

    ``two_stream`` also takes ``landmark_stream``: the session's per-frame
    [T_total, 543, 3] landmarks, aligned 1:1 with the video's frames. Each
    window slices its span and resamples it as the RGB frames are sampled,
    so both streams stay aligned per window. ``pose_bilstm`` uses
    :func:`predict_windows_landmarks`."""
    if model.takes_landmarks and not model.takes_rgb:
        raise ValueError(
            f"'{type(model.cfg).__name__}' consumes only landmarks — "
            "use predict_windows_landmarks(model, landmark_stream, fps)"
        )
    lm_for = None
    if model.takes_landmarks:
        if landmark_stream is None:
            raise ValueError(
                f"'{type(model.cfg).__name__}' is a fusion model: pass "
                "landmark_stream=[T_total, 543, 3] aligned to the video's "
                "frames (per-window slices resample alongside the RGB)"
            )
        landmark_stream = _check_landmarks(landmark_stream, "landmark_stream")
        nf = model.cfg.preprocess.num_frames

        def lm_for(rec):
            return landmark_stream[
                (rec.frame_start - 1)
                + uniform_sample_indices(rec.frame_end - rec.frame_start + 1, nf)
            ]

        lm_for.takes_record = True  # stream_predict passes the record
    total, fps = probe_video(path)
    if landmark_stream is not None and len(landmark_stream) < total:
        # A short stream would misalign every window past its end.
        raise ValueError(
            f"landmark_stream has {len(landmark_stream)} frames but the "
            f"video has {total} — the stream must cover every video frame"
        )
    spans = _resolve_plan(total, fps, window_seconds, window_frames,
                          stride_seconds, stride_frames)
    records = [
        ClipRecord(video_id=f"{path}#win{i:05d}", gloss="", label=-1, split="",
                   path=path, frame_start=s, frame_end=e)
        for i, (s, e) in enumerate(spans)
    ]
    index_of = {r.video_id: i for i, r in enumerate(records)}

    out: List[Optional[WindowPrediction]] = [None] * len(records)
    for rec, gloss, logits in stream_predict(
        model, records, batch_size=batch_size, gloss_names=gloss_names,
        decode_backend=decode_backend, decode_fast=decode_fast,
        num_decode_workers=num_decode_workers, landmarks_for=lm_for,
        yield_items=True,
    ):
        i = index_of[rec.video_id]
        out[i] = _window_prediction(i, spans[i], fps, logits, gloss)
    # The windows slice one video, so a decode failure hits every window
    # alike: stream_predict raises, and this is a backstop against a
    # silently sparse timeline.
    missing = [i for i, w in enumerate(out) if w is None]
    if missing:
        raise IOError(f"windows {missing} of {path} produced no prediction")
    return out  # type: ignore[return-value]


def predict_windows_landmarks(
    model: Model,
    landmarks: np.ndarray,
    fps: float,
    *,
    window_seconds: Optional[float] = None,
    window_frames: Optional[int] = None,
    stride_seconds: Optional[float] = None,
    stride_frames: Optional[int] = None,
    batch_size: int = 8,
    gloss_names: Optional[Sequence[str]] = None,
) -> List[WindowPrediction]:
    """Continuous recognition for ``pose_bilstm`` from a landmark stream:
    ``landmarks`` is the whole session's [T_total, 543, 3]. Windows are
    slices resampled to the model's ``num_frames`` (the clip lane's uniform
    sampling), padded to ``batch_size`` and run on ``model.device``.
    ``fps`` is the stream's frame rate (timestamps only)."""
    if not model.takes_landmarks or model.takes_rgb:
        raise ValueError(
            "predict_windows_landmarks is the pose-only lane; "
            f"'{type(model.cfg).__name__}' is not a pure landmark consumer"
        )
    landmarks = _check_landmarks(landmarks, "landmarks")
    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    spans = _resolve_plan(len(landmarks), fps, window_seconds, window_frames,
                          stride_seconds, stride_frames)
    nf = model.cfg.num_frames
    clips = np.stack([landmarks[(s - 1) + uniform_sample_indices(e - s + 1, nf)]
                      for s, e in spans])
    fn = model.predict_fn()
    out: List[WindowPrediction] = []
    for i0 in range(0, len(spans), batch_size):
        chunk = clips[i0:i0 + batch_size]
        x = torch.from_numpy(pad_to_batch(chunk, batch_size)).to(model.device)
        logits = fn(x).cpu().numpy()[: len(chunk)]
        for j, z in enumerate(logits):
            i = i0 + j
            out.append(_window_prediction(
                i, spans[i], fps, z, gloss_label(int(np.argmax(z)), gloss_names)))
    return out


def merge_windows(
    windows: Sequence[WindowPrediction], *, min_prob: float = 0.0
) -> List[GlossSegment]:
    """Collapse per-window predictions into gloss segments: maximal runs of
    consecutive windows with one argmax gloss. Windows whose top
    probability is below ``min_prob`` pool into uncertain runs
    (``gloss_id=-1``, gloss None) instead of being dropped, so the segments
    tile the predicted timeline end to end. Overlapping windows merge by
    span union (first window's start → last window's end)."""
    segs: List[GlossSegment] = []
    run: List[WindowPrediction] = []
    run_label = None

    def flush():
        if not run:
            return
        segs.append(GlossSegment(
            gloss_id=run_label,
            gloss=run[0].gloss if run_label >= 0 else None,
            start_frame=run[0].start_frame,
            end_frame=run[-1].end_frame,
            start_s=run[0].start_s,
            end_s=run[-1].end_s,
            num_windows=len(run),
            mean_prob=float(np.mean([w.prob for w in run])),
        ))

    for w in windows:
        label = w.gloss_id if w.prob >= min_prob else -1
        if label != run_label and run:
            flush()
            run = []
        run_label = label
        run.append(w)
    flush()
    return segs


def segments_json(segs: Sequence[GlossSegment]) -> List[dict]:
    """JSON-ready form of :func:`merge_windows`' output (the CLI's and the
    server's wire shape; seconds rounded to ms, probabilities to 1e-4)."""
    return [
        {
            "gloss": s.gloss,
            "gloss_id": s.gloss_id,
            "start_s": round(s.start_s, 3),
            "end_s": round(s.end_s, 3),
            "start_frame": s.start_frame,
            "end_frame": s.end_frame,
            "num_windows": s.num_windows,
            "mean_prob": round(s.mean_prob, 4),
        }
        for s in segs
    ]


def windows_json(wins: Sequence[WindowPrediction]) -> List[dict]:
    """The per-window trace in the CLI's and the server's wire shape."""
    return [
        {"start_s": round(w.start_s, 3), "end_s": round(w.end_s, 3),
         "gloss": w.gloss, "prob": round(w.prob, 4)}
        for w in wins
    ]
