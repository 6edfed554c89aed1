"""Host video decode: the one stage that stays on the host CPU. Counterpart
of ``asltpu/data/decode.py``; it produces the same bytes.

- Sampled-only decode: the uniform temporal sampling indices are computed
  first, and only those frames are converted and staged; the others are
  decoded with ``grab()`` and skipped.
- Staging on the host: frames are resized (aspect-preserving) and cropped to
  the fixed staging resolution, so the device sees one shape. The device
  does the rest (:mod:`asltpu_torch.ops.preprocess`).

Backends (:func:`make_decode_pool`): the native C++ libraries of
:mod:`asltpu_torch.native` decode whole batches on native threads with the
interpreter lock released ("native", OpenCV's C++ API, byte-identical to
the cv2 path here; "av", libavcodec directly, with codec-level fast modes);
the Python pools decode with cv2 in worker processes or threads. Items are
video paths or clip records (:class:`~asltpu_torch.data.wlasl.ClipRecord`),
whose frame segment and signer box are honoured.

Nothing here imports torch, and OpenCV is imported when a clip is decoded:
a spawned decode worker starts with numpy, this module and what it imports.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from asltpu_torch import native
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.pad import pad_to_batch
from asltpu_torch.data.staging import resize_plan, uniform_sample_indices
from asltpu_torch.utils.profiling import record_span, span

_log = logging.getLogger("asltpu_torch.decode")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "video decode needs OpenCV (the cv2 module), which is not installed"
        ) from e
    return cv2


def probe_video(path: str) -> Tuple[int, float]:
    """(frame_count, fps) of a video container. Containers that report no
    frame count are counted by ``grab()`` (no conversion); a missing or
    non-positive fps falls back to 25, as cv2 itself assumes."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            total = 0
            while cap.grab():
                total += 1
        fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
        return total, fps if fps > 0 else 25.0
    finally:
        cap.release()


def decode_sampled_frames(
    path: str,
    num_frames: int,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    frame_start: int = 1,
    frame_end: int = -1,
    bbox: Optional[Tuple[int, int, int, int]] = None,
    staging_format: str = "rgb",
) -> np.ndarray:
    """Decode exactly the uniformly-sampled frames of a video segment.

    ``frame_start``/``frame_end`` are the WLASL 1-based inclusive segment
    bounds (-1 → EOF); ``bbox`` is an optional [x0, y0, x1, y1] signer crop
    applied before staging. Returns uint8 RGB [T, Hs, Ws, 3], or packed I420
    planes [T, Hs·3/2, Ws] with ``staging_format="yuv420"``. Frames beyond a
    premature EOF repeat the last good frame.
    """
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            # Some containers don't report counts; fall back to full decode.
            return _decode_all_then_sample(
                cap, num_frames, staging_size, host_resize_short,
                frame_start, frame_end, bbox, staging_format,
            )
        first = max(frame_start - 1, 0)
        last = total if frame_end < 0 else min(frame_end, total)
        if first >= last:
            # Stale segment metadata (start past EOF): use the full video.
            first, last = 0, total
        seg = max(last - first, 1)
        want = first + uniform_sample_indices(seg, num_frames)
        pos = 0
        if first > 8:
            # Seek near the segment instead of grab()-ing from frame 0; cv2
            # decodes forward from the nearest keyframe.
            if cap.set(cv2.CAP_PROP_POS_FRAMES, first):
                got = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
                if 0 <= got <= first:
                    pos = got
                else:  # unreliable seek — fall back to sequential
                    cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        hs, ws = staging_size
        frame_shape = (
            (hs * 3 // 2, ws) if staging_format == "yuv420" else (hs, ws, 3)
        )
        out = np.empty((num_frames, *frame_shape), dtype=np.uint8)
        want_set: dict = {}
        for out_i, frame_i in enumerate(want):
            want_set.setdefault(int(frame_i), []).append(out_i)
        last = None
        max_needed = max(want_set)
        while pos <= max_needed:
            if pos in want_set:
                ok, frame = cap.read()  # decode + convert
                if not ok:
                    break
                frame = _stage(frame, staging_size, host_resize_short, bbox,
                               staging_format)
                for out_i in want_set[pos]:
                    out[out_i] = frame
                last = frame
            else:
                if not cap.grab():  # decode-only, skip conversion
                    break
            pos += 1
        if last is None:
            raise IOError(f"no decodable frames in {path}")
        # Fill any frames past a premature EOF with the last good frame.
        for frame_i, out_is in want_set.items():
            if frame_i >= pos:
                for out_i in out_is:
                    out[out_i] = last
        return out
    finally:
        cap.release()


def _decode_all_then_sample(
    cap, num_frames, staging_size, host_resize_short: int = 0,
    frame_start: int = 1, frame_end: int = -1, bbox=None,
    staging_format: str = "rgb",
) -> np.ndarray:
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    if not frames:
        raise IOError("no decodable frames")
    first = max(frame_start - 1, 0)
    last = len(frames) if frame_end < 0 else min(frame_end, len(frames))
    frames = frames[first:last] or frames
    idx = uniform_sample_indices(len(frames), num_frames)
    return np.stack([
        _stage(frames[i], staging_size, host_resize_short, bbox,
               staging_format)
        for i in idx
    ])


def _stage(
    frame_bgr: np.ndarray,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    bbox=None,
    staging_format: str = "rgb",
) -> np.ndarray:
    """BGR→RGB (or I420) + aspect-preserving resize + center crop to the
    fixed staging resolution.

    The short-side target is ``host_resize_short`` when set (transfer-thin
    mode: staging == final crop, the device only normalizes) and
    ``min(staging_size)`` otherwise; in the default configuration the staged
    frame composes with the device crop to exactly resize-short → center
    crop (center crops nest)."""
    cv2 = _cv2()
    if bbox is not None:
        x0, y0, x1, y1 = (int(v) for v in bbox)
        h, w = frame_bgr.shape[:2]
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w), min(y1, h)
        if x1 > x0 and y1 > y0:
            frame_bgr = frame_bgr[y0:y1, x0:x1]
    hs, ws = staging_size
    short = host_resize_short or min(hs, ws)
    h, w = frame_bgr.shape[:2]
    rh, rw = resize_plan((h, w), short)
    # Clamp up so the staging crop always fits (extreme aspect ratios).
    rh, rw = max(rh, hs), max(rw, ws)
    if (rh, rw) != (h, w):
        frame_bgr = cv2.resize(
            frame_bgr, (rw, rh), interpolation=cv2.INTER_LINEAR
        )
    y0, x0 = (rh - hs) // 2, (rw - ws) // 2
    staged = frame_bgr[y0 : y0 + hs, x0 : x0 + ws]
    if staging_format == "yuv420":
        # Packed I420 planes: 1.5 bytes/px on the wire; the device converts.
        return cv2.cvtColor(np.ascontiguousarray(staged),
                            cv2.COLOR_BGR2YUV_I420)
    return staged[:, :, ::-1]  # BGR → RGB


def decode_clip(
    path: str, cfg: PreprocessConfig, num_frames: Optional[int] = None
) -> np.ndarray:
    """Video path → staged uint8 frames [T, Hs, Ws, 3] (or packed I420
    [T, Hs·3/2, Ws]) ready for the device preprocess. On the native OpenCV
    library where it is built (the same bytes), else on cv2."""
    t = num_frames or cfg.num_frames
    if native.available():
        return native.decode_clip_native(
            path, t, cfg.staging_size, cfg.host_resize_short,
            yuv420=cfg.staging_format == "yuv420")
    return decode_sampled_frames(path, t, cfg.staging_size, cfg.host_resize_short,
                                 staging_format=cfg.staging_format)


def decode_record(rec, cfg: PreprocessConfig) -> np.ndarray:
    """A :class:`~asltpu_torch.data.wlasl.ClipRecord` → staged frames,
    honouring its frame segment and signer box; native where built."""
    if native.available():
        return native.decode_clip_native(
            rec.path, cfg.num_frames, cfg.staging_size, cfg.host_resize_short,
            frame_start=rec.frame_start, frame_end=rec.frame_end, bbox=rec.bbox,
            yuv420=cfg.staging_format == "yuv420")
    return decode_sampled_frames(
        rec.path, cfg.num_frames, cfg.staging_size, cfg.host_resize_short,
        frame_start=rec.frame_start, frame_end=rec.frame_end, bbox=rec.bbox,
        staging_format=cfg.staging_format)


def decode_item(item, cfg: PreprocessConfig) -> np.ndarray:
    """A path or a clip record → staged frames."""
    if hasattr(item, "path") and hasattr(item, "frame_start"):
        return decode_record(item, cfg)
    return decode_clip(item, cfg)


def _timed_decode(item, cfg: PreprocessConfig):
    """:func:`decode_item` in a worker, with the worker's own stamps:
    (frames, start_ns, end_ns, pid, native thread id)."""
    t0 = time.time_ns()
    frames = decode_item(item, cfg)
    return frames, t0, time.time_ns(), os.getpid(), threading.get_native_id()


def _limit_cv2_threads():
    _cv2().setNumThreads(0)


def _check_on_error(on_error: str) -> None:
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be raise|skip, got {on_error}")


class NativeDecodePool:
    """Batch decoder on a native library (:mod:`asltpu_torch.native`): each
    batch decodes on ``num_workers`` native threads in one call, with the
    interpreter lock released, straight into one uint8 array, and
    ``decode_ahead`` batches decode in the background while the consumer
    handles the current one.

    ``lib="opencv"`` is byte-identical to the cv2 path; ``lib="av"`` is
    libavcodec directly (close to it, not byte-identical) and takes
    ``fast_flags``, an OR of ``asltpu_torch.native.FAST_*``."""

    def __init__(self, cfg: PreprocessConfig, num_workers: int = 4,
                 lib: str = "opencv", fast_flags: int = 0):
        if lib not in ("opencv", "av"):
            raise ValueError(f"lib must be opencv|av, got {lib}")
        if lib == "av" and not native.av_available():
            raise RuntimeError(
                f"native av decode unavailable: {native.av_unavailable_reason()}")
        if lib == "opencv" and not native.available():
            raise RuntimeError(
                f"native decode unavailable: {native.unavailable_reason()}")
        if fast_flags and lib != "av":
            raise ValueError("fast_flags are codec-level modes of the av library")
        self.cfg = cfg
        self.lib = lib
        self.backend = "native" if lib == "opencv" else "av"  # make_decode_pool's name
        self.fast_flags = fast_flags
        self._n = num_workers
        # Chunks decoding ahead of the consumer: at 2 the next chunk's
        # Python-side set-up (ctypes arguments, the output array) is off the
        # critical path; each level keeps one more decoded batch resident.
        self.decode_ahead = 2
        self._pipeline = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="asltpu-torch-native-decode")

    def _decode(self, items):
        cfg = self.cfg
        yuv420 = cfg.staging_format == "yuv420"
        if self.lib == "av":
            return native.decode_batch_av(
                items, cfg.num_frames, cfg.staging_size, cfg.host_resize_short,
                yuv420=yuv420, fast_flags=self.fast_flags, n_threads=self._n)
        return native.decode_batch_native(
            items, cfg.num_frames, cfg.staging_size, cfg.host_resize_short,
            yuv420=yuv420, n_threads=self._n)

    def map_batches(self, paths: Sequence, batch_size: int,
                    on_error: str = "raise"):
        """Same contract as :meth:`DecodePool.map_batches`: yields
        ``(frames [B, ...] u8, kept_indices)`` in order; a short or partly
        failed batch is padded by repeating its last good clip."""
        _check_on_error(on_error)
        chunks = [(i, paths[i : i + batch_size])
                  for i in range(0, len(paths), batch_size)]
        ahead = max(1, int(self.decode_ahead))
        futs = [self._pipeline.submit(self._decode, chunks[k][1])
                for k in range(min(ahead, len(chunks)))]
        try:
            for ci, (base, items) in enumerate(chunks):
                with span("decode.wait", batch=ci):
                    frames, ok = futs[ci].result()
                futs[ci] = None  # a Future keeps its result array alive
                nxt = ci + ahead
                if nxt < len(chunks):
                    futs.append(self._pipeline.submit(self._decode, chunks[nxt][1]))
                good = [j for j in range(len(items)) if ok[j] == 0]
                if len(good) < len(items):
                    bad = [items[j] for j in range(len(items)) if ok[j] != 0]
                    if on_error == "raise":
                        raise IOError(f"cannot decode clip(s): {bad}")
                    _log.warning("skipping undecodable clip(s): %s", bad)
                    if not good:
                        continue
                    frames = frames[good]
                with span("decode.stack", batch=ci):
                    frames = pad_to_batch(frames, batch_size)
                yield frames, [base + j for j in good]
        finally:
            for f in futs:
                if f is not None:
                    f.cancel()

    def shutdown(self):
        """Cancel the queued chunks and wait for the one decoding, so no
        thread outlives the pool."""
        self._pipeline.shutdown(wait=True, cancel_futures=True)


class DecodePool:
    """Worker pool decoding clips concurrently; feeds the Prefetcher for
    batched/streaming inference.

    ``use_processes=True`` decodes in worker processes (started with
    ``spawn``) instead of threads, so decode keeps going while the consumer
    thread holds the interpreter lock; each staged clip comes back pickled."""

    def __init__(
        self,
        cfg: PreprocessConfig,
        num_workers: int = 4,
        use_processes: bool = False,
    ):
        self.cfg = cfg
        self.backend = "process" if use_processes else "thread"  # make_decode_pool's name
        if use_processes:
            self._pool = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_limit_cv2_threads,
            )
        else:
            # One decode per pool slot; OpenCV's own threading would only
            # oversubscribe the cores.
            _limit_cv2_threads()
            self._pool = ThreadPoolExecutor(
                max_workers=num_workers, thread_name_prefix="asltpu-torch-decode"
            )

    def submit(self, item):
        """``item``: a video path or a clip record (segment and box
        honoured)."""
        return self._pool.submit(decode_item, item, self.cfg)

    def map_batches(
        self,
        paths: Sequence,
        batch_size: int,
        on_error: str = "raise",
    ):
        """Yield ``(frames [B, T, ...] u8, kept_indices)`` in submission
        order; the final short batch is padded by repeating the last clip
        (``kept_indices`` carries the true members). Spans: ``decode.clip``
        per clip in its worker, ``decode.wait`` for a batch's clips,
        ``decode.stack`` for its stack and pad (``batch``: the batch's index).

        ``on_error="skip"`` drops undecodable clips with a warning instead
        of failing the stream; a batch whose clips all fail is skipped.
        """
        _check_on_error(on_error)
        # Keep at most a few batches of decodes in flight so a fast decoder
        # cannot pile a whole corpus of frames into host memory.
        window = max(batch_size * 4, 8)
        futures: list = []
        next_submit = 0

        def top_up(upto):
            nonlocal next_submit
            while next_submit < min(upto, len(paths)):
                futures.append(self._pool.submit(_timed_decode, paths[next_submit], self.cfg))
                next_submit += 1

        top_up(window)
        for i in range(0, len(paths), batch_size):
            b = i // batch_size
            top_up(i + batch_size + window)
            chunk = futures[i : i + batch_size]
            # Release consumed futures: a Future retains its result array.
            futures[i : i + batch_size] = [None] * len(chunk)
            clips, kept = [], []
            with span("decode.wait", batch=b):
                for j, f in enumerate(chunk):
                    try:
                        clip, t0, t1, pid, tid = f.result()
                    except Exception:
                        if on_error == "raise":
                            raise
                        _log.warning("skipping undecodable clip %s", paths[i + j],
                                     exc_info=True)
                        continue
                    record_span("decode.clip", t0, t1, pid=pid, tid=tid, batch=b)
                    clips.append(clip)
                    kept.append(i + j)
            if not clips:
                continue
            with span("decode.stack", batch=b):
                frames = pad_to_batch(np.stack(clips), batch_size)
            yield frames, kept

    def shutdown(self):
        """Cancel the queued decodes and wait for the running ones, so no
        worker outlives the pool."""
        self._pool.shutdown(wait=True, cancel_futures=True)


BACKENDS = ("auto", "native", "av", "process", "thread")


def make_decode_pool(
    cfg: PreprocessConfig, num_workers: int = 4, backend: str = "auto",
    fast_flags: int = 0,
):
    """Decode-pool factory. ``backend``:

    - "native": the OpenCV C++ batch decoder (byte-identical to cv2);
    - "av": the libavcodec C++ batch decoder, with ``fast_flags`` (an OR of
      ``asltpu_torch.native.FAST_*``); close to cv2, not byte-identical;
    - "process" / "thread": cv2 in worker processes or threads;
    - "auto": native, else process, else thread. Never av: its output is
      not byte-identical, so callers choose it.

    "native" and "av" raise where their library is unavailable, with the
    reason; ``fast_flags`` with any backend but "av" raises.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; expected one of "
            + "/".join(BACKENDS))
    if fast_flags and backend != "av":
        raise ValueError(
            "fast_flags are codec-level modes of the 'av' backend; "
            f"backend={backend!r} would ignore them")
    if backend == "av":
        return NativeDecodePool(cfg, num_workers, lib="av", fast_flags=fast_flags)
    if backend == "native" or (backend == "auto" and native.available()):
        return NativeDecodePool(cfg, num_workers)
    return DecodePool(cfg, num_workers=num_workers, use_processes=backend != "thread")
