"""Serving: a dynamic-batching predictor over a loaded model, config #5's
batched streaming inference run as a long-lived service. Counterpart of
``asltpu/serve.py``.

- One batcher thread owns the device: it drains the request queue up to
  ``max_batch`` requests or ``max_delay_ms``, pads the batch to the
  smallest batch bucket that holds it, copies it to ``model.device``, runs
  ``predict_fn`` and fulfils each request's future. Only this thread
  launches the preprocess kernels, so their launch counters stay exact.
- Requests carry staged frames (and/or landmarks): decode happens in the
  caller before ``submit``, so a slow codec never stalls the device.
- ``predict_fn`` enters inference mode inside itself and the kernels
  launch on the calling thread's current stream, so no stream or autograd
  mode is held across threads.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from asltpu_torch.api import Model, gloss_label
from asltpu_torch.config import PoseBiLSTMConfig
from asltpu_torch.data.pad import pad_to_batch


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    total_latency_s: float = 0.0

    @property
    def avg_batch_size(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def avg_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / self.requests if self.requests else 0.0


class _Request:
    __slots__ = ("frames", "landmarks", "future", "t_submit")

    def __init__(self, frames, landmarks):
        self.frames = frames
        self.landmarks = landmarks
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class PredictServer:
    """Dynamic-batching inference server over a loaded model.

    Usage::

        server = PredictServer(model, max_batch=32, max_delay_ms=10)
        fut = server.submit(staged_frames)          # non-blocking
        gloss, logits = fut.result()
        server.shutdown()

    ``batch_buckets`` pads a collected batch to the smallest listed size
    that holds it (``max_batch`` is always one), so a lone request does not
    pay for a full batch; without it every batch pads to ``max_batch``.
    """

    def __init__(
        self,
        model: Model,
        max_batch: int = 32,
        max_delay_ms: float = 10.0,
        gloss_names: Optional[List[str]] = None,
        batch_buckets: Optional[Tuple[int, ...]] = None,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.gloss_names = gloss_names
        buckets = sorted(set(batch_buckets or ())) or [max_batch]
        if buckets[-1] != max_batch:
            buckets.append(max_batch)
        if any(b < 1 for b in buckets):
            raise ValueError(f"batch_buckets must be >= 1: {buckets}")
        self.batch_buckets = tuple(buckets)
        self.stats = ServerStats()
        self._fn = model.predict_fn()
        self._pose_only = isinstance(model.cfg, PoseBiLSTMConfig)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._running = True
        # Guards the (_running check → put) pair in submit against the
        # batcher's final drain: without it a request could land in the
        # queue after the drain and block its caller forever.
        self._submit_lock = threading.Lock()
        pp = getattr(model.cfg, "preprocess", None)
        self._frames_shape = (
            (pp.num_frames, *pp.staged_frame_shape)
            if model.takes_rgb and pp is not None else None
        )
        # A fusion model's forward checks landmarks against the clip's
        # frame count (preprocess.num_frames); the pose model has no
        # preprocess and uses its own num_frames.
        lm_t = (
            pp.num_frames
            if (model.takes_rgb and pp is not None)
            else getattr(model.cfg, "num_frames", 16)
        )
        self._lm_shape = (
            (lm_t, getattr(model.cfg, "num_landmarks", 543),
             getattr(model.cfg, "landmark_dim", 3))
            if model.takes_landmarks else None
        )
        self._thread = threading.Thread(target=self._loop, name="asltpu_torch-serve",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(
        self,
        frames: Optional[np.ndarray] = None,
        landmarks: Optional[np.ndarray] = None,
    ) -> Future:
        """Enqueue one clip (staged frames [T, Hs, Ws, 3] uint8, or packed
        I420, and/or landmarks [T, 543, 3]); returns a Future of (gloss,
        logits)."""
        if self.model.takes_rgb and frames is None:
            raise ValueError("model requires RGB frames")
        if self.model.takes_landmarks and landmarks is None:
            raise ValueError("model requires landmarks")
        # Shapes are checked per request: a malformed one would otherwise
        # fail np.stack in _assemble and fail its whole batch.
        if self._frames_shape is not None and (
            tuple(np.shape(frames)) != self._frames_shape
        ):
            raise ValueError(
                f"frames shape {tuple(np.shape(frames))} != expected "
                f"{self._frames_shape} (one staged clip, no batch dim)"
            )
        if self._lm_shape is not None and (
            tuple(np.shape(landmarks)) != self._lm_shape
        ):
            raise ValueError(
                f"landmarks shape {tuple(np.shape(landmarks))} != expected "
                f"{self._lm_shape}"
            )
        req = _Request(frames, landmarks)
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("server is shut down")
            self._q.put(req)
        return req.future

    def shutdown(self, wait: bool = True):
        with self._submit_lock:
            self._running = False
        self._q.put(None)
        if wait:
            self._thread.join(timeout=30)

    # ------------------------------------------------------------------
    def _collect(self) -> List[_Request]:
        """Block for the first request, then drain up to max_batch or until
        max_delay elapses."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-signal shutdown for the outer loop
                break
            batch.append(item)
        return batch

    def _bucket_for(self, n: int) -> int:
        """Smallest configured bucket that fits ``n`` requests."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.max_batch

    def _run(self, args: Tuple[np.ndarray, ...]) -> np.ndarray:
        """A padded host batch → logits on the host: copy to the device,
        predict (the pose model takes the landmarks alone), copy back."""
        if self._pose_only:
            args = args[-1:]
        xs = [torch.from_numpy(a).to(self.model.device) for a in args]
        return self._fn(*xs).cpu().numpy()

    def warm(self):
        """Run every bucket once with zeros on the device before serving,
        so that the CUDA kernels are built and cuDNN has chosen its
        algorithms for each batch size before the first request. Call it
        before requests arrive."""
        for b in self.batch_buckets:
            args = []
            if self._frames_shape is not None:
                args.append(np.zeros((b, *self._frames_shape), np.uint8))
            if self._lm_shape is not None:
                args.append(np.zeros((b, *self._lm_shape), np.float32))
            self._run(tuple(args))

    def _assemble(self, reqs: List[_Request]) -> Tuple[np.ndarray, ...]:
        bucket = self._bucket_for(len(reqs))
        args = []
        if self.model.takes_rgb:
            args.append(pad_to_batch(np.stack([r.frames for r in reqs]), bucket))
        if self.model.takes_landmarks:
            args.append(pad_to_batch(
                np.stack([r.landmarks for r in reqs]).astype(np.float32), bucket))
        self.stats.padded_slots += bucket - len(reqs)
        return tuple(args)

    def _loop(self):
        while True:
            reqs = self._collect()
            if not reqs:
                break
            try:
                logits = self._run(self._assemble(reqs))[: len(reqs)]
                ids = logits.argmax(axis=-1)
                now = time.perf_counter()
                for i, r in enumerate(reqs):
                    self.stats.total_latency_s += now - r.t_submit
                    r.future.set_result((gloss_label(ids[i], self.gloss_names), logits[i]))
                self.stats.requests += len(reqs)
                self.stats.batches += 1
            except Exception as e:  # fail the whole batch, keep serving
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
        # Close the submit window before draining: once the lock is taken,
        # every submit that passed its _running check has put its request,
        # so the drain below sees all of them and later submits raise.
        with self._submit_lock:
            self._running = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("server is shut down"))
