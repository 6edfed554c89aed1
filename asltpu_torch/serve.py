"""Serving: a dynamic-batching predictor over a loaded model, config #5's
batched streaming inference run as a long-lived service. Counterpart of
``asltpu/serve.py``.

- One batcher thread owns the device: it drains the request queue up to
  ``max_batch`` requests or ``max_delay_ms``, writes the batch into the
  buffers kept for the smallest batch bucket that holds it, copies it to
  ``model.device``, runs ``predict_fn`` and fulfils each request's future.
  Only this thread launches the preprocess kernels, so their launch
  counters stay exact.
- A bucket's buffers live as long as the server: host rows, page-locked
  when the model is on the card, and a device tensor of the bucket's
  shape. A batch is written into the host rows in place, only its real
  rows cross to the card, and the padding (the last row repeated) is
  written there.
- Requests carry staged frames (and/or landmarks): decode happens in the
  caller before ``submit``, so a slow codec never stalls the device.
- ``predict_fn`` enters inference mode inside itself and the kernels
  launch on the calling thread's current stream, so no stream or autograd
  mode is held across threads.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asltpu_torch.api import Model, gloss_label
from asltpu_torch.utils import profiling


@dataclasses.dataclass
class ServerStats:
    """Counters of the batches served, always kept. Latency runs from
    ``submit`` to the answer; queue wait from ``submit`` to the batcher
    taking the request off the queue; assembly is the in-place fill of a
    bucket's host rows with the batch, copy the host time to start its
    rows' transfer and the padding on the model's device (on the card the
    transfer itself runs on after, inside the predict). ``staged_batches``
    counts the batches filled into page-locked rows: every batch on the
    card, none on the CPU."""

    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    staged_batches: int = 0
    total_latency_s: float = 0.0
    total_queue_wait_s: float = 0.0
    total_assemble_s: float = 0.0
    total_copy_s: float = 0.0

    @property
    def avg_batch_size(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def avg_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / self.requests if self.requests else 0.0

    @property
    def avg_queue_wait_ms(self) -> float:
        return 1e3 * self.total_queue_wait_s / self.requests if self.requests else 0.0

    @property
    def avg_assemble_ms(self) -> float:
        return 1e3 * self.total_assemble_s / self.batches if self.batches else 0.0

    @property
    def avg_copy_ms(self) -> float:
        return 1e3 * self.total_copy_s / self.batches if self.batches else 0.0


class _Staging:
    """The buffers one input of one batch bucket is batched in: ``host``,
    the rows a batch is written into (page-locked when the model is on the
    card), and ``batch``, the bucket-sized tensor the model reads (on the
    card; on the CPU a view of ``host``)."""

    def __init__(self, shape: Tuple[int, ...], dtype: np.dtype, device: torch.device):
        self.pinned = device.type == "cuda"
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        # Normal tensors even under a caller's inference mode: the padding
        # writes into ``batch`` from the batcher thread, outside it.
        with torch.inference_mode(False):
            self._rows = torch.empty(shape, dtype=tdtype, pin_memory=self.pinned)
            self.batch = (torch.empty(shape, dtype=tdtype, device=device) if self.pinned
                          else self._rows)
        self.host = self._rows.numpy()
        self._copied = torch.cuda.Event() if self.pinned else None

    def writable(self) -> np.ndarray:
        """``host``, once the last copy out of it has finished."""
        if self._copied is not None:
            self._copied.synchronize()
        return self.host

    def load(self, n: int) -> torch.Tensor:
        """``batch`` with the first ``n`` rows of ``host`` (copied without
        waiting, on the device's current stream) and the last of them
        repeated into the rest."""
        if self.pinned:
            self.batch[:n].copy_(self._rows[:n], non_blocking=True)
            self._copied.record(torch.cuda.current_stream(self.batch.device))
        if n < len(self.batch):
            self.batch[n:] = self.batch[n - 1]
        return self.batch


class _Request:
    """One clip in flight; ``t_submit`` and ``t_taken`` (off the queue) in
    ``time.time_ns()``, the clock of the program's spans."""

    __slots__ = ("frames", "landmarks", "future", "id", "t_submit", "t_taken")

    def __init__(self, frames, landmarks, rid: int):
        self.frames = frames
        self.landmarks = landmarks
        self.future: Future = Future()
        self.id = rid
        self.t_submit = time.time_ns()
        self.t_taken = 0


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
        self._request_ids = itertools.count()
        self._fn = model.predict_fn()
        # (bucket, clip shape, dtype) → that input's buffers. The lock makes
        # warm() and the batcher take turns with them.
        self._staging: Dict[tuple, _Staging] = {}
        self._staging_lock = threading.Lock()
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
        # fail _assemble and fail its whole batch.
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
        req = _Request(frames, landmarks, next(self._request_ids))
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
        max_delay elapses; each request is stamped as it is taken."""
        first = self._q.get()
        if first is None:
            return []
        first.t_taken = time.time_ns()
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
            item.t_taken = time.time_ns()
            batch.append(item)
        return batch

    def _bucket_for(self, n: int) -> int:
        """Smallest configured bucket that fits ``n`` requests."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.max_batch

    def _predict(self, xs: List[torch.Tensor]) -> np.ndarray:
        return self._fn(*xs).cpu().numpy()

    def warm(self):
        """Run every bucket once with zeros on the device before serving,
        so that the CUDA kernels are built, cuDNN has chosen its algorithms
        for each batch size and each bucket's buffers are made before the
        first request. Call it before requests arrive."""
        for b in self.batch_buckets:
            with self._staging_lock:
                stages = []
                if self._frames_shape is not None:
                    stages.append(self._stage(b, self._frames_shape, np.dtype(np.uint8)))
                if self._lm_shape is not None:
                    stages.append(self._stage(b, self._lm_shape, np.dtype(np.float32)))
                for s in stages:
                    s.writable().fill(0)
                self._predict([s.load(b) for s in stages])

    def _stage(self, bucket: int, shape: Tuple[int, ...], dtype: np.dtype) -> _Staging:
        key = (bucket, shape, dtype)
        stage = self._staging.get(key)
        if stage is None:
            stage = self._staging[key] = _Staging((bucket, *shape), dtype, self.model.device)
        return stage

    def _fill(self, bucket: int, rows: List[np.ndarray], dtype: np.dtype) -> _Staging:
        """Write ``rows`` (one shape: ``submit`` checks it) into the first
        rows of the bucket's host buffer for their shape and ``dtype``
        (cast as they are written)."""
        stage = self._stage(bucket, rows[0].shape, dtype)
        host = stage.writable()
        for i, r in enumerate(rows):
            host[i] = r
        return stage

    def _assemble(self, reqs: List[_Request]) -> List[_Staging]:
        """The batch written into its bucket's buffers, one an input: the
        frames in the dtype ``np.stack`` would give them, the landmarks in
        fp32."""
        bucket = self._bucket_for(len(reqs))
        stages = []
        if self.model.takes_rgb:
            rows = [np.asarray(r.frames) for r in reqs]
            stages.append(self._fill(bucket, rows, np.result_type(*{r.dtype for r in rows})))
        if self.model.takes_landmarks:
            rows = [np.asarray(r.landmarks) for r in reqs]
            stages.append(self._fill(bucket, rows, np.dtype(np.float32)))
        self.stats.padded_slots += bucket - len(reqs)
        return stages

    def _loop(self):
        now = time.time_ns
        for batch in itertools.count():
            reqs = self._collect()
            if not reqs:
                break
            try:
                with self._staging_lock:
                    t_collected = now()
                    stages = self._assemble(reqs)
                    t_assembled = now()
                    xs = [s.load(len(reqs)) for s in stages]
                    t_copied = now()
                    logits = self._predict(xs)[: len(reqs)]
                    t_predicted = now()
                ids = logits.argmax(axis=-1)
                t_answered = now()
                st = self.stats
                st.total_latency_s += sum(t_answered - r.t_submit for r in reqs) / 1e9
                st.total_queue_wait_s += sum(r.t_taken - r.t_submit for r in reqs) / 1e9
                st.total_assemble_s += (t_assembled - t_collected) / 1e9
                st.total_copy_s += (t_copied - t_assembled) / 1e9
                st.requests += len(reqs)
                st.batches += 1
                st.staged_batches += all(s.pinned for s in stages)
                for i, r in enumerate(reqs):
                    r.future.set_result((gloss_label(ids[i], self.gloss_names), logits[i]))
                t_replied = now()
                if profiling.recording():
                    _record_batch(batch, reqs, (t_collected, t_assembled, t_copied,
                                                t_predicted, t_replied))
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


def _record_batch(batch: int, reqs: List[_Request], stamps: Tuple[int, ...]) -> None:
    """The spans of one served batch, from the batcher's stamps:
    ``serve.batch`` (first request taken → last future set) and its
    children ``serve.collect`` (→ deadline or full), ``serve.assemble``
    (the in-place fill of the bucket's host rows), ``serve.copy`` (the
    launch of the real rows' copy and of the padding on the device),
    ``serve.predict`` (model, logits back; on the card it waits for the
    copy too), ``serve.reply`` (argmax, futures), and each request's
    ``serve.queue`` (submit → taken)."""
    first = reqs[0].t_taken
    parent = profiling.record_span("serve.batch", first, stamps[-1], batch=batch)
    for name, a, b in zip(("serve.collect", "serve.assemble", "serve.copy", "serve.predict",
                           "serve.reply"), (first, *stamps[:-1]), stamps):
        profiling.record_span(name, a, b, parent=parent, batch=batch)
    for r in reqs:
        profiling.record_span("serve.queue", r.t_submit, r.t_taken, parent=parent,
                              request=r.id, batch=batch)
