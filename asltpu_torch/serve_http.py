"""HTTP front end over :class:`asltpu_torch.serve.PredictServer`.
Counterpart of ``asltpu/serve_http.py``, with the same endpoints, bodies,
status codes and messages.

Endpoints:
  - ``POST /predict``            body = video container bytes (mp4, ...);
                                 decoded and staged on the request thread,
                                 then batched with concurrent requests.
                                 → ``{"gloss", "top5"}``
  - ``POST /predict_landmarks``  body = ``.npy`` bytes of [T, 543, 3]
                                 landmarks (the pose model).
  - ``POST /predict_fusion``     ``two_stream``: an 8-byte big-endian
                                 length of the video part, the video bytes,
                                 then ``.npy`` landmark bytes. → same JSON.
  - ``POST /predict_windows``    continuous recognition
                                 (``?window_s=2.0[&stride_s=1.0]
                                 [&min_prob=0.4]``): body = an untrimmed
                                 video; every window decodes on the request
                                 thread and rides the shared batcher.
                                 → ``{"num_windows", "segments", "windows"}``
  - ``POST /predict_windows_landmarks``  the pose model's counterpart: body
                                 = ``.npy`` [T, 543, 3] of a whole session
                                 (``&fps=`` for timestamps, default 25).
  - ``GET /healthz``             liveness and the model's config name
  - ``GET /stats``               batching and latency counters; the means of a
                                  request's queue wait and of a batch's assembly
                                  and copy to the device

Standard library only (``ThreadingHTTPServer``): one process, a thread per
request, one batcher thread that owns the device.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from asltpu_torch.api import Model
from asltpu_torch.data.decode import decode_clip, decode_record, probe_video
from asltpu_torch.data.staging import uniform_sample_indices
from asltpu_torch.data.wlasl import ClipRecord
from asltpu_torch.eval.metrics import topk_entries
from asltpu_torch.serve import PredictServer
from asltpu_torch.utils.logging import get_logger
from asltpu_torch.windows import (
    _resolve_plan,
    _window_prediction,
    merge_windows,
    segments_json,
    windows_json,
)


def _video_file(data: bytes) -> str:
    """The body's container bytes in a temporary file (cv2 opens a path,
    not a buffer); the caller unlinks it."""
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        f.write(data)
        return f.name


def make_handler(server_state):
    log = get_logger("asltpu_torch.http")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.info(fmt, *args)

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": type(server_state.model.cfg).__name__,
                })
            elif self.path == "/stats":
                st = server_state.predictor.stats
                self._json(200, {
                    "requests": st.requests,
                    "batches": st.batches,
                    "avg_batch_size": round(st.avg_batch_size, 2),
                    "avg_latency_ms": round(st.avg_latency_ms, 2),
                    "padded_slots": st.padded_slots,
                    "avg_queue_wait_ms": round(st.avg_queue_wait_ms, 2),
                    "avg_assemble_ms": round(st.avg_assemble_ms, 2),
                    "avg_copy_ms": round(st.avg_copy_ms, 2),
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("empty body")
            if length > server_state.max_body:
                # An oversized body is not drained: the connection closes
                # after the response, so keep-alive never parses body bytes
                # as the next request.
                self.close_connection = True
                raise ValueError(f"body too large ({length} bytes)")
            return self.rfile.read(length)

        def _drain_body(self):
            """Consume an unread body so a keep-alive connection stays in
            sync (or mark it closed when the body is too large)."""
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return
            if length > server_state.max_body:
                self.close_connection = True
                return
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                length -= len(chunk)

        def do_POST(self):
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/predict":
                    self._predict_video()
                elif parsed.path == "/predict_landmarks":
                    self._predict_landmarks()
                elif parsed.path == "/predict_fusion":
                    self._predict_fusion()
                elif parsed.path == "/predict_windows":
                    self._predict_windows(parse_qs(parsed.query))
                elif parsed.path == "/predict_windows_landmarks":
                    self._predict_windows_landmarks(parse_qs(parsed.query))
                else:
                    self._drain_body()
                    self._json(404, {"error": f"unknown path {self.path}"})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serve errors as 500s
                log.exception("request %s failed", parsed.path)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _decode_video_bytes(self, data: bytes) -> np.ndarray:
            tmp = _video_file(data)
            try:
                return decode_clip(tmp, server_state.model.cfg.preprocess)
            finally:
                os.unlink(tmp)

        def _parse_landmarks(self, data: bytes) -> np.ndarray:
            model = server_state.model
            lm = np.load(io.BytesIO(data), allow_pickle=False)
            if lm.ndim != 3 or lm.shape[1:] != (543, 3):
                raise ValueError(f"expected [T, 543, 3] landmarks, got "
                                 f"{list(lm.shape)}")
            # The T that PredictServer.submit checks: a model that also
            # takes RGB aligns landmarks to the clip's preprocess.num_frames.
            pp = getattr(model.cfg, "preprocess", None)
            nf = (
                pp.num_frames
                if (model.takes_rgb and pp is not None)
                else getattr(model.cfg, "num_frames", 16)
            )
            if lm.shape[0] != nf:
                lm = lm[uniform_sample_indices(lm.shape[0], nf)]
            return lm.astype(np.float32)

        def _predict_video(self):
            model = server_state.model
            if not model.takes_rgb:
                self._drain_body()
                raise ValueError("model consumes landmarks; use "
                                 "/predict_landmarks")
            if model.takes_landmarks:
                self._drain_body()
                raise ValueError("fusion models need video+landmarks; use "
                                 "/predict_fusion")
            frames = self._decode_video_bytes(self._read_body())
            gloss, logits = server_state.predictor.submit(frames).result(
                timeout=server_state.timeout_s)
            self._respond_prediction(gloss, logits)

        def _predict_landmarks(self):
            model = server_state.model
            if not model.takes_landmarks:
                self._drain_body()
                raise ValueError("model consumes RGB video; use /predict")
            if model.takes_rgb:
                self._drain_body()
                raise ValueError("fusion models need video+landmarks; use "
                                 "/predict_fusion")
            lm = self._parse_landmarks(self._read_body())
            gloss, logits = server_state.predictor.submit(landmarks=lm).result(
                timeout=server_state.timeout_s)
            self._respond_prediction(gloss, logits)

        def _predict_fusion(self):
            """``two_stream``: an 8-byte big-endian length of the video
            part, the video container bytes, then ``.npy`` landmark
            bytes."""
            model = server_state.model
            if not (model.takes_rgb and model.takes_landmarks):
                self._drain_body()
                raise ValueError(
                    "model is not a fusion model; use /predict or "
                    "/predict_landmarks"
                )
            body = self._read_body()
            if len(body) < 9:
                raise ValueError("fusion body too short (need 8-byte video "
                                 "length prefix + video + .npy landmarks)")
            vlen = int.from_bytes(body[:8], "big")
            if vlen <= 0 or 8 + vlen >= len(body):
                raise ValueError(
                    f"bad video length prefix {vlen} for body of "
                    f"{len(body)} bytes"
                )
            frames = self._decode_video_bytes(body[8:8 + vlen])
            lm = self._parse_landmarks(body[8 + vlen:])
            gloss, logits = server_state.predictor.submit(frames, landmarks=lm).result(
                timeout=server_state.timeout_s)
            self._respond_prediction(gloss, logits)

        def _predict_windows(self, query):
            """Continuous recognition: the body is an untrimmed video; each
            window decodes here (only its sampled frames) and is submitted
            to the shared batcher, so the windows batch with each other and
            with concurrent traffic. Every window is submitted before the
            first result is awaited."""
            model = server_state.model
            if not model.takes_rgb or model.takes_landmarks:
                self._drain_body()
                raise ValueError(
                    "windows need an RGB-consuming (non-fusion) model; "
                    "pose models stream landmarks to "
                    "/predict_windows_landmarks"
                )
            window_s, stride_s, min_prob = self._window_params(query)
            tmp = _video_file(self._read_body())
            try:
                total, fps = probe_video(tmp)
                spans = _resolve_plan(total, fps, window_s, None, stride_s, None)
                pp = model.cfg.preprocess
                futs = [
                    server_state.predictor.submit(decode_record(
                        ClipRecord(video_id=f"win{s}", gloss="", label=-1, split="",
                                   path=tmp, frame_start=s, frame_end=e),
                        pp,
                    ))
                    for s, e in spans
                ]
                results = [f.result(timeout=server_state.timeout_s) for f in futs]
            finally:
                os.unlink(tmp)
            self._respond_windows(spans, results, fps, min_prob)

        def _predict_windows_landmarks(self, query):
            """Continuous recognition for the pose model from a landmark
            stream: body = ``.npy`` of the session's [T, 543, 3];
            ``?window_s=`` and the rest as /predict_windows, plus ``&fps=``
            (default 25). Each window's resampled slice rides the shared
            batcher."""
            model = server_state.model
            if not model.takes_landmarks or model.takes_rgb:
                self._drain_body()
                raise ValueError(
                    "landmark windows need a pose (landmark-only) model; "
                    "RGB models take video at /predict_windows"
                )
            window_s, stride_s, min_prob = self._window_params(query)
            fps_vals = query.get("fps")
            fps = float(fps_vals[0]) if fps_vals else 25.0
            if not fps > 0:
                self._drain_body()
                raise ValueError(f"fps must be positive, got {fps}")
            lm = np.load(io.BytesIO(self._read_body()), allow_pickle=False)
            if lm.ndim != 3 or lm.shape[1:] != (543, 3):
                raise ValueError(
                    f"expected [T, 543, 3] landmarks, got {list(lm.shape)}"
                )
            spans = _resolve_plan(len(lm), fps, window_s, None, stride_s, None)
            nf = model.cfg.num_frames
            futs = [
                server_state.predictor.submit(landmarks=np.asarray(
                    lm[(s - 1) + uniform_sample_indices(e - s + 1, nf)], np.float32))
                for s, e in spans
            ]
            results = [f.result(timeout=server_state.timeout_s) for f in futs]
            self._respond_windows(spans, results, fps, min_prob)

        def _window_params(self, query):
            """?window_s, &stride_s and &min_prob (400 when malformed)."""

            def fparam(name, default=None):
                vals = query.get(name)
                if not vals:
                    return default
                try:
                    return float(vals[0])
                except ValueError:
                    raise ValueError(f"bad {name}: {vals[0]!r}") from None

            window_s = fparam("window_s")
            if window_s is None or window_s <= 0:
                self._drain_body()
                raise ValueError(
                    "pass ?window_s=<positive seconds> "
                    "(optional &stride_s=, &min_prob=)"
                )
            stride_s = fparam("stride_s")
            if stride_s is not None and stride_s <= 0:
                self._drain_body()
                raise ValueError("stride_s must be positive")
            return window_s, stride_s, fparam("min_prob", 0.0)

        def _respond_windows(self, spans, results, fps, min_prob):
            wins = [
                _window_prediction(i, span, fps, logits, gloss)
                for i, (span, (gloss, logits)) in enumerate(zip(spans, results))
            ]
            self._json(200, {
                "num_windows": len(wins),
                "segments": segments_json(merge_windows(wins, min_prob=min_prob)),
                "windows": windows_json(wins),
            })

        def _respond_prediction(self, gloss, logits):
            self._json(200, {
                "gloss": gloss,
                "top5": topk_entries(logits, server_state.gloss_names),
            })

    return Handler


class ServeState:
    def __init__(self, model, predictor, gloss_names, timeout_s, max_body):
        self.model = model
        self.predictor = predictor
        self.gloss_names = gloss_names
        self.timeout_s = timeout_s
        self.max_body = max_body


def serve(
    model: Model,
    host: str = "127.0.0.1",
    port: int = 8476,
    max_batch: int = 32,
    max_delay_ms: float = 10.0,
    gloss_names: Optional[List[str]] = None,
    timeout_s: float = 300.0,
    max_body: int = 256 * 1024 * 1024,
    block: bool = True,
    batch_buckets: Optional[tuple] = None,
    warm: bool = False,
):
    """Start the HTTP server. ``block=False`` serves from a daemon thread
    and returns ``(ThreadingHTTPServer, PredictServer)``; the caller stops
    both (``httpd.shutdown()``, ``httpd.server_close()``,
    ``predictor.shutdown()``).

    ``batch_buckets`` with ``warm=True``: partial batches pad to the
    smallest bucket that holds them, and every bucket runs once on the
    device before the socket opens."""
    predictor = PredictServer(
        model, max_batch=max_batch, max_delay_ms=max_delay_ms,
        gloss_names=gloss_names, batch_buckets=batch_buckets,
    )
    if warm:
        predictor.warm()
    state = ServeState(model, predictor, gloss_names, timeout_s, max_body)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    if not block:
        threading.Thread(target=httpd.serve_forever, name="asltpu_torch-http",
                         daemon=True).start()
        return httpd, predictor
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        predictor.shutdown()
    return httpd, predictor
