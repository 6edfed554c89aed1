"""The port's benchmark: throughput of each ported family on each of its wire
lanes, from staged uint8 frames and from mp4 files to logits.

    python -m asltpu_torch.benchmark                      # on the card
    python -m asltpu_torch.benchmark --device cpu --batch 2 --frames 2 \\
        --staging 40 --crop 32 --clip-size 48 --clip-frames 8   # plumbing only

Counterpart of the JAX bench (``asltpu/benchmark.py``, ``bench.py``), which
stays the JAX package's own. Cells, one per (family, lane):
``mobilenet_gru`` at batch 32 on the rgb and the yuv420 lane,
``resnet_transformer`` at batch 16, ``i3d`` at batch 4 (64 frames) and
``two_stream`` at batch 16 (with seeded landmarks of the clip's T) on the
rgb lane, and ``pose_bilstm`` at batch 64 on landmarks, each at full width
with random weights from ``--seed``. Per video cell:

- ``device_only``: back-to-back ``predict_fn`` calls on a batch already on
  the device, with the CUDA preprocess kernel and with ``use_pallas=False``
  (the plain PyTorch preprocess), the kernel's launches per predict, the
  stage times (preprocess; backbone: the per-frame 2D network, or I3D's
  stem through ``Mixed_5c``; head: the temporal head, I3D's pooling and
  logits, or the fusion model's landmark stream, cross-attention and
  classifier) and the peak device memory;
- ``stream``: seeded distinct uint8 batches made in host memory before the
  clock starts, through ``Prefetcher`` (pinned copy on a side stream) →
  predict → logits back on the host, cut into contiguous windows; the
  median window's clips/s, the fill time (to the first batch on the
  device) apart;
- ``decode``: decode-only clips/s by backend, each over a corpus of fresh
  synthetic mp4s (a file decoded before runs faster again): the process
  pool at each ``--decode-workers`` count (each worker decodes a clip with
  the native OpenCV library where it is built, else with cv2, as the JAX
  package's pool does), the native OpenCV and libav
  libraries at the largest count of threads, and libav with
  ``decode_fast`` (``FAST_ALL``); each on a pool started before the clock
  (a cell starts one pool per backend, worker count and fast flags, its
  workers warmed on clips of their own), where the JAX bench times from
  the pool's start;
- ``mp4_stream``: ``stream_predict`` over a fresh corpus, mp4 → logits,
  on such a started pool: ``auto`` (the backend it chose is named),
  ``process`` and, where libav builds, ``av`` (with ``FAST_ALL`` under
  ``--decode-fast`` or where the cell's ``decode_fast_gate`` promoted it;
  ``two_stream``: ``landmarks_for`` gives seeded landmarks per path); its
  top-1 must equal ``predict``'s on the same staged clips;
- ``gflops_per_clip`` (``FlopCounterMode`` over the model's forward in one
  predict, divided by the batch; the preprocess kernel is not a PyTorch op
  and adds none) and, on the card, ``mfu`` against the H100 SXM bf16 dense
  peak.

Every timed mp4 stream runs under the JAX bench's discipline
(``asltpu/benchmark.py:298-492``): contiguous windows, the median window,
and :func:`poisoned_sample`, whose reference rates are the same corpus
size's decode rows (each capped at the cell's device-only clips/s; none
on the CPU, where decode and the model share the host's cores); a
poisoned stream is retried once on a fresh corpus of the same size (after
a bounded host-recovery probe for ``uniform_starvation``), both attempts
reported (``first_attempt_windows``, ``retry_trigger``), the retry's
result standing. ``--trace DIR`` captures each timed stream, each
attempt, with ``torch.profiler`` (main process; corpus writing, the
pool's start-up and the comparison with ``predict`` stay outside) into
``DIR/<family>_<lane>/<row>/attempt<k>``, and the row's ``trace`` gives
the lane kernel's CUDA events in the stream's range and the device's busy
share over it.

The two ``mobilenet_gru`` cells also carry ``realistic``, the JAX bench's
640×480 corpus (``asltpu/benchmark.py:749-866``; off with
``--no-realistic-corpus``, the size from ``--realistic-size``): decode-only
clips/s by backend on fresh files at that size (``decode_only``), the
process pool by worker count with the fit ``min(workers * r1,
device_rate)`` against the cell's device-only clips/s (``scaling``),
``stream_predict`` over ``1 + --windows`` batches of such files on
``auto`` (``mp4_stream``) and on libav with ``FAST_ALL``
(``mp4_stream_fast``, its logits held to the exact decode's), and
``decode_fast_gate``: exact and ``FAST_ALL`` decode of fresh
``--clip-size`` files through the model, promoted when every top-1
matches, or when one flips and the largest logit gap stays under 10% of
the exact logits' spread. Every corpus of a cell except a retry's is
written before the cell's first decode measurement.

The ``i3d:train`` cell measures I3D fine-tuning (``asltpu_torch.train``):
full production train steps (the rgb kernel's preprocess, forward,
label-smoothed cross-entropy, backward, clip, AdamW) on a staged batch
already on the device, input and labels varied from step to step, in two
configurations, each its own result: the JAX bench's (batch 16, remat
off) and the production default (``TrainConfig``'s batch 8, remat on).
Each reports the step's time, steps/s and train clips/s, the peak device
memory, the kernel's launches per step, ``gflops_per_clip`` of forward +
backward (``FlopCounterMode`` over one step with remat off) with the remat
recompute counted apart (``recompute_gflops_per_clip``), and on the card
``mfu`` (forward + backward, without the recompute) against the bf16 peak.

The ``mobilenet_gru/rgb`` cell also measures serving (``serve``; off with
``--no-serve``): a closed loop of client threads, each submitting one
staged clip to a :class:`~asltpu_torch.serve.PredictServer` (batch buckets
1, 4, 8 and the cell's batch, every bucket run once before the clock
starts) and waiting for its result before the next, at three points:
concurrency 1 (``max_delay_ms`` 2, 8 rounds), 4 (5 ms, 8 rounds) and the
cell's batch (10 ms, 4 rounds). Each point reports clips/s over its wall
time, the p50 and p99 of submit → result latency on the host clock, the
server's average batch and the requests timed, under the keys
``serve_c1_*``, ``serve_c4_*`` and ``serve_*``.

The ``pose_bilstm`` cell has ``device_only`` (no preprocess kernel: its
``kernel`` is null with 0 launches, and ``gflops_per_clip`` counts the
LSTM's and the classifier's multiply-adds from the shapes) and ``stream``
(seeded landmark batches through ``Prefetcher``); it decodes no video.

``decode``, ``mp4_stream`` and ``realistic`` need OpenCV; without it each
is ``{"ran": false, "why": ...}`` and the rest runs. A native library whose
toolchain is missing (``g++``, the OpenCV or libav headers) is
``{"ran": false, "why": <what is missing>}``; one whose toolchain is
present but whose build or decode fails fails the run. Device times come from
CUDA events on the card; with ``--device cpu`` every time is the host
clock's and says so. Without a card and without ``--device cpu`` the run
fails; a failing cell raises. The last line of standard output is one JSON
object with every cell.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from asltpu_torch import api, native
from asltpu_torch.data.decode import make_decode_pool
from asltpu_torch.data.pad import pad_to_batch
from asltpu_torch.data.prefetch import Prefetcher
from asltpu_torch.data.synthetic import synthetic_landmarks, write_video
from asltpu_torch.models.fusion import TwoStreamFusion
from asltpu_torch.models.i3d import I3D
from asltpu_torch.models.temporal import GRUHead
from asltpu_torch.models.video import MobileNetV2GRU
from asltpu_torch.ops import preprocess_kernels
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.serve import PredictServer
from asltpu_torch.utils import profiling

# (family, lane, clips per batch): the JAX bench's batches per family
# (asltpu/benchmark.py:1298-1304).
CELLS: Tuple[Tuple[str, str, int], ...] = (
    ("mobilenet_gru", "rgb", 32),
    ("mobilenet_gru", "yuv420", 32),
    ("resnet_transformer", "rgb", 16),
    ("pose_bilstm", "landmarks", 64),
    ("i3d", "rgb", 4),
    ("two_stream", "rgb", 16),
    ("i3d", "train", 0),  # batches per configuration: TRAIN_CONFIGS
)
# The train cell's configurations: (name, clips per batch, remat). The JAX
# bench's measured one (asltpu/benchmark.py:1087-1093) and TrainConfig's.
TRAIN_CONFIGS = (("jax_bench", 16, False), ("default", 8, True))
# The yuv420 lane is the JAX bench's transfer-thin configuration: the host
# resizes to 256 and crops 224², and sends packed I420.
LANES = {
    "rgb": {},
    "yuv420": {"staging_size": (224, 224), "resize_short": 224,
               "host_resize_short": 256, "staging_format": "yuv420"},
}
KERNELS = {"rgb": "preprocess_rgb", "yuv420": "preprocess_yuv420"}
# The cell that measures serving, and its points (the JAX bench's,
# asltpu/benchmark.py:866-960): (clients (0: the cell's batch),
# max_delay_ms, rounds per client, key prefix).
SERVE_CELL = ("mobilenet_gru", "rgb")
SERVE_BUCKETS = (1, 4, 8)
SERVE_POINTS = ((1, 2.0, 8, "serve_c1_"), (4, 5.0, 8, "serve_c4_"), (0, 10.0, 4, "serve_"))
# H100 SXM data sheet: bf16 dense tensor-core peak, and fp32 outside the
# tensor cores (the pose model runs fp32 with TF32 off).
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_FP32_FLOP_PER_S = 67e12
# Native libraries measured beside the process pool:
# (row, make_decode_pool backend, native library, fast flags).
NATIVE_DECODE = (("native", "native", "opencv", 0), ("av", "av", "av", 0),
                 ("av_fast", "av", "av", native.FAST_ALL))
# The cells that carry the 640×480 block: the JAX bench's headline model on
# its headline lane (yuv420) and on load_model's default lane (rgb).
REALISTIC_CELLS = (("mobilenet_gru", "rgb"), ("mobilenet_gru", "yuv420"))
# Timed clips per backend (asltpu/benchmark.py:756-758), per worker count of
# the scaling sweep (:1465-1470) and of the decode-fast gate (:628-630).
REALISTIC_DECODE_CLIPS, SCALING_CLIPS, GATE_CLIPS = 32, 16, 16
# poisoned_sample's factors (asltpu/benchmark.py:317-324) and the bounded
# host-recovery probe before a uniform_starvation retry (:473-487).
BIMODAL_FACTOR, STARVATION_FACTOR = 0.5, 0.3
RECOVERY_PROBE_S, RECOVERY_PROBE_CLIPS, RECOVERY_SLEEP_S, RECOVERY_FACTOR = 150.0, 8, 20.0, 0.5
# The gate's criteria (asltpu/benchmark.py:249-254, :286-287).
GATE_REL_LOGIT_DELTA = 0.10
# The device's activity in a torch.profiler trace (Chrome trace categories),
# and the named range of a timed stream in it.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STREAM_SCOPE = "asltpu_torch.timed_stream"


def card_identity() -> Dict[str, object]:
    """The card as ``nvidia-smi`` and PyTorch name it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.split(",", 1))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "name": name, "power_limit": limit}


@dataclasses.dataclass(frozen=True)
class Clock:
    """How a device time is taken: CUDA events around back-to-back calls on
    the card, the host clock on the CPU; the median of ``samples`` runs of
    ``reps`` calls after ``warmup`` calls, per call."""

    device: torch.device
    reps: int
    samples: int
    warmup: int

    @classmethod
    def for_device(cls, device: torch.device) -> "Clock":
        if device.type == "cuda":
            return cls(device, reps=5, samples=7, warmup=3)
        return cls(device, reps=1, samples=3, warmup=1)

    @property
    def source(self) -> str:
        return "cuda events" if self.device.type == "cuda" else "host clock (cpu)"

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ms(self, fn: Callable[[], object], reps: Optional[int] = None) -> float:
        reps = reps or self.reps
        for _ in range(self.warmup):
            fn()
        self.sync()
        times = []
        for _ in range(self.samples):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / reps)
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                times.append((time.perf_counter() - t0) * 1e3 / reps)
        return statistics.median(times)


def _preprocess(lane: str, opts: argparse.Namespace) -> Dict[str, object]:
    """The lane's preprocess overrides, with the shape options applied."""
    pp: Dict[str, object] = dict(LANES[lane])
    if opts.frames:
        pp["num_frames"] = opts.frames
    if opts.crop:
        pp["crop"] = opts.crop
        if lane == "yuv420":
            pp.update(staging_size=(opts.crop, opts.crop), resize_short=opts.crop)
    if opts.staging:
        if lane == "yuv420":
            pp["host_resize_short"] = opts.staging
        else:
            pp.update(staging_size=(opts.staging, opts.staging),
                      resize_short=opts.staging)
    return pp


def backbone_and_head(module) -> Tuple[Callable, Callable]:
    """A built video model's backbone (preprocessed clip [B, T, H, W, 3] →
    features: per frame [B, T, F], or I3D's [B, 1024, T', H', W']) and its
    head ((features, *the model's other inputs) → logits)."""
    if isinstance(module, MobileNetV2GRU):
        return module.backbone, functools.partial(GRUHead.forward, module)
    if isinstance(module, I3D):
        return module.backbone, module.classify
    if isinstance(module, TwoStreamFusion):
        return module.backbone, module.fuse
    return module.backbone, module.head


def stage_fns(model: api.Model, *xs: torch.Tensor) -> Dict[str, Callable[[], object]]:
    """One predict on the device inputs ``xs`` (staged frames, and the
    landmarks of ``two_stream``) split into its three stages, each on the
    previous stage's output: preprocess, backbone, head."""
    pp = model.cfg.preprocess
    backbone, head = backbone_and_head(model.module)
    x, rest = xs[0], xs[1:]
    with torch.inference_mode():
        clip = preprocess_clip(x, pp)
        feats = backbone(clip)
    return {"preprocess": lambda: preprocess_clip(x, pp),
            "backbone": lambda: backbone(clip), "head": lambda: head(feats, *rest)}


def _gflops_per_clip(model: api.Model, *xs: torch.Tensor) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode():
        clip = preprocess_clip(xs[0], model.cfg.preprocess)
        counter = FlopCounterMode(display=False)
        with counter:
            model.module(clip, *xs[1:])
    return counter.get_total_flops() / xs[0].shape[0] / 1e9


def _windows(t_start: float, t_first: float, events: Sequence[Tuple[float, int]],
             n_windows: int, fill_clips: int = 0) -> Dict[str, object]:
    """Rates of a stream that started at ``t_start``: ``events`` are (time
    done, clips) per batch in order after the fill, which ended at
    ``t_first`` with ``fill_clips`` clips done. The batches are cut into
    ``n_windows`` contiguous windows, the first starting at ``t_first``;
    the median window's rate is the stream's."""
    nb = len(events)
    nw = min(n_windows, nb)
    bounds = [round(k * nb / nw) for k in range(nw + 1)]
    rates = []
    for k in range(nw):
        evs = events[bounds[k]:bounds[k + 1]]
        t0 = t_first if k == 0 else events[bounds[k] - 1][0]
        rates.append(sum(n for _, n in evs) / (evs[-1][0] - t0))
    clips = sum(n for _, n in events) + fill_clips
    return {"clips_per_s": statistics.median(rates), "window_clips_per_s": rates,
            "fill_s": t_first - t_start, "fill_clips": fill_clips,
            "overall_clips_per_s": clips / (events[-1][0] - t_start),
            "windowed_batches": nb, "clips": clips}


def host_stream(model: api.Model, batches: Sequence[Tuple[np.ndarray, ...]],
                n_windows: int) -> Dict[str, object]:
    """Host-staged stream: ``batches`` (tuples of the model's inputs) →
    ``Prefetcher`` → predict → logits on the host. Every batch's top-1 must
    equal ``predict``'s on it."""
    fn = model.predict_fn()
    events: List[Tuple[float, int]] = []
    logits: List[np.ndarray] = []
    t_start = time.perf_counter()
    t_first = None
    with Prefetcher(batches, depth=2, device=model.device) as pf:
        for xs in pf:
            if t_first is None:
                t_first = time.perf_counter()
            logits.append(fn(*xs).cpu().numpy())
            events.append((time.perf_counter(), xs[0].shape[0]))
    out = _windows(t_start, t_first, events, n_windows)
    agree = sum(int((api.predict(model, *b)[0] == lg.argmax(-1)).all())
                for b, lg in zip(batches, logits))
    if agree != len(batches):
        raise AssertionError(f"host stream: {len(batches) - agree} batches' top-1 "
                             "differ from predict on the same frames")
    out["top1_equal_predict"] = True
    return out


def serve_buckets(batch: int) -> Tuple[int, ...]:
    """``SERVE_BUCKETS`` below ``batch`` (the server adds ``batch``)."""
    return tuple(b for b in SERVE_BUCKETS if b < batch)


def serve_point(model: api.Model, clip: np.ndarray, batch: int, clients: int,
                max_delay_ms: float, rounds: int, prefix: str) -> Dict[str, object]:
    """One closed-loop load point: ``clients`` threads each submit
    ``clip`` ``rounds`` times to a fresh ``PredictServer`` (``max_batch``
    ``batch``, ``serve_buckets(batch)``), waiting for each result before the next
    submit. One request goes through first, outside the clock."""
    server = PredictServer(model, max_batch=batch, max_delay_ms=max_delay_ms,
                           batch_buckets=serve_buckets(batch))
    latencies: List[float] = []
    errors: List[BaseException] = []
    lock = threading.Lock()

    def client():
        try:
            for _ in range(rounds):
                t0 = time.perf_counter()
                server.submit(clip).result(timeout=600)
                with lock:
                    latencies.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — raised below, after the join
            with lock:
                errors.append(e)

    try:
        server.submit(clip).result(timeout=600)
        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
    if errors:
        raise RuntimeError(f"serve {prefix}: {len(errors)} clients failed") from errors[0]
    ms = sorted(1e3 * x for x in latencies)
    return {
        prefix + "clips_per_sec": len(ms) / wall,
        prefix + "p50_ms": ms[len(ms) // 2],
        prefix + "p99_ms": ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))],
        prefix + "avg_batch": server.stats.avg_batch_size,
        prefix + "requests": len(ms),
        prefix + "concurrency": clients,
        prefix + "max_delay_ms": max_delay_ms,
    }


def serve_curve(model: api.Model, clip: np.ndarray, batch: int) -> Dict[str, object]:
    """Every point of ``SERVE_POINTS`` for one staged clip, after each
    bucket ran once on the device (``PredictServer.warm``)."""
    warm = PredictServer(model, max_batch=batch, batch_buckets=serve_buckets(batch))
    try:
        warm.warm()
    finally:
        warm.shutdown()
    out: Dict[str, object] = {"max_batch": batch, "batch_buckets": list(warm.batch_buckets),
                              "timer": "host clock"}
    for clients, delay, rounds, prefix in SERVE_POINTS:
        out.update(serve_point(model, clip, batch, clients or batch, delay, rounds, prefix))
    return out


def _cv2_missing() -> Optional[str]:
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        return f"OpenCV (cv2) is not installed here: {e}"
    return None


def make_corpus(writers: concurrent.futures.Executor, root: str, prefix: str,
                n: int, seed0: int, size: Tuple[int, int], frames: int) -> List[str]:
    """``n`` distinct synthetic mp4s of ``size`` = (H, W) and ``frames``
    frames, seeds ``seed0`` on, written by the ``writers`` pool."""
    paths = [os.path.join(root, f"{prefix}{i:04d}.mp4") for i in range(n)]
    futures = [writers.submit(write_video, p, num_frames=frames, size=size,
                              seed=seed0 + i) for i, p in enumerate(paths)]
    for f in futures:
        f.result()
    return paths


@dataclasses.dataclass
class Corpus:
    """Fresh synthetic mp4s for one run: each call writes ``n`` files of
    ``size`` under a prefix of its own, every file with a seed of its own."""

    writers: concurrent.futures.Executor
    root: str
    frames: int
    seed: int = 0

    def __call__(self, prefix: str, n: int, size: Tuple[int, int]) -> List[str]:
        paths = make_corpus(self.writers, self.root, prefix, n, self.seed, size, self.frames)
        self.seed += n
        return paths


class CellPools:
    """The started decode pools of one cell, one per (backend it resolves
    to, workers, fast flags): each starts its workers (or loads its native
    library) on ``warm[:workers]`` when first asked for, outside every
    clock; :meth:`close` shuts them all down."""

    def __init__(self, cfg, warm: Sequence[str]):
        self.cfg, self.warm = cfg, warm
        self._pools: Dict[Tuple[str, int, int], object] = {}

    def get(self, backend: str, workers: int, fast_flags: int = 0):
        pool = make_decode_pool(self.cfg, num_workers=workers, backend=backend,
                                fast_flags=fast_flags)
        key = (pool.backend, workers, fast_flags)
        if key in self._pools:
            pool.shutdown()  # "auto" resolved to a pool already started
            return self._pools[key]
        self._pools[key] = pool
        for _ in pool.map_batches(self.warm[:workers], workers):
            pass
        return pool

    def close(self) -> None:
        for pool in self._pools.values():
            pool.shutdown()


def decode_rate(pool, paths: Sequence[str], batch: int) -> float:
    """Decode-only clips/s of a started pool over ``paths``."""
    t0 = time.perf_counter()
    n = sum(len(kept) for _, kept in pool.map_batches(paths, batch))
    return n / (time.perf_counter() - t0)


def corpus_landmarks(num_frames: int) -> Callable[[str], np.ndarray]:
    """``landmarks_for`` of a synthetic corpus: path → seeded landmarks
    [num_frames, 543, 3], the same for the same path."""
    def landmarks_for(path: str) -> np.ndarray:
        return synthetic_landmarks(1, num_frames, seed=zlib.crc32(path.encode()))[0]

    return landmarks_for


def poisoned_sample(win_rates: Sequence[float], e2e_cps: float,
                    sel: Dict[str, Optional[float]]) -> Optional[str]:
    """Why a timed stream is no evidence about the pipeline, or None if it
    stands (``asltpu/benchmark.py:298-325``):

    - ``"bimodal_windows"``: the median window is under half the best one,
      so something hit part of the stream;
    - ``"uniform_starvation"``: the windows agree, but the stream ran under
      0.3× the best reference decode rate of ``sel`` (None where a backend
      did not run), so something hit the whole of it.

    Empty windows stand."""
    if not win_rates:
        return None
    if e2e_cps < BIMODAL_FACTOR * max(win_rates):
        return "bimodal_windows"
    sel_best = max((r for r in sel.values() if isinstance(r, (int, float))), default=None)
    if sel_best and e2e_cps < STARVATION_FACTOR * sel_best:
        return "uniform_starvation"
    return None


def reference_rates(decode: Dict[str, object], device: torch.device,
                    cap: float) -> Dict[str, Optional[float]]:
    """``poisoned_sample``'s ``sel`` from a decode block's rows: each rate
    capped at ``cap``, the cell's device-only clips/s (a stream cannot
    outrun the device, so a decode rate above it says nothing of a slower
    stream's host); None where a row did not run. Empty on the CPU, where
    decode and the model share the host's cores and no decode rate bounds
    what a healthy stream reaches: there only ``bimodal_windows`` applies."""
    out: Dict[str, Optional[float]] = {}
    if device.type != "cuda":
        return out
    for row, r in decode.items():
        if not (isinstance(r, dict) and "ran" in r):
            continue
        if "clips_per_s_by_workers" in r:
            out.update({f"{row}_{w}": min(v, cap)
                        for w, v in r["clips_per_s_by_workers"].items()})
        else:
            out[row] = min(r["clips_per_s"], cap) if r["ran"] else None
    return out


def trace_summary(trace_dir: str, kernel: str) -> Dict[str, object]:
    """What the ``torch.profiler`` capture in ``trace_dir`` holds within its
    ``STREAM_SCOPE`` range: the CUDA events of the port's kernel ``kernel``
    (its ``<kernel>_kernel`` function), the device's activity (kernels,
    copies, sets) and its busy share over the range (None where the range
    holds no device activity: a run on the CPU)."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (scope,) = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == STREAM_SCOPE]
    lo, hi = scope["ts"], scope["ts"] + scope["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_EVENT_CATS and lo <= e["ts"] <= hi]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in device):
        busy += max(0.0, b - max(a, end))  # the union of the device's intervals
        end = max(end, b)
    return {"file": path, "device_events": len(device),
            "kernel_events": sum(1 for e in device if e.get("cat") == "kernel"
                                 and f"{kernel}_kernel" in e.get("name", "")),
            "span_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo) if device else None}


def _lane_kernel(model: api.Model) -> str:
    return KERNELS["yuv420" if model.cfg.preprocess.staging_format == "yuv420" else "rgb"]


def timed_stream(model: api.Model, paths: Sequence[str], batch: int, pool,
                 n_windows: int, trace_dir: Optional[str]) -> Tuple[Dict[str, object], np.ndarray]:
    """``stream_predict`` over ``paths`` on the started ``pool`` (and, for
    ``two_stream``, :func:`corpus_landmarks`), captured into ``trace_dir``
    where given: the first batch (decode of a batch, the first predict) is
    the fill, the later batches the windows, the median window the
    stream's rate. Returns the rates, the lane kernel's launches and the
    stream's logits."""
    landmarks_for = (corpus_landmarks(model.cfg.preprocess.num_frames)
                     if model.takes_landmarks else None)
    name = _lane_kernel(model)
    kernel = getattr(preprocess_kernels, name)
    stamps, logits = [], []
    capture = profiling.trace(trace_dir) if trace_dir else contextlib.nullcontext()
    kernel.launches = 0
    with capture, profiling.named_scope(STREAM_SCOPE):
        t_start = time.perf_counter()
        for _, _, lg in api.stream_predict(model, paths, batch_size=batch, decode_pool=pool,
                                           landmarks_for=landmarks_for):
            stamps.append(time.perf_counter())
            logits.append(lg)
    launches = kernel.launches
    ends = [stamps[min(i + batch, len(stamps)) - 1] for i in range(0, len(stamps), batch)]
    sizes = [min(batch, len(stamps) - i) for i in range(0, len(stamps), batch)]
    if len(ends) < 2:
        raise ValueError("mp4 stream: the corpus must hold at least two batches")
    out = _windows(t_start, ends[0], list(zip(ends[1:], sizes[1:])), n_windows,
                   fill_clips=sizes[0])
    out.update(predict_calls=len(ends), kernel=name, kernel_launches=launches)
    if trace_dir:
        out["trace"] = trace_summary(trace_dir, name)
    return out, np.stack(logits)


def host_recovery_probe(pool, corpus: Corpus, prefix: str, size: Tuple[int, int],
                        reference: float) -> float:
    """Decode-only clips/s of ``pool`` on fresh probes of
    ``RECOVERY_PROBE_CLIPS`` files, again every ``RECOVERY_SLEEP_S`` until
    it reaches ``RECOVERY_FACTOR`` × ``reference`` or ``RECOVERY_PROBE_S``
    have passed (``asltpu/benchmark.py:473-487``): the last probe's rate."""
    t0, k, rate = time.perf_counter(), 0, 0.0
    while time.perf_counter() - t0 < RECOVERY_PROBE_S:
        probe = corpus(f"{prefix}probe{k}_", RECOVERY_PROBE_CLIPS, size)
        k += 1
        tp = time.perf_counter()
        n = sum(len(kept) for _, kept in pool.map_batches(probe, RECOVERY_PROBE_CLIPS))
        rate = n / (time.perf_counter() - tp)
        if rate >= RECOVERY_FACTOR * reference:
            break
        time.sleep(RECOVERY_SLEEP_S)
    return rate


def mp4_row(model: api.Model, pool, paths: Sequence[str], batch: int, n_windows: int,
            sel: Dict[str, Optional[float]], corpus: Corpus, prefix: str,
            size: Tuple[int, int], trace_dir: Optional[str] = None, reference_pool=None,
            require_top1: bool = True) -> Dict[str, object]:
    """One timed mp4 → logits row: :func:`timed_stream` over ``paths`` on
    the started ``pool``. A stream that :func:`poisoned_sample` rejects
    against ``sel`` runs once more on a fresh corpus of the same size, and
    its result stands; the first attempt's windows and the trigger are
    reported beside it. Then the standing attempt's clips are decoded again
    by ``reference_pool`` (default ``pool``) and batched as the stream
    batched them: its logits against ``predict``'s on them, whose top-1 it
    must equal when ``require_top1``."""
    def attempt(k):
        return os.path.join(trace_dir, f"attempt{k}") if trace_dir else None

    out, got = timed_stream(model, paths, batch, pool, n_windows, attempt(1))
    trigger = poisoned_sample(out["window_clips_per_s"], out["clips_per_s"], sel)
    if trigger:
        first = out
        paths = corpus(f"{prefix}retry_", len(paths), size)
        probe = {}
        if trigger == "uniform_starvation":
            best = max(r for r in sel.values() if r is not None)
            probe["retry_host_probe_clips_per_s"] = host_recovery_probe(
                pool, corpus, prefix, size, best)
        out, got = timed_stream(model, paths, batch, pool, n_windows, attempt(2))
        out.update(retry_trigger=trigger, first_attempt_windows=first["window_clips_per_s"],
                   first_attempt_clips_per_s=first["clips_per_s"], **probe)
    out.update(backend=pool.backend, fast_flags=getattr(pool, "fast_flags", 0))
    landmarks_for = (corpus_landmarks(model.cfg.preprocess.num_frames)
                     if model.takes_landmarks else None)

    def inputs(frames, kept):
        if landmarks_for is None:
            return (frames,)
        return frames, pad_to_batch(np.stack([landmarks_for(paths[k]) for k in kept]), batch)

    want = np.concatenate([api.predict(model, *inputs(frames, kept))[1][:len(kept)]
                           for frames, kept in (reference_pool or pool).map_batches(paths, batch)])
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    if require_top1 and not top1:
        raise AssertionError("mp4 stream: top-1 differs from predict on the same "
                             "staged clips")
    out.update(top1_equal_predict=top1, max_logit_err_vs_predict=float(np.abs(got - want).max()))
    return out


def decode_fast_gate(model: api.Model, pools: CellPools, paths: Sequence[str], batch: int,
                     workers: int) -> Dict[str, object]:
    """Whether libav's ``FAST_ALL`` may decode the cell's av streams
    (``asltpu/benchmark.py:243-296``): ``paths`` decoded exactly and with
    ``FAST_ALL``, each through ``predict``; promoted when every top-1
    matches, or when at most one clip flips and the largest logit gap stays
    under ``GATE_REL_LOGIT_DELTA`` of the exact logits' spread."""
    def logits(flags):
        pool = pools.get("av", workers, flags)
        return np.concatenate([api.predict(model, frames)[1][:len(kept)]
                               for frames, kept in pool.map_batches(paths, batch)])

    ex, fa = logits(0), logits(native.FAST_ALL)
    n = len(ex)
    match = float(np.mean(ex.argmax(-1) == fa.argmax(-1)))
    spread = float(ex.max() - ex.min()) or 1.0
    rel_delta = float(np.abs(ex - fa).max()) / spread
    promoted = match == 1.0 or (match >= (n - 1) / n and rel_delta < GATE_REL_LOGIT_DELTA)
    verdict = ("promoted" if promoted else
               f"rejected: top1_match={match:.3f} rel_logit_delta={rel_delta:.3f}")
    return {"ran": True, "verdict": verdict, "promoted": promoted, "top1_match": match,
            "rel_logit_delta": rel_delta, "clips": n, "fast_flags": native.FAST_ALL}


def scaling_fit(rates: Dict[str, float], device_rate: float) -> Dict[str, object]:
    """The decode-worker scaling model ``min(workers * r1, device_rate)``
    (``asltpu/benchmark.py:1452-1480``): ``r1`` is the per-worker rate at
    the fewest workers measured (one worker's rate where 1 was measured),
    ``device_rate`` the cell's device-only clips/s, and the projection the
    workers that would reach it."""
    w0 = min(rates, key=int)
    r1 = rates[w0] / int(w0)
    return {"fit": "min(workers * r1, device_rate)", "r1_clips_per_s_per_worker": r1,
            "r1_from_workers": int(w0), "device_rate_clips_per_s": device_rate,
            "fit_clips_per_s_by_workers": {w: min(int(w) * r1, device_rate) for w in rates},
            "projected_workers_for_device_rate": math.ceil(device_rate / r1)}


def _native_rows() -> List[Tuple[str, str, str, int, Optional[str]]]:
    """``NATIVE_DECODE`` with each row's missing toolchain (None where present)."""
    return [(row, backend, lib, flags, native.toolchain_missing(lib))
            for row, backend, lib, flags in NATIVE_DECODE]


def decode_rows(pools: CellPools, files: Dict[str, List[str]], prefix: str, batch: int,
                workers: Sequence[int]) -> Dict[str, object]:
    """Decode-only clips/s by backend, each over its own fresh corpus
    ``files[prefix + row]``: the process pool at each count of ``workers``
    (``process``), then the native libraries at the largest count of
    threads (``{"ran": false, "why": ...}`` where a library's toolchain is
    missing; a build or decode that fails raises)."""
    rates = {str(w): decode_rate(pools.get("process", w), files[f"{prefix}w{w}"], batch)
             for w in workers}
    out: Dict[str, object] = {"process": {"ran": True, "clips_per_s_by_workers": rates}}
    threads = max(workers)
    for row, backend, _, flags, missing in _native_rows():
        if missing:
            out[row] = {"ran": False, "why": missing}
            continue
        out[row] = {"ran": True, "threads": threads, "fast_flags": flags,
                    "clips_per_s": decode_rate(pools.get(backend, threads, flags),
                                               files[prefix + row], batch)}
    return out


def _plan_corpora(family: str, lane: str, batch: int, opts: argparse.Namespace,
                  realistic: bool) -> Dict[str, Tuple[int, Tuple[int, int]]]:
    """Every corpus a video cell's mp4 parts read, retries excepted: name →
    (files, (H, W)). ``warm`` starts the pools."""
    workers = max(opts.decode_workers)
    square, big = (opts.clip_size, opts.clip_size), opts.realistic_size
    natives = [row for row, *_, missing in _native_rows() if not missing]
    plan = {"warm": (workers, square)}
    plan.update({f"decode_w{w}": (opts.corpus_clips, square) for w in opts.decode_workers})
    plan.update({f"decode_{row}": (opts.corpus_clips, square) for row in natives})
    av = native.toolchain_missing("av") is None
    for row in ("auto", "process") + (("av",) if av else ()):
        plan[f"mp4_{row}"] = (opts.mp4_batches * batch, square)
    if realistic:
        plan[f"r_decode_w{workers}"] = (REALISTIC_DECODE_CLIPS, big)
        plan.update({f"r_decode_{row}": (REALISTIC_DECODE_CLIPS, big) for row in natives})
        plan.update({f"r_scaling_w{w}": (SCALING_CLIPS, big) for w in opts.decode_workers})
        plan["r_mp4"] = ((1 + opts.windows) * batch, big)
        if av:
            plan["r_mp4_fast"] = plan["r_mp4"]
            if not opts.decode_fast:
                plan["gate"] = (GATE_CLIPS, square)
    return plan


def bench_mp4(model: api.Model, family: str, lane: str, batch: int,
              opts: argparse.Namespace, corpus: Corpus,
              device_rate: float) -> Dict[str, object]:
    """The cell's ``decode`` and ``mp4_stream`` and, on ``REALISTIC_CELLS``
    unless ``--no-realistic-corpus``, its ``realistic`` block. Every corpus
    but a retry's is written first (``corpus_s``), the writers idle before
    the first measurement; each pool starts once (:class:`CellPools`)."""
    realistic = opts.realistic and (family, lane) in REALISTIC_CELLS
    workers = max(opts.decode_workers)
    prefix = f"{family}_{lane}_"
    t0 = time.perf_counter()
    files = {name: corpus(f"{prefix}{name}_", n, size)
             for name, (n, size) in _plan_corpora(family, lane, batch, opts, realistic).items()}
    cell: Dict[str, object] = {"corpus_s": time.perf_counter() - t0}
    trace = os.path.join(opts.trace, f"{family}_{lane}") if opts.trace else None

    def row_trace(row):
        return os.path.join(trace, row) if trace else None

    with contextlib.closing(CellPools(model.cfg.preprocess, files["warm"])) as pools:
        cell["decode"] = {"ran": True, "clips": opts.corpus_clips,
                          "clip": {"size": [opts.clip_size] * 2, "frames": opts.clip_frames},
                          **decode_rows(pools, files, "decode_", batch, opts.decode_workers)}
        av_missing = native.toolchain_missing("av")
        if not realistic:
            gate: Dict[str, object] = {}
        elif av_missing:
            gate = {"ran": False, "why": av_missing}
        elif opts.decode_fast:
            gate = {"ran": False, "why": "--decode-fast: the av streams decode with FAST_ALL"}
        else:
            gate = decode_fast_gate(model, pools, files["gate"], batch, workers)
        fast = opts.decode_fast or bool(gate.get("promoted"))

        sel = reference_rates(cell["decode"], model.device, device_rate)
        mp4: Dict[str, object] = {"ran": True, "workers": workers}
        for row in ("auto", "process", "av"):
            if row == "av" and av_missing:
                mp4[row] = {"ran": False, "why": av_missing}
                continue
            pool = pools.get(row, workers, native.FAST_ALL if row == "av" and fast else 0)
            mp4[row] = mp4_row(model, pool, files[f"mp4_{row}"], batch, opts.windows, sel,
                               corpus, f"{prefix}mp4_{row}_", (opts.clip_size,) * 2,
                               row_trace(f"mp4_{row}"))
        cell["mp4_stream"] = mp4
        if realistic:
            t0 = time.perf_counter()
            cell["realistic"] = realistic_block(model, pools, batch, opts, corpus, files,
                                                prefix, device_rate, gate, row_trace)
            cell["realistic"]["seconds"] = time.perf_counter() - t0
    return cell


def realistic_block(model: api.Model, pools: CellPools, batch: int,
                    opts: argparse.Namespace, corpus: Corpus, files: Dict[str, List[str]],
                    prefix: str, device_rate: float, gate: Dict[str, object],
                    row_trace: Callable[[str], Optional[str]]) -> Dict[str, object]:
    """The 640×480 measurements of one cell on its written corpora
    (``files["r_*"]``)."""
    big = opts.realistic_size
    workers = max(opts.decode_workers)
    decode_only = {"clips": REALISTIC_DECODE_CLIPS,
                   **decode_rows(pools, files, "r_decode_", batch, [workers])}
    rates = {str(w): decode_rate(pools.get("process", w), files[f"r_scaling_w{w}"], batch)
             for w in opts.decode_workers}
    out: Dict[str, object] = {
        "ran": True, "clip": {"size": list(big), "frames": opts.clip_frames},
        "workers": workers, "decode_only": decode_only,
        "scaling": {"backend": "process", "clips": SCALING_CLIPS,
                    "clips_per_s_by_workers": rates, **scaling_fit(rates, device_rate)},
        "decode_fast_gate": gate,
    }
    sel = reference_rates(decode_only, model.device, device_rate)
    out["mp4_stream"] = mp4_row(model, pools.get("auto", workers), files["r_mp4"], batch,
                                opts.windows, sel, corpus, f"{prefix}r_mp4_", big,
                                row_trace("realistic_mp4"))
    missing = native.toolchain_missing("av")
    if missing:
        out["mp4_stream_fast"] = {"ran": False, "why": missing}
        return out
    out["mp4_stream_fast"] = mp4_row(
        model, pools.get("av", workers, native.FAST_ALL), files["r_mp4_fast"], batch,
        opts.windows, sel, corpus, f"{prefix}r_mp4_fast_", big,
        row_trace("realistic_mp4_fast"), reference_pool=pools.get("av", workers),
        require_top1=False)
    return out


def bench_cell(family: str, lane: str, batch: int, opts: argparse.Namespace,
               device: torch.device, corpus: Optional[Corpus]) -> Dict[str, object]:
    """Every measurement of one (family, lane) cell. ``corpus`` writes fresh
    mp4s (None where OpenCV is missing)."""
    clock = Clock.for_device(device)
    pp = _preprocess(lane, opts)
    model = api.load_model(family, seed=opts.seed, device=device, preprocess=pp)
    cfg = model.cfg.preprocess
    rng = np.random.default_rng(opts.seed + 1)
    shape = (batch, cfg.num_frames, *cfg.staged_frame_shape)
    host = []  # each batch: (frames,) or (frames, landmarks)
    for i in range(opts.stream_batches):
        host.append((rng.integers(0, 256, shape, np.uint8),))
        if model.takes_landmarks:
            host[-1] += (synthetic_landmarks(batch, cfg.num_frames, seed=opts.seed + 2 + i),)
    xs = [torch.from_numpy(a).to(device) for a in host[0]]
    fn = model.predict_fn()

    kernel = getattr(preprocess_kernels, KERNELS[lane])
    clock.sync()
    kernel.launches = 0
    logits = fn(*xs)
    clock.sync()
    launches = kernel.launches
    if logits.shape != (batch, model.cfg.num_classes) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{family}/{lane}: logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    plain = api.load_model(family, seed=opts.seed, device=device,
                           preprocess=dict(pp, use_pallas=False))
    plain_fn = plain.predict_fn()
    plain_logits = plain_fn(*xs)
    ms = clock.ms(lambda: fn(*xs))
    plain_ms = clock.ms(lambda: plain_fn(*xs))
    del plain, plain_fn
    with torch.inference_mode():
        stage_ms = {k: clock.ms(f) for k, f in stage_fns(model, *xs).items()}
    peak_gb = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        fn(*xs)
        torch.cuda.synchronize(device)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    gflops = _gflops_per_clip(model, *xs)
    device_only = {
        "clips_per_s": batch / ms * 1e3, "ms_per_batch": ms,
        "plain_clips_per_s": batch / plain_ms * 1e3, "plain_ms_per_batch": plain_ms,
        "kernel": KERNELS[lane], "kernel_launches_per_predict": launches,
        "max_logit_err_vs_plain": float((logits - plain_logits).abs().max()),
        "stage_ms": stage_ms, "peak_mem_gb": peak_gb, "timer": clock.source,
    }
    cell: Dict[str, object] = {
        "family": family, "lane": lane, "batch": batch,
        "input": list(shape), "compute_dtype": model.cfg.compute_dtype,
        "preprocess": dataclasses.asdict(cfg), "device": str(device),
        "device_only": device_only, "gflops_per_clip": gflops,
    }
    if model.takes_landmarks:
        cell["landmarks_input"] = list(host[0][1].shape)
    if device.type == "cuda":
        cell["mfu"] = gflops * 1e9 * device_only["clips_per_s"] / PEAK_BF16_FLOP_PER_S
    cell["stream"] = host_stream(model, host, opts.windows)
    if (family, lane) == SERVE_CELL and opts.serve:
        cell["serve"] = serve_curve(model, host[0][0][0], batch)
    del host, xs

    if corpus is None:
        cell["decode"] = cell["mp4_stream"] = {"ran": False, "why": _cv2_missing()}
        if opts.realistic and (family, lane) in REALISTIC_CELLS:
            cell["realistic"] = {"ran": False, "why": _cv2_missing()}
        return cell
    cell.update(bench_mp4(model, family, lane, batch, opts, corpus, device_only["clips_per_s"]))
    return cell


def _grouped_conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                                dilation, transposed, output_padding, groups, output_mask,
                                out_shape=None, **kwargs) -> int:
    """torch's count of a conv's backward, with the weight gradient of a
    grouped conv divided by its groups: ``FlopCounterMode`` counts that
    gradient as a dense conv's, ``groups`` times the operations
    (MobileNetV2's depthwise convs, up to 960 groups)."""
    from torch.utils.flop_counter import conv_backward_flop

    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
            output_padding, groups)
    flops = conv_backward_flop(*args, [output_mask[0], False], out_val=out_shape)
    if output_mask[1]:
        flops += conv_backward_flop(*args, [False, True], out_val=out_shape) // groups
    return flops


def train_gflops(state, step_fn, batch_in, labels) -> float:
    """Operations of one train step, GFLOP (``FlopCounterMode``: convs and
    matmuls, forward and backward, and the recompute where remat is on, a
    grouped conv's weight gradient counted per group; the preprocess
    kernel is not a PyTorch op)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _grouped_conv_backward_flop})
    with counter:
        step_fn(state, batch_in, labels)
    return counter.get_total_flops() / 1e9


def bench_train_cells(opts: argparse.Namespace,
                      device: torch.device) -> Iterator[Dict[str, object]]:
    """The ``i3d:train`` cell: one result per :data:`TRAIN_CONFIGS` entry
    (``--batch`` overrides their batches), yielded as each is measured."""
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train.loop import create_train_state, make_step_fn

    clock = Clock(device, reps=2, samples=5, warmup=2) if device.type == "cuda" else \
        Clock(device, reps=1, samples=2, warmup=1)
    for name, config_batch, remat in TRAIN_CONFIGS:
        batch = opts.batch or config_batch
        model = api.build_trainable("i3d", seed=opts.seed, device=device, remat=remat,
                                    preprocess=_preprocess("rgb", opts))
        cfg = model.cfg
        tcfg = TrainConfig(batch_size=batch, num_steps=1000, warmup_steps=100)
        state = create_train_state(model.module, tcfg, opts.seed)
        step_fn = make_step_fn(tcfg, cfg.preprocess)
        shape = (batch, cfg.preprocess.num_frames, *cfg.preprocess.staged_frame_shape)
        gen = torch.Generator(device).manual_seed(opts.seed + 1)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)
        # Input and labels varied from step to step.
        inputs = [(x + k, (torch.arange(batch, device=device) + k) % cfg.num_classes)
                  for k in range(2)]
        del x
        turn = [0]

        def step():
            xk, lk = inputs[turn[0] % 2]
            turn[0] += 1
            return step_fn(state, xk, lk)

        kernel = preprocess_kernels.preprocess_rgb
        clock.sync()
        kernel.launches = 0
        _, metrics = step()
        clock.sync()
        launches = kernel.launches
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"i3d/train {name}: metrics not finite: {metrics}")
        ms = clock.ms(step)
        peak_gb = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            step()
            torch.cuda.synchronize(device)
            peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        model.module.remat = False
        fwd_bwd = train_gflops(state, step_fn, *inputs[0]) / batch
        model.module.remat = True
        with_remat = train_gflops(state, step_fn, *inputs[0]) / batch
        model.module.remat = remat
        cell: Dict[str, object] = {
            "family": "i3d", "lane": "train", "config": name, "batch": batch, "remat": remat,
            "input": list(shape), "compute_dtype": cfg.compute_dtype,
            "param_dtype": "float32", "device": str(device),
            "ms_per_step": ms, "steps_per_s": 1e3 / ms, "clips_per_s": batch * 1e3 / ms,
            "peak_mem_gb": peak_gb, "kernel": "preprocess_rgb",
            "kernel_launches_per_step": launches, "loss": float(metrics["loss"]),
            "gflops_per_clip": fwd_bwd, "recompute_gflops_per_clip": with_remat - fwd_bwd,
            "timer": clock.source,
        }
        if device.type == "cuda":
            cell["mfu"] = fwd_bwd * 1e9 * cell["clips_per_s"] / PEAK_BF16_FLOP_PER_S
        del model, state, inputs
        yield cell


def pose_gflops_per_clip(cfg) -> float:
    """Multiply-adds of one ``pose_bilstm`` clip, ×2: per layer and
    direction, the input projection of every step (F × 4H) and the
    recurrence (H × 4H); then the classifier (2H × classes)."""
    t, h = cfg.num_frames, cfg.hidden_size
    f, macs = cfg.num_landmarks * cfg.landmark_dim, 0
    for _ in range(cfg.num_layers):
        macs += 2 * t * (f * 4 * h + h * 4 * h)
        f = 2 * h
    return 2 * (macs + 2 * h * cfg.num_classes) / 1e9


def bench_pose_cell(batch: int, opts: argparse.Namespace,
                    device: torch.device) -> Dict[str, object]:
    """``pose_bilstm``: device-only clips/s on a batch of seeded landmarks
    already on the device, and the host-staged stream of seeded batches."""
    clock = Clock.for_device(device)
    over = {"num_frames": opts.frames} if opts.frames else {}
    model = api.load_model("pose_bilstm", seed=opts.seed, device=device, **over)
    cfg = model.cfg
    host = [synthetic_landmarks(batch, cfg.num_frames, seed=opts.seed + 1 + i)
            for i in range(opts.stream_batches)]
    x = torch.from_numpy(host[0]).to(device)
    fn = model.predict_fn()
    logits = fn(x)
    if logits.shape != (batch, cfg.num_classes) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"pose_bilstm: logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    ms = clock.ms(lambda: fn(x))
    peak_gb = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        fn(x)
        torch.cuda.synchronize(device)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    gflops = pose_gflops_per_clip(cfg)
    cell: Dict[str, object] = {
        "family": "pose_bilstm", "lane": "landmarks", "batch": batch,
        "input": list(x.shape), "compute_dtype": cfg.compute_dtype, "device": str(device),
        "device_only": {"clips_per_s": batch / ms * 1e3, "ms_per_batch": ms,
                        "kernel": None, "kernel_launches_per_predict": 0,
                        "peak_mem_gb": peak_gb, "timer": clock.source},
        "gflops_per_clip": gflops,
    }
    if device.type == "cuda":
        cell["mfu_fp32"] = gflops * 1e9 * batch / ms * 1e3 / PEAK_FP32_FLOP_PER_S
    cell["stream"] = host_stream(model, [(b,) for b in host], opts.windows)
    return cell


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default (cpu: plumbing only)")
    ap.add_argument("--cells", default=",".join(f"{f}:{ln}" for f, ln, _ in CELLS),
                    help="comma-separated family:lane pairs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="clips per batch (0: each family's own)")
    ap.add_argument("--frames", type=int, default=0, help="override num_frames")
    ap.add_argument("--crop", type=int, default=0, help="override the crop")
    ap.add_argument("--staging", type=int, default=0,
                    help="override the staged frame's side (yuv420: the host resize)")
    ap.add_argument("--stream-batches", type=int, default=12)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--decode-workers", default="1,2,4",
                    help="process pool sizes; the native libraries take the largest "
                         "as their thread count")
    ap.add_argument("--corpus-clips", type=int, default=64,
                    help="clips timed per decode worker count")
    ap.add_argument("--mp4-batches", type=int, default=12,
                    help="batches of fresh mp4s through stream_predict")
    ap.add_argument("--clip-size", type=int, default=256)
    ap.add_argument("--clip-frames", type=int, default=50)
    ap.add_argument("--no-serve", dest="serve", action="store_false",
                    help="leave out the serving points of the mobilenet_gru/rgb cell")
    ap.add_argument("--no-realistic-corpus", dest="realistic", action="store_false",
                    help="leave out the mobilenet_gru cells' 640x480 block")
    ap.add_argument("--realistic-size", default="480x640", metavar="HxW",
                    help="the realistic block's frame size")
    ap.add_argument("--decode-fast", action="store_true",
                    help="decode the av streams with FAST_ALL, without the gate "
                         "(needs the av library)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="a torch.profiler capture of each timed mp4 stream under DIR")
    opts = ap.parse_args(argv)
    opts.decode_workers = [int(w) for w in opts.decode_workers.split(",")]
    try:
        h, w = (int(v) for v in opts.realistic_size.lower().split("x"))
    except ValueError:
        ap.error(f"--realistic-size {opts.realistic_size!r}: expected HxW, e.g. 480x640")
    opts.realistic_size = (h, w)
    if opts.decode_fast and not native.av_available():
        ap.error(f"--decode-fast needs the av library: {native.av_unavailable_reason()}")
    return opts


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the cells that ``argv`` selects; returns the result line."""
    opts = parse_args(argv)
    device = api.resolve_device(opts.device)
    if device.type == "cuda":
        card: Dict[str, object] = card_identity()
    else:
        card = {"platform": "cpu", "kind": "not a card: timings are the host's"}
    batches = {(f, ln): b for f, ln, b in CELLS}
    cells = []
    with contextlib.ExitStack() as stack:
        corpus = None
        if _cv2_missing() is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="asltpu_torch_bench_"))
            writers = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")))
            corpus = Corpus(writers, tmp, opts.clip_frames, seed=opts.seed * 10_000_000)
        for pair in opts.cells.split(","):
            family, lane = pair.split(":")
            batch = opts.batch or batches[(family, lane)]
            t0 = time.perf_counter()
            if lane == "train":
                results: Iterable[Dict[str, object]] = bench_train_cells(opts, device)
            elif family == "pose_bilstm":
                results = [bench_pose_cell(batch, opts, device)]
            else:
                results = [bench_cell(family, lane, batch, opts, device, corpus)]
            for cell in results:
                cell["seconds"] = time.perf_counter() - t0
                print(json.dumps({"cell": f"{family}/{lane}", **cell}), file=sys.stderr,
                      flush=True)
                cells.append(cell)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
    return {"bench": "asltpu_torch", "card": card, "seed": opts.seed, "cells": cells}


def main(argv: Optional[Sequence[str]] = None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
