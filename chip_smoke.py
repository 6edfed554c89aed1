#!/usr/bin/env python3
"""Smoke run of the asltpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``asltpu_torch/csrc`` and runs, in order, each
phase printing one JSON line:

1. device  — the card (``nvidia-smi`` name and power limit), versions, the
   kernel build time and ptxas's register counts; TF32 is switched off so
   the fp32 comparisons are fp32.
2. kernels — every kernel against its plain PyTorch version on the card, at
   the main path's shapes and at a ragged one, in bf16 and fp32; kernel and
   plain times by CUDA events around runs of back-to-back calls, beside the
   least time the card could take.
3. rgb lane — ``load_model("mobilenet_gru")`` at full width and the default
   config, ``predict`` on a seeded batch of 32 clips × 16 frames of 256²
   RGB; the rgb kernel must have launched, and the logits must match the
   same model with ``use_pallas=False`` (plain preprocess on the card).
   Then device-only times by CUDA events: a predict with each model, and
   its three stages (preprocess, backbone, GRU head) one by one.
4. yuv420 lane — the same with the transfer-thin I420 config (224² staging).
5. host — ``load_clip`` → ``predict`` and ``stream_predict`` on synthetic
   videos, when OpenCV is installed.

Then the card's ``nvidia-smi`` line, the kernels' JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero; on
a host without a CUDA device it exits nonzero before doing anything. It
imports nothing of JAX or of the ``asltpu`` package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 32  # clips per predict batch, as the JAX bench (bench.py --batch 32)
WARMUP, SAMPLES = 5, 10
# Back-to-back calls between one pair of CUDA events: enough that the
# host's time to enqueue the first call is a small share of the run.
KERNEL_REPS, PLAIN_REPS, PREDICT_REPS = 50, 10, 5
F32_ATOL = 1e-4
BF16_ATOL = {"rgb": 2e-2, "yuv420": 4e-2}  # one bf16 ulp at |x|≈2.6 / ≈4
# Logits of the same bf16 model with the kernel vs the plain preprocess: the
# two preprocess outputs differ by at most a bf16 rounding here and there.
LANE_LOGIT_ATOL = 1e-2
# H100 SXM data-sheet peaks.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# fp32 operations per output value: rgb 4 tap products + 3 adds (bilinear
# weights applied rows then columns: 6 mul + 3 add) + multiply-add normalize;
# yuv420 3 products + 3 adds + clamp (2) + the luma/chroma offsets.
OPS_PER_VALUE = {"rgb": 11, "yuv420": 9}
RGB_LANE = {}
YUV_LANE = {"staging_size": (224, 224), "resize_short": 224,
            "host_resize_short": 256, "staging_format": "yuv420"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, samples: int = SAMPLES, warmup: int = WARMUP) -> float:
    """Device time of one call: the median over ``samples`` runs of CUDA
    events around ``reps`` back-to-back calls, divided by ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device():
    from asltpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = _build.build(_build.all_sources())
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        with open(path.with_suffix(".log")) as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": round(build_s, 3), "ptxas": ptxas,
        "tf32": "off (cudnn.allow_tf32 = matmul.allow_tf32 = False)",
    })
    return smi


def rgb_input_bytes(cfg, in_hw) -> int:
    """Bytes of one staged frame that the rgb resize needs: the pixels whose
    row and column both carry a nonzero tap weight, 3 bytes each. At the
    main path's identity resize that is the centre 224² crop."""
    from asltpu_torch.ops.resize_mm import resize_crop_taps

    idx, w = resize_crop_taps(in_hw, cfg.resize_short, cfg.crop)
    rows = set(idx[0][w[0] != 0]) | set(idx[1][w[1] != 0])
    cols = set(idx[2][w[2] != 0]) | set(idx[3][w[3] != 0])
    return len(rows) * len(cols) * 3


def _uint8(rng, shape, device):
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)


def phase_kernels():
    from asltpu_torch.config import PreprocessConfig
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.ops.preprocess import preprocess_clip_interp

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    main_rgb = PreprocessConfig()
    main_yuv = PreprocessConfig(**YUV_LANE)
    x_rgb = _uint8(rng, (BATCH, 16, 256, 256, 3), dev)
    x_yuv = _uint8(rng, (BATCH, 16, 336, 224), dev)
    cases = [
        ("rgb", "main", x_rgb, main_rgb),
        ("rgb", "ragged", _uint8(rng, (4, 16, 240, 320, 3), dev),
         PreprocessConfig(staging_size=(240, 320))),
        ("yuv420", "main", x_yuv, main_yuv),
        ("yuv420", "ragged", _uint8(rng, (4, 16, 300, 200), dev),
         PreprocessConfig(staging_size=(200, 200), resize_short=200, crop=200,
                          staging_format="yuv420")),
    ]
    wrap = {"rgb": (k.preprocess_rgb, k.preprocess_rgb_plain),
            "yuv420": (k.preprocess_yuv420, k.preprocess_yuv420_plain)}
    checks, max_err = [], {"rgb": 0.0, "yuv420": 0.0}
    for lane, shape_name, x, cfg in cases:
        kernel, plain = wrap[lane]
        for out_dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, out_dtype=out_dtype)
            got = kernel(x, c)
            torch.cuda.synchronize()
            want = plain(x, c)
            assert got.shape == want.shape and got.dtype == want.dtype
            err = float((got.float() - want.float()).abs().max())
            atol = F32_ATOL if out_dtype == "float32" else BF16_ATOL[lane]
            checks.append({"kernel": lane, "shape": shape_name,
                           "input": list(x.shape), "out_dtype": out_dtype,
                           "max_abs_err": err, "atol": atol})
            if err > atol:
                raise AssertionError(f"{lane} kernel disagrees: {checks[-1]}")
            if shape_name == "main" and out_dtype == main_rgb.out_dtype:
                max_err[lane] = err

    timing = {}
    for lane, x, cfg in (("rgb", x_rgb, main_rgb), ("yuv420", x_yuv, main_yuv)):
        kernel, plain = wrap[lane]
        n = x.shape[0] * x.shape[1]
        out_values = n * cfg.crop * cfg.crop * 3
        # Input: what the function needs of each frame (the yuv420 kernel
        # reads every byte of its I420 frame); output written once.
        in_bytes = (n * rgb_input_bytes(cfg, tuple(x.shape[2:4]))
                    if lane == "rgb" else x.numel())
        nbytes = in_bytes + out_values * cfg.out_torch_dtype.itemsize
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = out_values * OPS_PER_VALUE[lane] / PEAK_FP32_FLOP_PER_S * 1e3
        # plain, kernel, kernel, plain: compare within one call, in turns.
        p1 = time_ms(lambda: plain(x, cfg), PLAIN_REPS)
        k1 = time_ms(lambda: kernel(x, cfg), KERNEL_REPS)
        k2 = time_ms(lambda: kernel(x, cfg), KERNEL_REPS)
        p2 = time_ms(lambda: plain(x, cfg), PLAIN_REPS)
        timing[lane] = {
            "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "bytes": nbytes, "input_bytes": in_bytes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
    # Information only: F.interpolate + crop + normalize is three or more
    # PyTorch calls, so it is no single-call yardstick for the rgb kernel.
    timing["rgb"]["interp_chain_ms_info"] = time_ms(
        lambda: preprocess_clip_interp(x_rgb, main_rgb), PLAIN_REPS)
    emit({"phase": "kernels", "checks": checks, "timing": timing,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flop_per_s": PEAK_FP32_FLOP_PER_S,
                    "source": "H100 SXM data sheet"}})
    return max_err, timing


def _lane(name, pp_overrides, staged_shape):
    """Drive one lane through the public API; returns the launch counts of
    the main-path predict."""
    from asltpu_torch import api
    from asltpu_torch.models.temporal import GRUHead
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.ops.preprocess import preprocess_clip

    model = api.load_model("mobilenet_gru", seed=SEED, preprocess=dict(pp_overrides))
    cfg = model.cfg
    assert cfg.width_mult == 1.0 and cfg.gru_hidden == 512
    assert cfg.num_classes == 100 and cfg.preprocess.crop == 224
    frames = np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, cfg.preprocess.num_frames, *staged_shape), np.uint8)
    assert frames.shape[2:] == cfg.preprocess.staged_frame_shape
    torch.cuda.reset_peak_memory_stats()

    k.preprocess_rgb.launches = 0
    k.preprocess_yuv420.launches = 0
    ids, logits = api.predict(model, frames)
    torch.cuda.synchronize()
    launches = {"preprocess_rgb": k.preprocess_rgb.launches,
                "preprocess_yuv420": k.preprocess_yuv420.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert logits.shape == (BATCH, 100) and np.isfinite(logits).all()
    plain_model = api.load_model(
        "mobilenet_gru", seed=SEED, preprocess=dict(pp_overrides, use_pallas=False))
    plain_ids, plain_logits = api.predict(plain_model, frames)
    err = float(np.abs(logits - plain_logits).max())
    top2 = np.sort(plain_logits, axis=-1)
    if not (ids == plain_ids).all() or err > LANE_LOGIT_ATOL:
        raise AssertionError(f"{name} lane: kernel and plain preprocess disagree "
                             f"(max logit err {err}, top-1 {ids} vs {plain_ids})")

    x = torch.from_numpy(frames).to(model.device)
    fn, plain_fn = model.predict_fn(), plain_model.predict_fn()
    ms = time_ms(lambda: fn(x), PREDICT_REPS)
    plain_ms = time_ms(lambda: plain_fn(x), PREDICT_REPS)
    # The same predict, stage by stage: preprocess, backbone, GRU head.
    module = model.module
    with torch.inference_mode():
        clip = preprocess_clip(x, cfg.preprocess)
        nchw = clip.flatten(0, 1).permute(0, 3, 1, 2)
        feats = module.features(nchw).reshape(BATCH, cfg.preprocess.num_frames, -1)
        split = {
            "preprocess": time_ms(
                lambda: preprocess_clip(x, cfg.preprocess), KERNEL_REPS),
            "backbone": time_ms(lambda: module.features(nchw), PREDICT_REPS),
            "head": time_ms(lambda: GRUHead.forward(module, feats), PREDICT_REPS),
        }
    emit({
        "phase": f"{name}_lane", "config": {"preprocess": pp_overrides,
                                           "compute_dtype": cfg.compute_dtype},
        "input": list(frames.shape), "launches": launches,
        "logits_finite": True, "top1_equal_plain": True,
        "max_logit_err_vs_plain": err, "atol": LANE_LOGIT_ATOL,
        "min_top1_margin": float((top2[:, -1] - top2[:, -2]).min()),
        "device_ms_per_batch": ms, "device_clips_per_s": BATCH / ms * 1e3,
        "plain_device_ms_per_batch": plain_ms,
        "plain_device_clips_per_s": BATCH / plain_ms * 1e3,
        "stage_ms": split, "peak_mem_gb": peak_gb,
    })
    return launches


def _write_video(path, num_frames, size, seed):
    """A smooth moving-gradient mp4 (codec-friendly content)."""
    import cv2

    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase, freq = rng.uniform(0, 2 * np.pi, 3), rng.uniform(0.02, 0.08, 3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    try:
        for t in range(num_frames):
            img = 127.5 + 110 * np.sin(
                freq * (xx + yy)[..., None] + phase + 0.3 * t)
            writer.write(np.clip(img, 0, 255).astype(np.uint8))
    finally:
        writer.release()


def phase_host():
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        emit({"phase": "host", "ran": False,
              "why": f"OpenCV is not installed on this machine ({e})"})
        return
    from asltpu_torch import api

    model = api.load_model("mobilenet_gru", seed=SEED)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, size in enumerate([(240, 320), (320, 240), (256, 256), (480, 640)]):
            paths.append(os.path.join(d, f"clip{i}.mp4"))
            _write_video(paths[-1], 40, size, seed=i)
        singles = []
        for p in paths:
            clip = api.load_clip(p, model.cfg.preprocess)
            assert clip.shape == (16, 256, 256, 3)
            _, logits = api.predict(model, clip)
            assert logits.shape == (100,) and np.isfinite(logits).all()
            singles.append(logits)
        out = list(api.stream_predict(model, paths, batch_size=2,
                                      num_decode_workers=2, decode_backend="thread"))
    assert [p for p, _, _ in out] == paths
    err = max(float(np.abs(lg - s).max()) for (_, _, lg), s in zip(out, singles))
    if err > 5e-2:
        raise AssertionError(f"stream_predict disagrees with predict by {err}")
    emit({"phase": "host", "ran": True, "clips": len(paths),
          "max_logit_err_stream_vs_predict": err})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from asltpu_torch.config import PreprocessConfig

    t0 = time.perf_counter()
    smi = phase_device()
    max_err, timing = phase_kernels()
    rgb = _lane("rgb", RGB_LANE, PreprocessConfig().staged_frame_shape)
    yuv = _lane("yuv420", YUV_LANE, PreprocessConfig(**YUV_LANE).staged_frame_shape)
    if rgb["preprocess_rgb"] < 1 or yuv["preprocess_yuv420"] < 1:
        raise AssertionError(f"a kernel did not run on its lane: {rgb}, {yuv}")
    phase_host()

    kernels = []
    for lane, fn, launches, replaces in (
        ("rgb", "preprocess_rgb", rgb["preprocess_rgb"],
         "asltpu/ops/preprocess_pallas.py:67"),
        ("yuv420", "preprocess_yuv420", yuv["preprocess_yuv420"],
         "asltpu/ops/preprocess_pallas.py:216"),
    ):
        t = timing[lane]
        kernels.append({
            "name": fn, "route": "cuda", "source": "asltpu_torch/csrc/preprocess.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err[lane], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
