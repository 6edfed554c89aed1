"""Wrappers of the hand-written CUDA preprocess kernels
(``asltpu_torch/csrc/preprocess.cu``), with their plain PyTorch versions and
launch counters.

``preprocess_rgb`` replaces ``asltpu/ops/preprocess_pallas.py::
preprocess_clip_pallas``; ``preprocess_yuv420`` replaces
``preprocess_clip_yuv420_pallas``. Both are memory passes: the least time
is (input bytes the function needs + output bytes) / the card's memory
bandwidth. For rgb the input is the pixels its taps weigh, not the whole
staged frame: at the main path's identity resize (256² staging,
resize_short 256, crop 224) that is the centre 224²×3 u8, so 451,584 B per
frame with the 224²×3 bf16 output. For yuv420 it is 376,320 B per frame
(224²×1.5 u8 in, 224²×3 bf16 out). The kernels spend one thread per output
pixel and move nothing else through device memory; the source file says
more.

For a CPU tensor a wrapper returns its plain version, which is also what the
tests and ``chip_smoke.py`` hold the kernel against on the card:

- rgb: :func:`asltpu_torch.ops.preprocess.preprocess_clip_mm`, the fp32
  sampling-matrix contractions;
- yuv420: :func:`asltpu_torch.ops.preprocess.preprocess_clip_yuv420`.

For a CUDA tensor a wrapper launches its kernel or raises; there is no
fallback. Each launch adds one to the wrapper's ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from asltpu_torch.config import PreprocessConfig
from asltpu_torch.ops import _build, resize_mm
from asltpu_torch.ops.preprocess import (
    _BT601_CUB,
    _BT601_CUG,
    _BT601_CVG,
    _BT601_CVR,
    _BT601_CY,
    _thin_mode_identity,
    preprocess_clip_mm,
    preprocess_clip_yuv420,
)

# Largest grid y and z dimensions: the kernels put output rows on y and
# frames on z.
_GRID_YZ_MAX = 65535

preprocess_rgb_plain = preprocess_clip_mm
preprocess_yuv420_plain = preprocess_clip_yuv420


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("preprocess")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_preprocess_rgb.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.asl_preprocess_rgb.restype = i
    lib.asl_preprocess_yuv420.argtypes = [p, p, p, i, i, i, i, p]
    lib.asl_preprocess_yuv420.restype = i
    return lib


@functools.lru_cache(maxsize=32)
def _rgb_constants(
    device: torch.device,
    in_hw: Tuple[int, int],
    resize_short: int,
    crop: int,
    mean: Tuple[float, ...],
    std: Tuple[float, ...],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tap tables (int32 [4, crop], fp32 [4, crop]) and (scale, shift),
    on ``device``. scale/shift come from the plain version's own expression."""
    idx, w = resize_mm.resize_crop_taps(in_hw, resize_short, crop)
    scale, shift = resize_mm.normalize_affine(
        torch.tensor(mean, dtype=torch.float32),
        torch.tensor(std, dtype=torch.float32),
    )
    consts = torch.cat([scale, shift])
    return (
        torch.from_numpy(idx).to(device),
        torch.from_numpy(w).to(device),
        consts.to(device),
    )


@functools.lru_cache(maxsize=8)
def _yuv_constants(
    device: torch.device, mean: Tuple[float, ...], std: Tuple[float, ...]
) -> torch.Tensor:
    """fp32 [15] = (ky, ku, kv, lo, hi), three per channel, folded as the
    Pallas kernel's ``_yuv_kernel_constants`` folds them: s_c = 1/(255·std_c),
    lo_c = −mean_c/std_c (the bias), hi_c = 1/std_c + lo_c."""
    std64 = np.asarray(std, np.float64)
    s = 1.0 / (255.0 * std64)
    lo = (-np.asarray(mean, np.float64) / std64).astype(np.float32)
    ucoef = np.array([0.0, -_BT601_CUG, _BT601_CUB])
    vcoef = np.array([_BT601_CVR, -_BT601_CVG, 0.0])
    hi = (1.0 / std64).astype(np.float32) + lo
    consts = np.concatenate([
        (_BT601_CY * s).astype(np.float32),
        (ucoef * s).astype(np.float32),
        (vcoef * s).astype(np.float32),
        lo,
        hi,
    ])
    return torch.from_numpy(consts).to(device)


def _check_cuda_input(x: torch.Tensor, rank: int, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.uint8:
        raise ValueError(f"{name}: expected uint8 frames, got {x.dtype}")
    if x.dim() != rank:
        raise ValueError(
            f"{name}: expected a rank-{rank} tensor, got shape {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")


def _out_flag(cfg: PreprocessConfig, name: str) -> int:
    dtype = cfg.out_torch_dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bfloat16 or float32, got {dtype}")
    return int(dtype == torch.bfloat16)


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def preprocess_rgb(frames_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """[B, T, Hs, Ws, 3] uint8 → [B, T, crop, crop, 3] ``cfg.out_dtype``:
    short-side bilinear resize, centre crop and normalize."""
    if frames_u8.device.type == "cpu":
        return preprocess_rgb_plain(frames_u8, cfg)
    name = "preprocess_rgb"
    _check_cuda_input(frames_u8, 5, name)
    b, t, hs, ws, c = frames_u8.shape
    if c != 3:
        raise ValueError(f"{name}: expected 3 channels, got {c}")
    out_bf16 = _out_flag(cfg, name)
    crop, n = cfg.crop, b * t
    if n > _GRID_YZ_MAX or crop > _GRID_YZ_MAX:
        raise ValueError(f"{name}: {n} frames of crop {crop} exceed one launch")
    dev = frames_u8.device
    idx, w, consts = _rgb_constants(
        dev, (hs, ws), cfg.resize_short, crop, cfg.mean, cfg.std
    )
    out = torch.empty((b, t, crop, crop, 3), dtype=cfg.out_torch_dtype, device=dev)
    if n == 0:
        return out
    rc = _lib().asl_preprocess_rgb(
        frames_u8.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(),
        consts.data_ptr(), n, hs, ws, crop, out_bf16, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(rc, name)
    preprocess_rgb.launches += 1
    return out


preprocess_rgb.launches = 0


def preprocess_yuv420(planes_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """[B, T, Hs·3/2, Ws] packed I420 uint8 → [B, T, Hs, Ws, 3]
    ``cfg.out_dtype``: BT.601 conversion and normalize. On the card, only
    the identity-resize configuration (staging == crop², as the dispatcher
    guarantees) is taken."""
    if planes_u8.device.type == "cpu":
        return preprocess_yuv420_plain(planes_u8, cfg)
    name = "preprocess_yuv420"
    _check_cuda_input(planes_u8, 4, name)
    b, t, hp, ws = planes_u8.shape
    hs = hp * 2 // 3
    if hs * 3 != hp * 2 or hs % 4 or ws % 2:
        raise ValueError(
            f"{name}: packed I420 needs Hs % 4 == 0 and even Ws; got planes "
            f"of shape {(hp, ws)}"
        )
    if (hs, ws) != tuple(cfg.staging_size) or not _thin_mode_identity(cfg):
        raise ValueError(
            f"{name}: the kernel takes identity-resize configurations only "
            f"(staging == crop²); got planes for {(hs, ws)} with {cfg}"
        )
    out_bf16 = _out_flag(cfg, name)
    n = b * t
    if n > _GRID_YZ_MAX or hs > _GRID_YZ_MAX:
        raise ValueError(f"{name}: {n} frames of height {hs} exceed one launch")
    dev = planes_u8.device
    consts = _yuv_constants(dev, cfg.mean, cfg.std)
    out = torch.empty((b, t, hs, ws, 3), dtype=cfg.out_torch_dtype, device=dev)
    if n == 0:
        return out
    rc = _lib().asl_preprocess_yuv420(
        planes_u8.data_ptr(), out.data_ptr(), consts.data_ptr(), n, hs, ws,
        out_bf16, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(rc, name)
    preprocess_yuv420.launches += 1
    return out


preprocess_yuv420.launches = 0
