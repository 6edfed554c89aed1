"""Clip preprocessing: uniform temporal sampling + resize + center-crop +
mean/std normalize, emitting NHWC clip tensors for the backbone.

Counterpart of ``asltpu/ops/preprocess.py``. Decode stays on the host;
everything after decode runs on the device, so host→device traffic is the
uint8 staged frames.

Implementations, each held against its JAX twin by the tests:

- :func:`preprocess_clip_interp` — ``F.interpolate`` bilinear, the
  correctness oracle (JAX: ``preprocess_clip_jnp``);
- :func:`preprocess_clip_mm` — resize+crop as two fp32 contractions, the
  plain PyTorch version of the rgb kernel;
- :func:`preprocess_clip_yuv420` — packed I420 → RGB → normalize, the plain
  version of the yuv420 kernel;
- :func:`preprocess_clip_normalize_only` — the transfer-thin rgb lane;
- the CUDA kernels in :mod:`asltpu_torch.ops.preprocess_kernels`.

:func:`preprocess_clip` dispatches between them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.staging import resize_plan, uniform_sample_indices  # noqa: F401
from asltpu_torch.ops import resize_mm


def _mean_std(cfg: PreprocessConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=device)
    return mean, std


def _bilinear_nhwc(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[N, H, W, C] float → [N, size..., C], half-pixel bilinear without
    antialiasing (cv2.INTER_LINEAR's taps, jax.image 'linear' with
    antialias=False)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=size, mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1)


def _center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    """[N, H, W, C] → [N, crop, crop, C], the centre window."""
    y0 = (x.shape[1] - crop) // 2
    x0 = (x.shape[2] - crop) // 2
    return x[:, y0 : y0 + crop, x0 : x0 + crop]


def preprocess_clip_interp(
    frames_u8: torch.Tensor, cfg: PreprocessConfig
) -> torch.Tensor:
    """Reference implementation: [B, T, Hs, Ws, 3] uint8 → [B, T, crop,
    crop, 3] normalized ``cfg.out_dtype``, NHWC."""
    b, t, hs, ws, c = frames_u8.shape
    rh, rw = resize_plan((hs, ws), cfg.resize_short)
    x = frames_u8.to(torch.float32) / 255.0
    x = x.reshape(b * t, hs, ws, c)
    if (rh, rw) != (hs, ws):
        x = _bilinear_nhwc(x, (rh, rw))
    x = _center_crop(x, cfg.crop)
    mean, std = _mean_std(cfg, frames_u8.device)
    x = (x - mean) / std
    return x.reshape(b, t, cfg.crop, cfg.crop, c).to(cfg.out_torch_dtype)


def preprocess_clip_mm(
    frames_u8: torch.Tensor, cfg: PreprocessConfig
) -> torch.Tensor:
    """Resize+crop as two dense fp32 contractions with the normalize
    epilogue (:func:`asltpu_torch.ops.resize_mm.resize_crop_normalize`)."""
    b, t, hs, ws, c = frames_u8.shape
    rh, rw = resize_mm.resize_crop_matrices((hs, ws), cfg.resize_short, cfg.crop)
    dev = frames_u8.device
    mean, std = _mean_std(cfg, dev)
    out = resize_mm.resize_crop_normalize(
        frames_u8.reshape(b * t, hs, ws, c),
        torch.from_numpy(rh).to(dev),
        torch.from_numpy(rw).to(dev),
        mean,
        std,
        out_dtype=cfg.out_torch_dtype,
    )
    return out.reshape(b, t, cfg.crop, cfg.crop, c)


# ITU-R BT.601 studio-swing coefficients — the constants OpenCV's I420↔BGR
# conversions use (ITUR_BT_601 fixed-point values / 2^20).
_BT601_CY = 1220542 / (1 << 20)   # 1.163898…  luma expand (Y-16)
_BT601_CVR = 1673527 / (1 << 20)  # 1.596027…  V → R
_BT601_CVG = 852492 / (1 << 20)   # 0.812968…  V → G (subtractive)
_BT601_CUG = 409993 / (1 << 20)   # 0.391001…  U → G (subtractive)
_BT601_CUB = 2116026 / (1 << 20)  # 2.017990…  U → B


def yuv420_planes_to_rgb(planes_u8: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """Packed I420 planes [..., Hs·3/2, Ws] uint8 → RGB float32
    [..., Hs, Ws, 3] in [0, 255], matching ``cv2.COLOR_YUV2BGR_I420``:
    BT.601 studio swing, chroma upsampled by 2×2 replication."""
    lead = planes_u8.shape[:-2]
    y = planes_u8[..., :hs, :].to(torch.float32)
    # In the packed 2D view each row holds TWO rows of a half-width chroma
    # plane: U occupies packed rows [Hs, Hs + Hs/4), V the remainder.
    qh = hs // 4
    u = planes_u8[..., hs : hs + qh, :].reshape(*lead, hs // 2, ws // 2)
    v = planes_u8[..., hs + qh :, :].reshape(*lead, hs // 2, ws // 2)

    def up2(p):
        p = p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return p.to(torch.float32) - 128.0

    u, v = up2(u), up2(v)
    # cv2 clamps the luma excursion at zero before scaling (max(0, Y-16)).
    yf = _BT601_CY * torch.clamp(y - 16.0, min=0.0)
    r = yf + _BT601_CVR * v
    g = yf - _BT601_CVG * v - _BT601_CUG * u
    b = yf + _BT601_CUB * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def preprocess_clip_yuv420(
    planes_u8: torch.Tensor, cfg: PreprocessConfig
) -> torch.Tensor:
    """[B, T, Hs·3/2, Ws] packed I420 uint8 → [B, T, crop, crop, 3]
    normalized: YUV→RGB, (optional) resize/crop, normalize."""
    b, t, hp, ws = planes_u8.shape
    hs = hp * 2 // 3
    x = yuv420_planes_to_rgb(planes_u8, hs, ws) / 255.0  # [B,T,Hs,Ws,3] 0..1
    rh, rw = resize_plan((hs, ws), cfg.resize_short)
    x = x.reshape(b * t, hs, ws, 3)
    if (rh, rw) != (hs, ws):
        x = _bilinear_nhwc(x, (rh, rw))
    if (rh, rw) != (cfg.crop, cfg.crop):
        x = _center_crop(x, cfg.crop)
    mean, std = _mean_std(cfg, planes_u8.device)
    x = (x - mean) / std
    return x.reshape(b, t, cfg.crop, cfg.crop, 3).to(cfg.out_torch_dtype)


def preprocess_clip_normalize_only(
    frames_u8: torch.Tensor, cfg: PreprocessConfig
) -> torch.Tensor:
    """Transfer-thin lane: staging == crop and the resize is identity (the
    host already resized and cropped), so the device work is only
    u8→f32 → normalize → cast."""
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    mean, std = _mean_std(cfg, frames_u8.device)
    return ((x - mean) / std).to(cfg.out_torch_dtype)


def _thin_mode_identity(cfg: PreprocessConfig) -> bool:
    """True when staging == crop² and the device resize plan is identity —
    i.e. the host staged final-resolution frames (transfer-thin mode)."""
    if cfg.staging_size != (cfg.crop, cfg.crop):
        return False
    return resize_plan(cfg.staging_size, cfg.resize_short) == cfg.staging_size


def preprocess_clip(frames_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Production entry point — dispatches on staging format, then to the
    hand-written CUDA kernel for a CUDA tensor or the plain PyTorch path
    (CPU tensors, ``use_pallas=False``). The conditions are the JAX
    dispatcher's, with "the tensor is on CUDA" for "the platform is TPU"."""
    if cfg.staging_format == "yuv420":
        if (
            cfg.use_pallas
            and frames_u8.dim() == 4
            and _thin_mode_identity(cfg)
            and frames_u8.is_cuda
        ):
            from asltpu_torch.ops.preprocess_kernels import preprocess_yuv420

            return preprocess_yuv420(frames_u8, cfg)
        return preprocess_clip_yuv420(frames_u8, cfg)
    if frames_u8.dim() == 5 and _thin_mode_identity(cfg):
        return preprocess_clip_normalize_only(frames_u8, cfg)
    if cfg.use_pallas and frames_u8.dim() == 5 and frames_u8.is_cuda:
        from asltpu_torch.ops.preprocess_kernels import preprocess_rgb

        return preprocess_rgb(frames_u8, cfg)
    return preprocess_clip_mm(frames_u8, cfg)
