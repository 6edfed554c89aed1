"""Bilinear resize + center-crop as two dense contractions, and the same
sampling as per-row and per-column tap tables.

Counterpart of ``asltpu/ops/resize_mm.py``. The sampling is cv2-style
half-pixel bilinear: each output row (column) reads at most two input rows
(columns), with weights ``w_lo`` and ``w_hi``. The centre crop folds into the
sampling positions, so cropped pixels are never computed.

- :func:`_sampling_matrix` writes the taps into a dense ``[crop, n_in]``
  matrix, bit for bit the JAX package's. :func:`resize_crop_normalize`
  contracts with two of them: the plain PyTorch version of the rgb kernel.
- :func:`resize_crop_taps` hands the same taps to the CUDA kernel, which
  gathers 4 pixels per output pixel instead of multiplying by matrices that
  are almost all zero.

Because rows of R sum to 1, normalization commutes with the resize and is
applied as the epilogue.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from asltpu_torch.data.staging import resize_plan


@functools.lru_cache(maxsize=64)
def _sampling_taps(
    n_in: int, n_resized: int, crop: int, crop_offset: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, w_lo, w_hi), each ``[crop]``, of: resize n_in → n_resized
    (half-pixel centers, cv2.INTER_LINEAR convention), then take ``crop``
    pixels starting at ``crop_offset``. ``lo == hi`` where the clamp meets
    the image edge; the two weights then belong to one input pixel."""
    scale = n_in / n_resized
    out_idx = np.arange(crop_offset, crop_offset + crop, dtype=np.float64)
    src = (out_idx + 0.5) * scale - 0.5
    # cv2 clamps the sample window to the valid range.
    src = np.clip(src, 0.0, n_in - 1.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    return lo, hi, (1.0 - w_hi).astype(np.float32), w_hi.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sampling_matrix(
    n_in: int, n_resized: int, crop: int, crop_offset: int
) -> np.ndarray:
    """[crop, n_in] bilinear sampling matrix of :func:`_sampling_taps`."""
    lo, hi, w_lo, w_hi = _sampling_taps(n_in, n_resized, crop, crop_offset)
    mat = np.zeros((crop, n_in), dtype=np.float32)
    rows = np.arange(crop)
    mat[rows, lo] += w_lo
    mat[rows, hi] += w_hi
    return mat


def _crop_window(
    in_hw: Tuple[int, int], resize_short: int, crop: int
) -> Tuple[int, int, int, int]:
    """(rh, rw, y0, x0): resized size and crop offset, checked to fit."""
    rh, rw = resize_plan(in_hw, resize_short)
    if rh < crop or rw < crop:
        raise ValueError(
            f"crop {crop} exceeds resized dims {(rh, rw)} (staging "
            f"{in_hw}, resize_short {resize_short})"
        )
    return rh, rw, (rh - crop) // 2, (rw - crop) // 2


def resize_crop_matrices(
    in_hw: Tuple[int, int], resize_short: int, crop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(Rh [crop, Hin], Rw [crop, Win]) for short-side resize + center crop."""
    h, w = in_hw
    rh, rw, y0, x0 = _crop_window(in_hw, resize_short, crop)
    return (
        _sampling_matrix(h, rh, crop, y0),
        _sampling_matrix(w, rw, crop, x0),
    )


def resize_crop_taps(
    in_hw: Tuple[int, int], resize_short: int, crop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Tap tables of :func:`resize_crop_matrices`: (idx int32 [4, crop],
    w float32 [4, crop]) with rows (row lo, row hi, col lo, col hi)."""
    h, w = in_hw
    rh, rw, y0, x0 = _crop_window(in_hw, resize_short, crop)
    rlo, rhi, rwlo, rwhi = _sampling_taps(h, rh, crop, y0)
    clo, chi, cwlo, cwhi = _sampling_taps(w, rw, crop, x0)
    idx = np.stack([rlo, rhi, clo, chi]).astype(np.int32)
    wts = np.stack([rwlo, rwhi, cwlo, cwhi]).astype(np.float32)
    return idx, wts


def normalize_affine(
    mean: torch.Tensor, std: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) with ``x_u8 * scale + shift == (x_u8/255 - mean)/std``."""
    return (1.0 / 255.0) / std, -mean / std


def resize_crop_normalize(
    frames: torch.Tensor,  # [N, Hin, Win, C] any numeric dtype (u8 typical)
    rh: torch.Tensor,  # [crop, Hin]
    rw: torch.Tensor,  # [crop, Win]
    mean: torch.Tensor,  # [C] in 0-1 units
    std: torch.Tensor,  # [C]
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """cast → H-contraction → W-contraction → normalize, all in fp32."""
    x = frames.to(torch.float32)
    # [N, Hin, Win, C] × [crop, Hin] → [N, crop, Win, C]
    y = torch.einsum("nhwc,oh->nowc", x, rh)
    # [N, crop, Win, C] × [crop, Win] → [N, crop, crop, C]
    y = torch.einsum("nowc,pw->nopc", y, rw)
    scale, shift = normalize_affine(mean, std)
    return (y * scale + shift).to(out_dtype)
