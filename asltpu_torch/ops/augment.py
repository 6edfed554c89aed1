"""Train-time clip augmentation: random resized crop, horizontal flip and
colour jitter, then mean/std normalisation. Counterpart of
``asltpu/ops/augment.py``.

One transform per clip, the same for each of its frames. The crop and the
flip are per-clip bilinear sampling matrices ([crop, Hs] for rows,
[crop, Ws] for columns, the column one reversed for a flip) applied as two
batched fp32 einsums, with TF32 off as the JAX package's ``HIGHEST``
precision asks; brightness and contrast are an elementwise epilogue.

:func:`draw_augment` takes the seven per-clip scalars from a
``torch.Generator``; :func:`augment_clip` is the transform that takes
them, so the same scalars can be fed to this package and to the JAX one.
The JAX package has no kernel for this path: it is plain PyTorch here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional

import torch

from asltpu_torch.config import PreprocessConfig


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    enabled: bool = True
    # Random-resized-crop: sampled window area fraction and aspect jitter.
    min_area: float = 0.5
    max_area: float = 1.0
    min_aspect: float = 0.8
    max_aspect: float = 1.25
    hflip_prob: float = 0.5
    brightness: float = 0.15  # ± fraction
    contrast: float = 0.15  # ± fraction


def sampling_matrices(n_in: int, n_out: int, start: torch.Tensor, size: torch.Tensor,
                      flip: torch.Tensor) -> torch.Tensor:
    """[B, n_out, n_in] bilinear matrices, one per clip, sampling ``n_out``
    points across the window [start, start + size) of an ``n_in``-pixel
    axis (``start``, ``size``, ``flip`` [B] fp32; ``flip`` > 0 reverses the
    direction). Source positions are clamped to the axis; the upper tap of
    the last pixel falls on itself."""
    out_idx = torch.arange(n_out, dtype=torch.float32, device=start.device)
    out_idx = torch.where(flip[:, None] > 0, n_out - 1.0 - out_idx, out_idx)  # [B, n_out]
    scale = size[:, None] / n_out
    src = ((out_idx + 0.5) * scale + start[:, None] - 0.5).clamp(0.0, n_in - 1.0)
    lo = torch.floor(src)
    w = (src - lo)[..., None]
    cols = torch.arange(n_in, dtype=torch.float32, device=start.device)
    lo_match = (cols == lo[..., None]).float()
    hi_match = (cols == torch.clamp(lo + 1.0, max=n_in - 1.0)[..., None]).float()
    return lo_match * (1.0 - w) + hi_match * w


def draw_augment(generator: Optional[torch.Generator], batch: int, aug: AugmentConfig,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The seven per-clip scalars, each [batch] fp32, as the JAX function
    draws them from its seven keys: ``area`` U(min_area, max_area),
    ``log_aspect`` U(log min_aspect, log max_aspect), ``y`` and ``x`` U(0, 1)
    (the window's offset as a share of the slack), ``flip`` U(0, 1)
    (compared with ``hflip_prob``), ``brightness`` U(−b, b) and
    ``contrast`` U(1 − c, 1 + c)."""
    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(batch, generator=generator, device=device)
        return lo + (hi - lo) * u

    return {
        "area": uniform(aug.min_area, aug.max_area),
        "log_aspect": uniform(math.log(aug.min_aspect), math.log(aug.max_aspect)),
        "y": uniform(0.0, 1.0),
        "x": uniform(0.0, 1.0),
        "flip": uniform(0.0, 1.0),
        "brightness": uniform(-aug.brightness, aug.brightness),
        "contrast": uniform(1.0 - aug.contrast, 1.0 + aug.contrast),
    }


@contextlib.contextmanager
def _fp32_matmul() -> Iterator[None]:
    """fp32 matmuls on the card (no TF32), as ``Precision.HIGHEST``."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def augment_clip(frames_u8: torch.Tensor, draws: Dict[str, torch.Tensor],
                 pp: PreprocessConfig, aug: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """[B, T, Hs, Ws, 3] uint8 staged frames and the per-clip ``draws`` →
    [B, T, crop, crop, 3] in ``pp.out_dtype``: the window of area share
    ``area`` and aspect exp(``log_aspect``) (clamped to the frame) at
    offset (``y``, ``x``) of the slack, resampled to crop², mirrored where
    ``flip`` < ``hflip_prob``; then /255, + ``brightness``, contrast about
    each clip's mean, clamped to [0, 1], and normalised."""
    b, t, hs, ws, _ = frames_u8.shape
    crop = pp.crop
    aspect = torch.exp(draws["log_aspect"])
    win_h = torch.clamp(torch.sqrt(draws["area"] * hs * ws / aspect), max=float(hs))
    win_w = torch.clamp(win_h * aspect, max=float(ws))
    y0 = draws["y"] * (hs - win_h)
    x0 = draws["x"] * (ws - win_w)
    flip = (draws["flip"] < aug.hflip_prob).float()
    mh = sampling_matrices(hs, crop, y0, win_h, torch.zeros_like(flip))  # [B, crop, Hs]
    mw = sampling_matrices(ws, crop, x0, win_w, flip)  # [B, crop, Ws]

    x = frames_u8.to(torch.float32)
    with _fp32_matmul():
        y = torch.einsum("boh,bthwc->btowc", mh, x)
        y = torch.einsum("bpw,btowc->btopc", mw, y)
    y = y / 255.0
    if aug.brightness > 0:
        y = y + draws["brightness"].view(b, 1, 1, 1, 1)
    if aug.contrast > 0:
        mean_lum = y.mean(dim=(2, 3, 4), keepdim=True)
        y = (y - mean_lum) * draws["contrast"].view(b, 1, 1, 1, 1) + mean_lum
    y = y.clamp(0.0, 1.0)
    mean = torch.tensor(pp.mean, dtype=torch.float32, device=y.device)
    std = torch.tensor(pp.std, dtype=torch.float32, device=y.device)
    return ((y - mean) / std).to(pp.out_torch_dtype)


def augment_preprocess_clip(generator: Optional[torch.Generator], frames_u8: torch.Tensor,
                            pp: PreprocessConfig,
                            aug: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Random resized crop + flip + colour jitter + normalise, drawn from
    ``generator`` (on the frames' device). The eval-time path
    (:func:`asltpu_torch.ops.preprocess.preprocess_clip`) is its
    deterministic special case."""
    draws = draw_augment(generator, frames_u8.shape[0], aug, frames_u8.device)
    return augment_clip(frames_u8, draws, pp, aug)
