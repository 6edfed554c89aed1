"""Wrappers of the hand-written CUDA preprocess kernels
(``asltpu_torch/csrc/preprocess.cu``), with their plain PyTorch versions,
the rgb kernel's band plan and the launch counters.

``preprocess_rgb`` replaces ``asltpu/ops/preprocess_pallas.py::
preprocess_clip_pallas``; ``preprocess_yuv420`` replaces
``preprocess_clip_yuv420_pallas``. Both are memory passes: the least time
is (input bytes the function needs + output bytes) / the card's memory
bandwidth. For rgb the input is the pixels its taps weigh, not the whole
staged frame: at the main path's identity resize (256² staging,
resize_short 256, crop 224) that is the centre 224²×3 u8, so 451,584 B per
frame with the 224²×3 bf16 output. For yuv420 it is 376,320 B per frame
(224²×1.5 u8 in, 224²×3 bf16 out). Both kernels stream: persistent grids,
8 output pixels per thread at a time, warp-wide 16-byte stores. The rgb
kernel stages each band of output rows' input rows in shared memory with
16-byte copies (:func:`rgb_band_plan` sizes the bands; the C side lays out
the shared memory); the source file says more.

Each kernel is a ``torch.library`` custom op, ``asltpu_torch::preprocess_rgb``
and ``asltpu_torch::preprocess_yuv420``, whose arguments are the tensor and
primitives (resize_short, crop, mean, std, out dtype), with a fake
implementation that gives the output's shape and dtype. So ``torch.export``
traces a call into the exported program (:mod:`asltpu_torch.export`), and
the program launches the hand-written kernel when it runs, on the caller's
current stream; ``predict``, the train step and export all reach the kernel
through the op. Registering the ops builds nothing: nvcc runs at the first
launch. The wrappers ``preprocess_rgb(frames, cfg)`` and
``preprocess_yuv420(planes, cfg)`` call the ops.

For a CPU tensor an op returns its plain version, which is also what the
tests and ``chip_smoke.py`` hold the kernel against on the card:

- rgb: :func:`asltpu_torch.ops.preprocess.preprocess_clip_mm`, the fp32
  sampling-matrix contractions;
- yuv420: :func:`asltpu_torch.ops.preprocess.preprocess_clip_yuv420`.

For a CUDA tensor an op launches its kernel or raises; there is no
fallback. Each launch adds one to the wrapper's ``launches`` attribute,
inside an exported program too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.staging import resize_plan
from asltpu_torch.ops import _build, resize_mm
from asltpu_torch.ops.preprocess import (
    _BT601_CUB,
    _BT601_CUG,
    _BT601_CVG,
    _BT601_CVR,
    _BT601_CY,
    preprocess_clip_mm,
    preprocess_clip_yuv420,
)

# The kernels' compile-time sizes (preprocess.cu: kGroup): output pixels
# per thread and group.
_GROUP = 8
# Output rows per rgb band, halved by the plan until the band fits; the most
# shared memory one block may take (the H100's opt-in limit, 232,448 bytes).
_BAND_ROWS = 16
_SMEM_ONE_BLOCK = 227 * 1024
# The warps' store chunks in shared memory, per byte of an output value: 256
# threads × one group of 24 values (RgbSmem in C: kThreads × Out<T>::kChunks
# × 16 bytes).
_STORE_BYTES_PER_OUT_BYTE = 256 * 24

preprocess_rgb_plain = preprocess_clip_mm
preprocess_yuv420_plain = preprocess_clip_yuv420


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("preprocess")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.asl_preprocess_rgb.argtypes = [p, p, p, p, n] + [i] * 11 + [p]
    lib.asl_preprocess_rgb.restype = i
    lib.asl_preprocess_rgb_smem_bytes.argtypes = [i] * 4
    lib.asl_preprocess_rgb_smem_bytes.restype = i
    lib.asl_preprocess_yuv420.argtypes = [p, p, p, n, i, i, i, i, p]
    lib.asl_preprocess_yuv420.restype = i
    return lib


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def rgb_taps(
    in_hw: Tuple[int, int], resize_short: int, crop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The tap tables of :func:`resize_mm.resize_crop_taps` with every tap
    whose weight is 0 pointed at its partner: the product is 0 either way,
    and the kernel then stages nothing for it (at the main path's identity
    resize every hi tap weighs 0)."""
    idx, w = resize_mm.resize_crop_taps(in_hw, resize_short, crop)
    idx = idx.copy()
    for lo, hi in ((0, 1), (2, 3)):
        idx[hi] = np.where(w[hi] == 0, idx[lo], idx[hi])
        idx[lo] = np.where(w[lo] == 0, idx[hi], idx[lo])
    return idx, w


def rgb_table_words(crop: int) -> int:
    """int32 words of the tap tables but the bands: rows and columns (4 each
    per output row or column) and one flag per group of 8 columns, padded to
    16 bytes (``rgb_table_words`` in C)."""
    return 8 * crop + _up(-(-crop // _GROUP), 4)


def rgb_smem_table_words(crop: int) -> int:
    """The same tables in the kernel's shared memory, where the column table
    has a slot for each pixel of each group (``RgbSmem::chunks_at`` / 4 in
    C)."""
    groups = -(-crop // _GROUP)
    return 4 * crop + 4 * _GROUP * groups + _up(groups, 4)


@dataclasses.dataclass(frozen=True)
class RgbBandPlan:
    rows: int                           # output rows per band
    bands: Tuple[Tuple[int, int], ...]  # per band: first staged input row, rows
    stage_rows: int                     # rows of each staging buffer
    col0: int                           # first staged input column
    span: int                           # staged bytes of each row
    pitch: int                          # bytes between staged rows, % 16 == 0
    smem_bytes: int                     # the fit test's total (see rgb_band_plan)


def _bands(idx: np.ndarray, crop: int, rows: int) -> Tuple[Tuple[int, int], ...]:
    out = []
    for oy in range(0, crop, rows):
        taps = idx[0:2, oy:oy + rows]
        out.append((int(taps.min()), int(taps.max() - taps.min() + 1)))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def rgb_band_plan(
    in_hw: Tuple[int, int], resize_short: int, crop: int, out_bytes: int = 2
) -> RgbBandPlan:
    """The rgb kernel's bands, for an output of ``out_bytes`` per value: the
    most output rows per band (from 16, halving) whose two staging buffers
    fit one block's shared memory beside the tap tables and the warps' store
    chunks. A band stages only the input rows its taps touch and, of each,
    only the bytes of the columns any tap touches, from their start rounded
    down to 16 bytes (``pitch`` leaves room for that). A frame whose tables
    or single-row bands do not fit is refused.

    The layout itself belongs to the C side (``RgbSmem`` in preprocess.cu),
    which sizes the launch's shared memory and refuses a launch that needs
    more than a block may have; ``smem_bytes`` is this module's count of the
    same total, used only to choose the rows per band, and a card test holds
    it to ``asl_preprocess_rgb_smem_bytes``."""
    idx, _ = rgb_taps(tuple(in_hw), resize_short, crop)
    col0 = int(idx[2:4].min())
    span = 3 * (int(idx[2:4].max()) - col0 + 1)
    pitch = _up(span + 15, 16)
    rows = _BAND_ROWS
    while True:
        bands = _bands(idx, crop, rows)
        stage_rows = max(n for _, n in bands)
        smem = (4 * rgb_smem_table_words(crop) + _STORE_BYTES_PER_OUT_BYTE * out_bytes
                + 2 * stage_rows * pitch)
        if smem <= _SMEM_ONE_BLOCK:
            return RgbBandPlan(rows, bands, stage_rows, col0, span, pitch, smem)
        if rows == 1:
            raise ValueError(
                f"preprocess_rgb: no band of a {tuple(in_hw)} frame resized to "
                f"{resize_short} and cropped to {crop} fits one block's shared "
                f"memory ({smem} > {_SMEM_ONE_BLOCK} bytes)")
        rows //= 2


def _rgb_tables(
    in_hw: Tuple[int, int], resize_short: int, crop: int, plan: RgbBandPlan
) -> np.ndarray:
    """int32 tables of one rgb launch (layout in preprocess.cu, weights as
    fp32 bits): rows (lo, hi, w_lo, w_hi); columns with lo and hi as byte
    offsets into the staged span; per group of 8 columns, 1 where they are
    unit taps (hi == lo, lo + 1 from column to column, weights 1 and 0);
    per band its first staged row and row count."""
    idx, w = rgb_taps(in_hw, resize_short, crop)
    wbits = w.view(np.int32)
    rows = np.stack([idx[0], idx[1], wbits[0], wbits[1]], axis=1)
    cols = np.stack([3 * (idx[2] - plan.col0), 3 * (idx[3] - plan.col0),
                     wbits[2], wbits[3]], axis=1)
    flags = np.zeros(rgb_table_words(crop) - 8 * crop, np.int32)
    for g in range(crop // _GROUP):
        sel = slice(g * _GROUP, (g + 1) * _GROUP)
        lo, hi = idx[2, sel], idx[3, sel]
        flags[g] = int((hi == lo).all() and (np.diff(lo) == 1).all()
                       and (w[2, sel] == 1).all() and (w[3, sel] == 0).all())
    return np.concatenate([rows.ravel(), cols.ravel(), flags,
                           np.asarray(plan.bands, np.int32).ravel()]).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _rgb_constants(
    device: torch.device,
    in_hw: Tuple[int, int],
    resize_short: int,
    crop: int,
    out_bytes: int,
    mean: Tuple[float, ...],
    std: Tuple[float, ...],
) -> Tuple[torch.Tensor, np.ndarray]:
    """The launch's tables (:func:`_rgb_tables`, for the plan of
    ``out_bytes`` per output value) on ``device`` and fp32 (scale, shift) on
    the host (the kernel takes them as parameters). scale/shift come from
    the plain version's own expression."""
    plan = rgb_band_plan(in_hw, resize_short, crop, out_bytes)
    scale, shift = resize_mm.normalize_affine(
        torch.tensor(mean, dtype=torch.float32),
        torch.tensor(std, dtype=torch.float32),
    )
    return (
        torch.from_numpy(_rgb_tables(in_hw, resize_short, crop, plan)).to(device),
        torch.cat([scale, shift]).numpy(),
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
    if x.dtype != torch.uint8:
        raise ValueError(f"{name}: expected uint8 frames, got {x.dtype}")
    if x.dim() != rank:
        raise ValueError(
            f"{name}: expected a rank-{rank} tensor, got shape {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")


def _out_flag(dtype: torch.dtype, name: str) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bfloat16 or float32, got {dtype}")
    return int(dtype == torch.bfloat16)


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _plain_cfg(resize_short: int, crop: int, mean: Sequence[float], std: Sequence[float],
               out_dtype: torch.dtype) -> PreprocessConfig:
    """The config fields the plain versions read, from the ops' arguments
    (the plain versions take the staging size from the input's shape)."""
    return PreprocessConfig(resize_short=resize_short, crop=crop, mean=tuple(mean),
                            std=tuple(std), out_dtype=str(out_dtype).rsplit(".", 1)[-1])


# The ops' schema: the tensor and primitives only, so that an exported
# program can hold a call. The dispatcher sends a CPU tensor to the plain
# version and a CUDA one to the kernel; ``register_fake`` gives the output's
# shape and dtype to ``torch.export``'s tracer. (``torch.library.Library``
# rather than ``custom_op``: its dispatch adds less host time to each
# launch, which back-to-back kernel timings show; PERF.md has the numbers.)
_LIB = torch.library.Library("asltpu_torch", "DEF")
_ARGS = "int resize_short, int crop, float[] mean, float[] std, ScalarType out_dtype"
_LIB.define(f"preprocess_rgb(Tensor frames_u8, {_ARGS}) -> Tensor")
_LIB.define(f"preprocess_yuv420(Tensor planes_u8, {_ARGS}) -> Tensor")


def _rgb_plain_op(frames_u8, resize_short, crop, mean, std, out_dtype):
    return preprocess_rgb_plain(frames_u8, _plain_cfg(resize_short, crop, mean, std, out_dtype))


def _rgb_kernel_op(frames_u8: torch.Tensor, resize_short: int, crop: int,
                   mean: Sequence[float], std: Sequence[float],
                   out_dtype: torch.dtype) -> torch.Tensor:
    name = "preprocess_rgb"
    _check_cuda_input(frames_u8, 5, name)
    b, t, hs, ws, c = frames_u8.shape
    if c != 3:
        raise ValueError(f"{name}: expected 3 channels, got {c}")
    out_bf16 = _out_flag(out_dtype, name)
    n = b * t
    out_bytes = out_dtype.itemsize
    plan = rgb_band_plan((hs, ws), resize_short, crop, out_bytes)
    dev = frames_u8.device
    tables, consts = _rgb_constants(
        dev, (hs, ws), resize_short, crop, out_bytes, tuple(mean), tuple(std)
    )
    out = torch.empty((b, t, crop, crop, 3), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    rc = _lib().asl_preprocess_rgb(
        frames_u8.data_ptr(), out.data_ptr(), tables.data_ptr(),
        consts.ctypes.data, n, hs, ws, crop, plan.rows, len(plan.bands),
        plan.col0, plan.span, plan.pitch, plan.stage_rows,
        out_bf16, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(rc, name)
    preprocess_rgb.launches += 1
    return out


_LIB.impl("preprocess_rgb", _rgb_plain_op, "CPU")
_LIB.impl("preprocess_rgb", _rgb_kernel_op, "CUDA")


@torch.library.register_fake("asltpu_torch::preprocess_rgb", lib=_LIB)
def _rgb_fake(frames_u8, resize_short, crop, mean, std, out_dtype):
    b, t = frames_u8.shape[:2]
    return frames_u8.new_empty((b, t, crop, crop, 3), dtype=out_dtype)


def preprocess_rgb(frames_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """[B, T, Hs, Ws, 3] uint8 → [B, T, crop, crop, 3] ``cfg.out_dtype``:
    short-side bilinear resize, centre crop and normalize. Calls the custom
    op ``asltpu_torch::preprocess_rgb``."""
    return torch.ops.asltpu_torch.preprocess_rgb.default(
        frames_u8, cfg.resize_short, cfg.crop, list(cfg.mean), list(cfg.std),
        cfg.out_torch_dtype)


preprocess_rgb.launches = 0


def _yuv420_plain_op(planes_u8, resize_short, crop, mean, std, out_dtype):
    return preprocess_yuv420_plain(planes_u8, _plain_cfg(resize_short, crop, mean, std,
                                                         out_dtype))


def _yuv420_kernel_op(planes_u8: torch.Tensor, resize_short: int, crop: int,
                      mean: Sequence[float], std: Sequence[float],
                      out_dtype: torch.dtype) -> torch.Tensor:
    name = "preprocess_yuv420"
    _check_cuda_input(planes_u8, 4, name)
    b, t, hp, ws = planes_u8.shape
    hs = hp * 2 // 3
    if hs * 3 != hp * 2 or hs % 4 or ws % 2:
        raise ValueError(
            f"{name}: packed I420 needs Hs % 4 == 0 and even Ws; got planes "
            f"of shape {(hp, ws)}"
        )
    if (hs, ws) != (crop, crop) or resize_plan((hs, ws), resize_short) != (hs, ws):
        raise ValueError(
            f"{name}: the kernel takes identity-resize configurations only "
            f"(staging == crop²); got planes for {(hs, ws)} with resize_short "
            f"{resize_short} and crop {crop}"
        )
    out_bf16 = _out_flag(out_dtype, name)
    n = b * t
    dev = planes_u8.device
    consts = _yuv_constants(dev, tuple(mean), tuple(std))
    out = torch.empty((b, t, hs, ws, 3), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    rc = _lib().asl_preprocess_yuv420(
        planes_u8.data_ptr(), out.data_ptr(), consts.data_ptr(), n, hs, ws,
        out_bf16, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(rc, name)
    preprocess_yuv420.launches += 1
    return out


_LIB.impl("preprocess_yuv420", _yuv420_plain_op, "CPU")
_LIB.impl("preprocess_yuv420", _yuv420_kernel_op, "CUDA")


@torch.library.register_fake("asltpu_torch::preprocess_yuv420", lib=_LIB)
def _yuv420_fake(planes_u8, resize_short, crop, mean, std, out_dtype):
    b, t = planes_u8.shape[:2]
    return planes_u8.new_empty((b, t, crop, crop, 3), dtype=out_dtype)


def preprocess_yuv420(planes_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """[B, T, Hs·3/2, Ws] packed I420 uint8 → [B, T, crop, crop, 3]
    ``cfg.out_dtype``: BT.601 conversion and normalize. Calls the custom op
    ``asltpu_torch::preprocess_yuv420``; on the card only the
    identity-resize configuration (staging == crop², as the dispatcher
    guarantees) is taken."""
    return torch.ops.asltpu_torch.preprocess_yuv420.default(
        planes_u8, cfg.resize_short, cfg.crop, list(cfg.mean), list(cfg.std),
        cfg.out_torch_dtype)


preprocess_yuv420.launches = 0
