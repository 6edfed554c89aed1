"""Fused stride-1 MBConv block: the wrapper of the hand-written CUDA kernels
(``asltpu_torch/csrc/mbconv.cu``), their plain PyTorch version, their tile
plans and their launch counter. Counterpart of ``asltpu/ops/mbconv_pallas.py``.

``fused_mbconv_s1`` replaces ``asltpu/ops/mbconv_pallas.py::fused_mbconv_s1``:
one inverted-residual block with BN folded into its weights (:func:`fold_bn`),

    out = relu6(dw3x3(mask(relu6(x @ w1 + b1))) + b2) @ w2 + b3  (+ x),

with the 6× expanded activation kept out of device memory. Layouts are the
JAX package's: ``x`` NHWC ``[N, H, W, Cin]`` (bf16 or fp32), ``w1 [Cin, Ce]``,
``dw [3, 3, Ce]``, ``w2 [Ce, Cout]``; weights and sums fp32, one rounding to
``x.dtype`` at the end.

What bounds it: a few bytes per pixel in and out against 2·Cin·Ce + 18·Ce +
2·Ce·Cout operations, so the 56² and 28² blocks of the main path are bound
by bytes and the 14² and 7² ones by operations (at the bf16 tensor-core
peak). Two kernels, chosen by ``x.dtype``:

- bf16 (the main path's type): the two 1×1 products on TF32 tensor cores
  (``nvcuda::wmma`` m16n16k8, fp32 accumulators), the depthwise on CUDA
  cores. TF32 and not bf16 operands: a bf16 ``x`` is exact in TF32, so only
  ``w1``, ``w2`` and the depthwise output are rounded (10 mantissa bits);
  emulated at the 7 main-path shapes that moves the fp32 result by
  0.046–0.059 of one bf16 ulp of the largest output, where bf16 operands
  move it by 0.36–0.62 (``tests/test_torch_mbconv.py``). One block = one
  image × ``rows`` output rows × all of Cout; each of its 8 warps keeps at
  most ``_MAX_FRAG`` 16×16 accumulator fragments of the output tile for the
  whole loop over Ce (in chunks of 16). :func:`tf32_tile_plan` takes the
  most rows whose fragments and shared memory (:func:`tf32_layout`) fit,
  preferring two blocks per SM, and spreads them evenly; Cout is never
  split.
- fp32: the first, CUDA-core kernel (fp32 FMAs fed from shared memory), as
  the fp32 check (1e-4 relative) needs; TF32 cannot meet it. Its plan is
  :func:`tile_plan` (rows × output channels per block).

The source file says how each kernel is laid out. For a CPU tensor the
wrapper returns :func:`fused_mbconv_s1_plain`, which is also what the tests
and ``chip_smoke.py`` hold the kernels against on the card. For a CUDA
tensor it launches one of the two kernels or raises; there is no fallback.
Each launch adds one to ``fused_mbconv_s1.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from asltpu_torch.ops import _build

# The kernels' compile-time sizes (mbconv.cu: kThreads, kChunk, kMaxAcc,
# kMaxFrag, kLe, kLw1, kStage).
_THREADS, _CHUNK, _MAX_ACC, _MAX_FRAG = 256, 16, 32, 10
_WARPS, _LE, _LW1, _STAGE = _THREADS // 32, _CHUNK + 4, _CHUNK + 8, 16 * 16
# Shared memory a block may take so that two blocks fit on one H100 SM
# (228 KB each, 1 KB of it reserved per block), and the most one block may
# take (the H100's opt-in limit, 232,448 bytes).
_SMEM_BUDGET = 113 * 1024
_SMEM_ONE_BLOCK = 227 * 1024
_GRID_X_MAX = 2**31 - 1


def fold_bn(weight, scale, bias, mean, var, eps=1e-5):
    """Fold inference BatchNorm into a conv weight and a bias.

    ``weight`` has the output channel last (``[..., Cout]``, the JAX layout);
    returns ``(weight·s, bias − mean·s)`` with ``s = scale / sqrt(var + eps)``.
    """
    s = scale / torch.sqrt(var + eps)
    return weight * s, bias - mean * s


def fused_mbconv_s1_plain(x, w1, b1, dw, b2, w2, b3, use_res=True):
    """The fused block in fp32 PyTorch, step by step as the Pallas body:
    zero-pad, expand + ReLU6, zero the halo, nine shifted multiply-adds,
    + b2 + ReLU6, project + b3, the residual when ``use_res`` and
    Cin == Cout, one cast to ``x.dtype``."""
    n, h, w, cin = x.shape
    ce, cout = w1.shape[1], w2.shape[1]
    xf = x.float()
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    e = torch.clamp(xp @ w1.float() + b1.float(), 0.0, 6.0)
    # expand(0) = relu6(b1) ≠ 0: the padded ring must be zero again.
    ring = torch.ones((h + 2, w + 2, 1), dtype=e.dtype, device=e.device)
    ring[0] = ring[-1] = 0.0
    ring[:, 0] = ring[:, -1] = 0.0
    e = e * ring
    taps = dw.float().reshape(9, ce)
    acc = torch.zeros((n, h, w, ce), dtype=torch.float32, device=x.device)
    for dr in range(3):
        for dc in range(3):
            acc = acc + e[:, dr:dr + h, dc:dc + w, :] * taps[dr * 3 + dc]
    acc = torch.clamp(acc + b2.float(), 0.0, 6.0)
    out = acc @ w2.float() + b3.float()
    if use_res and cin == cout:
        out = out + xf
    return out.to(x.dtype)


def smem_bytes(tr: int, w: int, cin: int, cot: int) -> int:
    """Shared memory of one block (``smem_floats`` in mbconv.cu)."""
    halo = (tr + 2) * (w + 2)
    floats = (halo * (cin + 1) + halo * _CHUNK + tr * w * (_CHUNK + 1)
              + cin * _CHUNK + _CHUNK * cot + 11 * _CHUNK)
    return 4 * floats


def tile_plan(h: int, w: int, cin: int, cout: int) -> Tuple[int, int]:
    """``(tr, cot)``: output rows and output channels per block. Fewest
    splits of Cout first (each split recomputes the expand), then the most
    rows whose outputs fit the accumulators (``tr·W·cot ≤ 256·32``) and
    whose shared memory lets two blocks share an SM; the rows are then
    spread evenly over the tiles."""
    for splits in range(1, cout + 1):
        cot = -(-cout // splits)
        for tr in range(h, 0, -1):
            if (tr * w * cot <= _THREADS * _MAX_ACC
                    and smem_bytes(tr, w, cin, cot) <= _SMEM_BUDGET):
                return -(-h // -(-h // tr)), cot
    raise ValueError(
        f"fused_mbconv_s1: no tile of a {h}×{w}×{cin} image fits one block's "
        f"shared memory")


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def tf32_layout(tr: int, w: int, cin: int, cout: int) -> Dict[str, int]:
    """One block of the TF32 kernel with ``tr`` output rows (``tc_tile`` in
    mbconv.cu): the offsets of its shared sub-buffers and its total, in
    floats; the leading dimensions of its wmma tiles; its output fragments."""
    m1p = _up((tr + 2) * w, 16)        # positions of the haloed rows
    m2p = _up(tr * w, 16)              # output positions
    kp, np_ = _up(cin, 8), _up(cout, 16)
    lay = {"ld_x": kp + 4, "ld_e": _LE, "ld_w1": _LW1, "ld_w2": np_ + 8,
           "ld_stage": 16, "frags": (m2p // 16) * (np_ // 16), "cout_covered": np_}
    lay["es"] = m1p * lay["ld_x"]
    lay["ds"] = lay["es"] + m1p * _LE
    # es and ds hold the warps' staging tiles in the epilogue.
    lay["w1"] = lay["es"] + max((m1p + m2p) * _LE, _WARPS * _STAGE)
    lay["w2"] = lay["w1"] + kp * _LW1
    lay["dw"] = lay["w2"] + _CHUNK * lay["ld_w2"]
    lay["b1"] = lay["dw"] + 9 * _CHUNK
    lay["b2"] = lay["b1"] + _CHUNK
    lay["mask"] = lay["b2"] + _CHUNK
    lay["col"] = lay["mask"] + m1p
    lay["total"] = lay["col"] + m2p
    return lay


@dataclasses.dataclass(frozen=True)
class Tf32Plan:
    rows: int            # output rows per block (all of Cout)
    frags_per_warp: int  # accumulator fragments of each warp, ≤ _MAX_FRAG
    smem_bytes: int
    blocks_per_sm: int   # 2 when smem_bytes ≤ _SMEM_BUDGET, else 1


@functools.lru_cache(maxsize=None)
def tf32_tile_plan(h: int, w: int, cin: int, cout: int) -> Tf32Plan:
    """The TF32 kernel's tile: the most output rows whose fragments fit the
    warps (≤ 8·``_MAX_FRAG``) and whose shared memory lets two blocks share
    an SM, else one; the rows are then spread evenly over the tiles. Cout is
    never split: a shape no tile fits is refused."""
    for budget, per_sm in ((_SMEM_BUDGET, 2), (_SMEM_ONE_BLOCK, 1)):
        for tr in range(h, 0, -1):
            lay = tf32_layout(tr, w, cin, cout)
            if (-(-lay["frags"] // _WARPS) <= _MAX_FRAG
                    and 4 * lay["total"] <= budget):
                tr = -(-h // -(-h // tr))
                lay = tf32_layout(tr, w, cin, cout)
                return Tf32Plan(tr, -(-lay["frags"] // _WARPS), 4 * lay["total"], per_sm)
    raise ValueError(
        f"fused_mbconv_s1: no tile of a {h}×{w}×{cin} image with {cout} output "
        f"channels fits one block's accumulators and shared memory")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mbconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_fused_mbconv_s1_tf32.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.asl_fused_mbconv_s1_tf32.restype = i
    lib.asl_fused_mbconv_s1_fp32.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.asl_fused_mbconv_s1_fp32.restype = i
    return lib


def _check_cuda_args(name, x, weights, shapes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    for (wname, t), shape in zip(weights.items(), shapes):
        if t.device != x.device:
            raise ValueError(f"{name}: {wname} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {wname} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {wname} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {wname} must be contiguous")


def fused_mbconv_s1(x, w1, b1, dw, b2, w2, b3, use_res=True) -> torch.Tensor:
    """Stride-1 MBConv block, fused: ``[N, H, W, Cin]`` → ``[N, H, W, Cout]``
    in ``x.dtype``. The residual applies when ``use_res`` and Cin == Cout."""
    if x.device.type == "cpu":
        return fused_mbconv_s1_plain(x, w1, b1, dw, b2, w2, b3, use_res)
    name = "fused_mbconv_s1"
    if x.dim() != 4 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(
            f"{name}: expected x [N,H,W,Cin], w1 [Cin,Ce], w2 [Ce,Cout]; got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    n, h, w, cin = x.shape
    ce, cout = w1.shape[1], w2.shape[1]
    _check_cuda_args(
        name, x, {"w1": w1, "b1": b1, "dw": dw, "b2": b2, "w2": w2, "b3": b3},
        [(cin, ce), (ce,), (3, 3, ce), (ce,), (ce, cout), (cout,)])
    if x.dtype == torch.bfloat16:
        tr = tf32_tile_plan(h, w, cin, cout).rows
        blocks = n * math.ceil(h / tr)
    else:
        tr, cot = tile_plan(h, w, cin, cout)
        blocks = n * math.ceil(h / tr) * math.ceil(cout / cot)
    if blocks > _GRID_X_MAX:
        raise ValueError(f"{name}: {blocks} blocks exceed one launch")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    dev = x.device
    ptrs = [t.data_ptr() for t in (x, w1, b1, dw, b2, w2, b3, out)]
    res = int(bool(use_res) and cin == cout)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == torch.bfloat16:
        rc = _lib().asl_fused_mbconv_s1_tf32(
            *ptrs, n, h, w, cin, ce, cout, tr, res, dev.index, stream)
    else:
        rc = _lib().asl_fused_mbconv_s1_fp32(
            *ptrs, n, h, w, cin, ce, cout, tr, cot, res, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    fused_mbconv_s1.launches += 1
    return out


fused_mbconv_s1.launches = 0
