"""Fused stride-1 MBConv block: the wrapper of the hand-written CUDA kernel
(``asltpu_torch/csrc/mbconv.cu``), its plain PyTorch version, its tile plan
and its launch counter. Counterpart of ``asltpu/ops/mbconv_pallas.py``.

``fused_mbconv_s1`` replaces ``asltpu/ops/mbconv_pallas.py::fused_mbconv_s1``:
one inverted-residual block with BN folded into its weights (:func:`fold_bn`),

    out = relu6(dw3x3(mask(relu6(x @ w1 + b1))) + b2) @ w2 + b3  (+ x),

with the 6× expanded activation kept out of device memory. Layouts are the
JAX package's: ``x`` NHWC ``[N, H, W, Cin]`` (bf16 or fp32), ``w1 [Cin, Ce]``,
``dw [3, 3, Ce]``, ``w2 [Ce, Cout]``; weights and arithmetic fp32, one
rounding to ``x.dtype`` at the end. What bounds it and how the kernel is
laid out is said in the source file.

For a CPU tensor the wrapper returns :func:`fused_mbconv_s1_plain`, which
is also what the tests and ``chip_smoke.py`` hold the kernel against on the
card. For a CUDA tensor it launches the kernel or raises; there is no
fallback. Each launch adds one to ``fused_mbconv_s1.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from asltpu_torch.ops import _build

# The kernel's compile-time sizes (mbconv.cu: kThreads, kChunk, kMaxAcc).
_THREADS, _CHUNK, _MAX_ACC = 256, 16, 32
# Shared memory a block may take so that two blocks fit on one H100 SM
# (228 KB each, 1 KB of it reserved per block).
_SMEM_BUDGET = 113 * 1024
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


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mbconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_fused_mbconv_s1.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.asl_fused_mbconv_s1.restype = i
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
    tr, cot = tile_plan(h, w, cin, cout)
    blocks = n * math.ceil(h / tr) * math.ceil(cout / cot)
    if blocks > _GRID_X_MAX:
        raise ValueError(f"{name}: {blocks} blocks exceed one launch")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    dev = x.device
    rc = _lib().asl_fused_mbconv_s1(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw.data_ptr(), b2.data_ptr(),
        w2.data_ptr(), b3.data_ptr(), out.data_ptr(), n, h, w, cin, ce, cout,
        tr, cot, int(bool(use_res) and cin == cout), int(x.dtype == torch.bfloat16),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    fused_mbconv_s1.launches += 1
    return out


fused_mbconv_s1.launches = 0
