"""I3D's 3D max-pools: the wrapper of the hand-written CUDA kernels
(``asltpu_torch/csrc/pool3d.cu``), their plain PyTorch versions, the
custom ops and the launch counters.

The kernels replace no TPU kernel: the JAX package pools with flax's
``max_pool``, which XLA lowers to ``reduce_window``. On the card the plain
version (pad_same's −inf copy where TF-"SAME" pads asymmetrically, then
aten's ``max_pool3d`` writing int64 indices, its backward a zero fill and an
atomic scatter) took about a third of an I3D training step.

One op takes every pool of I3D, TF-"SAME" and VALID alike: a window
``kernel``, a ``stride`` and per axis a (lo, hi) pad, ``pad = (t_lo, t_hi,
h_lo, h_hi, w_lo, w_hi)``, with ``0 <= lo <= hi < k`` and ``2·lo <= k``
(what ``same_pads`` gives, and all zeros for VALID); output extents
``(L + lo + hi − k) // s + 1``. Tensors are NCDHW in ``channels_last_3d``
memory. Besides the output the forward gives one uint8 a value, the argmax's
offset inside its window, ``(kt·KH + kh)·KW + kw`` counted from the window's
unclipped corner ``o·s − lo``; the backward needs only those and the shapes,
not the input and not int64 indices.

- ``asltpu_torch::max_pool3d_same(x, kernel, stride, pad) -> (out, offsets)``
  with ``register_autograd``, so a training step, the recompute of a
  rematerialised block and ``torch.export`` all reach it;
- ``asltpu_torch::max_pool3d_same_backward(grad, offsets, size, kernel,
  stride, pad) -> grad_in``, ``size`` the input's (T, H, W).

Both have fake implementations. For a CPU tensor each op runs its plain
version: :func:`max_pool3d_plain` (``pad_same`` + ``F.max_pool3d`` with the
pads given, its indices turned into offsets) and
:func:`max_pool3d_backward_plain` (a scatter-add of the output gradient at
the offsets). For a CUDA tensor it launches its kernel or raises: bf16 or
fp32 in ``channels_last_3d`` memory, I3D's windows (:data:`KERNEL_WINDOWS`)
only, C a multiple of 4 with every tensor aligned to 4 values (16 bytes in
fp32), and no fallback. Each launch adds
one to ``max_pool3d_same.launches`` or ``max_pool3d_same_backward.launches``;
each call, from its checks to its launch, runs inside the span
``i3d.max_pool`` (:func:`asltpu_torch.utils.profiling.span`).

Tie rule, aten's: the first maximum in the window's (t, h, w) order, a NaN
over any number and the last of several NaNs, the first in-bounds tap in a
window of −inf only. The kernel's forward gives the plain version's values
bit for bit and its offsets; its backward sums each element's gradients in
fp32 and rounds once, where aten's adds them with atomics in the working
dtype. Bound, on the card: the bytes moved once (forward x, out and the
offsets; backward the output gradient, the offsets and the input
gradient); the source file says how the kernels go after it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from asltpu_torch.ops import _build
from asltpu_torch.utils.profiling import span

# The span around each launch of either direction.
SPAN = "i3d.max_pool"
# Offsets are one byte; the kernels form their counts in 32 bits.
_MAX_WINDOW = 256
_INT32 = 2**31
# The windows the kernels are built for (I3D's); any strides and pads.
KERNEL_WINDOWS = ((1, 3, 3), (3, 3, 3), (2, 2, 2))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pool3d")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_max_pool3d_fwd.argtypes = [p, p, p, p, i, i, i, p]
    lib.asl_max_pool3d_fwd.restype = i
    lib.asl_max_pool3d_bwd.argtypes = [p, p, p, p, i, i, i, p]
    lib.asl_max_pool3d_bwd.restype = i
    return lib


def pool_geometry(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int],
                  pad: Sequence[int]) -> Tuple[int, int, int]:
    """The output's (T, H, W) for an input of spatial ``size``; raises
    ``ValueError`` on a window, stride or pad the op does not take."""
    if not (len(size) == len(kernel) == len(stride) == 3 and len(pad) == 6):
        raise ValueError(f"max_pool3d_same: expected 3 extents, 3 window sizes, 3 strides "
                         f"and 6 pads, got {size}, {kernel}, {stride}, {pad}")
    if kernel[0] * kernel[1] * kernel[2] > _MAX_WINDOW:
        raise ValueError(f"max_pool3d_same: a {tuple(kernel)} window has more taps than "
                         f"a one-byte offset holds")
    out = []
    for n, k, s, lo, hi in zip(size, kernel, stride, pad[0::2], pad[1::2]):
        if k < 1 or s < 1 or not 0 <= lo <= hi < k or 2 * lo > k or n + lo + hi < k:
            raise ValueError(f"max_pool3d_same: extent {n}, window {k}, stride {s} and "
                             f"pads ({lo}, {hi}) are not taken (0 <= lo <= hi < k, "
                             f"2·lo <= k, one window at least)")
        out.append((n + lo + hi - k) // s + 1)
    return tuple(out)


def _empty(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device,
                       memory_format=torch.channels_last_3d)


def max_pool3d_plain(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                     pad: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, offsets) in plain PyTorch: ``pad_same``'s form of the pads, the
    excess of each upper pad over the lower filled with −inf (a copy) and
    the lower ones as ``F.max_pool3d``'s symmetric ``padding``; its int64
    indices (into the padded volume, whose lower corner is the input's)
    turned into window offsets."""
    size = x.shape[2:]
    pool_geometry(size, kernel, stride, pad)
    lo = pad[0::2]
    extra: List[int] = []
    for a, b in reversed(list(zip(pad[0::2], pad[1::2]))):
        extra += [0, b - a]  # F.pad takes the last axis first
    padded = F.pad(x, extra, value=float("-inf")) if any(extra) else x
    # NCDHW: aten's channels-last CPU pool leaves the t term out of the
    # index of a window of −inf only, in the channels past its last full
    # vector.
    out, idx = F.max_pool3d(padded.contiguous(), tuple(kernel), tuple(stride), tuple(lo),
                            return_indices=True)
    hp, wp = padded.shape[3:]
    t, rest = idx // (hp * wp), idx % (hp * wp)
    corner = [torch.arange(m, device=x.device) * s - p
              for m, s, p in zip(out.shape[2:], stride, lo)]
    dt = t - corner[0].view(-1, 1, 1)
    dh = rest // wp - corner[1].view(-1, 1)
    dw = rest % wp - corner[2]
    offsets = (dt * kernel[1] + dh) * kernel[2] + dw
    return (out.contiguous(memory_format=torch.channels_last_3d),
            offsets.to(torch.uint8).contiguous(memory_format=torch.channels_last_3d))


def max_pool3d_backward_plain(grad: torch.Tensor, offsets: torch.Tensor, size: Sequence[int],
                              kernel: Sequence[int], stride: Sequence[int],
                              pad: Sequence[int]) -> torch.Tensor:
    """The input's gradient in plain PyTorch: each output gradient added at
    the element its offset names (fp32 sums for a lower precision, one
    rounding), zero where no window's maximum lies."""
    n, c = grad.shape[:2]
    t, h, w = size
    off = offsets.long()
    kt, kh, kw = kernel
    corner = [torch.arange(m, device=grad.device) * s - p
              for m, s, p in zip(grad.shape[2:], stride, pad[0::2])]
    it = corner[0].view(-1, 1, 1) + off // (kh * kw)
    ih = corner[1].view(-1, 1) + off // kw % kh
    iw = corner[2] + off % kw
    flat = ((it * h + ih) * w + iw).reshape(n, c, -1)
    acc = torch.float64 if grad.dtype == torch.float64 else torch.float32
    out = torch.zeros((n, c, t * h * w), dtype=acc, device=grad.device)
    out.scatter_add_(2, flat, grad.reshape(n, c, -1).to(acc))
    return out.view(n, c, t, h, w).to(grad.dtype).contiguous(
        memory_format=torch.channels_last_3d)


def _geom(size, out_size, n: int, c: int, kernel, stride, pad) -> ctypes.Array:
    """The kernels' geometry, int32 [17] (``Geom`` in pool3d.cu); raises
    where a count they form in 32 bits would not fit."""
    t, h, w = size
    ot, oh, ow = out_size
    if max(n * t, n * ot, h * w * c, oh * ow * c) >= _INT32:
        raise ValueError(f"max_pool3d_same: [{n}, {c}, {t}, {h}, {w}] is too large for "
                         f"one launch")
    fields = (n, c, t, h, w, ot, oh, ow, *kernel, *stride, *pad[0::2])
    return (ctypes.c_int * 17)(*fields)


def _vec(name: str, c: int, *tensors: torch.Tensor) -> int:
    """Values a thread moves: 16 bytes' worth (8 bf16, 4 fp32) where that
    divides C and keeps every tensor's accesses aligned, else 4 bf16 (8
    bytes); raises ``ValueError`` where neither holds. Every I3D pool's C,
    and each of its 4-way tensor-parallel shards, is a multiple of 4."""
    for v in (8, 4) if tensors[0].element_size() == 2 else (4,):
        if not (c % v or any(t.data_ptr() % (v * t.element_size()) for t in tensors)):
            return v
    raise ValueError(f"{name}: the kernels take C a multiple of 4 with every tensor aligned "
                     f"to 4 values (16 bytes for fp32), got C = {c} and data at "
                     f"{[t.data_ptr() % 16 for t in tensors]} past a 16-byte boundary")


def _check_cuda(x: torch.Tensor, kernel: Sequence[int], name: str) -> None:
    if tuple(kernel) not in KERNEL_WINDOWS:
        raise ValueError(f"{name}: the kernels take the windows {KERNEL_WINDOWS}, "
                         f"not {tuple(kernel)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: expected bfloat16 or float32, got {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"{name}: expected NCDHW in channels_last_3d memory, got shape "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _launch(fn, name: str, a, b, c, geom, dtype, vec: int, device) -> None:
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), geom, int(dtype == torch.bfloat16),
            vec, device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _forward_kernel(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                    pad: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    name = "max_pool3d_same"
    # The span holds the whole call: checks, allocations and the launch.
    with span(SPAN):
        _check_cuda(x, kernel, name)
        n, c = x.shape[:2]
        out_size = pool_geometry(x.shape[2:], kernel, stride, pad)
        out = _empty((n, c, *out_size), x.dtype, x.device)
        offsets = _empty(out.shape, torch.uint8, x.device)
        if out.numel() == 0:
            return out, offsets
        geom = _geom(x.shape[2:], out_size, n, c, kernel, stride, pad)
        vec = _vec(name, c, x, out, offsets)
        _launch(_lib().asl_max_pool3d_fwd, name, x, out, offsets, geom, x.dtype, vec,
                x.device)
    max_pool3d_same.launches += 1
    return out, offsets


def _backward_kernel(grad: torch.Tensor, offsets: torch.Tensor, size: Sequence[int],
                     kernel: Sequence[int], stride: Sequence[int],
                     pad: Sequence[int]) -> torch.Tensor:
    name = "max_pool3d_same_backward"
    # The span holds the whole call, the pack below included.
    with span(SPAN):
        # The gradient of a pool that feeds a conv is dense; a strided view
        # of one (a slice of a concatenation's gradient) is packed first.
        grad = grad.contiguous(memory_format=torch.channels_last_3d)
        _check_cuda(grad, kernel, name)
        if (offsets.dtype != torch.uint8 or offsets.shape != grad.shape
                or offsets.device != grad.device
                or not offsets.is_contiguous(memory_format=torch.channels_last_3d)):
            raise ValueError(f"{name}: offsets must be uint8 of the gradient's shape "
                             f"{tuple(grad.shape)} in channels_last_3d memory")
        n, c = grad.shape[:2]
        if tuple(grad.shape[2:]) != pool_geometry(size, kernel, stride, pad):
            raise ValueError(f"{name}: a gradient of shape {tuple(grad.shape)} is no output "
                             f"of an input of extents {tuple(size)}")
        grad_in = _empty((n, c, *size), grad.dtype, grad.device)
        if grad_in.numel() == 0:
            return grad_in
        geom = _geom(size, grad.shape[2:], n, c, kernel, stride, pad)
        vec = _vec(name, c, grad, offsets, grad_in)
        _launch(_lib().asl_max_pool3d_bwd, name, grad, offsets, grad_in, geom, grad.dtype,
                vec, grad.device)
    max_pool3d_same_backward.launches += 1
    return grad_in


# The ops join the namespace the preprocess ops define
# (``preprocess_kernels``), as a fragment of it.
_LIB = torch.library.Library("asltpu_torch", "FRAGMENT")
_POOL_ARGS = "int[3] kernel, int[3] stride, int[6] pad"
_LIB.define(f"max_pool3d_same(Tensor x, {_POOL_ARGS}) -> (Tensor, Tensor)")
_LIB.define(f"max_pool3d_same_backward(Tensor grad, Tensor offsets, int[3] size, "
            f"{_POOL_ARGS}) -> Tensor")
_LIB.impl("max_pool3d_same", max_pool3d_plain, "CPU")
_LIB.impl("max_pool3d_same", _forward_kernel, "CUDA")
_LIB.impl("max_pool3d_same_backward", max_pool3d_backward_plain, "CPU")
_LIB.impl("max_pool3d_same_backward", _backward_kernel, "CUDA")


@torch.library.register_fake("asltpu_torch::max_pool3d_same", lib=_LIB)
def _forward_fake(x, kernel, stride, pad):
    shape = (*x.shape[:2], *pool_geometry(x.shape[2:], kernel, stride, pad))
    return _empty(shape, x.dtype, x.device), _empty(shape, torch.uint8, x.device)


@torch.library.register_fake("asltpu_torch::max_pool3d_same_backward", lib=_LIB)
def _backward_fake(grad, offsets, size, kernel, stride, pad):
    return _empty((*grad.shape[:2], *size), grad.dtype, grad.device)


def _setup_context(ctx, inputs, output):
    x, kernel, stride, pad = inputs
    ctx.save_for_backward(output[1])
    ctx.pool = (list(x.shape[2:]), kernel, stride, pad)


def _backward(ctx, grad, _offsets_grad):
    (offsets,) = ctx.saved_tensors
    return max_pool3d_same_backward(grad, offsets, *ctx.pool), None, None, None


torch.library.register_autograd("asltpu_torch::max_pool3d_same", _backward,
                                setup_context=_setup_context, lib=_LIB)


def max_pool3d_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                    pad: Sequence[int]) -> torch.Tensor:
    """Max-pool ``x`` [N, C, T, H, W] over ``kernel`` windows at ``stride``
    with the implicit −inf ``pad`` (t_lo, t_hi, h_lo, h_hi, w_lo, w_hi):
    the first output of the op ``asltpu_torch::max_pool3d_same``, whose
    backward reads its offsets."""
    return torch.ops.asltpu_torch.max_pool3d_same.default(
        x, list(kernel), list(stride), list(pad))[0]


max_pool3d_same.launches = 0


def max_pool3d_same_backward(grad: torch.Tensor, offsets: torch.Tensor, size: Sequence[int],
                             kernel: Sequence[int], stride: Sequence[int],
                             pad: Sequence[int]) -> torch.Tensor:
    """The input's gradient from the output's and the forward's offsets:
    the op ``asltpu_torch::max_pool3d_same_backward``."""
    return torch.ops.asltpu_torch.max_pool3d_same_backward.default(
        grad, offsets, list(size), list(kernel), list(stride), list(pad))


max_pool3d_same_backward.launches = 0
