"""Plain operations the references share: the device half of preprocess,
BatchNorm, and the rounding of a lower precision that the controls use.

Plain PyTorch, float32 with TF32 off, written from the published
descriptions. Nothing here imports the program under test."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """float32 matmuls and convolutions without TF32, whatever the process
    had set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _int8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to symmetric int8 under a per-tensor scale (127 at its
    largest magnitude), in ``x``'s dtype."""
    scale = 127.0 / x.abs().amax().clamp(min=1e-30)
    return torch.round(x * scale).clamp(-127, 127) / scale


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    puts its largest magnitude at the format's largest, in ``x``'s dtype."""
    scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


ROUND = {"fp8": (lambda x: _fp8(x, torch.float8_e4m3fn), lambda g: _fp8(g, torch.float8_e5m2)),
         "int8": (_int8, _int8), "bf16": (_bf16, _bf16)}


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded as ``precision`` rounds the
    backward operands (float8 e5m2, int8 or bfloat16)."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ROUND[ctx.precision][1](grad), None


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A convolution's or matmul's operand in ``precision``: "fp32" as it
    is; "fp8" rounded to float8 e4m3, "int8" to int8, each under a
    per-tensor scale, "bf16" to bfloat16 (a witness, not a control), the
    gradient passing straight through."""
    if precision == "fp32":
        return x
    q = ROUND[precision][0](x.detach())
    return x + (q - x.detach())


def output(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A convolution's output in ``precision``: below fp32 the gradient
    that reaches it is rounded (float8 e5m2, or int8), so that its backward
    products take the low-precision operands its forward ones do."""
    if precision == "fp32" or not y.requires_grad:
        return y
    return _RoundGrad.apply(y, precision)


def crop_normalize(frames_u8: torch.Tensor, pp: dict) -> torch.Tensor:
    """Staged uint8 frames [B, T, Hs, Ws, 3] → float32 [B, T, 3, crop, crop]:
    the short-side resize (the identity at the configurations here, which
    stage at the resize size), the centre crop, x / 255, (x − mean) / std."""
    b, t, hs, ws, _ = frames_u8.shape
    if min(hs, ws) != pp["resize_short"]:
        raise ValueError(f"the reference resizes only where staging already has the short "
                         f"side {pp['resize_short']}; got {hs}x{ws}")
    crop = pp["crop"]
    y0, x0 = (hs - crop) // 2, (ws - crop) // 2
    x = frames_u8[:, :, y0:y0 + crop, x0:x0 + crop].to(torch.float32) / 255.0
    mean = torch.tensor(pp["mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(pp["std"], dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 1, 4, 2, 3)


def batch_norm(x: torch.Tensor, params: Params, name: str, eps: float, mode: str) -> torch.Tensor:
    """BatchNorm over every axis but the channels (axis 1).

    ``mode``: "infer" normalises by the running statistics, "train" by the
    batch's mean and biased variance."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if mode == "infer":
        mean, var = params[f"{name}.running_mean"], params[f"{name}.running_var"]
    elif mode == "train":
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    inv = torch.rsqrt(var + eps) * params[f"{name}.weight"]
    return (x - mean.view(shape)) * inv.view(shape) + params[f"{name}.bias"].view(shape)


def tf_same_pads(lengths: Sequence[int], kernel: Sequence[int],
                 stride: Sequence[int]) -> list:
    """TensorFlow's "SAME" padding per axis as (lo, hi): ceil(L / s) outputs,
    the total pad max((out − 1)·s + k − L, 0), the lower side its half
    rounded down."""
    pads = []
    for n, k, s in zip(lengths, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """``x`` [N, C, *spatial] padded for a "SAME" window of ``kernel`` and
    ``stride``."""
    flat = []
    for lo, hi in reversed(tf_same_pads(x.shape[2:], kernel, stride)):
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x
