"""Shared building blocks: ``ConvBN``, seeded initialisation, the cast to
the compute dtype, and merging time into the batch. Counterpart of
``asltpu/models/common.py``."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.temporal import TransformerHead
from asltpu_torch.ops.recurrent import GRU

# Normalisation layers keep fp32 parameters and statistics under any compute
# dtype, as flax's ``param_dtype=float32`` does: they take the low-precision
# input, normalise in fp32 and round once.
NORMS = (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)


relu6 = nn.ReLU6


class ConvBN(nn.Sequential):
    """Conv → BatchNorm → ReLU6, laid out as torchvision's
    ``Conv2dNormActivation``: child ``0`` the conv, ``1`` the BN, ``2`` the
    activation. Padding is torch-style symmetric ``k//2`` (the JAX
    package's default), BN eps 1e-5 and torch momentum 0.1 (flax 0.9).
    Every ConvBN of MobileNetV2 ends in ReLU6; its linear project conv is
    a plain conv + BN in torchvision's layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                      groups=groups, bias=False),
            nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            relu6(),
        )


def same_pads(lengths: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> List[Tuple[int, int]]:
    """TF/flax "SAME" padding, (lo, hi) per axis: the output has
    ``ceil(L / s)`` positions, the total pad is ``max((out − 1)·s + k − L,
    0)`` and the lower side takes ``total // 2``. At stride 2 it is
    asymmetric, which torch's ``padding=`` cannot express."""
    pads = []
    for n, k, s in zip(lengths, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``x`` [N, C, *spatial] made ready for a "SAME" conv (``value`` 0) or
    max-pool (``value`` −inf) of ``kernel`` and ``stride``: returns
    ``(x, padding)`` for the op's own symmetric ``padding=``. SAME's upper
    pad exceeds the lower by 0 or 1; where it is 1 on some axis, ``x`` is
    padded there with ``value`` first (a copy), else it is returned as
    is."""
    pads = same_pads(x.shape[2:], kernel, stride)
    extra: List[int] = []
    for lo, hi in reversed(pads):
        extra += [0, hi - lo]  # F.pad takes the last axis first
    if any(extra):
        x = F.pad(x, extra, value=value)
    return x, tuple(lo for lo, _ in pads)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialisation, in place: convs (2D and 3D)
    kaiming-normal over fan-out with a zero bias where they have one, BN as
    identity (torchvision's MobileNetV2 and ResNet),
    linears as ``nn.Linear``'s default, LayerNorm as identity, attention's
    packed q/k/v projection as ``nn.MultiheadAttention``'s (Xavier-uniform,
    zero bias), GRUs and LSTMs U(-1/√H, 1/√H), the transformer's CLS token
    and positions truncated-normal (std 0.02), the fusion model's positions
    too."""
    from asltpu_torch.models.fusion import TwoStreamFusion  # it imports this module

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                fan_out = m.out_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, NORMS):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.MultiheadAttention):
                nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (GRU, TransformerHead, TwoStreamFusion)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LSTM):
                k = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-k, k, generator=generator)


def cast_for_compute(module: nn.Module, dtype: torch.dtype,
                     keep_fp32: Iterable[nn.Module] = ()) -> nn.Module:
    """Cast ``module``'s parameters (convs, linears, attention, the CLS
    token and positions) to ``dtype`` in place, except those of every
    BatchNorm2d, BatchNorm3d and LayerNorm and of the submodules in
    ``keep_fp32``: those
    parameters and the norms' running statistics stay fp32. Names are
    unchanged, and a later ``load_state_dict`` keeps each tensor's dtype."""
    keep = set()
    for m in keep_fp32:
        keep.update(m.modules())
    for m in module.modules():
        if isinstance(m, NORMS) or m in keep:
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def merge_time_into_batch(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, T, ...] → ([B·T, ...], (B, T)) — the per-frame backbone runs all
    frames as one large batch."""
    b, t = x.shape[:2]
    return x.reshape((b * t,) + tuple(x.shape[2:])), (b, t)


def split_time_from_batch(x: torch.Tensor, bt: Tuple[int, int]) -> torch.Tensor:
    b, t = bt
    return x.reshape((b, t) + tuple(x.shape[1:]))


def per_frame(backbone, clip: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, T, H, W, 3] NHWC clip → [B, T, F] features of the per-frame
    ``backbone`` (NCHW frames → [N, F]) run in ``dtype``."""
    frames, bt = merge_time_into_batch(clip)
    # NHWC → NCHW view: channels_last strides, no copy.
    return split_time_from_batch(backbone(frames.permute(0, 3, 1, 2).to(dtype)), bt)
