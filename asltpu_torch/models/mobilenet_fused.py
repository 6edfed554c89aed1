"""Fused-inference MobileNetV2 backbone: the parameters and running
statistics of :class:`asltpu_torch.models.mobilenetv2.MobileNetV2`, with the
12 stride-1 expanded inverted-residual blocks (at full width) run through
the fused MBConv kernel (:func:`asltpu_torch.ops.mbconv_kernels.
fused_mbconv_s1`), so their expanded activations never touch device memory.
The stem, the stride-2 blocks, the t=1 block and the head stay plain convs.
Counterpart of ``asltpu/models/mobilenet_fused.py``.

BN is folded at call time from the module's live parameters and statistics,
in fp32 (inference semantics). The plain convs round as the JAX package's
do: a bf16 conv, then a bf16 bias add, then ReLU6.

``load_model`` does not use this path: it is an entry point of its own,
as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.mobilenetv2 import _INVERTED_RESIDUAL_SCHEDULE
from asltpu_torch.ops.mbconv_kernels import fold_bn, fused_mbconv_s1


@torch.no_grad()
def _folded(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv weight ``[O, I, kh, kw]`` and BN → folded fp32 weight (same
    layout) and bias."""
    w, b = fold_bn(
        conv.weight.float().movedim(0, -1), bn.weight.float(), bn.bias.float(),
        bn.running_mean.float(), bn.running_var.float(), bn.eps)
    return w.movedim(-1, 0), b


def _conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
             relu6: bool = True) -> torch.Tensor:
    """Plain conv + folded BN (+ ReLU6) on NHWC bf16, torch-style ``k//2``
    padding: the conv rounds to bf16, then the bf16 bias is added."""
    w, b = _folded(conv, bn)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.bfloat16), w.to(torch.bfloat16),
                 None, conv.stride, conv.kernel_size[0] // 2, 1, conv.groups)
    y = y.permute(0, 2, 3, 1) + b.to(torch.bfloat16)
    return torch.clamp(y, 0.0, 6.0) if relu6 else y


def _plain_block(x: torch.Tensor, block: nn.Module, stride: int,
                 expand_ratio: int) -> torch.Tensor:
    """Unfused inverted residual (the stride-2 blocks and the t=1 block)."""
    layers = list(block.conv)
    y = x
    if expand_ratio != 1:
        expand = layers.pop(0)
        y = _conv_bn(y, expand[0], expand[1])
    depthwise, project, project_bn = layers
    y = _conv_bn(y, depthwise[0], depthwise[1])
    y = _conv_bn(y, project, project_bn, relu6=False)
    if stride == 1 and x.shape[-1] == y.shape[-1]:
        y = x + y
    return y


def fused_block_args(block: nn.Module) -> Tuple[torch.Tensor, ...]:
    """An expanded ``InvertedResidual`` → the fused kernel's folded fp32
    ``(w1 [Cin,Ce], b1, dw [3,3,Ce], b2, w2 [Ce,Cout], b3)``, contiguous."""
    expand, depthwise, project, project_bn = block.conv
    w1, b1 = _folded(expand[0], expand[1])      # [Ce, Cin, 1, 1]
    dw, b2 = _folded(depthwise[0], depthwise[1])  # [Ce, 1, 3, 3]
    w2, b3 = _folded(project, project_bn)       # [Cout, Ce, 1, 1]
    return (w1[:, :, 0, 0].t().contiguous(), b1,
            dw[:, 0].permute(1, 2, 0).contiguous(), b2,
            w2[:, :, 0, 0].t().contiguous(), b3)


def _fused_block(x: torch.Tensor, block: nn.Module) -> torch.Tensor:
    """The residual applies when Cin == Cout (the wrapper's own gate)."""
    return fused_mbconv_s1(x.contiguous(), *fused_block_args(block))


def fused_layers(backbone: nn.Module) -> List[Callable[[torch.Tensor], torch.Tensor]]:
    """The fused path's 19 layers in order, each NHWC → NHWC bf16 and the
    twin of ``backbone[i]``: the stem, the 17 inverted residuals (dispatched
    as the JAX function does: stride 1 and t ≠ 1 fused, the rest plain),
    the head."""
    layers = [functools.partial(_conv_bn, conv=backbone[0][0], bn=backbone[0][1])]
    idx = 1
    for t, _, n, st in _INVERTED_RESIDUAL_SCHEDULE:
        for i in range(n):
            stride = st if i == 0 else 1
            if stride == 1 and t != 1:
                layers.append(functools.partial(_fused_block, block=backbone[idx]))
            else:
                layers.append(functools.partial(
                    _plain_block, block=backbone[idx], stride=stride, expand_ratio=t))
            idx += 1
    layers.append(functools.partial(_conv_bn, conv=backbone[idx][0], bn=backbone[idx][1]))
    return layers


def fused_backbone_apply(backbone: nn.Module, frames: torch.Tensor) -> torch.Tensor:
    """NHWC frames ``[N, H, W, 3]`` → pooled features ``[N, 1280·w]`` bf16:
    the fused-inference twin of ``backbone(frames.permute(0, 3, 1, 2))``."""
    with torch.inference_mode():
        x = frames.to(torch.bfloat16)
        for layer in fused_layers(backbone):
            x = layer(x)
        return x.mean(dim=(1, 2))
