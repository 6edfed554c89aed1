"""MobileNetV2 backbone: per-frame feature extractor in torchvision's
``mobilenet_v2().features`` layout. Counterpart of
``asltpu/models/mobilenetv2.py``.

Architecture: Sandler et al., "MobileNetV2: Inverted Residuals and Linear
Bottlenecks" (CVPR 2018) — stem conv, 17 inverted-residual blocks with the
standard (t, c, n, s) schedule, 1×1 head conv to 1280, global average pool.

Children ``0`` (stem) … ``17`` (blocks) and ``18`` (head) carry the
torchvision names, so a torchvision-layout state dict loads with
``load_state_dict``. The module takes NCHW input; the port runs it in
``torch.channels_last`` memory, which the preprocess output already is
after ``permute(0, 3, 1, 2)``. It computes in the dtype of its input
(each conv casts its weight to it) and trains as flax's does
(``forward(x, train=True)``: BatchNorm through
:func:`asltpu_torch.models.common.batch_norm`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from asltpu_torch.models.common import ConvBN, batch_norm, conv2d

# (expand_ratio, out_channels, num_blocks, first_stride)
_INVERTED_RESIDUAL_SCHEDULE: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding rule from the reference implementation of the paper."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """``conv`` = [expand ConvBN (if expand_ratio != 1), depthwise ConvBN,
    project conv, project BN], plus the residual when the block keeps its
    shape."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBN(in_ch, hidden, kernel=1))
        layers += [
            ConvBN(hidden, hidden, kernel=3, stride=stride, groups=hidden),
            nn.Conv2d(hidden, out_ch, 1, bias=False),
            nn.BatchNorm2d(out_ch),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        *convbns, project, project_bn = self.conv
        y = x
        for layer in convbns:
            y = layer(y, train)
        y = batch_norm(project_bn, conv2d(project, y), train)
        return x + y if self.use_res else y


class MobileNetV2(nn.Sequential):
    """[N, 3, H, W] → pooled per-image features [N, 1280·max(1, width)]
    (no classifier — the temporal head classifies)."""

    def __init__(self, width_mult: float = 1.0):
        stem_ch = _make_divisible(32 * width_mult)
        layers = [ConvBN(3, stem_ch, kernel=3, stride=2)]
        in_ch = stem_ch
        for t, c, n, s in _INVERTED_RESIDUAL_SCHEDULE:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                layers.append(
                    InvertedResidual(in_ch, out_ch, s if i == 0 else 1, t))
                in_ch = out_ch
        head_ch = _make_divisible(1280 * max(1.0, width_mult))
        layers.append(ConvBN(in_ch, head_ch, kernel=1))
        super().__init__(*layers)
        self.out_features = head_ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self:
            x = layer(x, train)
        return x.mean(dim=(2, 3))  # global average pool
