"""ResNet-18 backbone: per-frame feature extractor in torchvision's
``resnet18`` layout, without its classifier. Counterpart of
``asltpu/models/resnet.py``.

Architecture: He et al., "Deep Residual Learning" (CVPR 2016) — 7×7
stride-2 stem, 3×3 stride-2 max pool, four stages of two BasicBlocks
(64/128/256/512), global average pool → 512.

The names are torchvision's (``conv1``, ``bn1``, ``layer{s}.{b}.conv1/bn1/
conv2/bn2``, ``layer{s}.{b}.downsample.0/.1``), the ones
``asltpu.ckpt.import_resnet18`` reads. The module takes NCHW input; the port
runs it in ``torch.channels_last`` memory. It computes in the dtype of its
input (each conv casts its weight to it; BatchNorm keeps fp32 parameters
and normalises in fp32) and trains as flax's does (``forward(x,
train=True)``: BatchNorm through
:func:`asltpu_torch.models.common.batch_norm`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.common import batch_norm, conv2d

_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (width, first stride)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + identity); the identity goes
    through a 1×1 conv + BN (``downsample``) when the stride or the width
    changes. Padding is torch-style ``k//2``."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = _bn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = _bn(out_ch)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))
            if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        y = batch_norm(self.bn2, conv2d(self.conv2, y), train)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = batch_norm(bn, conv2d(conv, x), train)
        return F.relu(y + identity)


class ResNet18(nn.Module):
    """[N, 3, H, W] → pooled per-image features [N, 512] (no classifier —
    the temporal head classifies), in the dtype of the input."""

    out_features = 512

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        in_ch = 64
        for s, (ch, stride) in enumerate(_STAGES):
            setattr(self, f"layer{s + 1}", nn.Sequential(
                BasicBlock(in_ch, ch, stride), BasicBlock(ch, ch, 1)))
            in_ch = ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        # max_pool2d pads with −inf, as flax's max_pool does.
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(len(_STAGES)):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, train)
        return x.mean(dim=(2, 3))  # global average pool
