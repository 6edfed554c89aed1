"""End-to-end video classifiers: a per-frame 2D backbone + a temporal head.
Counterparts of ``asltpu/models/video.py::MobileNetV2GRU`` and
``::ResNet18Transformer``. The (B, T) axes fold into one batch for the
backbone.

Each computes in ``dtype`` (None: the dtype of its conv weights, as a
model cast by ``cast_for_compute`` has them; ``build_module`` passes the
config's ``compute_dtype``, bf16 by default) and trains as the JAX model
does: ``forward(clip, train=True, generator=g)`` runs BatchNorm on the
batch's statistics with flax's update of the running ones and draws every
dropout from ``g``; ``nn.Module.training`` plays no part.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from asltpu_torch.models.common import per_frame
from asltpu_torch.models.mobilenetv2 import MobileNetV2
from asltpu_torch.models.resnet import ResNet18
from asltpu_torch.models.temporal import GRUHead, TransformerHead


class MobileNetV2GRU(GRUHead):
    """Config #2: MobileNetV2 per-frame features + GRU head (north star).

    It is a :class:`GRUHead` with the backbone as ``features`` in front, so
    its state dict has torchvision's ``features.*`` beside ``gru.*`` and
    ``fc.*`` — the names ``asltpu.ckpt.load_torch_checkpoint`` reads. The
    backbone runs in the compute dtype and the head in fp32.
    """

    def __init__(self, num_classes: int = 100, width_mult: float = 1.0,
                 gru_hidden: int = 512, gru_layers: int = 1,
                 dropout: float = 0.2, dtype: Optional[torch.dtype] = None):
        features = MobileNetV2(width_mult)
        super().__init__(num_classes, features.out_features, gru_hidden,
                         gru_layers, dropout)
        self.features = features
        self.dtype = dtype

    def backbone(self, clip: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → features [B, T, 1280]."""
        dtype = self.dtype or self.features[0][0].weight.dtype
        return per_frame(functools.partial(self.features, train=train), clip, dtype)

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        return super().forward(self.backbone(clip, train), train, generator)


class ResNet18Transformer(ResNet18):
    """Config #3: ResNet-18 per-frame features + 4-layer transformer head.

    It is a :class:`ResNet18` with the head as ``head``, so its state dict
    has torchvision's ResNet-18 names at the top level beside ``head.*`` —
    the names ``asltpu.ckpt.load_torch_checkpoint`` reads. ``num_frames``
    sizes the head's positions (the clip's T).
    """

    def __init__(self, num_classes: int = 300, num_frames: int = 32,
                 d_model: int = 512, num_heads: int = 8, num_tx_layers: int = 4,
                 mlp_ratio: int = 4, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.head = TransformerHead(num_classes, self.out_features, num_frames,
                                    d_model, num_heads, num_tx_layers, mlp_ratio,
                                    dropout, dtype)

    def backbone(self, clip: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → features [B, T, 512]."""
        dtype = self.dtype or self.conv1.weight.dtype
        return per_frame(functools.partial(super().forward, train=train), clip, dtype)

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        return self.head(self.backbone(clip, train), train, generator)
