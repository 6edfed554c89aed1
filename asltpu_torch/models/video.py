"""End-to-end video classifier: per-frame MobileNetV2 + GRU head. Counterpart
of ``asltpu/models/video.py::MobileNetV2GRU``. The (B, T) axes fold into one
batch for the backbone."""

from __future__ import annotations

import torch

from asltpu_torch.models.common import merge_time_into_batch, split_time_from_batch
from asltpu_torch.models.mobilenetv2 import MobileNetV2
from asltpu_torch.models.temporal import GRUHead


class MobileNetV2GRU(GRUHead):
    """Config #2: MobileNetV2 per-frame features + GRU head (north star).

    It is a :class:`GRUHead` with the backbone as ``features`` in front, so
    its state dict has torchvision's ``features.*`` beside ``gru.*`` and
    ``fc.*`` — the names ``asltpu.ckpt.load_torch_checkpoint`` reads. The
    backbone runs in the dtype of its parameters (bf16 by default, set by
    ``asltpu_torch.api.load_model``) and the head in fp32.
    """

    def __init__(self, num_classes: int = 100, width_mult: float = 1.0,
                 gru_hidden: int = 512, gru_layers: int = 1,
                 dropout: float = 0.2):
        features = MobileNetV2(width_mult)
        super().__init__(num_classes, features.out_features, gru_hidden,
                         gru_layers, dropout)
        self.features = features

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        frames, bt = merge_time_into_batch(clip)
        dtype = self.features[0][0].weight.dtype
        # NHWC → NCHW view: channels_last strides, no copy.
        x = frames.permute(0, 3, 1, 2).to(dtype)
        feats = split_time_from_batch(self.features(x), bt)  # [B, T, 1280]
        return super().forward(feats)
