"""Two-stream RGB + keypoint fusion with cross-attention (config #5):
(clip [B, T, H, W, 3], landmarks [B, T, 543, 3]) → [B, num_classes].
Counterpart of ``asltpu/models/fusion.py``.

The RGB stream is the MobileNetV2 per-frame backbone (tokens = per-frame
features), the keypoint stream embeds normalised 543-landmark frames; N
fusion layers run bidirectional cross-attention (RGB queries attend
keypoint tokens and the other way round), then an MLP per stream; both
streams are mean-pooled, concatenated and classified.

Names are the ones ``asltpu.ckpt.import_two_stream`` reads: ``features.*``
(torchvision's MobileNetV2), ``rgb_proj``, ``kp_proj``, ``pos``, ``fc``,
``fusion.{i}.{a_from_b,b_from_a}_{lnq,lnkv,attn}`` and
``fusion.{i}.{a,b}_mlp_{ln,fc1,fc2}``. Every op rounds where flax's does
(the helpers of :mod:`asltpu_torch.models.temporal`): the model computes
in ``dtype`` (None: the dtype of its weights; bf16 under the config's
default) with fp32 LayerNorms, BatchNorms and ``fc``. It trains as the JAX
model does (``forward(clip, landmarks, train=True, generator=g)``):
BatchNorm on the batch's statistics, and dropout from ``g`` on each
attention's weights, after each attention and each MLP, and on the pooled
features.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from asltpu_torch.config import LANDMARK_DIM, NUM_LANDMARKS
from asltpu_torch.models.bilstm import normalize_landmarks
from asltpu_torch.models.common import Dropout, cast, per_frame
from asltpu_torch.models.mobilenetv2 import MobileNetV2
from asltpu_torch.models.temporal import _dense, _gelu, _layer_norm, attention


class CrossAttentionBlock(nn.Module):
    """Pre-LN bidirectional cross-attention between two token streams:
    a + attn(lnq(a), lnkv(b)) and b + attn(lnq(b), lnkv(a)) (the residual
    adds the un-normalised input), then x + fc2(gelu(fc1(ln(x)))) per
    stream, with the exact (erf) GELU. It computes in its inputs' dtype.
    Under tensor parallelism (:mod:`asltpu_torch.dist.tp`) its two
    ``*_attn`` shard by heads; the MLPs (``*_fc1``, ``*_fc2``) stay whole."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        for name in ("a_from_b", "b_from_a"):
            self.add_module(f"{name}_lnq", nn.LayerNorm(d_model, eps=1e-5))
            self.add_module(f"{name}_lnkv", nn.LayerNorm(d_model, eps=1e-5))
            self.add_module(f"{name}_attn", nn.MultiheadAttention(
                d_model, num_heads, dropout=dropout, batch_first=True))
        for name in ("a_mlp", "b_mlp"):
            self.add_module(f"{name}_ln", nn.LayerNorm(d_model, eps=1e-5))
            self.add_module(f"{name}_fc1", nn.Linear(d_model, 4 * d_model))
            self.add_module(f"{name}_fc2", nn.Linear(4 * d_model, d_model))
        self.dropout = Dropout(dropout)

    def _xattn(self, q_in: torch.Tensor, kv_in: torch.Tensor, name: str, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        q = _layer_norm(q_in, getattr(self, f"{name}_lnq"))
        kv = _layer_norm(kv_in, getattr(self, f"{name}_lnkv"))
        y = attention(getattr(self, f"{name}_attn"), q, kv, train, generator)
        return q_in + self.dropout(y, train, generator)

    def _mlp(self, x: torch.Tensor, name: str, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        y = _layer_norm(x, getattr(self, f"{name}_ln"))
        y = _dense(_gelu(_dense(y, getattr(self, f"{name}_fc1"))),
                   getattr(self, f"{name}_fc2"))
        return x + self.dropout(y, train, generator)

    def forward(self, a: torch.Tensor, b: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a2 = self._xattn(a, b, "a_from_b", train, generator)  # RGB attends keypoints
        b2 = self._xattn(b, a, "b_from_a", train, generator)  # keypoints attend RGB
        return (self._mlp(a2, "a_mlp", train, generator),
                self._mlp(b2, "b_mlp", train, generator))


class TwoStreamFusion(nn.Module):
    """(clip [B, T, H, W, 3], landmarks [B, T, 543, 3]) → [B, num_classes].

    :meth:`backbone` (MobileNetV2 over the B·T frames) and :meth:`fuse`
    (both streams' tokens, the fusion layers and ``fc``) split
    :meth:`forward` in two. ``pos`` has ``num_frames`` rows: the clip's and
    the landmarks' T."""

    def __init__(self, num_classes: int = 100, num_frames: int = 16,
                 d_model: int = 256, num_heads: int = 8,
                 num_fusion_layers: int = 2, dropout: float = 0.1,
                 width_mult: float = 1.0, num_landmarks: int = NUM_LANDMARKS,
                 landmark_dim: int = LANDMARK_DIM, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.features = MobileNetV2(width_mult)
        self.rgb_proj = nn.Linear(self.features.out_features, d_model)
        self.kp_proj = nn.Linear(num_landmarks * landmark_dim, d_model)
        self.pos = nn.Parameter(torch.zeros(1, num_frames, d_model))
        self.fusion = nn.ModuleList(
            CrossAttentionBlock(d_model, num_heads, dropout)
            for _ in range(num_fusion_layers))
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(2 * d_model, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``pos``, truncated normal at ±2 std (flax's
        ``truncated_normal(0.02)``); the submodules initialise themselves."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)

    def _dtype(self) -> torch.dtype:
        return self.dtype or self.rgb_proj.weight.dtype

    def backbone(self, clip: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, H, W, 3] → per-frame features [B, T, 1280]."""
        return per_frame(functools.partial(self.features, train=train), clip, self._dtype())

    def fuse(self, rgb: torch.Tensor, landmarks: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-frame features [B, T, F] and landmarks [B, T, 543, 3] →
        logits [B, num_classes] fp32."""
        dtype = self._dtype()
        b, t = rgb.shape[:2]
        rgb = _dense(cast(rgb, dtype), self.rgb_proj)
        kp = _dense(normalize_landmarks(landmarks).reshape(b, t, -1).to(dtype),
                    self.kp_proj)
        pos = cast(self.pos, dtype)
        rgb, kp = rgb + pos, kp + pos
        for block in self.fusion:
            rgb, kp = block(rgb, kp, train, generator)
        pooled = cast(torch.cat([rgb.mean(dim=1), kp.mean(dim=1)], dim=-1),
                      self.fc.weight.dtype)
        return self.fc(self.dropout(pooled, train, generator))

    def forward(self, clip: torch.Tensor, landmarks: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t = clip.shape[:2]
        if tuple(landmarks.shape[:2]) != (b, t):
            # reshape(b, t, -1) would succeed whenever T_lm·1629 divides by
            # t and surface as a kp_proj shape mismatch.
            raise ValueError(
                f"landmarks [B,T]={tuple(landmarks.shape[:2])} must match "
                f"clip [B,T]=({b}, {t}) — resample landmarks to the clip's "
                "frame sampling (e.g. LandmarkStore.get / aligned decode)"
            )
        return self.fuse(self.backbone(clip, train), landmarks, train, generator)
