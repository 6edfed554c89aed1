"""TimeSformer-HR (config ``timesformer``): a clip [B, T, H, W, 3] →
[B, num_classes] logits by divided space–time attention. The port's own
family: the JAX package has no counterpart.

Architecture: Bertasius, Wang and Torresani, "Is Space-Time Attention All
You Need for Video Understanding?" (ICML 2021), as
facebookresearch/TimeSformer's ``timesformer/models/vit.py`` writes it
(``VisionTransformer`` with ``attention_type='divided_space_time'``), and
under its parameter names (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``time_embed``, ``blocks.<i>.temporal_attn.qkv``, ``norm``,
``head``, …). A 16×16 patch conv per frame; the CLS token and ``pos_embed``
added per frame, ``time_embed`` to the patch tokens; then each block runs
three sub-layers, each a pre-LayerNorm residual branch with stochastic
depth:

1. temporal attention: each patch position over its own T frames (the CLS
   token left out), then ``temporal_fc``;
2. spatial attention: each frame's patches with a copy of the CLS token,
   whose T outputs are averaged;
3. the MLP (exact GELU), on every token.

The head is the final LayerNorm and a linear layer on the CLS token.

Layout: the patch tokens of a clip are [B, (h w t), d], the reference's
order, t innermost, and the CLS token [B, 1, d] travels beside them: every
sub-layer but spatial attention is per token. Temporal attention's
sequences [(B h w), t, d] are then a view of the tokens; spatial
attention's [(B t), 1 + h w, d] are one copy, which also puts each frame's
copy of the CLS token in front. Both hand their packed q/k/v projection to
:func:`asltpu_torch.ops.attention.attention`, which chooses the kernel.

Precision: the compute dtype is ``dtype`` (None: the patch conv's weight
dtype); fp32 masters are cast inside each layer; every LayerNorm
normalises in fp32 and rounds once; the head reads the final LayerNorm's
fp32 output with fp32 weights.

Training (``forward(clip, train=True, generator=g)``): stochastic depth at
``drop_path_rate · i / (depth − 1)`` in block i, drawn from ``g`` with
:func:`~asltpu_torch.models.common.batch_rand` (block 0 draws nothing), one
draw a sub-layer over the first axis of its branch: [B·h·w] for temporal
attention, [B·T] for spatial attention, [B] for the MLP.

Spans: each attention sub-layer, from its LayerNorm to its residual add,
runs inside ``timesformer.time_attn`` or ``timesformer.space_attn``, its
backward too (:func:`~asltpu_torch.models.common.sublayer`)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.common import (cast, conv2d, drop_path, keep_mask, layer_norm, linear,
                                        sublayer)
from asltpu_torch.ops.attention import attention

TIME_SPAN = "timesformer.time_attn"
SPACE_SPAN = "timesformer.space_attn"
LN_EPS = 1e-6


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)


class Attention(nn.Module):
    """Multi-head self-attention with a packed, biased q/k/v projection
    (``qkv``, rows q; k; v) and an output projection (``proj``); the
    packed projection goes whole to :func:`attention`."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, L, d] → [N, L, d] in the dtype of ``x``."""
        return linear(attention(linear(x, self.qkv), self.num_heads), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    """One divided space–time block over the CLS token [B, 1, d] and the
    patch tokens [B, (h w t), d] of T frames; ``drop_path`` its stochastic
    depth rate."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.temporal_attn = Attention(dim, num_heads)
        self.temporal_fc = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.drop_path = drop_path

    def temporal(self, x: torch.Tensor, t: int, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x + temporal_fc(drop_path(temporal_attn(temporal_norm1(x)))),
        each patch position attending over its T frames."""
        b, n, d = x.shape
        y = layer_norm(x, self.temporal_norm1).view(b * n // t, t, d)
        y = self.temporal_attn(y)
        y = drop_path(y, keep_mask(y.shape[0], self.drop_path, train, generator, x.device),
                      self.drop_path)
        return x + linear(y.view(b, n, d), self.temporal_fc)

    def spatial(self, cls: torch.Tensor, x: torch.Tensor, t: int, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each frame's patches and a copy of the CLS token through
        attn(norm1(·)) with stochastic depth per frame; the patches' outputs
        added to x, the CLS copies' outputs averaged over the frames and
        added to the CLS token."""
        b, n, d = x.shape
        hw = n // t
        y = torch.cat([layer_norm(cls, self.norm1).view(b, 1, 1, d).expand(b, t, 1, d),
                       layer_norm(x, self.norm1).view(b, hw, t, d).transpose(1, 2)], dim=2)
        y = self.attn(y.view(b * t, hw + 1, d))
        y = drop_path(y, keep_mask(b * t, self.drop_path, train, generator, x.device),
                      self.drop_path).view(b, t, hw + 1, d)
        cls = cls + y[:, :, :1].mean(dim=1)
        x = (x.view(b, hw, t, d) + y[:, :, 1:].transpose(1, 2)).reshape(b, n, d)
        return cls, x

    def forward(self, cls: torch.Tensor, x: torch.Tensor, t: int, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        (x,) = sublayer(TIME_SPAN, lambda x: (self.temporal(x, t, train, generator),), x)
        cls, x = sublayer(SPACE_SPAN, lambda c, x: self.spatial(c, x, t, train, generator),
                          cls, x)
        # The MLP is per token: the CLS token and the patches each take it,
        # under one stochastic-depth draw a clip.
        keep = keep_mask(x.shape[0], self.drop_path, train, generator, x.device)
        cls, x = (z + drop_path(self.mlp(layer_norm(z, self.norm2)), keep, self.drop_path)
                  for z in (cls, x))
        return cls, x


class TimeSformer(nn.Module):
    """TimeSformer with divided space–time attention: [B, T, H, W, 3]
    preprocessed NHWC clip → logits [B, num_classes] (fp32). ``pos_embed``
    has (H / patch)² + 1 rows, ``time_embed`` ``num_frames``."""

    def __init__(self, num_classes: int = 2000, num_frames: int = 16, img_size: int = 448,
                 patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4, drop_path_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch_size) ** 2 + 1,
                                                  embed_dim))
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, embed_dim))
        rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, r) for r in rates)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The original's initialisation (``vit.py``): linears truncated
        normal (std 0.02, ±2 std) with zero biases, ``cls_token`` and
        ``pos_embed`` the same, ``time_embed`` 0, LayerNorms the identity,
        and ``temporal_fc`` 0 in every block but the first. The patch conv
        is drawn as :func:`~asltpu_torch.models.common.init_weights` draws
        every conv: kaiming-normal over fan-out, zero bias."""
        with torch.no_grad():
            conv = self.patch_embed.proj
            fan_out = conv.out_channels * math.prod(conv.kernel_size)
            conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            conv.bias.zero_()
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                          generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
            for p in (self.cls_token, self.pos_embed):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
            self.time_embed.zero_()
            for blk in self.blocks[1:]:
                blk.temporal_fc.weight.zero_()
                blk.temporal_fc.bias.zero_()

    def tokens(self, clip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedded clip: the CLS token [B, 1, d] and the patch tokens
        [B, (h w t), d], in the compute dtype."""
        dtype = self.dtype or self.patch_embed.proj.weight.dtype
        b, t, height, width = clip.shape[:4]
        frames = cast(clip.reshape(b * t, height, width, 3).permute(0, 3, 1, 2), dtype)
        x = conv2d(self.patch_embed.proj, frames).flatten(2).transpose(1, 2)  # [(B t), hw, d]
        hw, d = x.shape[1:]
        pos = cast(self.pos_embed, dtype)
        if pos.shape[1] != hw + 1:
            raise ValueError(f"pos_embed holds {pos.shape[1] - 1} patch positions, the clip "
                             f"gives {hw} ({height}x{width} frames, patch {self.patch_size})")
        x = (x + pos[:, 1:]).view(b, t, hw, d).transpose(1, 2) + cast(self.time_embed, dtype)
        cls = (cast(self.cls_token, dtype) + pos[:, :1]).expand(b, 1, d)
        return cls, x.reshape(b, hw * t, d)

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        t = clip.shape[1]
        if t != self.time_embed.shape[1]:
            raise ValueError(f"time_embed holds {self.time_embed.shape[1]} frames, the clip "
                             f"has {t}")
        cls, x = self.tokens(clip)
        for blk in self.blocks:
            cls, x = blk(cls, x, t, train, generator)
        cls = F.layer_norm(cls[:, 0].float(), self.norm.normalized_shape, self.norm.weight,
                           self.norm.bias, self.norm.eps)
        return F.linear(cast(cls, self.head.weight.dtype), self.head.weight, self.head.bias)
