"""Video Swin Transformer (config ``video_swin``): a clip [B, T, H, W, 3] →
[B, num_classes] logits by 3D shifted-window attention. The port's own
family: the JAX package has no counterpart.

Architecture: Liu et al., "Video Swin Transformer" (CVPR 2022), as
SwinTransformer/Video-Swin-Transformer's
``mmaction/models/backbones/swin_transformer.py`` writes it
(``SwinTransformer3D`` with ``patch_norm=True``), with the ``I3DHead`` of
its recognizer, under its parameter names (``patch_embed.proj``,
``patch_embed.norm``, ``layers.<i>.blocks.<j>.attn.qkv``,
``…attn.relative_position_bias_table``, ``layers.<i>.downsample.reduction``,
``norm``; the head's ``fc_cls`` is ``head``). A Conv3d patch embedding
and its LayerNorm; then stages of blocks over tokens [B, D, H, W, C], each
block two pre-LayerNorm residual branches with stochastic depth:

1. window attention over 3D windows of Wd·Wh·Ww tokens, q·kᵀ plus a learned
   relative-position bias gathered from a table of (2Wd−1)(2Wh−1)(2Ww−1)
   rows a head; in every second block the windows are shifted by half a
   window (a cyclic roll of the tokens, rolled back after), and tokens
   from different regions of the rolled grid are kept apart by a −100
   mask;
2. the MLP (exact GELU).

Between stages, patch merging: the 2×2 spatial neighbours side by side, a
LayerNorm over 4C and a linear layer to 2C without bias. Where a stage is
no larger than the window along an axis, the window takes the whole axis
and the shift there is 0 (``get_window_size``); the relative-position index
is then sliced to the first N positions, as the published code slices it.
A stage that is not a whole number of windows is padded after the
LayerNorm, as there. The head is the final LayerNorm, the mean over
(D, H, W), dropout and a linear layer.

The relative-position index and each stage's shift regions and mask are
made once for each (stage size, device, dtype) and kept by the model
(:func:`shift_mask` counts its builds in ``shift_mask.builds``: none once
warm). Each window sub-layer hands its packed q/k/v projection and its bias
by index (a :class:`~asltpu_torch.ops.window_attention_kernels.WindowBias`:
the table, the window, the index, and in a shifted block the regions [nW, N]
and the mask [nW, N, N] of a clip's nW windows) to
:func:`asltpu_torch.ops.attention.attention`, which chooses the kernel: the
window kernel reads the table by index, any other path the bias
materialised; :func:`window_attention` counts the windows attended in
``window_attention.windows``.

Precision: the compute dtype is ``dtype`` (None: the patch conv's weight
dtype); fp32 masters are cast inside each layer; every LayerNorm
normalises in fp32 and rounds once; the head reads the final LayerNorm's
fp32 output with fp32 weights.

Training (``forward(clip, train=True, generator=g)``): stochastic depth at
``drop_path_rate · k / (blocks − 1)`` in block k counted over all stages,
drawn from ``g`` with :func:`~asltpu_torch.models.common.batch_rand`
(block 0 draws nothing), one draw [B] a branch; then the head's dropout
[B, C].

Spans (:func:`~asltpu_torch.models.common.sublayer`, both directions):
each unshifted window sub-layer, from its LayerNorm through the pad,
partition, projections, attention and reverse to its residual add, runs
inside ``swin.window_attn``; each shifted one, the roll and the mask
included, inside ``swin.shifted_attn``; each patch merging inside
``swin.merge``."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.common import (Dropout, cast, drop_path, keep_mask, layer_norm, linear,
                                        sublayer)
from asltpu_torch.ops.attention import attention
from asltpu_torch.ops.window_attention_kernels import (WindowBias, region_mask,
                                                       relative_position_index, table_rows)

WINDOW_SPAN = "swin.window_attn"
SHIFTED_SPAN = "swin.shifted_attn"
MERGE_SPAN = "swin.merge"
LN_EPS = 1e-5

Size = Tuple[int, int, int]


class Geometry(NamedTuple):
    """What a block's window sub-layer needs of its stage: the window and
    shift clipped to the stage, the flat relative-position index [N·N]
    into the bias table, the shift mask [nW, N, N] and the regions [nW, N]
    (int32) it is made of (both None where the block is not shifted)."""

    window: Size
    shift: Size
    index: torch.Tensor
    mask: Optional[torch.Tensor]
    regions: Optional[torch.Tensor]


def clip_window(size: Sequence[int], window: Sequence[int],
                shift: Sequence[int]) -> Tuple[Size, Size]:
    """``get_window_size``: along an axis no longer than the window, the
    window is the axis and the shift 0."""
    clipped = [(n, 0) if n <= k else (k, s) for n, k, s in zip(size, window, shift)]
    return tuple(k for k, _ in clipped), tuple(s for _, s in clipped)


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] → [B·nW, Wd·Wh·Ww, C], a clip's windows in a row."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window: Sequence[int], b: int,
                   size: Sequence[int]) -> torch.Tensor:
    """[B·nW, Wd·Wh·Ww, C] → [B, D, H, W, C]."""
    (d, h, w), (wd, wh, ww) = size, window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_regions(size: Sequence[int], window: Sequence[int], shift: Sequence[int],
                  device) -> torch.Tensor:
    """``compute_mask``'s labels over a padded stage of ``size``, window by
    window: [nW, N] int32, the region of the rolled grid each token lies in.
    Along an axis shifted by s the regions are [0, n − k), [n − k, n − s)
    and [n − s, n); an unshifted axis is one region."""
    labels = []
    for n, k, s in zip(size, window, shift):
        pos = torch.arange(n, device=device)
        labels.append((pos >= n - k).long() + (pos >= n - s).long() if s else pos * 0)
    region = labels[0][:, None, None] * 9 + labels[1][None, :, None] * 3 + labels[2]
    return window_partition(region[None, ..., None], window)[..., 0].to(torch.int32)


def shift_mask(size: Sequence[int], window: Sequence[int], shift: Sequence[int], device,
               dtype: torch.dtype) -> torch.Tensor:
    """``compute_mask`` over a padded stage of ``size``: [nW, N, N], 0
    between two tokens of a window that lie in one region of the rolled
    grid (:func:`shift_regions`) and −100 between two that do not. Adds one
    to ``shift_mask.builds``."""
    shift_mask.builds += 1
    return region_mask(shift_regions(size, window, shift, device), dtype)


shift_mask.builds = 0


class PatchEmbed3D(nn.Module):
    def __init__(self, patch_size: Size, embed_dim: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(3, embed_dim, self.patch_size, self.patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, T, H, W] → normalised tokens [B, D, H', W', C] in the
        dtype of ``x``; T, H, W padded at their ends to whole patches."""
        pads = [-n % p for n, p in zip(x.shape[2:], self.patch_size)]
        if any(pads):
            x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
        x = F.conv3d(x, cast(self.proj.weight, x.dtype), cast(self.proj.bias, x.dtype),
                     self.patch_size)
        return layer_norm(x.permute(0, 2, 3, 4, 1), self.norm)


class WindowAttention3D(nn.Module):
    """Multi-head self-attention within each window, with a packed, biased
    q/k/v projection (``qkv``, rows q; k; v), the relative-position bias
    table (rows × heads) and an output projection (``proj``)."""

    def __init__(self, dim: int, window_size: Size, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_rows(window_size),
                                                                     num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                regions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Windows [B·nW, N, C] → [B·nW, N, C] in the dtype of ``x``: the bias
        read from the table by ``index`` [N·N] (the first N positions of the
        window's), plus ``mask`` [nW, N, N] of ``regions`` [nW, N] where
        given."""
        bias = WindowBias(self.relative_position_bias_table, self.window_size, index, regions,
                          mask)
        return linear(attention(linear(x, self.qkv), self.num_heads, bias), self.proj)


def window_attention(attn: WindowAttention3D, x: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """``forward_part1`` after its LayerNorm: ``x`` [B, D, H, W, C] padded to
    whole windows, rolled back by the shift where the block is shifted,
    partitioned, attended, put back, rolled forward and cropped. Adds the
    windows attended to ``window_attention.windows``."""
    b, d, h, w, _ = x.shape
    pads = [-n % k for n, k in zip((d, h, w), geo.window)]
    if any(pads):
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    size = x.shape[1:4]
    if geo.mask is not None:
        x = torch.roll(x, [-s for s in geo.shift], (1, 2, 3))
    windows = window_partition(x, geo.window)
    window_attention.windows += windows.shape[0]
    y = window_reverse(attn(windows, geo.index, geo.mask, geo.regions), geo.window, b, size)
    if geo.mask is not None:
        y = torch.roll(y, list(geo.shift), (1, 2, 3))
    return y[:, :d, :h, :w] if any(pads) else y


window_attention.windows = 0


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class SwinTransformerBlock3D(nn.Module):
    """A window attention branch and an MLP branch over [B, D, H, W, C];
    ``drop_path`` its stochastic depth rate. Whether it is shifted is its
    stage's choice (every second block)."""

    def __init__(self, dim: int, num_heads: int, window_size: Size, mlp_ratio: int,
                 drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.drop_path = drop_path

    def attend(self, x: torch.Tensor, geo: Geometry, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """x + drop_path(window attention(norm1(x)))."""
        y = window_attention(self.attn, layer_norm(x, self.norm1), geo)
        keep = keep_mask(x.shape[0], self.drop_path, train, generator, x.device)
        return x + drop_path(y, keep, self.drop_path)

    def forward(self, x: torch.Tensor, geo: Geometry, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        name = WINDOW_SPAN if geo.mask is None else SHIFTED_SPAN
        (x,) = sublayer(name, lambda x: (self.attend(x, geo, train, generator),), x)
        keep = keep_mask(x.shape[0], self.drop_path, train, generator, x.device)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2)), keep, self.drop_path)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D, H, W, C] → [B, D, ⌈H/2⌉, ⌈W/2⌉, 2C]: the neighbours (0, 0),
        (1, 0), (0, 1), (1, 1) of each 2×2 (h, w) cell side by side, an odd
        side padded at its end."""
        h, w = x.shape[2:4]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                       x[:, :, 1::2, 1::2]], -1)
        return linear(layer_norm(x, self.norm), self.reduction)


class BasicLayer(nn.Module):
    """A stage: blocks at one width, every second one shifted, then patch
    merging unless it is the last."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Size, mlp_ratio: int,
                 rates: Sequence[float], downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock3D(dim, num_heads, window_size,
                                                           mlp_ratio, rates[j])
                                    for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor, geometry: Tuple[Geometry, Geometry], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for j, blk in enumerate(self.blocks):
            x = blk(x, geometry[j % 2], train, generator)
        if self.downsample is not None:
            (x,) = sublayer(MERGE_SPAN, lambda x: (self.downsample(x),), x)
        return x


class VideoSwin(nn.Module):
    """Video Swin: [B, T, H, W, 3] preprocessed NHWC clip → logits
    [B, num_classes] (fp32)."""

    def __init__(self, num_classes: int = 2000, patch_size: Size = (2, 4, 4),
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: Size = (8, 7, 7),
                 mlp_ratio: int = 4, drop_path_rate: float = 0.3, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.window_size = tuple(window_size)
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim)
        blocks = sum(depths)
        rates = [drop_path_rate * k / max(blocks - 1, 1) for k in range(blocks)]
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            first = sum(depths[:i])
            self.layers.append(BasicLayer(embed_dim * 2 ** i, depth, heads, self.window_size,
                                          mlp_ratio, rates[first:first + depth],
                                          i < len(depths) - 1))
        features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(features, eps=LN_EPS)
        self.dropout = Dropout(dropout)
        self.head = nn.Linear(features, num_classes)
        # (stage size, device, dtype) → the stage's (unshifted, shifted) geometry.
        self._geometry: Dict[tuple, Tuple[Geometry, Geometry]] = {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The original's initialisation (``SwinTransformer3D._init_weights``,
        ``I3DHead.init_weights``): linears truncated normal (std 0.02, ±2
        std) with zero biases, the bias tables the same, LayerNorms the
        identity, the head normal with std 0.01 and a zero bias. The patch
        conv is drawn as :func:`~asltpu_torch.models.common.init_weights`
        draws every conv: kaiming-normal over fan-out, zero bias."""
        with torch.no_grad():
            conv = self.patch_embed.proj
            fan_out = conv.out_channels * math.prod(conv.kernel_size)
            conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            conv.bias.zero_()
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                          generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
                elif isinstance(m, WindowAttention3D):
                    nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04,
                                          b=0.04, generator=generator)
            self.head.weight.normal_(0.0, 0.01, generator=generator)
            self.head.bias.zero_()

    def geometry(self, size: Sequence[int], device: torch.device,
                 dtype: torch.dtype) -> Tuple[Geometry, Geometry]:
        """The (unshifted, shifted) geometry of a stage of ``size`` (D, H, W),
        made on the first call for its size, device and dtype."""
        key = (tuple(size), device, dtype)
        if key not in self._geometry:
            half = tuple(k // 2 for k in self.window_size)
            window, shift = clip_window(size, self.window_size, half)
            n = math.prod(window)
            index = relative_position_index(self.window_size, device)[:n, :n].reshape(-1)
            padded = [-(-s // k) * k for s, k in zip(size, window)]
            mask = regions = None
            if any(shift):
                mask = shift_mask(padded, window, shift, device, dtype)
                regions = shift_regions(padded, window, shift, device)
            self._geometry[key] = (Geometry(window, (0, 0, 0), index, None, None),
                                   Geometry(window, shift, index, mask, regions))
        return self._geometry[key]

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        dtype = self.dtype or self.patch_embed.proj.weight.dtype
        x = self.patch_embed(cast(clip.permute(0, 4, 1, 2, 3), dtype))
        for layer in self.layers:
            x = layer(x, self.geometry(x.shape[1:4], x.device, x.dtype), train, generator)
        x = F.layer_norm(x.float(), self.norm.normalized_shape, self.norm.weight, self.norm.bias,
                         self.norm.eps).mean(dim=(1, 2, 3))
        x = self.dropout(x, train, generator)
        return F.linear(cast(x, self.head.weight.dtype), self.head.weight, self.head.bias)
