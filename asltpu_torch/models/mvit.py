"""Multiscale Vision Transformer v2 (config ``mvit_v2``): a clip
[B, T, H, W, 3] → [B, num_classes] logits by pooling attention. The port's
own family: the JAX package has no counterpart.

Architecture: Li et al., "MViTv2: Improved Multiscale Vision Transformers
for Classification and Detection" (CVPR 2022), as facebookresearch/SlowFast
writes it (``slowfast/models/video_model_builder.py`` ``MViT``,
``slowfast/models/attention.py`` ``MultiScaleAttention``,
``MultiScaleBlock`` and ``attention_pool``, ``slowfast/models/utils.py``
``cal_rel_pos_spatial`` and ``cal_rel_pos_temporal``, the head
``TransformerBasicHead``) with ``MODE: conv``, ``CLS_EMBED_ON``,
``REL_POS_SPATIAL``, ``REL_POS_TEMPORAL``, ``RESIDUAL_POOLING``,
``DIM_MUL_IN_ATT``, ``QKV_BIAS`` and no absolute position, under its
parameter names (``patch_embed.proj``, ``cls_token``,
``blocks.<i>.attn.qkv``, ``…attn.pool_q/k/v``, ``…attn.norm_q/k/v``,
``…attn.rel_pos_h/w/t``, ``…attn.proj``, ``blocks.<i>.proj``, ``norm``,
``head.projection``).

A Conv3d patch embedding and a learned cls token in front; then blocks over
tokens [B, 1 + T·H·W, C], each two pre-LayerNorm residual branches with
stochastic depth:

1. pooling attention: one projection to q, k and v of ``dim_out`` (split
   into heads); each pooled by a depthwise Conv3d over a head's channels
   (the same weights for every head; the cls token set aside and put back)
   and then LayerNormed; q at the block's q stride, k and v at its k/v
   stride. The scores are (q·scale)·kᵀ plus a bias that depends on q
   (decomposed relative position: ``q·Rt[t_q, t_k] + q·Rh[h_q, h_k] +
   q·Rw[w_q, w_k]`` from three learned tables gathered by a fixed index,
   none for the cls row and column); softmax, times v; then the pooled q
   added back (residual pooling, not to the cls row) and ``proj``. Where
   the width changes, the skip takes ``proj(norm1(x))``; where q is
   strided, the skip is max-pooled (1, 3, 3) / (1, 2, 2) (the cls token
   kept);
2. the MLP (exact GELU).

Width and heads change inside a block's attention (``dim_mul`` and
``head_mul``, [block, multiplier]); k and v are pooled at the adaptive
stride, divided by each q stride as the blocks pass. The head is the final
LayerNorm of the cls token, dropout and a linear layer.

Each block's pooled geometry and its relative-position index (``dist_t``,
``dist_h``, ``dist_w``) are made once for each (token grid, device) and kept
by the model. The bias is built by :func:`rel_pos_bias` straight into
storage whose rows are padded to 16 keys
(:func:`asltpu_torch.ops.attention.bias_storage`) and handed with q, k and v
to :func:`asltpu_torch.ops.attention.pooled_attention`, which chooses the
kernel: the memory-efficient kernel with the bias and its gradient on the
card, the plain math on the CPU.

Precision: the compute dtype is ``dtype`` (None: the patch conv's weight
dtype); fp32 masters are cast inside each layer, the relative-position
tables after their gather, so that their gradient sums in fp32; every
LayerNorm normalises in fp32 and rounds once; the head reads the final
LayerNorm's fp32 output with fp32 weights.

Training (``forward(clip, train=True, generator=g)``): stochastic depth at
``drop_path_rate · k / (depth − 1)`` in block k (block 0 draws nothing), one
draw [B] a branch, the attention's first; then the head's dropout [B, C].

Counters: ``mvit_pool.calls`` (the q, k and v pools: 3 a block),
``rel_pos_bias.bytes`` (the bias storage made, padding included).

Spans (:func:`~asltpu_torch.models.common.sublayer`, both directions): each
attention sub-layer, from ``norm1`` through the projection, pools, bias,
attention, residual pooling, ``proj``, the skip's projection and pool, to
its residual add, runs inside ``mvit.attn``; inside it, the three pools and
their LayerNorms inside ``mvit.pool``, and the index gather, the three
products and the bias's expansion to [Lq, Lk] inside ``mvit.rel_pos``."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.models.common import (Dropout, cast, drop_path, keep_mask, layer_norm, linear,
                                        sublayer)
from asltpu_torch.ops.attention import bias_storage, pooled_attention

ATTN_SPAN = "mvit.attn"
POOL_SPAN = "mvit.pool"
REL_POS_SPAN = "mvit.rel_pos"
LN_EPS = 1e-6

Size = Tuple[int, int, int]


class BlockPlan(NamedTuple):
    """One block's shape: its input and output widths, heads, and the q and
    k/v pooling strides."""

    dim: int
    dim_out: int
    heads: int
    stride_q: Size
    stride_kv: Size


class Geometry(NamedTuple):
    """What a block needs of its token grid: the input grid (T, H, W), the
    pooled q and k/v grids, their lengths with the cls token, and the
    relative-position index of each axis ([q, k] int64 rows of the
    block's tables)."""

    thw: Size
    q_thw: Size
    kv_thw: Size
    lq: int
    lk: int
    dist_t: torch.Tensor
    dist_h: torch.Tensor
    dist_w: torch.Tensor


def round_width(width: float, multiplier: float, min_width: int = 1, divisor: int = 1) -> int:
    """SlowFast's ``round_width``: ``width · multiplier`` rounded to a
    multiple of ``divisor``, at least ``min_width``."""
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def block_plan(embed_dim: int, num_heads: int, depth: int, dim_mul: Sequence[Sequence[float]],
               head_mul: Sequence[Sequence[float]], pool_q_stride: Sequence[Sequence[int]],
               pool_kv_stride_adaptive: Sequence[int]) -> List[BlockPlan]:
    """Each block's :class:`BlockPlan`, as ``MViT.__init__`` derives it with
    ``DIM_MUL_IN_ATT``: the heads and width multiplied in the block listed,
    the k/v stride divided by each q stride (``POOL_KV_STRIDE_ADAPTIVE``).
    ``pool_q_stride`` must list every block."""
    stride_q = {int(s[0]): tuple(int(x) for x in s[1:]) for s in pool_q_stride}
    if sorted(stride_q) != list(range(depth)):
        raise ValueError(f"pool_q_stride lists blocks {sorted(stride_q)}; it must list each of "
                         f"the {depth} blocks")
    dmul, hmul = [1.0] * (depth + 1), [1.0] * (depth + 1)
    for i, m in dim_mul:
        dmul[int(i)] = m
    for i, m in head_mul:
        hmul[int(i)] = m
    kv, dim, heads, out = tuple(pool_kv_stride_adaptive), embed_dim, num_heads, []
    for i in range(depth):
        kv = tuple(max(s // q, 1) for s, q in zip(kv, stride_q[i]))
        heads = round_width(heads, hmul[i])
        dim_out = round_width(dim, dmul[i], divisor=round_width(heads, hmul[i]))
        out.append(BlockPlan(dim, dim_out, heads, stride_q[i], kv))
        dim = dim_out
    return out


def pooled_size(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> Size:
    """A grid's size after a pool of ``kernel`` and ``stride`` padded by
    ``kernel // 2`` on each side."""
    return tuple((n + 2 * (k // 2) - k) // s + 1 for n, k, s in zip(size, kernel, stride))


def rel_dist(q: int, k: int, device) -> torch.Tensor:
    """``cal_rel_pos_spatial``'s ``dist_h`` for q and k sides of ``q`` and
    ``k``: [q, k] rows of a table of 2·max(q, k) − 1, each side scaled up to
    the longer one."""
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    dist = (torch.arange(q, device=device)[:, None] * q_ratio
            - torch.arange(k, device=device)[None, :] * k_ratio)
    return (dist + (k - 1) * k_ratio).long()


class _ExpandBias(torch.autograd.Function):
    """The bias [B, h, Lq, Lk] from its three factors ``rel_t``, ``rel_h``,
    ``rel_w`` ([B, h, qt, qh, qw, kt | kh | kw]): the sum at
    ((t_q, h_q, w_q), (t_k, h_k, w_k)), 0 in the cls row and column, written
    once into :func:`~asltpu_torch.ops.attention.bias_storage`. The
    gradient of each factor is the bias's summed over the other two key
    axes (two passes over it)."""

    @staticmethod
    def forward(ctx, rel_t, rel_h, rel_w, lk):
        b, h, qt, qh, qw, kt = rel_t.shape
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        bias = bias_storage(b, h, 1 + qt * qh * qw, lk, rel_t.dtype, rel_t.device)
        bias[:, :, 0].zero_()
        bias[:, :, 1:, 0].zero_()
        th = rel_t[..., :, None] + rel_h[..., None, :]
        torch.add(th[..., None], rel_w[..., None, None, :],
                  out=bias[:, :, 1:, 1:].view(b, h, qt, qh, qw, kt, kh, kw))
        ctx.shapes = (rel_t.shape, rel_h.shape, rel_w.shape)
        return bias

    @staticmethod
    def backward(ctx, grad):
        shape_t, shape_h, shape_w = ctx.shapes
        b, h = grad.shape[:2]
        g = grad[:, :, 1:, 1:].reshape(b, h, -1, shape_t[-1], shape_h[-1], shape_w[-1])
        g_th = g.sum(-1)
        return (g_th.sum(-1).view(shape_t), g_th.sum(-2).view(shape_h),
                g.sum((-3, -2)).view(shape_w), None)


def rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                 rel_pos_t: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """The decomposed relative-position bias [B, h, Lq, Lk] of the pooled,
    normalised, unscaled ``q`` [B, h, Lq, D]: each table gathered by its
    index (in the table's dtype, then cast to q's), the three products of
    ``cal_rel_pos_spatial`` and ``cal_rel_pos_temporal``, and their sum
    over the key grid; the cls row and column 0. Adds the bias's storage
    bytes to ``rel_pos_bias.bytes``."""
    b, h, _, c = q.shape
    r_q = q[:, :, 1:].reshape(b, h, *geo.q_thw, c)
    rt, rh, rw = (cast(table[dist], q.dtype) for table, dist in
                  ((rel_pos_t, geo.dist_t), (rel_pos_h, geo.dist_h), (rel_pos_w, geo.dist_w)))
    rel_t = torch.einsum("bythwc,tkc->bythwk", r_q, rt)
    rel_h = torch.einsum("bythwc,hkc->bythwk", r_q, rh)
    rel_w = torch.einsum("bythwc,wkc->bythwk", r_q, rw)
    bias = _ExpandBias.apply(rel_t, rel_h, rel_w, geo.lk)
    rel_pos_bias.bytes += bias.untyped_storage().nbytes()
    return bias


rel_pos_bias.bytes = 0


def mvit_pool(t: torch.Tensor, conv: nn.Conv3d, norm: nn.LayerNorm,
              thw: Sequence[int]) -> torch.Tensor:
    """``attention_pool``: ``t`` [B, h, 1 + T·H·W, D] with its cls token set
    aside, the rest as a grid (T, H, W) of D channels through the depthwise
    ``conv`` (every head alike), the cls token put back and the whole
    LayerNormed by ``norm`` → [B, h, 1 + T'·H'·W', D]. Adds one to
    ``mvit_pool.calls``."""
    mvit_pool.calls += 1
    b, h, _, c = t.shape
    grid = t[:, :, 1:].reshape(b * h, *thw, c).permute(0, 4, 1, 2, 3).contiguous()
    # Input and weight in the standard layout: PyTorch's own depthwise 3D kernel.
    # Either laid out channels-last (as to_channels_last lays the weight out)
    # sends the conv to cuDNN, 4-7 times slower forward at these shapes on an
    # H100.
    weight = cast(conv.weight, t.dtype).clone(memory_format=torch.contiguous_format)
    grid = F.conv3d(grid, weight, None, conv.stride, conv.padding, groups=c)
    body = grid.flatten(2).transpose(1, 2).reshape(b, h, -1, c)
    return layer_norm(torch.cat((t[:, :, :1], body), 2), norm)


mvit_pool.calls = 0


def skip_pool(x: torch.Tensor, thw: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """``pool_skip`` on the skip path [B, 1 + T·H·W, C]: a max-pool of
    kernel ``s + 1`` where the stride ``s`` is above 1 (else 1), padded by
    half the kernel, over the grid; the cls token kept."""
    b, _, c = x.shape
    kernel = tuple(s + 1 if s > 1 else s for s in stride)
    grid = x[:, 1:].reshape(b, *thw, c).permute(0, 4, 1, 2, 3)
    grid = F.max_pool3d(grid, kernel, tuple(stride), tuple(k // 2 for k in kernel))
    return torch.cat((x[:, :1], grid.permute(0, 2, 3, 4, 1).reshape(b, -1, c)), 1)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, kernel: Size, stride: Size, padding: Size):
        super().__init__()
        self.proj = nn.Conv3d(3, embed_dim, kernel, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, T, H, W] → [B, C, T', H', W'] in the dtype of ``x``."""
        return F.conv3d(x, cast(self.proj.weight, x.dtype), cast(self.proj.bias, x.dtype),
                        self.proj.stride, self.proj.padding)


class MultiScaleAttention(nn.Module):
    """Pooling attention from ``dim`` to ``dim_out`` over ``heads`` heads:
    the packed, biased q/k/v projection ``qkv`` (rows q; k; v), the three
    depthwise pools and their LayerNorms, the relative-position tables
    (``rel_pos_h``/``rel_pos_w`` of 2·max(q side, k/v side) − 1 rows for an
    input side ``input_size[1]``, ``rel_pos_t`` of 2·T − 1) and ``proj``."""

    def __init__(self, dim: int, dim_out: int, heads: int, input_size: Size, kernel: Size,
                 stride_q: Size, stride_kv: Size):
        super().__init__()
        self.num_heads = heads
        head_dim = dim_out // heads
        side = input_size[1]
        rows = 2 * max(side // stride_q[1], side // stride_kv[1]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, head_dim))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        padding = tuple(k // 2 for k in kernel)
        for name, stride in (("q", stride_q), ("k", stride_kv), ("v", stride_kv)):
            setattr(self, f"pool_{name}", nn.Conv3d(head_dim, head_dim, kernel, stride, padding,
                                                    groups=head_dim, bias=False))
            setattr(self, f"norm_{name}", nn.LayerNorm(head_dim, eps=LN_EPS))

    def pool(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             thw: Sequence[int]) -> Tuple[torch.Tensor, ...]:
        return (mvit_pool(q, self.pool_q, self.norm_q, thw),
                mvit_pool(k, self.pool_k, self.norm_k, thw),
                mvit_pool(v, self.pool_v, self.norm_v, thw))

    def forward(self, x: torch.Tensor, geo: Geometry) -> torch.Tensor:
        """Normalised tokens [B, 1 + T·H·W, dim] → [B, Lq, dim_out] in the
        dtype of ``x``."""
        b, n, _ = x.shape
        q, k, v = linear(x, self.qkv).view(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = sublayer(POOL_SPAN, lambda q, k, v: self.pool(q, k, v, geo.thw), q, k, v)
        (bias,) = sublayer(REL_POS_SPAN, lambda q, th, tw, tt: (rel_pos_bias(q, th, tw, tt, geo),),
                           q, self.rel_pos_h, self.rel_pos_w, self.rel_pos_t)
        out = pooled_attention(q, k, v, bias) + F.pad(q[:, :, 1:], (0, 0, 1, 0))
        return linear(out.transpose(1, 2).reshape(b, geo.lq, -1), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class MultiScaleBlock(nn.Module):
    """A pooling attention branch and an MLP branch; ``proj`` carries the
    skip to ``dim_out`` where the width changes; ``drop_path`` is the
    block's stochastic depth rate."""

    def __init__(self, plan: BlockPlan, input_size: Size, kernel: Size, mlp_ratio: int,
                 drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(plan.dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(plan.dim, plan.dim_out, plan.heads, input_size, kernel,
                                        plan.stride_q, plan.stride_kv)
        self.norm2 = nn.LayerNorm(plan.dim_out, eps=LN_EPS)
        self.mlp = Mlp(plan.dim_out, plan.dim_out * mlp_ratio)
        self.proj = nn.Linear(plan.dim, plan.dim_out) if plan.dim != plan.dim_out else None
        self.stride_q = plan.stride_q
        self.drop_path = drop_path

    def attend(self, x: torch.Tensor, geo: Geometry, train: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """skip(x) + drop_path(attention(norm1(x)))."""
        x_norm = layer_norm(x, self.norm1)
        y = self.attn(x_norm, geo)
        if self.proj is not None:
            x = linear(x_norm, self.proj)
        if math.prod(self.stride_q) > 1:
            x = skip_pool(x, geo.thw, self.stride_q)
        keep = keep_mask(x.shape[0], self.drop_path, train, generator, x.device)
        return x + drop_path(y, keep, self.drop_path)

    def forward(self, x: torch.Tensor, geo: Geometry, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        (x,) = sublayer(ATTN_SPAN, lambda x: (self.attend(x, geo, train, generator),), x)
        keep = keep_mask(x.shape[0], self.drop_path, train, generator, x.device)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2)), keep, self.drop_path)


class TransformerBasicHead(nn.Module):
    def __init__(self, dim: int, num_classes: int, dropout: float):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.projection = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Features [B, dim] → logits [B, num_classes] (no softmax: the
        original's at evaluation is left to the caller)."""
        x = self.dropout(x, train, generator)
        return F.linear(cast(x, self.projection.weight.dtype), self.projection.weight,
                        self.projection.bias)


class MViT(nn.Module):
    """MViTv2: [B, T, H, W, 3] preprocessed NHWC clip of ``num_frames``
    frames of ``img_size``² → logits [B, num_classes] (fp32)."""

    def __init__(self, num_classes: int = 2000, num_frames: int = 32, img_size: int = 224,
                 patch_kernel: Size = (3, 7, 7), patch_stride: Size = (2, 4, 4),
                 patch_padding: Size = (1, 3, 3), embed_dim: int = 96, depth: int = 24,
                 num_heads: int = 1, dim_mul: Sequence[Sequence[float]] = (),
                 head_mul: Sequence[Sequence[float]] = (),
                 pool_q_stride: Sequence[Sequence[int]] = (),
                 pool_kvq_kernel: Size = (3, 3, 3), pool_kv_stride_adaptive: Size = (1, 8, 8),
                 mlp_ratio: int = 4, drop_path_rate: float = 0.3, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = tuple(pool_kvq_kernel)
        self.patch_embed = PatchEmbed(embed_dim, tuple(patch_kernel), tuple(patch_stride),
                                      tuple(patch_padding))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.patch_dims = (num_frames // patch_stride[0], img_size // patch_stride[1],
                           img_size // patch_stride[2])
        self.plan = block_plan(embed_dim, num_heads, depth, dim_mul, head_mul, pool_q_stride,
                               pool_kv_stride_adaptive)
        rates = [drop_path_rate * k / max(depth - 1, 1) for k in range(depth)]
        self.blocks = nn.ModuleList()
        size = self.patch_dims
        for plan, rate in zip(self.plan, rates):
            self.blocks.append(MultiScaleBlock(plan, size, self.kernel, mlp_ratio, rate))
            size = tuple(n // s for n, s in zip(size, plan.stride_q))
        features = self.plan[-1].dim_out
        self.norm = nn.LayerNorm(features, eps=LN_EPS)
        self.head = TransformerBasicHead(features, num_classes, dropout)
        # (token grid, device) → every block's geometry.
        self._geometry: Dict[tuple, Tuple[Geometry, ...]] = {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The original's initialisation (``MViT._init_weights``): linears and
        convs truncated normal (std 0.02, ±2 std), linear biases 0.02,
        LayerNorms scale 1 and shift 0.02; the cls token and the
        relative-position tables truncated normal (std 0.02). The patch
        conv's bias, which the original leaves at ``nn.Conv3d``'s own draw,
        is 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv3d)):
                    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                          generator=generator)
                    if m.bias is not None:
                        m.bias.fill_(0.02 if isinstance(m, nn.Linear) else 0.0)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.fill_(0.02)
            tables = [t for blk in self.blocks for t in
                      (blk.attn.rel_pos_h, blk.attn.rel_pos_w, blk.attn.rel_pos_t)]
            for t in [self.cls_token, *tables]:
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

    def geometry(self, thw: Sequence[int], device: torch.device) -> Tuple[Geometry, ...]:
        """Every block's :class:`Geometry` for a token grid ``thw``, made on
        the first call for the grid and device."""
        key = (tuple(thw), device)
        if key not in self._geometry:
            out, size = [], tuple(thw)
            for plan in self.plan:
                q = pooled_size(size, self.kernel, plan.stride_q)
                kv = pooled_size(size, self.kernel, plan.stride_kv)
                dist = [rel_dist(a, b, device) for a, b in zip(q, kv)]
                out.append(Geometry(size, q, kv, 1 + math.prod(q), 1 + math.prod(kv), *dist))
                size = q
            self._geometry[key] = tuple(out)
        return self._geometry[key]

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, H, W, 3] preprocessed NHWC clip → logits [B, num_classes]."""
        dtype = self.dtype or self.patch_embed.proj.weight.dtype
        x = self.patch_embed(cast(clip.permute(0, 4, 1, 2, 3), dtype))
        b, thw = x.shape[0], tuple(x.shape[2:])
        if thw != self.patch_dims:
            raise ValueError(f"a clip of {tuple(clip.shape[1:4])} makes a token grid {thw}; "
                             f"the relative-position tables are sized for {self.patch_dims}")
        x = torch.cat((cast(self.cls_token, dtype).expand(b, -1, -1), x.flatten(2).transpose(1, 2)),
                      1)
        for blk, geo in zip(self.blocks, self.geometry(thw, x.device)):
            x = blk(x, geo, train, generator)
        x = F.layer_norm(x[:, 0].float(), self.norm.normalized_shape, self.norm.weight,
                         self.norm.bias, self.norm.eps)
        return self.head(x, train, generator)
