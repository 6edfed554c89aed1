"""Plain reference of ``video_swin`` and of one step of its fine-tune.

The network is the Video Swin Transformer (Liu et al., "Video Swin
Transformer", CVPR 2022, arXiv:2106.13230), written line by line after
SwinTransformer/Video-Swin-Transformer's
``mmaction/models/backbones/swin_transformer.py``: ``window_partition``,
``window_reverse``, ``get_window_size``, ``WindowAttention3D``,
``SwinTransformerBlock3D``, ``PatchMerging``, ``compute_mask``,
``BasicLayer``, ``PatchEmbed3D`` and ``SwinTransformer3D.forward``, and the
head as ``mmaction/models/heads/i3d_head.py``'s ``I3DHead`` has it (average
over (T, H, W), dropout, one linear layer). Each ``rearrange`` of the
original is the permute beside its pattern. Parameter names are
``SwinTransformer3D``'s.

Departures from ``swin_transformer.py`` and ``i3d_head.py``:

- functions over a flat dict of float32 parameters instead of modules;
  the backbone's ``backbone.`` prefix is dropped and the head's
  ``cls_head.fc_cls`` is named ``head``;
- the input is the staged uint8 clip: ``ops.crop_normalize`` takes the
  centre crop and normalises it (the program's preprocess) before the
  patch embedding;
- ``relative_position_index`` is made by :func:`relative_position_index`
  on the device of the call, not kept as a buffer (it is no parameter);
  where a window is clipped to a smaller stage it is sliced
  ``[:N, :N]``, as ``WindowAttention3D.forward`` slices it, which keeps
  the index of the full window's first N positions;
- ``compute_mask`` is not cached (``lru_cache`` in the original): it is
  made once a stage and a forward;
- ``drop_path`` draws ``torch.rand`` in float32 from the step's generator
  and keeps a sample where its draw is at least the rate (the original's
  ``floor(keep_prob + rand)`` up to the rounding of that sum); each
  block's two draws (the window attention's and the MLP's, [B] each) and
  the head's dropout draw ([B, C]) are made before the network runs, so
  that a block's recompute under a checkpoint takes the same masks;
- each block is checkpointed (recomputed in the backward pass) where a
  gradient is taken and ``recompute`` is set, as the original's
  ``use_checkpoint`` does, so a full-size batch fits on one card beside
  the program's state: the arithmetic is the same;
- initialisation is the harness's (:func:`param_specs`), not the
  original's.

One step: label-smoothed cross-entropy, the gradient, its global-norm clip
and AdamW under a linear warmup (``reference/i3d.py``'s). Float32 with TF32
off; ``precision="fp8"`` rounds every linear's, the patch conv's and the
two attention products' operands to float8 instead (e4m3 forward, e5m2 for
the gradient of their outputs), the control of a bfloat16 network; "bf16"
rounds them to bfloat16, a witness of what rounding alone does.

:func:`window_attn_flops` counts the window attention sub-layers' matmul
operations of a step, which the roofline of ``swin.window_attn`` and
``swin.shifted_attn`` reads."""

from __future__ import annotations

import math
from functools import reduce
from operator import mul
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import ops
from perfbench.reference.i3d import lr_at, smoothed_ce

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5
# The harness's scales: linears and the patch conv normal with std
# √(1 / fan_in), so that a branch's output is about as large as its
# normalised input and attention's softmax is not flat; biases uniform in
# ±BIAS; the relative-position bias tables normal with the original's std
# 0.02; the head uniform in ±1/√features, as nn.Linear draws it.
BIAS = 0.02
TABLE_STD = 0.02


def stages(cfg: dict) -> List[Tuple[int, int, int]]:
    """(width, depth, heads) of each stage."""
    return [(cfg["embed_dim"] * 2 ** i, depth, heads)
            for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"]))]


def rates(cfg: dict) -> List[float]:
    """Each block's stochastic depth rate, over all stages in order:
    ``torch.linspace(0, drop_path_rate, sum(depths))``."""
    n = sum(cfg["depths"])
    return [cfg["drop_path_rate"] * i / max(n - 1, 1) for i in range(n)]


def table_rows(window: Sequence[int]) -> int:
    return (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter, in
    ``SwinTransformer3D``'s order of registration."""
    c0, patch, window = cfg["embed_dim"], tuple(cfg["patch_size"]), tuple(cfg["window_size"])

    def linear(name, fan_in, fan_out, bias=True):
        out = [(f"{name}.weight", (fan_out, fan_in), "normal", math.sqrt(1.0 / fan_in))]
        return out + ([(f"{name}.bias", (fan_out,), "uniform", BIAS)] if bias else [])

    def norm(name, dim):
        return [(f"{name}.weight", (dim,), "ones", 1.0), (f"{name}.bias", (dim,), "zeros", 0.0)]

    specs = [("patch_embed.proj.weight", (c0, 3, *patch), "normal",
              math.sqrt(1.0 / (3 * reduce(mul, patch)))),
             ("patch_embed.proj.bias", (c0,), "uniform", BIAS)] + norm("patch_embed.norm", c0)
    layers = stages(cfg)
    for i, (dim, depth, heads) in enumerate(layers):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            specs += (norm(f"{b}.norm1", dim)
                      + [(f"{b}.attn.relative_position_bias_table", (table_rows(window), heads),
                          "normal", TABLE_STD)]
                      + linear(f"{b}.attn.qkv", dim, 3 * dim) + linear(f"{b}.attn.proj", dim, dim)
                      + norm(f"{b}.norm2", dim)
                      + linear(f"{b}.mlp.fc1", dim, dim * cfg["mlp_ratio"])
                      + linear(f"{b}.mlp.fc2", dim * cfg["mlp_ratio"], dim))
        if i < len(layers) - 1:
            specs += (linear(f"layers.{i}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
                      + norm(f"layers.{i}.downsample.norm", 4 * dim))
    features, bound = layers[-1][0], 1.0 / math.sqrt(layers[-1][0])
    specs += norm("norm", features) + [
        ("head.weight", (cfg["num_classes"], features), "uniform", bound),
        ("head.bias", (cfg["num_classes"],), "uniform", bound)]
    return specs


def linear(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    w = params[f"{name}.weight"]
    return ops.output(F.linear(ops.operand(x, precision), ops.operand(w, precision),
                               params.get(f"{name}.bias")), precision)


def layer_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"],
                        LN_EPS)


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] → [B·nW, Wd·Wh·Ww, C]."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // window_size[0], window_size[0], H // window_size[1], window_size[1],
               W // window_size[2], window_size[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, reduce(mul, window_size), C)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], B: int, D: int, H: int,
                   W: int) -> torch.Tensor:
    """[B·nW, Wd, Wh, Ww, C] → [B, D, H, W, C]."""
    x = windows.view(B, D // window_size[0], H // window_size[1], W // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)


def get_window_size(x_size, window_size, shift_size=None):
    """The window (and shift) clipped to a stage of size ``x_size``: an
    axis no longer than the window takes the whole axis, unshifted."""
    use_window_size = list(window_size)
    if shift_size is not None:
        use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def relative_position_index(window_size: Sequence[int], device) -> torch.Tensor:
    """``WindowAttention3D.__init__``'s ``relative_position_index`` [N, N]."""
    coords_d = torch.arange(window_size[0], device=device)
    coords_h = torch.arange(window_size[1], device=device)
    coords_w = torch.arange(window_size[2], device=device)
    coords = torch.stack(torch.meshgrid(coords_d, coords_h, coords_w, indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)  # 3, Wd*Wh*Ww
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]  # 3, N, N
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()  # N, N, 3
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1)  # Wd*Wh*Ww, Wd*Wh*Ww


def compute_mask(D: int, H: int, W: int, window_size, shift_size, device) -> torch.Tensor:
    """The shifted windows' mask [nW, N, N]: 0 between tokens of one region
    of the shifted grid, −100 between tokens of two."""
    img_mask = torch.zeros((1, D, H, W, 1), device=device)  # 1 Dp Hp Wp 1
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size)  # nW, ws[0]*ws[1]*ws[2], 1
    mask_windows = mask_windows.squeeze(-1)  # nW, ws[0]*ws[1]*ws[2]
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                            float(0.0))


def window_attention(x: torch.Tensor, mask: Optional[torch.Tensor], params: Params, name: str,
                     heads: int, window: Sequence[int], precision: str) -> torch.Tensor:
    """``WindowAttention3D.forward``: q, k, v from ``qkv``, q scaled by
    head_dim^−½, q·kᵀ plus the relative-position bias (and the mask of the
    shifted windows), softmax, times v, then ``proj``; no dropout."""
    B_, N, C = x.shape
    qkv = linear(x, params, f"{name}.qkv", precision).reshape(
        B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # B_, nH, N, C
    q = q * (C // heads) ** -0.5
    attn = ops.output(ops.operand(q, precision) @ ops.operand(k, precision).transpose(-2, -1),
                      precision)
    index = relative_position_index(window, x.device)
    relative_position_bias = params[f"{name}.relative_position_bias_table"][
        index[:N, :N].reshape(-1)].reshape(N, N, -1)  # Wd*Wh*Ww,Wd*Wh*Ww,nH
    relative_position_bias = relative_position_bias.permute(2, 0, 1).contiguous()
    attn = attn + relative_position_bias.unsqueeze(0)  # B_, nH, N, N
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, N, N)
    attn = attn.softmax(dim=-1)
    x = ops.output(ops.operand(attn, precision) @ ops.operand(v, precision), precision)
    x = x.transpose(1, 2).reshape(B_, N, C)
    return linear(x, params, f"{name}.proj", precision)


def mlp(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    """``Mlp.forward``: fc1, exact GELU, fc2; no dropout."""
    return linear(F.gelu(linear(x, params, f"{name}.fc1", precision)), params, f"{name}.fc2",
                  precision)


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``drop_path`` with its mask given: ``x.div(keep_prob) *
    random_tensor`` over the first axis."""
    if keep is None:
        return x
    mask = keep.to(x.dtype).view(-1, *([1] * (x.dim() - 1)))
    return x.div(1.0 - rate) * mask


def forward_part1(x: torch.Tensor, mask_matrix: torch.Tensor, params: Params, name: str,
                  heads: int, window: Sequence[int], shift: Sequence[int],
                  precision: str) -> torch.Tensor:
    """``SwinTransformerBlock3D.forward_part1``: norm1, pad to whole
    windows, the cyclic shift, window attention, and back."""
    B, D, H, W, C = x.shape
    window_size, shift_size = get_window_size((D, H, W), window, shift)
    x = layer_norm(x, params, f"{name}.norm1")
    # pad feature maps to multiples of window size
    pad_l = pad_t = pad_d0 = 0
    pad_d1 = (window_size[0] - D % window_size[0]) % window_size[0]
    pad_b = (window_size[1] - H % window_size[1]) % window_size[1]
    pad_r = (window_size[2] - W % window_size[2]) % window_size[2]
    x = F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b, pad_d0, pad_d1))
    _, Dp, Hp, Wp, _ = x.shape
    # cyclic shift
    if any(i > 0 for i in shift_size):
        shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                               dims=(1, 2, 3))
        attn_mask = mask_matrix
    else:
        shifted_x = x
        attn_mask = None
    # partition windows
    x_windows = window_partition(shifted_x, window_size)  # B*nW, Wd*Wh*Ww, C
    # W-MSA/SW-MSA
    attn_windows = window_attention(x_windows, attn_mask, params, f"{name}.attn", heads, window,
                                    precision)
    # merge windows
    attn_windows = attn_windows.view(-1, *(window_size + (C,)))
    shifted_x = window_reverse(attn_windows, window_size, B, Dp, Hp, Wp)  # B D' H' W' C
    # reverse cyclic shift
    if any(i > 0 for i in shift_size):
        x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1], shift_size[2]),
                       dims=(1, 2, 3))
    else:
        x = shifted_x
    if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
        x = x[:, :D, :H, :W, :].contiguous()
    return x


def block(x: torch.Tensor, mask_matrix: torch.Tensor, keeps: tuple, params: Params, name: str,
          heads: int, window: Sequence[int], shift: Sequence[int], rate: float,
          precision: str) -> torch.Tensor:
    """``SwinTransformerBlock3D.forward``: the window attention and the MLP,
    each a residual branch with stochastic depth."""
    keep_attn, keep_mlp = keeps
    shortcut = x
    x = forward_part1(x, mask_matrix, params, name, heads, window, shift, precision)
    x = shortcut + drop_path(x, keep_attn, rate)
    return x + drop_path(mlp(layer_norm(x, params, f"{name}.norm2"), params, f"{name}.mlp",
                             precision), keep_mlp, rate)


def patch_merging(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    """``PatchMerging.forward``: the 2×2 spatial neighbours side by side,
    norm over 4C, reduction to 2C."""
    B, D, H, W, C = x.shape
    # padding
    pad_input = (H % 2 == 1) or (W % 2 == 1)
    if pad_input:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]  # B D H/2 W/2 C
    x1 = x[:, :, 1::2, 0::2, :]  # B D H/2 W/2 C
    x2 = x[:, :, 0::2, 1::2, :]  # B D H/2 W/2 C
    x3 = x[:, :, 1::2, 1::2, :]  # B D H/2 W/2 C
    x = torch.cat([x0, x1, x2, x3], -1)  # B D H/2 W/2 4*C
    x = layer_norm(x, params, f"{name}.norm")
    return linear(x, params, f"{name}.reduction", precision)


def draws(cfg: dict, batch: int, gen: Optional[torch.Generator], device) -> List[tuple]:
    """Each block's stochastic depth masks (window attention, MLP), [B]
    each, drawn from ``gen`` in the program's order; none at rate 0 or
    without ``gen``."""
    out = []
    for rate in rates(cfg):
        if gen is None or rate == 0.0:
            out.append((None, None))
            continue
        out.append(tuple(torch.rand((batch,), generator=gen, device=device) >= rate
                         for _ in range(2)))
    return out


def dropout_keep(cfg: dict, batch: int, gen: Optional[torch.Generator],
                 device) -> Optional[torch.Tensor]:
    """The head's dropout mask [B, C], drawn after every block's."""
    features = stages(cfg)[-1][0]
    if gen is None or cfg["dropout"] == 0.0:
        return None
    return torch.rand((batch, features), generator=gen, device=device) >= cfg["dropout"]


def forward_train(frames_u8: torch.Tensor, params: Params, cfg: dict,
                  gen: Optional[torch.Generator], precision: str = "fp32",
                  recompute: bool = True) -> torch.Tensor:
    """Staged uint8 clips [B, T, Hs, Ws, 3] → logits [B, C]:
    ``SwinTransformer3D.forward`` and ``I3DHead.forward``, stochastic depth
    and dropout drawn from ``gen`` (none without it). ``recompute``:
    checkpoint each block when a gradient is taken."""
    x = ops.crop_normalize(frames_u8, cfg["preprocess"]).permute(0, 2, 1, 3, 4)  # B C T H W
    B = x.shape[0]
    masks = draws(cfg, B, gen, x.device)
    keep_head = dropout_keep(cfg, B, gen, x.device)
    window = tuple(cfg["window_size"])
    patch_size = tuple(cfg["patch_size"])

    # PatchEmbed3D.forward
    _, _, D, H, W = x.size()
    if W % patch_size[2] != 0:
        x = F.pad(x, (0, patch_size[2] - W % patch_size[2]))
    if H % patch_size[1] != 0:
        x = F.pad(x, (0, 0, 0, patch_size[1] - H % patch_size[1]))
    if D % patch_size[0] != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, patch_size[0] - D % patch_size[0]))
    x = ops.output(F.conv3d(ops.operand(x, precision),
                            ops.operand(params["patch_embed.proj.weight"], precision),
                            params["patch_embed.proj.bias"], stride=patch_size), precision)
    D, Wh, Ww = x.size(2), x.size(3), x.size(4)
    x = x.flatten(2).transpose(1, 2)
    x = layer_norm(x, params, "patch_embed.norm")
    x = x.transpose(1, 2).view(-1, cfg["embed_dim"], D, Wh, Ww)

    k = 0
    layers = stages(cfg)
    for i, (_, depth, heads) in enumerate(layers):
        # BasicLayer.forward
        B, C, D, H, W = x.shape
        shift = tuple(s // 2 for s in window)
        window_size, shift_size = get_window_size((D, H, W), window, shift)
        x = x.permute(0, 2, 3, 4, 1)  # 'b c d h w -> b d h w c'
        Dp = int(math.ceil(D / window_size[0])) * window_size[0]
        Hp = int(math.ceil(H / window_size[1])) * window_size[1]
        Wp = int(math.ceil(W / window_size[2])) * window_size[2]
        attn_mask = compute_mask(Dp, Hp, Wp, window_size, shift_size, x.device)
        for j in range(depth):
            args = (attn_mask, masks[k], params, f"layers.{i}.blocks.{j}", heads, window,
                    (0, 0, 0) if j % 2 == 0 else shift, rates(cfg)[k], precision)
            if recompute and torch.is_grad_enabled():
                x = checkpoint(block, x, *args, use_reentrant=False)
            else:
                x = block(x, *args)
            k += 1
        x = x.view(B, D, H, W, -1)
        if i < len(layers) - 1:
            x = patch_merging(x, params, f"layers.{i}.downsample", precision)
        x = x.permute(0, 4, 1, 2, 3)  # 'b d h w c -> b c d h w'

    x = x.permute(0, 2, 3, 4, 1)  # 'n c d h w -> n d h w c'
    x = layer_norm(x, params, "norm")
    # I3DHead.forward: the average over (T, H, W), dropout, fc_cls.
    x = x.mean(dim=(1, 2, 3))
    if keep_head is not None:
        x = x * keep_head.to(x.dtype) / (1.0 - cfg["dropout"])
    return F.linear(x, params["head.weight"], params["head.bias"])


def forward(frames_u8: torch.Tensor, params: Params, cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Inference: staged uint8 clips → logits [B, C] float32, TF32 off."""
    with ops.exact_fp32(), torch.no_grad():
        return forward_train(frames_u8, params, cfg, None, precision, recompute=False)


def stage_sizes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(D, H, W) of each stage's tokens for one clip."""
    pp, patch = cfg["preprocess"], cfg["patch_size"]
    size = [-(-n // p) for n, p in zip((cfg["num_frames"], pp["crop"], pp["crop"]), patch)]
    out = []
    for _ in cfg["depths"]:
        out.append(tuple(size))
        size = [size[0], -(-size[1] // 2), -(-size[2] // 2)]
    return out


def window_attn_flops(cfg: dict, batch: int) -> float:
    """The window attention sub-layers' matmul operations in one train step
    of ``batch`` clips, shifted and unshifted alike: the q/k/v and output
    projections over every token of the padded grid, q·kᵀ and the weighted
    sum of v over each window of N tokens; 2 a multiply-add, the backward
    counted as twice the forward (no recompute)."""
    total = 0
    window = tuple(cfg["window_size"])
    for (dim, depth, _), size in zip(stages(cfg), stage_sizes(cfg)):
        clipped = get_window_size(size, window)
        n = reduce(mul, clipped)
        tokens = batch * reduce(mul, (-(-s // w) * w for s, w in zip(size, clipped)))
        total += depth * (2 * tokens * dim * (3 * dim + dim) + 2 * 2 * tokens * n * dim)
    return float(3 * total)


class Trainer:
    """The reference's train state: float32 parameters, AdamW moments, the
    step count and the stochastic depth and dropout generator, seeded as
    the program's is."""

    def __init__(self, params: Params, cfg: dict, train: dict, dropout_seed: int,
                 precision: str = "fp32"):
        self.cfg, self.train, self.precision = cfg, train, precision
        self.names = [n for n, *_ in param_specs(cfg)]
        self.params = {n: params[n].detach().clone().requires_grad_(True) for n in self.names}
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.count = 0
        self.gen = torch.Generator(next(iter(params.values())).device).manual_seed(dropout_seed)

    def resume(self, m: Params, v: Params, count: int, batch: int) -> None:
        """Take up AdamW's moments ``m``, ``v`` after ``count`` updates, and
        move the generator past the draws of those ``count`` steps at
        ``batch`` clips."""
        self.m = {n: m[n].detach().clone() for n in self.names}
        self.v = {n: v[n].detach().clone() for n in self.names}
        self.count = count
        for _ in range(count):
            draws(self.cfg, batch, self.gen, self.gen.device)
            dropout_keep(self.cfg, batch, self.gen, self.gen.device)

    def step(self, frames_u8: torch.Tensor, labels: torch.Tensor) -> Tuple[float, Params]:
        """One update. Returns the loss and the clipped gradient."""
        p = self.params
        with ops.exact_fp32():
            loss = smoothed_ce(forward_train(frames_u8, p, self.cfg, self.gen, self.precision),
                               labels, self.train["label_smoothing"])
            grads = torch.autograd.grad(loss, [p[n] for n in self.names])
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = torch.clamp(self.train["grad_clip_norm"] / norm, max=1.0)
        grads = {n: g * scale for n, g in zip(self.names, grads)}
        lr, wd = lr_at(self.train, self.count), self.train["weight_decay"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        with torch.no_grad():
            for n in self.names:
                g = grads[n]
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[n] / (1 - b1 ** self.count)
                v_hat = self.v[n] / (1 - b2 ** self.count)
                p[n].mul_(1 - lr * wd)
                p[n].sub_(lr * m_hat / (v_hat.sqrt() + eps))
        return float(loss.detach()), grads
