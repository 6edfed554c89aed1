"""Plain reference of ``mvit_v2`` and of one step of its fine-tune.

The network is MViTv2 (Li et al., "MViTv2: Improved Multiscale Vision
Transformers for Classification and Detection", CVPR 2022,
arXiv:2112.01526), written line by line after facebookresearch/SlowFast:
``slowfast/models/video_model_builder.py`` (``MViT.__init__``'s block
settings and ``MViT.forward``), ``slowfast/models/attention.py``
(``attention_pool``, ``MultiScaleAttention.forward``,
``MultiScaleBlock.forward``), ``slowfast/models/utils.py``
(``round_width``, ``get_rel_pos``, ``cal_rel_pos_spatial``,
``cal_rel_pos_temporal``), ``slowfast/models/stem_helper.py``
(``PatchEmbed.forward``) and ``slowfast/models/head_helper.py``
(``TransformerBasicHead.forward``), under ``MODE: conv``,
``CLS_EMBED_ON``, ``USE_ABS_POS: False``, ``REL_POS_SPATIAL``,
``REL_POS_TEMPORAL``, ``RESIDUAL_POOLING``, ``DIM_MUL_IN_ATT``,
``QKV_BIAS``, ``POOL_FIRST: False``, ``USE_MEAN_POOLING: False``,
``LAYER_SCALE_INIT_VALUE: 0`` and ``DROPOUT_RATE: 0``. Parameter names are
``MViT``'s.

Departures from SlowFast:

- functions over a flat dict of float32 parameters instead of modules; a
  norm is ``F.layer_norm`` with its pair;
- a pool (``nn.Conv3d`` with ``groups`` = channels, no bias) is written as
  the sum of its 27 taps, each channel's weight times the shifted, strided
  input (:func:`pool_conv`): the same values, and torch's
  ``FlopCounterMode``, which ``mfu.train`` reads through the harness,
  counts a grouped convolution's backward as an ungrouped one's (96 times
  the work at heads of 96: 1.644 TFLOP a clip for the 1.347 it is), while
  the taps' products it does not count at all (≈ 9.5 GFLOP a clip, 0.7%);
- the input is the staged uint8 clip: ``ops.crop_normalize`` takes the
  centre crop and normalises it (the program's preprocess) before the
  patch embedding;
- the configuration is a dict of the ``MVIT`` keys in lower case
  (``dim_mul``, ``head_mul``, ``pool_q_stride``, ``pool_kvq_kernel``,
  ``pool_kv_stride_adaptive``, ``patch_kernel``, ``patch_stride``,
  ``patch_padding``, ``embed_dim``, ``depth``, ``num_heads``,
  ``mlp_ratio``, ``drop_path_rate``), ``dropout`` for ``MODEL.DROPOUT_RATE``;
  the multipliers are Python floats, not a ``torch.ones`` tensor, and the
  stochastic depth rates ``rate · k / (depth − 1)`` in float64, not
  ``torch.linspace`` in float32;
- ``drop_path`` draws ``torch.rand`` in float32 from the step's generator
  and keeps a sample where its draw is at least the rate (the original's
  ``floor(keep_prob + rand)`` up to the rounding of that sum); each
  block's two draws (attention, MLP; [B] each) and the head's dropout draw
  ([B, C]) are made before the network runs, so that a block's recompute
  under a checkpoint takes the same masks; a block at rate 0 draws
  nothing;
- each block is checkpointed (recomputed in the backward pass) where a
  gradient is taken and ``recompute`` is set, as ``ACT_CHECKPOINT`` does,
  so a full-size batch fits on one card beside the program's state: the
  arithmetic is the same;
- the head returns the logits at evaluation too (the original's softmax
  there is left out);
- q·kᵀ and the weighted sum are copied before the in-place adds of the
  relative-position terms and of residual pooling (the same values);
- initialisation is the harness's (:func:`param_specs`), not the
  original's.

One step: label-smoothed cross-entropy, the gradient, its global-norm clip
and AdamW under a linear warmup (``reference/i3d.py``'s). Float32 with TF32
off; ``precision="fp8"`` rounds the operands of every linear layer but the
head, of the patch conv and the three pools, of q·kᵀ and of the weighted
sum, and of the three relative-position products, to float8 instead (e4m3
forward, e5m2 for the gradient of their outputs), the control of a
bfloat16 network; "bf16" rounds them to bfloat16, a witness of what
rounding alone does.

:func:`pool_attn_flops` counts the pooling attention sub-layers' matmul and
convolution operations of a step, which the roofline of ``mvit.attn``
reads."""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import ops
from perfbench.reference.i3d import lr_at, smoothed_ce

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
# The harness's scales: linears, the patch conv and the pools normal with
# std √(1 / fan_in), so that a branch's output is about as large as its
# normalised input and attention's softmax is not flat; biases uniform in
# ±BIAS; the cls token and the relative-position tables normal with the
# original's std 0.02; the head uniform in ±1/√features, as nn.Linear draws
# it.
BIAS = 0.02
TABLE_STD = 0.02


def round_width(width, multiplier, min_width=1, divisor=1):
    """``slowfast/models/utils.py``'s ``round_width``."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def rates(cfg: dict) -> List[float]:
    """Each block's stochastic depth rate."""
    n = cfg["depth"]
    return [cfg["drop_path_rate"] * i / max(n - 1, 1) for i in range(n)]


def patch_dims(cfg: dict) -> List[int]:
    """The token grid after the patch embedding: ``input_dims // patch_stride``."""
    crop, stride = cfg["preprocess"]["crop"], cfg["patch_stride"]
    return [cfg["num_frames"] // stride[0], crop // stride[1], crop // stride[2]]


def blocks(cfg: dict) -> List[dict]:
    """Each block's ``MultiScaleBlock`` arguments, as ``MViT.__init__``
    derives them: dim, dim_out, num_heads, input_size, kernel_q, kernel_kv,
    stride_q, stride_kv, drop_path."""
    depth = cfg["depth"]
    dim_mul, head_mul = [1.0] * (depth + 1), [1.0] * (depth + 1)
    for i in range(len(cfg["dim_mul"])):
        dim_mul[cfg["dim_mul"][i][0]] = cfg["dim_mul"][i][1]
    for i in range(len(cfg["head_mul"])):
        head_mul[cfg["head_mul"][i][0]] = cfg["head_mul"][i][1]

    pool_q = [[] for i in range(depth)]
    pool_kv = [[] for i in range(depth)]
    stride_q = [[] for i in range(depth)]
    stride_kv = [[] for i in range(depth)]

    for i in range(len(cfg["pool_q_stride"])):
        stride_q[cfg["pool_q_stride"][i][0]] = list(cfg["pool_q_stride"][i][1:])
        pool_q[cfg["pool_q_stride"][i][0]] = list(cfg["pool_kvq_kernel"])

    # If POOL_KV_STRIDE_ADAPTIVE is not None, initialize POOL_KV_STRIDE.
    _stride_kv = list(cfg["pool_kv_stride_adaptive"])
    pool_kv_stride = []
    for i in range(depth):
        if len(stride_q[i]) > 0:
            _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(len(_stride_kv))]
        pool_kv_stride.append([i] + _stride_kv)

    for i in range(len(pool_kv_stride)):
        stride_kv[pool_kv_stride[i][0]] = pool_kv_stride[i][1:]
        pool_kv[pool_kv_stride[i][0]] = list(cfg["pool_kvq_kernel"])

    input_size = patch_dims(cfg)
    embed_dim, num_heads, dpr = cfg["embed_dim"], cfg["num_heads"], rates(cfg)
    out = []
    for i in range(depth):
        num_heads = round_width(num_heads, head_mul[i])
        dim_out = round_width(embed_dim, dim_mul[i], divisor=round_width(num_heads, head_mul[i]))
        out.append(dict(dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
                        input_size=list(input_size), kernel_q=pool_q[i], kernel_kv=pool_kv[i],
                        stride_q=stride_q[i], stride_kv=stride_kv[i], drop_path=dpr[i]))
        if len(stride_q[i]) > 0:
            input_size = [size // stride for size, stride in zip(input_size, stride_q[i])]
        embed_dim = dim_out
    return out


def rel_sp_dim(blk: dict) -> int:
    """``MultiScaleAttention.__init__``'s rows of ``rel_pos_h`` and ``rel_pos_w``."""
    size = blk["input_size"][1]
    q_size = size // blk["stride_q"][1] if len(blk["stride_q"]) > 0 else size
    kv_size = size // blk["stride_kv"][1] if len(blk["stride_kv"]) > 0 else size
    return 2 * max(q_size, kv_size) - 1


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter, in ``MViT``'s
    ``state_dict`` order (a module's own parameters before its children's)."""
    c0, kernel = cfg["embed_dim"], tuple(cfg["patch_kernel"])

    def linear(name, fan_in, fan_out):
        return [(f"{name}.weight", (fan_out, fan_in), "normal", math.sqrt(1.0 / fan_in)),
                (f"{name}.bias", (fan_out,), "uniform", BIAS)]

    def norm(name, dim):
        return [(f"{name}.weight", (dim,), "ones", 1.0), (f"{name}.bias", (dim,), "zeros", 0.0)]

    specs = [("cls_token", (1, 1, c0), "normal", TABLE_STD),
             ("patch_embed.proj.weight", (c0, 3, *kernel), "normal",
              math.sqrt(1.0 / (3 * math.prod(kernel)))),
             ("patch_embed.proj.bias", (c0,), "uniform", BIAS)]
    for i, blk in enumerate(blocks(cfg)):
        b, dim, dim_out = f"blocks.{i}", blk["dim"], blk["dim_out"]
        head_dim = dim_out // blk["num_heads"]
        rows = rel_sp_dim(blk)
        specs += norm(f"{b}.norm1", dim) + [
            (f"{b}.attn.rel_pos_h", (rows, head_dim), "normal", TABLE_STD),
            (f"{b}.attn.rel_pos_w", (rows, head_dim), "normal", TABLE_STD),
            (f"{b}.attn.rel_pos_t", (2 * blk["input_size"][0] - 1, head_dim), "normal",
             TABLE_STD)]
        specs += linear(f"{b}.attn.qkv", dim, 3 * dim_out) + linear(f"{b}.attn.proj", dim_out,
                                                                     dim_out)
        for name, k in (("q", blk["kernel_q"]), ("k", blk["kernel_kv"]), ("v", blk["kernel_kv"])):
            specs += [(f"{b}.attn.pool_{name}.weight", (head_dim, 1, *k), "normal",
                       math.sqrt(1.0 / math.prod(k)))] + norm(f"{b}.attn.norm_{name}", head_dim)
        hidden = int(dim_out * cfg["mlp_ratio"])
        specs += (norm(f"{b}.norm2", dim_out) + linear(f"{b}.mlp.fc1", dim_out, hidden)
                  + linear(f"{b}.mlp.fc2", hidden, dim_out))
        if dim != dim_out:
            specs += linear(f"{b}.proj", dim, dim_out)
    features = blocks(cfg)[-1]["dim_out"]
    bound = 1.0 / math.sqrt(features)
    specs += norm("norm", features) + [
        ("head.projection.weight", (cfg["num_classes"], features), "uniform", bound),
        ("head.projection.bias", (cfg["num_classes"],), "uniform", bound)]
    return specs


def linear(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    w = params[f"{name}.weight"]
    return ops.output(F.linear(ops.operand(x, precision), ops.operand(w, precision),
                               params.get(f"{name}.bias")), precision)


def layer_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"],
                        LN_EPS)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return ops.output(ops.operand(a, precision) @ ops.operand(b, precision), precision)


def pool_conv(x: torch.Tensor, weight: torch.Tensor, stride, padding,
              precision: str) -> torch.Tensor:
    """The depthwise ``nn.Conv3d(dim_conv, dim_conv, kernel, stride, padding,
    groups=dim_conv, bias=False)`` of ``x`` [N, C, T, H, W] by ``weight``
    [C, 1, kt, kh, kw], written as the sum of the kernel's taps: each
    channel's weight times the zero-padded input shifted by the tap and
    strided."""
    x, weight = ops.operand(x, precision), ops.operand(weight, precision)
    kernel = weight.shape[2:]
    x = F.pad(x, (padding[2], padding[2], padding[1], padding[1], padding[0], padding[0]))
    size = [(n - k) // s + 1 for n, k, s in zip(x.shape[2:], kernel, stride)]
    out = 0
    for i in range(kernel[0]):
        for j in range(kernel[1]):
            for k in range(kernel[2]):
                tap = x[:, :, i:i + (size[0] - 1) * stride[0] + 1:stride[0],
                        j:j + (size[1] - 1) * stride[1] + 1:stride[1],
                        k:k + (size[2] - 1) * stride[2] + 1:stride[2]]
                out = out + weight[:, 0, i, j, k].view(1, -1, 1, 1, 1) * tap
    return ops.output(out, precision)


def attention_pool(tensor, pool, thw_shape, has_cls_embed=True, norm=None):
    """``attention_pool``: pool the tokens of ``tensor`` [B, N, L, C] (or
    [B, L, C]) as a grid ``thw_shape``, the cls token set aside, then put it
    back and apply ``norm``."""
    if pool is None:
        return tensor, thw_shape
    tensor_dim = tensor.ndim
    if tensor_dim == 4:
        pass
    elif tensor_dim == 3:
        tensor = tensor.unsqueeze(1)
    else:
        raise NotImplementedError(f"Unsupported input dimension {tensor.shape}")

    if has_cls_embed:
        cls_tok, tensor = tensor[:, :, :1, :], tensor[:, :, 1:, :]

    B, N, L, C = tensor.shape
    T, H, W = thw_shape
    tensor = tensor.reshape(B * N, T, H, W, C).permute(0, 4, 1, 2, 3).contiguous()

    tensor = pool(tensor)

    thw_shape = [tensor.shape[2], tensor.shape[3], tensor.shape[4]]
    L_pooled = tensor.shape[2] * tensor.shape[3] * tensor.shape[4]
    tensor = tensor.reshape(B, N, C, L_pooled).transpose(2, 3)
    if has_cls_embed:
        tensor = torch.cat((cls_tok, tensor), dim=2)
    if norm is not None:
        tensor = norm(tensor)
    # Assert tensor_dim in [3, 4]
    if tensor_dim == 4:
        pass
    else:  # tensor_dim == 3:
        tensor = tensor.squeeze(1)
    return tensor, thw_shape


def get_rel_pos(rel_pos, d):
    """``get_rel_pos``: the table, interpolated to ``d`` rows where it has
    another number."""
    if isinstance(d, int):
        ori_d = rel_pos.shape[0]
        if ori_d == d:
            return rel_pos
        else:
            # Interpolate rel pos.
            new_pos_embed = F.interpolate(
                rel_pos.reshape(1, ori_d, -1).permute(0, 2, 1),
                size=d,
                mode="linear",
            )
            return new_pos_embed.reshape(-1, d).permute(1, 0)


def cal_rel_pos_spatial(attn, q, has_cls_embed, q_shape, k_shape, rel_pos_h, rel_pos_w,
                        precision):
    """``cal_rel_pos_spatial``: ``attn`` plus q·Rh[h_q, h_k] and q·Rw[w_q, w_k]."""
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dh = int(2 * max(q_h, k_h) - 1)
    dw = int(2 * max(q_w, k_w) - 1)

    # Scale up rel pos if shapes for q and k are different.
    q_h_ratio = max(k_h / q_h, 1.0)
    k_h_ratio = max(q_h / k_h, 1.0)
    dist_h = (torch.arange(q_h, device=q.device)[:, None] * q_h_ratio
              - torch.arange(k_h, device=q.device)[None, :] * k_h_ratio)
    dist_h += (k_h - 1) * k_h_ratio
    q_w_ratio = max(k_w / q_w, 1.0)
    k_w_ratio = max(q_w / k_w, 1.0)
    dist_w = (torch.arange(q_w, device=q.device)[:, None] * q_w_ratio
              - torch.arange(k_w, device=q.device)[None, :] * k_w_ratio)
    dist_w += (k_w - 1) * k_w_ratio

    # Intepolate rel pos if needed.
    rel_pos_h = get_rel_pos(rel_pos_h, dh)
    rel_pos_w = get_rel_pos(rel_pos_w, dw)
    Rh = rel_pos_h[dist_h.long()]
    Rw = rel_pos_w[dist_w.long()]

    B, n_head, q_N, dim = q.shape

    r_q = q[:, :, sp_idx:].reshape(B, n_head, q_t, q_h, q_w, dim)
    rel_h_q = ops.output(torch.einsum("bythwc,hkc->bythwk", ops.operand(r_q, precision),
                                      ops.operand(Rh, precision)), precision)
    rel_w_q = ops.output(torch.einsum("bythwc,wkc->bythwk", ops.operand(r_q, precision),
                                      ops.operand(Rw, precision)), precision)

    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel_h_q[:, :, :, :, :, None, :, None]
        + rel_w_q[:, :, :, :, :, None, None, :]
    ).view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)

    return attn


def cal_rel_pos_temporal(attn, q, has_cls_embed, q_shape, k_shape, rel_pos_t, precision):
    """``cal_rel_pos_temporal``: ``attn`` plus q·Rt[t_q, t_k]."""
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dt = int(2 * max(q_t, k_t) - 1)
    # Intepolate rel pos if needed.
    rel_pos_t = get_rel_pos(rel_pos_t, dt)

    # Scale up rel pos if shapes for q and k are different.
    q_t_ratio = max(k_t / q_t, 1.0)
    k_t_ratio = max(q_t / k_t, 1.0)
    dist_t = (torch.arange(q_t, device=q.device)[:, None] * q_t_ratio
              - torch.arange(k_t, device=q.device)[None, :] * k_t_ratio)
    dist_t += (k_t - 1) * k_t_ratio
    Rt = rel_pos_t[dist_t.long()]

    B, n_head, q_N, dim = q.shape

    r_q = q[:, :, sp_idx:].reshape(B, n_head, q_t, q_h, q_w, dim)
    # [B, H, q_t, q_h, q_w, dim] -> [q_t, B, H, q_h, q_w, dim] -> [q_t, B*H*q_h*q_w, dim]
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, B * n_head * q_h * q_w, dim)

    # [q_t, B*H*q_h*q_w, dim] * [q_t, dim, k_t] = [q_t, B*H*q_h*q_w, k_t] -> [B*H*q_h*q_w, q_t, k_t]
    rel = matmul(r_q, Rt.transpose(1, 2), precision).transpose(0, 1)
    # [B*H*q_h*q_w, q_t, k_t] -> [B, H, q_t, q_h, q_w, k_t]
    rel = rel.view(B, n_head, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)

    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel[:, :, :, :, :, :, None, None]
    ).view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)

    return attn


def multi_scale_attention(x: torch.Tensor, thw_shape, params: Params, name: str, blk: dict,
                          precision: str):
    """``MultiScaleAttention.forward`` (no pool_first, packed qkv): the
    pooled, normalised q, k and v, (q·scale)·kᵀ plus both relative-position
    terms, softmax, times v, the pooled q added back, ``proj``."""
    B, N, _ = x.shape
    num_heads, dim_out = blk["num_heads"], blk["dim_out"]
    head_dim = dim_out // num_heads
    scale = head_dim ** -0.5
    qkv = linear(x, params, f"{name}.qkv", precision).reshape(B, N, 3, num_heads, -1).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]

    def pool_and_norm(which, kernel, stride):
        padding = [int(s // 2) for s in kernel]
        pool = functools.partial(pool_conv, weight=params[f"{name}.pool_{which}.weight"],
                                 stride=stride, padding=padding, precision=precision)
        norm = functools.partial(layer_norm, params=params, name=f"{name}.norm_{which}")
        return pool, norm

    pool, norm = pool_and_norm("q", blk["kernel_q"], blk["stride_q"])
    q, q_shape = attention_pool(q, pool, thw_shape, has_cls_embed=True, norm=norm)
    pool, norm = pool_and_norm("k", blk["kernel_kv"], blk["stride_kv"])
    k, k_shape = attention_pool(k, pool, thw_shape, has_cls_embed=True, norm=norm)
    pool, norm = pool_and_norm("v", blk["kernel_kv"], blk["stride_kv"])
    v, v_shape = attention_pool(v, pool, thw_shape, has_cls_embed=True, norm=norm)

    # Both products are copied to tensors of their own: below fp32 they are
    # views of the rounding function, which the in-place adds may not write.
    attn = matmul(q * scale, k.transpose(-2, -1), precision).clone()
    attn = cal_rel_pos_spatial(attn, q, True, q_shape, k_shape, params[f"{name}.rel_pos_h"],
                               params[f"{name}.rel_pos_w"], precision)
    attn = cal_rel_pos_temporal(attn, q, True, q_shape, k_shape, params[f"{name}.rel_pos_t"],
                                precision)
    attn = attn.softmax(dim=-1)

    x = matmul(attn, v, precision).clone()

    # residual pooling
    x[:, :, 1:, :] += q[:, :, 1:, :]

    x = x.transpose(1, 2).reshape(B, -1, dim_out)
    x = linear(x, params, f"{name}.proj", precision)
    return x, q_shape


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


def attention_part(x: torch.Tensor, thw_shape, keep: Optional[torch.Tensor], params: Params,
                   name: str, blk: dict, precision: str):
    """``MultiScaleBlock.forward`` up to the first residual add: norm1, the
    attention, the skip's projection (``DIM_MUL_IN_ATT``) and max-pool, and
    the add with stochastic depth."""
    x_norm = layer_norm(x, params, f"{name}.norm1")
    x_block, thw_shape_new = multi_scale_attention(x_norm, thw_shape, params, f"{name}.attn",
                                                   blk, precision)
    if blk["dim"] != blk["dim_out"]:
        x = linear(x_norm, params, f"{name}.proj", precision)
    stride_skip = blk["stride_q"]
    kernel_skip = [s + 1 if s > 1 else s for s in stride_skip]
    padding_skip = [int(skip // 2) for skip in kernel_skip]
    pool_skip = (functools.partial(F.max_pool3d, kernel_size=kernel_skip, stride=stride_skip,
                                   padding=padding_skip, ceil_mode=False)
                 if len(stride_skip) > 0 and math.prod(stride_skip) > 1 else None)
    x_res, _ = attention_pool(x, pool_skip, thw_shape, has_cls_embed=True)
    return x_res + drop_path(x_block, keep, blk["drop_path"]), thw_shape_new


def block(x: torch.Tensor, thw_shape, keeps: tuple, params: Params, name: str, blk: dict,
          precision: str) -> torch.Tensor:
    """``MultiScaleBlock.forward``: the attention and the MLP, each a
    residual branch with stochastic depth."""
    keep_attn, keep_mlp = keeps
    x, _ = attention_part(x, thw_shape, keep_attn, params, name, blk, precision)
    x_norm = layer_norm(x, params, f"{name}.norm2")
    x_mlp = mlp(x_norm, params, f"{name}.mlp", precision)
    return x + drop_path(x_mlp, keep_mlp, blk["drop_path"])


def draws(cfg: dict, batch: int, gen: Optional[torch.Generator], device) -> List[tuple]:
    """Each block's stochastic depth masks (attention, MLP), [B] each,
    drawn from ``gen`` in the program's order; none at rate 0 or without
    ``gen``."""
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
    features = blocks(cfg)[-1]["dim_out"]
    if gen is None or cfg["dropout"] == 0.0:
        return None
    return torch.rand((batch, features), generator=gen, device=device) >= cfg["dropout"]


def forward_train(frames_u8: torch.Tensor, params: Params, cfg: dict,
                  gen: Optional[torch.Generator], precision: str = "fp32",
                  recompute: bool = True) -> torch.Tensor:
    """Staged uint8 clips [B, T, Hs, Ws, 3] → logits [B, C]: ``MViT.forward``
    and ``TransformerBasicHead.forward``, stochastic depth and dropout
    drawn from ``gen`` (none without it). ``recompute``: checkpoint each
    block when a gradient is taken."""
    x = ops.crop_normalize(frames_u8, cfg["preprocess"]).permute(0, 2, 1, 3, 4)  # B C T H W
    B = x.shape[0]
    masks = draws(cfg, B, gen, x.device)
    keep_head = dropout_keep(cfg, B, gen, x.device)

    # PatchEmbed.forward
    x = ops.output(F.conv3d(ops.operand(x, precision),
                            ops.operand(params["patch_embed.proj.weight"], precision),
                            params["patch_embed.proj.bias"], stride=cfg["patch_stride"],
                            padding=cfg["patch_padding"]), precision)
    bcthw = x.shape
    x = x.flatten(2).transpose(1, 2)
    T, H, W = bcthw[-3], bcthw[-2], bcthw[-1]
    assert [T, H, W] == patch_dims(cfg), bcthw
    B, N, C = x.shape

    cls_tokens = params["cls_token"].expand(B, -1, -1)
    x = torch.cat((cls_tokens, x), dim=1)

    thw = [T, H, W]
    for i, blk in enumerate(blocks(cfg)):
        args = (thw, masks[i], params, f"blocks.{i}", blk, precision)
        if recompute and torch.is_grad_enabled():
            x = checkpoint(block, x, *args, use_reentrant=False)
        else:
            x = block(x, *args)
        if len(blk["stride_q"]) > 0:
            thw = [size // stride for size, stride in zip(thw, blk["stride_q"])]

    x = layer_norm(x, params, "norm")
    x = x[:, 0]
    # TransformerBasicHead.forward: dropout, projection.
    if keep_head is not None:
        x = x * keep_head.to(x.dtype) / (1.0 - cfg["dropout"])
    return F.linear(x, params["head.projection.weight"], params["head.projection.bias"])


def forward(frames_u8: torch.Tensor, params: Params, cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Inference: staged uint8 clips → logits [B, C] float32, TF32 off."""
    with ops.exact_fp32(), torch.no_grad():
        return forward_train(frames_u8, params, cfg, None, precision, recompute=False)


def pool_attn_flops(cfg: dict, batch: int) -> float:
    """The pooling attention sub-layers' matmul and convolution operations
    in one train step of ``batch`` clips, over every block: the q/k/v
    projection, the three depthwise pools (27 multiply-adds an output
    value at a 3³ kernel), q·kᵀ, the three relative-position products, the
    weighted sum, ``proj`` and, where the width changes, the skip's
    projection; 2 a multiply-add, the backward counted as twice the
    forward (no recompute)."""
    total, thw = 0, patch_dims(cfg)
    for blk in blocks(cfg):
        dim, dim_out, heads = blk["dim"], blk["dim_out"], blk["num_heads"]
        head_dim = dim_out // heads
        q_thw = [(n + 2 * (k // 2) - k) // s + 1
                 for n, k, s in zip(thw, blk["kernel_q"], blk["stride_q"])]
        kv_thw = [(n + 2 * (k // 2) - k) // s + 1
                  for n, k, s in zip(thw, blk["kernel_kv"], blk["stride_kv"])]
        n_in, n_q, n_kv = (math.prod(s) for s in (thw, q_thw, kv_thw))
        rows = batch * heads
        macs = batch * (1 + n_in) * dim * 3 * dim_out
        macs += rows * head_dim * (n_q * math.prod(blk["kernel_q"])
                                   + 2 * n_kv * math.prod(blk["kernel_kv"]))
        macs += 2 * rows * (1 + n_q) * (1 + n_kv) * head_dim
        macs += rows * n_q * sum(kv_thw) * head_dim
        macs += batch * (1 + n_q) * dim_out * dim_out
        if dim != dim_out:
            macs += batch * (1 + n_in) * dim * dim_out
        total += 2 * macs
        thw = q_thw
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
