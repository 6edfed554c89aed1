"""Plain reference of ``timesformer`` and of one step of its fine-tune.

The network is TimeSformer with divided space–time attention (Bertasius,
Wang and Torresani, "Is Space-Time Attention All You Need for Video
Understanding?", ICML 2021), written line by line after
facebookresearch/TimeSformer's ``timesformer/models/vit.py``:
``PatchEmbed.forward``, ``VisionTransformer.forward_features`` and
``forward``, ``Block.forward`` under ``attention_type ==
'divided_space_time'``, ``Attention.forward``, ``Mlp.forward`` and
``drop_path``; each ``rearrange`` of the original is the reshape and
permute beside its pattern. Parameter names are ``VisionTransformer``'s.

Departures from ``vit.py``:

- functions over a flat dict of float32 parameters instead of modules, and
  plain reshapes and permutes instead of ``einops.rearrange``;
- the input is the staged uint8 clip: ``ops.crop_normalize`` takes the
  centre crop and normalises it (the program's preprocess) before the
  patch embedding;
- no resizing of ``pos_embed`` or ``time_embed``: the clip has the sizes
  they were made for;
- ``drop_path`` draws ``torch.rand`` in float32 from the step's generator
  (not in the branch's dtype from the global one) and keeps a sample where
  its draw is at least the rate (``floor(keep_prob + r)`` up to the
  rounding of that sum); each block's three draws (temporal, spatial, MLP)
  are made before the block runs, so that its recompute under a
  checkpoint takes the same masks;
- each block is checkpointed (recomputed in the backward pass) where a
  gradient is taken, so a full-size batch fits on one card: the
  arithmetic is the same;
- initialisation is the harness's (:func:`param_specs`), not the
  original's, and ``temporal_fc`` is drawn non-zero in every block (the
  original zeroes it in all blocks but the first, which would hide every
  fault of the temporal path).

One step: label-smoothed cross-entropy, the gradient, its global-norm clip
and AdamW under a linear warmup (``reference/i3d.py``'s). Float32 with TF32
off; ``precision="fp8"`` rounds every linear's, the patch conv's and the
two attention products' operands to float8 instead (e4m3 forward, e5m2 for
the gradient of their outputs), the control of a bfloat16 network; "bf16"
rounds them to bfloat16, a witness of what rounding alone does.

:func:`space_attn_flops` counts the spatial attention sub-layers' matmul
operations of a step, which the roofline of ``timesformer.space_attn``
reads."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import ops
from perfbench.reference.i3d import lr_at, smoothed_ce

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6
# The harness's scales: linears and the patch conv normal with std
# √(1 / fan_in), so that a branch's output is about as large as its
# normalised input and attention's softmax is not flat; biases uniform in
# ±BIAS; cls_token, pos_embed and time_embed normal with the original's
# std 0.02; the head uniform in ±1/√embed_dim, as nn.Linear draws it.
BIAS = 0.02
TOKEN_STD = 0.02


def sizes(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(T, patches per frame, embed_dim, heads, depth) of ``cfg``."""
    side = cfg["preprocess"]["crop"] // cfg["patch_size"]
    return cfg["num_frames"], side * side, cfg["embed_dim"], cfg["num_heads"], cfg["depth"]


def rates(cfg: dict) -> List[float]:
    """Each block's stochastic depth rate: ``torch.linspace(0,
    drop_path_rate, depth)``."""
    d = cfg["depth"]
    return [cfg["drop_path_rate"] * i / max(d - 1, 1) for i in range(d)]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter, in ``VisionTransformer``'s
    order of registration."""
    _, n, d, _, depth = sizes(cfg)
    p, hidden, c = cfg["patch_size"], d * cfg["mlp_ratio"], cfg["num_classes"]

    def linear(name, fan_in, fan_out):
        return [(f"{name}.weight", (fan_out, fan_in), "normal", math.sqrt(1.0 / fan_in)),
                (f"{name}.bias", (fan_out,), "uniform", BIAS)]

    def norm(name):
        return [(f"{name}.weight", (d,), "ones", 1.0), (f"{name}.bias", (d,), "zeros", 0.0)]

    specs = [("cls_token", (1, 1, d), "normal", TOKEN_STD),
             ("pos_embed", (1, n + 1, d), "normal", TOKEN_STD),
             ("time_embed", (1, cfg["num_frames"], d), "normal", TOKEN_STD),
             ("patch_embed.proj.weight", (d, 3, p, p), "normal", math.sqrt(1.0 / (3 * p * p))),
             ("patch_embed.proj.bias", (d,), "uniform", BIAS)]
    for i in range(depth):
        b = f"blocks.{i}"
        specs += (norm(f"{b}.norm1") + linear(f"{b}.attn.qkv", d, 3 * d)
                  + linear(f"{b}.attn.proj", d, d) + norm(f"{b}.temporal_norm1")
                  + linear(f"{b}.temporal_attn.qkv", d, 3 * d)
                  + linear(f"{b}.temporal_attn.proj", d, d) + linear(f"{b}.temporal_fc", d, d)
                  + norm(f"{b}.norm2") + linear(f"{b}.mlp.fc1", d, hidden)
                  + linear(f"{b}.mlp.fc2", hidden, d))
    bound = 1.0 / math.sqrt(d)
    specs += norm("norm") + [("head.weight", (c, d), "uniform", bound),
                             ("head.bias", (c,), "uniform", bound)]
    return specs


def linear(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    w = params[f"{name}.weight"]
    return ops.output(F.linear(ops.operand(x, precision), ops.operand(w, precision),
                               params[f"{name}.bias"]), precision)


def layer_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"],
                        LN_EPS)


def attention(x: torch.Tensor, params: Params, name: str, heads: int,
              precision: str) -> torch.Tensor:
    """``Attention.forward`` with ``with_qkv``: q, k, v from ``qkv``,
    softmax(q·kᵀ · head_dim^−½)·v, then ``proj``; no dropout."""
    B, N, C = x.shape
    qkv = linear(x, params, f"{name}.qkv", precision).reshape(
        B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scale = (C // heads) ** -0.5
    attn = ops.output(ops.operand(q, precision) @ ops.operand(k, precision).transpose(-2, -1),
                      precision) * scale
    attn = attn.softmax(dim=-1)
    x = ops.output(ops.operand(attn, precision) @ ops.operand(v, precision), precision)
    x = x.transpose(1, 2).reshape(B, N, C)
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


def draws(cfg: dict, batch: int, gen: Optional[torch.Generator], device) -> List[tuple]:
    """Each block's stochastic depth masks (temporal, spatial, MLP), drawn
    from ``gen`` in the program's order: [B·h·w], [B·T], [B] a block, none
    at rate 0 or without ``gen``."""
    t, n, *_ = sizes(cfg)
    out = []
    for rate in rates(cfg):
        if gen is None or rate == 0.0:
            out.append((None, None, None))
            continue
        out.append(tuple(torch.rand((m,), generator=gen, device=device) >= rate
                         for m in (batch * n, batch * t, batch)))
    return out


def block(x: torch.Tensor, masks: tuple, params: Params, i: int, cfg: dict, B: int, T: int,
          W: int, precision: str) -> torch.Tensor:
    """``Block.forward(x, B, T, W)`` under ``divided_space_time``."""
    name, rate, heads = f"blocks.{i}", rates(cfg)[i], cfg["num_heads"]
    keep_t, keep_s, keep_m = masks
    num_spatial_tokens = (x.size(1) - 1) // T
    H = num_spatial_tokens // W
    m = x.size(2)

    # Temporal
    xt = x[:, 1:, :]
    xt = xt.reshape(B * H * W, T, m)  # 'b (h w t) m -> (b h w) t m'
    res_temporal = drop_path(attention(layer_norm(xt, params, f"{name}.temporal_norm1"),
                                       params, f"{name}.temporal_attn", heads, precision),
                             keep_t, rate)
    res_temporal = res_temporal.reshape(B, H * W * T, m)  # '(b h w) t m -> b (h w t) m'
    res_temporal = linear(res_temporal, params, f"{name}.temporal_fc", precision)
    xt = x[:, 1:, :] + res_temporal

    # Spatial
    init_cls_token = x[:, 0, :].unsqueeze(1)
    cls_token = init_cls_token.repeat(1, T, 1)
    cls_token = cls_token.reshape(B * T, m).unsqueeze(1)  # 'b t m -> (b t) m'
    xs = xt
    # 'b (h w t) m -> (b t) (h w) m'
    xs = xs.reshape(B, H * W, T, m).permute(0, 2, 1, 3).reshape(B * T, H * W, m)
    xs = torch.cat((cls_token, xs), 1)
    res_spatial = drop_path(attention(layer_norm(xs, params, f"{name}.norm1"), params,
                                      f"{name}.attn", heads, precision), keep_s, rate)

    # Taking care of CLS token
    cls_token = res_spatial[:, 0, :]
    cls_token = cls_token.reshape(B, T, m)  # '(b t) m -> b t m'
    cls_token = torch.mean(cls_token, 1, True)  # averaging for every frame
    res_spatial = res_spatial[:, 1:, :]
    # '(b t) (h w) m -> b (h w t) m'
    res_spatial = res_spatial.reshape(B, T, H * W, m).permute(0, 2, 1, 3).reshape(
        B, H * W * T, m)
    res = res_spatial
    x = xt

    # Mlp
    x = torch.cat((init_cls_token, x), 1) + torch.cat((cls_token, res), 1)
    x = x + drop_path(mlp(layer_norm(x, params, f"{name}.norm2"), params, f"{name}.mlp",
                          precision), keep_m, rate)
    return x


def forward_train(frames_u8: torch.Tensor, params: Params, cfg: dict,
                  gen: Optional[torch.Generator], precision: str = "fp32",
                  recompute: bool = True) -> torch.Tensor:
    """Staged uint8 clips [B, T, Hs, Ws, 3] → logits [B, C]: ``forward``
    with ``forward_features``, stochastic depth drawn from ``gen`` (none
    without it). ``recompute``: checkpoint each block when a gradient is
    taken."""
    x = ops.crop_normalize(frames_u8, cfg["preprocess"]).permute(0, 2, 1, 3, 4)
    B, _, T = x.shape[:3]
    masks = draws(cfg, B, gen, x.device)
    # PatchEmbed.forward: 'b c t h w -> (b t) c h w', the conv, flatten.
    C, Hp, Wp = x.shape[1], x.shape[3], x.shape[4]
    x = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, Hp, Wp)
    x = ops.output(F.conv2d(ops.operand(x, precision),
                            ops.operand(params["patch_embed.proj.weight"], precision),
                            params["patch_embed.proj.bias"], stride=cfg["patch_size"]),
                   precision)
    W = x.size(-1)
    x = x.flatten(2).transpose(1, 2)

    cls_tokens = params["cls_token"].expand(x.size(0), -1, -1)
    x = torch.cat((cls_tokens, x), dim=1)
    x = x + params["pos_embed"]

    # Time Embeddings
    cls_tokens = x[:B, 0, :].unsqueeze(1)
    x = x[:, 1:]
    n, m = x.shape[1:]
    x = x.reshape(B, T, n, m).permute(0, 2, 1, 3).reshape(B * n, T, m)  # '(b t) n m -> (b n) t m'
    x = x + params["time_embed"]
    x = x.reshape(B, n * T, m)  # '(b n) t m -> b (n t) m'
    x = torch.cat((cls_tokens, x), dim=1)

    # Attention blocks
    for i in range(cfg["depth"]):
        args = (masks[i], params, i, cfg, B, T, W, precision)
        if recompute and torch.is_grad_enabled():
            x = checkpoint(block, x, *args, use_reentrant=False)
        else:
            x = block(x, *args)
    x = layer_norm(x, params, "norm")
    x = x[:, 0]
    return F.linear(x, params["head.weight"], params["head.bias"])


def forward(frames_u8: torch.Tensor, params: Params, cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Inference: staged uint8 clips → logits [B, C] float32, TF32 off."""
    with ops.exact_fp32(), torch.no_grad():
        return forward_train(frames_u8, params, cfg, None, precision, recompute=False)


def space_attn_flops(cfg: dict, batch: int) -> float:
    """The spatial attention sub-layers' matmul operations in one train
    step of ``batch`` clips: the q/k/v and output projections, q·kᵀ and the
    weighted sum of v, over B·T sequences of 1 + h·w tokens, in every
    block; 2 a multiply-add, the backward counted as twice the forward (no
    recompute)."""
    t, n, d, _, depth = sizes(cfg)
    seqs, length = batch * t, n + 1
    tokens = seqs * length
    forward_flops = 2 * tokens * d * (3 * d + d) + 2 * 2 * seqs * length * length * d
    return float(3 * forward_flops * depth)


class Trainer:
    """The reference's train state: float32 parameters, AdamW moments, the
    step count and the stochastic depth generator, seeded as the program's
    is."""

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
        move the generator past the stochastic depth draws of those
        ``count`` steps at ``batch`` clips."""
        self.m = {n: m[n].detach().clone() for n in self.names}
        self.v = {n: v[n].detach().clone() for n in self.names}
        self.count = count
        for _ in range(count):
            draws(self.cfg, batch, self.gen, self.gen.device)

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
