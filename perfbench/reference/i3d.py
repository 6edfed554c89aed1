"""Plain reference of ``i3d`` and of one step of its fine-tune.

The network is I3D (Carreira & Zisserman, "Quo Vadis, Action
Recognition?", CVPR 2017): Inception-v1 inflated to 3D, as pytorch-i3d
writes it and WLASL (Li et al., WACV 2020) fine-tunes it. TensorFlow-"SAME"
padding on every conv and max-pool (pools pad with −inf), BatchNorm with
eps 1e-3, ReLU; the head averages over space, averages adjacent time
steps, applies dropout and the per-step linear ``logits`` and averages
the logits over time. Parameter names are pytorch-i3d's.

One step: label-smoothed cross-entropy, the gradient, its global-norm clip
and AdamW (decoupled weight decay on every parameter) under a linear
warmup. Float32 with TF32 off; ``precision="fp8"`` rounds every conv's
operands to float8 instead (e4m3 forward, e5m2 for the gradient of its
output), the control of a bfloat16 network. Two witnesses of what
rounding alone does: ``"bf16"`` rounds every conv's operands and output
gradient to bfloat16, ``"bf16_input"`` only the normalised input.
Stages are checkpointed (recomputed in the backward pass), so a full-size
batch fits on one card: the arithmetic is the same."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import ops

Params = Dict[str, torch.Tensor]
BN_EPS = 1e-3
# (name, (b0, b1a, b1b, b2a, b2b, b3b)): Inception-v1's branch widths.
MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
# Unit3D name → (in, out, kernel, stride).
Unit = Tuple[int, int, Tuple[int, int, int], Tuple[int, int, int]]


def units() -> Dict[str, Unit]:
    out: Dict[str, Unit] = {
        "Conv3d_1a_7x7": (3, 64, (7, 7, 7), (2, 2, 2)),
        "Conv3d_2b_1x1": (64, 64, (1, 1, 1), (1, 1, 1)),
        "Conv3d_2c_3x3": (64, 192, (3, 3, 3), (1, 1, 1)),
    }
    cin = 192
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in MIXED:
        one, three = (1, 1, 1), (3, 3, 3)
        out.update({f"{name}.b0": (cin, b0, one, one), f"{name}.b1a": (cin, b1a, one, one),
                    f"{name}.b1b": (b1a, b1b, three, one), f"{name}.b2a": (cin, b2a, one, one),
                    f"{name}.b2b": (b2a, b2b, three, one), f"{name}.b3b": (cin, b3b, one, one)})
        cin = b0 + b1b + b2b + b3b
    return out


# Every BatchNorm's shift at first: its ReLU then passes nearly all of its
# input, and the random network is close to linear. With shifts at 0 it
# is chaotic in training mode (BatchNorm's gradient explosion): rounding
# the input alone to bf16 moved the first gradient as much as computing
# in float8 did, and no comparison could tell the two apart.
BN_SHIFT = 3.0


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale): convs normal with std √(2 / fan_in),
    BN scale 1, shift :data:`BN_SHIFT`, statistics (0, 1), the classifier
    uniform in ±1/√1024."""
    specs = []
    for name, (cin, cout, k, _) in units().items():
        specs.append((f"{name}.conv3d.weight", (cout, cin, *k), "normal",
                      math.sqrt(2.0 / (cin * math.prod(k)))))
        specs += [(f"{name}.bn.weight", (cout,), "ones", 1.0),
                  (f"{name}.bn.bias", (cout,), "const", BN_SHIFT),
                  (f"{name}.bn.running_mean", (cout,), "zeros", 1.0),
                  (f"{name}.bn.running_var", (cout,), "ones", 1.0)]
    c, bound = cfg["num_classes"], 1.0 / math.sqrt(1024)
    specs += [("logits.conv3d.weight", (c, 1024, 1, 1, 1), "uniform", bound),
              ("logits.conv3d.bias", (c,), "uniform", bound)]
    return specs


def unit(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    """SAME conv (no bias) → BatchNorm on the batch's statistics → ReLU."""
    _, _, k, s = units()[name]
    w = params[f"{name}.conv3d.weight"]
    x = ops.output(F.conv3d(ops.operand(ops.pad_same(x, k, s), precision),
                            ops.operand(w, precision), None, s), precision)
    return F.relu(ops.batch_norm(x, params, f"{name}.bn", BN_EPS, "train"))


def max_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    return F.max_pool3d(ops.pad_same(x, k, s, float("-inf")), k, s)


def inception(x: torch.Tensor, params: Params, name: str, precision: str) -> torch.Tensor:
    def u(branch, y):
        return unit(y, params, f"{name}.{branch}", precision)

    return torch.cat([u("b0", x), u("b1b", u("b1a", x)), u("b2b", u("b2a", x)),
                      u("b3b", max_pool(x, (3, 3, 3), (1, 1, 1)))], dim=1)


def _stages(params: Params, precision: str):
    def stem(x):
        return max_pool(unit(x, params, "Conv3d_1a_7x7", precision), (1, 3, 3), (1, 2, 2))

    def conv2(x):
        x = unit(unit(x, params, "Conv3d_2b_1x1", precision), params, "Conv3d_2c_3x3", precision)
        return max_pool(x, (1, 3, 3), (1, 2, 2))

    def mixed(names, pool):
        def run(x):
            for n in names:
                x = inception(x, params, n, precision)
            return pool(x) if pool else x
        return run

    return [stem, conv2,
            mixed(["Mixed_3b", "Mixed_3c"], lambda x: max_pool(x, (3, 3, 3), (2, 2, 2))),
            mixed(["Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"],
                  lambda x: F.max_pool3d(x, (2, 2, 2), (2, 2, 2))),
            mixed(["Mixed_5b", "Mixed_5c"], None)]


def forward_train(frames_u8: torch.Tensor, params: Params, cfg: dict,
                  gen: Optional[torch.Generator], precision: str = "fp32",
                  recompute: bool = True) -> torch.Tensor:
    """Staged uint8 clips [B, T, Hs, Ws, 3] → logits [B, C], BatchNorm on the
    batch's statistics. Dropout keeps a feature of the pair-averaged
    [B, T'', 1024] where ``torch.rand`` of that shape from ``gen`` is at
    least p, and scales it by 1 / (1 − p); no dropout without ``gen``.
    ``recompute``: checkpoint each stage when a gradient is taken."""
    x = ops.crop_normalize(frames_u8, cfg["preprocess"]).permute(0, 2, 1, 3, 4)
    if precision == "bf16_input":
        x, precision = x.bfloat16().float(), "fp32"
    for stage in _stages(params, precision):
        if recompute and torch.is_grad_enabled():
            x = checkpoint(stage, x, use_reentrant=False)
        else:
            x = stage(x)
    x = x.mean(dim=(3, 4)).transpose(1, 2)  # [B, T', 1024]
    if x.shape[1] > 1:
        x = 0.5 * (x[:, :-1] + x[:, 1:])
    p = cfg["dropout"]
    if gen is not None and p > 0:
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
        x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    w = params["logits.conv3d.weight"].flatten(1)
    return F.linear(x, w, params["logits.conv3d.bias"]).mean(dim=1)


def dropout_shape(cfg: dict, batch: int) -> Tuple[int, int, int]:
    """The shape of the dropout draw of one step: [B, T'', 1024], where T''
    is the number of adjacent pairs of the time steps that the stride-2
    stem, the SAME stride-2 pool after Mixed_3c and the VALID stride-2
    pool after Mixed_4f leave."""
    t = -(-cfg["preprocess"]["num_frames"] // 2)
    t = -(-t // 2) // 2
    return batch, max(t - 1, 1), 1024


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    c = logits.shape[-1]
    target = F.one_hot(labels.long(), c).float() * (1.0 - smoothing) + smoothing / c
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def lr_at(train: dict, count: int) -> float:
    """The learning rate of the update made after ``count`` earlier ones:
    linear from 0 over the warmup, then a cosine to 0 at ``num_steps``."""
    warm = train["warmup_steps"]
    if count < warm:
        return train["learning_rate"] * count / warm
    span = max(train["num_steps"], warm + 1) - warm
    c = min(count - warm, span)
    return train["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * c / span))


class Trainer:
    """The reference's train state: float32 parameters, AdamW moments, the
    step count and the dropout generator, seeded as the program's is."""

    def __init__(self, params: Params, cfg: dict, train: dict, dropout_seed: int,
                 precision: str = "fp32"):
        self.cfg, self.train, self.precision = cfg, train, precision
        self.names = [n for n, *_ in param_specs(cfg) if not n.endswith(("running_mean",
                                                                          "running_var"))]
        self.params = {n: params[n].detach().clone().requires_grad_(n in self.names)
                       for n in params}
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.count = 0
        self.gen = torch.Generator(next(iter(params.values())).device).manual_seed(dropout_seed)

    def resume(self, m: Params, v: Params, count: int, batch: int) -> None:
        """Take up AdamW's moments ``m``, ``v`` after ``count`` updates, and
        move the dropout generator past the draws of those ``count`` steps
        at ``batch`` clips."""
        self.m = {n: m[n].detach().clone() for n in self.names}
        self.v = {n: v[n].detach().clone() for n in self.names}
        self.count = count
        shape = dropout_shape(self.cfg, batch)
        for _ in range(count if self.cfg["dropout"] > 0 else 0):
            torch.rand(shape, generator=self.gen, device=self.gen.device)

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
