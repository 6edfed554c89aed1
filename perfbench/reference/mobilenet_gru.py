"""Plain reference of ``mobilenet_gru``: MobileNetV2 per frame (Sandler et
al., "MobileNetV2: Inverted Residuals and Linear Bottlenecks", CVPR 2018;
torchvision's ``mobilenet_v2().features`` layout and names), the pooled
1280 features of the 16 frames through a one-layer GRU (torch's gate
equations: r, z, n, the reset gate after the hidden matmul), and a linear
classifier on the last hidden state.

Parameters are a flat dict under torchvision's names (``features.*``)
beside ``gru.*`` and ``fc.*``. Everything computes in float32 with TF32
off; ``precision="fp8"`` rounds the backbone's convolution operands to
float8 e4m3 instead, the control of a bfloat16 backbone."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import ops

# (expand_ratio, out_channels, num_blocks, first_stride), the paper's Table 2.
SCHEDULE = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
BN_EPS = 1e-5


def make_divisible(v: float, divisor: int = 8) -> int:
    """The channel rounding of the paper's reference implementation."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# One conv: (weight name, BN name, in, out, kernel, stride, groups, relu6).
Conv = Tuple[str, str, int, int, int, int, int, bool]


def blocks(width_mult: float) -> List[Tuple[List[Conv], bool]]:
    """The backbone as a list of (convs, residual) blocks."""
    out: List[Tuple[List[Conv], bool]] = []
    stem = make_divisible(32 * width_mult)
    out.append(([("features.0.0", "features.0.1", 3, stem, 3, 2, 1, True)], False))
    cin, idx = stem, 1
    for t, c, n, s in SCHEDULE:
        cout = make_divisible(c * width_mult)
        for i in range(n):
            stride, hidden, p = (s if i == 0 else 1), cin * t, f"features.{idx}.conv"
            convs: List[Conv] = []
            j = 0
            if t != 1:
                convs.append((f"{p}.0.0", f"{p}.0.1", cin, hidden, 1, 1, 1, True))
                j = 1
            convs.append((f"{p}.{j}.0", f"{p}.{j}.1", hidden, hidden, 3, stride, hidden, True))
            convs.append((f"{p}.{j + 1}", f"{p}.{j + 2}", hidden, cout, 1, 1, 1, False))
            out.append((convs, stride == 1 and cin == cout))
            cin, idx = cout, idx + 1
    head = make_divisible(1280 * max(1.0, width_mult))
    out.append(([(f"features.{idx}.0", f"features.{idx}.1", cin, head, 1, 1, 1, True)], False))
    return out


def feature_dim(cfg: dict) -> int:
    return blocks(cfg["width_mult"])[-1][0][0][3]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter and BN statistic.
    Convs are normal with std √(gain / fan_in), gain 2 before a ReLU6 and
    1 for the linear projections, so that a signal keeps its scale through
    the depth with BatchNorm at scale 1, shift 0 and statistics (0, 1): a
    random network that neither explodes nor turns chaotic, whose output a
    rounding moves by as little as it moves each layer. The GRU and the
    classifier are uniform in ±1/√fan_in."""
    specs = []
    for convs, _ in blocks(cfg["width_mult"]):
        for w, bn, cin, cout, k, _, groups, act in convs:
            fan_in = cin // groups * k * k
            specs.append((f"{w}.weight", (cout, cin // groups, k, k), "normal",
                          math.sqrt((2.0 if act else 1.0) / fan_in)))
            specs += [(f"{bn}.weight", (cout,), "ones", 1.0), (f"{bn}.bias", (cout,), "zeros", 1.0),
                      (f"{bn}.running_mean", (cout,), "zeros", 1.0),
                      (f"{bn}.running_var", (cout,), "ones", 1.0)]
    f, h, c = feature_dim(cfg), cfg["gru_hidden"], cfg["num_classes"]
    if cfg["gru_layers"] != 1:
        raise ValueError("the reference GRU has one layer")
    g = 1.0 / math.sqrt(h)
    specs += [("gru.weight_ih_l0", (3 * h, f), "uniform", g),
              ("gru.weight_hh_l0", (3 * h, h), "uniform", g),
              ("gru.bias_ih_l0", (3 * h,), "uniform", g),
              ("gru.bias_hh_l0", (3 * h,), "uniform", g),
              ("fc.weight", (c, h), "uniform", 1.0 / math.sqrt(h)),
              ("fc.bias", (c,), "uniform", 1.0 / math.sqrt(h))]
    return specs


def backbone(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: dict,
             precision: str = "fp32") -> torch.Tensor:
    """Frames [N, 3, H, W] float32 → pooled features [N, F]."""
    for convs, residual in blocks(cfg["width_mult"]):
        y = x
        for w, bn, _, _, k, stride, groups, act in convs:
            y = F.conv2d(ops.operand(y, precision), ops.operand(params[f"{w}.weight"], precision),
                         None, stride, k // 2, 1, groups)
            y = ops.batch_norm(y, params, bn, BN_EPS, "infer")
            if act:
                y = y.clamp(0.0, 6.0)
        x = x + y if residual else y
    return x.mean(dim=(2, 3))


def gru_last(feats: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, T, F] → the last hidden state [B, H] of a GRU from h = 0."""
    w_ih, w_hh = params["gru.weight_ih_l0"], params["gru.weight_hh_l0"]
    b_ih, b_hh = params["gru.bias_ih_l0"], params["gru.bias_hh_l0"]
    b, t, _ = feats.shape
    gx = F.linear(feats, w_ih, b_ih)
    h = feats.new_zeros(b, w_hh.shape[1])
    for s in range(t):
        xr, xz, xn = gx[:, s].chunk(3, dim=-1)
        hr, hz, hn = F.linear(h, w_hh, b_hh).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
    return h


def forward(frames_u8: torch.Tensor, params: Dict[str, torch.Tensor], cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Staged uint8 clips [B, T, Hs, Ws, 3] → logits [B, num_classes] float32."""
    with ops.exact_fp32():
        x = ops.crop_normalize(frames_u8, cfg["preprocess"])
        b, t = x.shape[:2]
        feats = backbone(x.reshape(b * t, *x.shape[2:]), params, cfg, precision)
        h = gru_last(feats.reshape(b, t, -1), params)
        return F.linear(h, params["fc.weight"], params["fc.bias"])


def logits_in_blocks(frames_u8: torch.Tensor, params: Dict[str, torch.Tensor], cfg: dict,
                     precision: str = "fp32", rows: int = 16) -> torch.Tensor:
    """:func:`forward` over ``rows`` clips at a time (inference BN treats each
    clip alone), so that a large batch fits."""
    with torch.no_grad():
        return torch.cat([forward(frames_u8[i:i + rows], params, cfg, precision)
                          for i in range(0, frames_u8.shape[0], rows)])
