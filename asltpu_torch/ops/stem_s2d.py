"""The I3D stem conv (7×7×7, stride 2, TF-"SAME") in two forms that compute
the same function. Counterpart of ``asltpu/ops/stem_s2d.py``.

- :func:`stem_conv3d_plain`: pad SAME, then a stride-2 ``conv3d``. On even
  axes the pads are (2, 3).
- :func:`stem_conv3d_s2d`: the exact space-to-depth rewrite, for even
  T, H and W. Every stride-2 axis splits into its even and odd phases,
  packed into channels (3 → 24), and the kernel is re-indexed to match:
  a stride-1 4×4×4 conv with pads (1, 2) per axis. Per axis, with
  x_e[m] = x[2m] and x_o[m] = x[2m + 1]::

      y[o] = Σ_{k=0..6} w[k] · x[2o + k − 2]
      k even: x_e[o + k/2 − 1]      k odd: x_o[o + (k − 3)/2]

  so the packed kernel is the original zero-padded 7 → 8 and reshaped, tap
  k = 2·i + parity. It does 8·4³/7³ ≈ 1.49× the multiply-adds (the zero
  taps) with a contraction of 24 channels per tap instead of 3.

Which form is faster is the card's to say: ``chip_smoke.py`` times both at
the I3D contract shape, and :mod:`asltpu_torch.models.i3d` uses the faster
one where the rewrite applies. Tensors are NCDHW; the model keeps them in
``torch.channels_last_3d`` memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asltpu_torch.models.common import pad_same

STEM_KERNEL = (7, 7, 7)
STEM_STRIDE = (2, 2, 2)


def s2d_applies(x: torch.Tensor) -> bool:
    """Whether the rewrite covers ``x`` [N, C, T, H, W]: every spatial axis
    even (and so at least 2)."""
    return all(n % 2 == 0 and n >= 2 for n in x.shape[2:])


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[N, C, T, H, W] (even axes, channels_last_3d memory) → [N, 8C, T/2,
    H/2, W/2] in channels_last_3d memory, in one copy: each axis split into
    its even and odd phases, channel C·8 + 4·pT + 2·pH + pW (the JAX
    package's ``parity_pack`` over T, then H, then W)."""
    n, c, t, h, w = x.shape
    x = x.permute(0, 2, 3, 4, 1).reshape(n, t // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(n, t // 2, h // 2, w // 2, 8 * c)
    return x.permute(0, 4, 1, 2, 3)


def s2d_kernel7(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 7, 7, 7] → [Cout, 8·Cin, 4, 4, 4] for the parity-packed
    input: the kernel zero-padded to 8 per axis, tap k = 2·i + parity,
    channel Cin·8 + 4·pT + 2·pH + pW."""
    cout, cin = w.shape[:2]
    w8 = F.pad(w, (0, 1, 0, 1, 0, 1)).reshape(cout, cin, 4, 2, 4, 2, 4, 2)
    return w8.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(cout, cin * 8, 4, 4, 4)


def stem_conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3d(x, w)`` at stride 2 with TF-"SAME" pads, any shape."""
    x, padding = pad_same(x, STEM_KERNEL, STEM_STRIDE)
    return F.conv3d(x, w, stride=STEM_STRIDE, padding=padding)


def stem_conv3d_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function as :func:`stem_conv3d_plain` for even T, H, W, by
    the space-to-depth rewrite (raises on other shapes)."""
    if not s2d_applies(x):
        raise ValueError(f"the space-to-depth stem needs even T, H, W; got {tuple(x.shape)}")
    wq = s2d_kernel7(w).contiguous(memory_format=torch.channels_last_3d)
    return F.conv3d(F.pad(space_to_depth(x), (1, 2, 1, 2, 1, 2)), wq)
