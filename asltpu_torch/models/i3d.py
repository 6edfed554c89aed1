"""I3D — the Inflated 3D Inception network (config #4): a clip
[B, T, H, W, 3] → [B, num_classes] logits. Counterpart of
``asltpu/models/i3d.py``.

Architecture: Carreira & Zisserman, "Quo Vadis, Action Recognition?"
(CVPR 2017), Inception-v1 inflated to 3D. Module names follow pytorch-i3d
(``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b0.bn.running_var``, …,
``logits.conv3d.weight`` [C, 1024, 1, 1, 1] and its bias), the names
``asltpu.ckpt.import_i3d`` reads, so a pytorch-i3d ``.pt`` loads with
:func:`asltpu_torch.ckpt.load_torch_checkpoint`.

As the reference, which is TF-origin: every conv and max-pool pads
TF-"SAME" (asymmetric at stride 2; pools pad with −inf), BatchNorm has eps
1e-3 and keeps fp32 parameters under a bf16 compute dtype, and the head
averages over space in the compute dtype, averages adjacent time steps,
applies the fp32 ``logits`` per step and averages the logits over time.
The network runs NCDHW in ``torch.channels_last_3d`` memory, which the
NDHWC clip already is after ``permute(0, 4, 1, 2, 3)``.

Training (``forward(clip, train=True, generator=g)``), as the JAX module
trains: BatchNorm on the batch's statistics with flax's update of the
running ones (:func:`asltpu_torch.models.common.batch_norm`), dropout
before ``logits`` from ``g``, and with ``remat`` each Inception block
rematerialised (``torch.utils.checkpoint``, non-reentrant) with its
recompute kept from updating the running statistics a second time. The
compute dtype is ``dtype``; fp32 master weights are cast inside each conv.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from asltpu_torch.models.common import (
    Dropout,
    batch_norm,
    data_parallel,
    data_parallel_mesh,
    frozen_running_stats,
    pad_same,
)
from asltpu_torch.ops.stem_s2d import (
    STEM_KERNEL,
    STEM_STRIDE,
    s2d_applies,
    stem_conv3d_plain,
    stem_conv3d_s2d,
)

Triple = Tuple[int, int, int]

# (name, (b0, b1a, b1b, b2a, b2b, b3b)) in checkpoint order.
_MIXED = (
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


def max_pool_same(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """flax ``max_pool(padding="SAME")``: −inf pads, TF-"SAME" per axis."""
    x, padding = pad_same(x, kernel, stride, float("-inf"))
    return F.max_pool3d(x, kernel, stride, padding)


def stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7×7×7 stride-2 stem conv in the form the card runs faster: the
    space-to-depth rewrite where it applies (even T, H, W), else the plain
    strided conv. At [4, 64, 224², 3] bf16 → 64 channels on an NVIDIA H100
    80GB HBM3 at 700 W the rewrite takes 2.49 ms against 11.99 ms
    (``chip_smoke.py``, phase stem)."""
    if s2d_applies(x):
        return stem_conv3d_s2d(x, w)
    return stem_conv3d_plain(x, w)


class Unit3D(nn.Module):
    """Conv3d (TF-"SAME", no bias) → BatchNorm3d (eps 1e-3) → ReLU, the I3D
    building block; the 7×7×7 stride-2 stem takes :func:`stem_conv`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Triple = (1, 1, 1),
                 stride: Triple = (1, 1, 1)):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(in_ch, out_ch, kernel, stride, bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-3, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """In the dtype of ``x``: the conv's weight is cast to it (a no-op
        for weights cast ahead), BN normalises in fp32 and rounds once."""
        w = self.conv3d.weight.to(x.dtype)
        if (self.kernel, self.stride) == (STEM_KERNEL, STEM_STRIDE):
            x = stem_conv(x, w)
        else:
            x, padding = pad_same(x, self.kernel, self.stride)
            x = F.conv3d(x, w, None, self.stride, padding)
        return F.relu(batch_norm(self.bn, x, train))


class InceptionBlock(nn.Module):
    """The four Inception branches, inflated to 3D: 1³ / 1³ → 3³ / 1³ → 3³ /
    SAME max-pool 3³ → 1³, concatenated over channels."""

    def __init__(self, in_ch: int, ch: Tuple[int, int, int, int, int, int]):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = ch
        self.b0 = Unit3D(in_ch, b0)
        self.b1a = Unit3D(in_ch, b1a)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(in_ch, b2a)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3b = Unit3D(in_ch, b3b)
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        pooled = max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x, train), self.b1b(self.b1a(x, train), train),
                          self.b2b(self.b2a(x, train), train), self.b3b(pooled, train)],
                         dim=1)


class Logits(nn.Module):
    """pytorch-i3d's 1×1×1 ``logits`` conv (``logits.conv3d.*``), applied as
    a dense layer per time step."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv3d = nn.Conv3d(in_ch, num_classes, 1, bias=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """As ``nn.Linear``'s default, U(−1/√in, 1/√in): a classifier, like
        the JAX package's ``Dense`` over its input width; a conv's
        fan-out init would scale it by the class count."""
        bound = 1.0 / math.sqrt(self.conv3d.in_channels)
        with torch.no_grad():
            self.conv3d.weight.uniform_(-bound, bound, generator=generator)
            self.conv3d.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv3d.weight
        return F.linear(x.to(w.dtype), w.flatten(1), self.conv3d.bias)


@contextlib.contextmanager
def _recompute(mesh):
    """A rematerialised block's recompute: the running statistics frozen,
    the forward's data-parallel mesh in force."""
    with frozen_running_stats(), data_parallel(mesh):
        yield


class I3D(nn.Module):
    """[B, T, H, W, 3] preprocessed clip → logits [B, num_classes].

    :meth:`backbone` (stem through ``Mixed_5c``) and :meth:`classify` (the
    pooling and the logits) split :meth:`forward` in two. The network
    computes in ``dtype`` (None: the dtype of its conv weights, as a model
    cast by ``cast_for_compute`` has them); BN and ``logits`` stay fp32.
    ``remat`` rematerialises each Inception block in training, as the JAX
    module's ``nn.remat`` does."""

    def __init__(self, num_classes: int = 2000, dropout: float = 0.5,
                 remat: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat, self.dtype = remat, dtype
        self.Conv3d_1a_7x7 = Unit3D(3, 64, STEM_KERNEL, STEM_STRIDE)
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        in_ch = 192
        for name, ch in _MIXED:
            block = InceptionBlock(in_ch, ch)
            self.add_module(name, block)
            in_ch = block.out_channels
        self.dropout = Dropout(dropout)
        self.logits = Logits(in_ch, num_classes)

    def _block(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        block = getattr(self, name)
        if not (train and self.remat):
            return block(x, train)
        # Nothing in a block draws random numbers, so no RNG state is kept;
        # the recompute runs with the running statistics frozen (and the
        # step's data-parallel mesh, so its BatchNorms all-reduce again).
        return checkpoint(block, x, train, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _recompute(data_parallel_mesh())))

    def backbone(self, clip: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, H, W, 3] → features [B, 1024, T', H', W'] (NCDHW view)."""
        dtype = self.dtype or self.Conv3d_1a_7x7.conv3d.weight.dtype
        x = clip.permute(0, 4, 1, 2, 3).to(dtype)
        x = self.Conv3d_1a_7x7(x, train)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x, train), train)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for name, _ in _MIXED:
            x = self._block(name, x, train)
            if name == "Mixed_3c":
                x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
            elif name == "Mixed_4f":
                x = F.max_pool3d(x, (2, 2, 2), (2, 2, 2))  # VALID
        return x

    def classify(self, feats: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, 1024, T', H', W'] → logits: the spatial mean in the compute
        dtype; where T' > 1 the mean of each pair of adjacent steps (the
        temporal half of pytorch-i3d's AvgPool3d((2, 7, 7))); dropout in
        training; the fp32 ``logits`` per step; their mean over time."""
        x = feats.mean(dim=(3, 4)).transpose(1, 2)  # [B, T', 1024]
        if x.shape[1] > 1:
            x = 0.5 * (x[:, :-1] + x[:, 1:])
        return self.logits(self.dropout(x, train, generator)).mean(dim=1)

    def forward(self, clip: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.classify(self.backbone(clip, train), train, generator)
