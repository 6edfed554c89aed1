"""Shared building blocks: ``ConvBN``, seeded initialisation, the cast to
the compute dtype, merging time into the batch, the layers that round
where flax rounds (:func:`dense`, :func:`gelu`, :func:`layer_norm`,
:func:`in_dtype`), the training semantics of the shared parts: dropout
from an explicit generator and BatchNorm in training mode as flax
computes it, and a span around a sub-layer's forward and backward
(:func:`sublayer`). Counterpart of ``asltpu/models/common.py``.

Every model takes ``train`` and a ``generator`` as arguments of
``forward``, as the JAX modules take ``train`` and a dropout key;
``nn.Module.training`` plays no part. Its compute dtype is its own
(``dtype``; None: the dtype of its weights), apart from the dtype of its
parameters: fp32 masters are cast inside each layer (:func:`cast`), so the
gradient reaches the fp32 parameter, and a model cast ahead by
:func:`cast_for_compute` is not cast again.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import TYPE_CHECKING, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from asltpu_torch.dist.mesh import Mesh

# Normalisation layers keep fp32 parameters and statistics under any compute
# dtype, as flax's ``param_dtype=float32`` does: they take the low-precision
# input, normalise in fp32 and round once.
NORMS = (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)


relu6 = nn.ReLU6

# Set while a rematerialised block runs its forward a second time in the
# backward pass: the running statistics were updated by the first run.
_STATS_FROZEN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "asltpu_torch_stats_frozen", default=False)
# The mesh of a data-parallel train step (one with a data group), while it runs.
_DATA_PARALLEL: contextvars.ContextVar[Optional["Mesh"]] = contextvars.ContextVar(
    "asltpu_torch_data_parallel", default=None)


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """:func:`batch_norm` in training mode leaves the running statistics
    alone inside this context (the recompute of a checkpointed block; flax's
    remat is functional and keeps the one update of the forward)."""
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


@contextlib.contextmanager
def data_parallel(mesh: Optional["Mesh"]) -> Iterator[None]:
    """Inside this context, with a mesh that has a data group (a data axis
    of more than one rank), the batch is this rank's rows of a global
    batch: :func:`batch_norm` in training takes the global batch's
    statistics, and :func:`batch_rand` draws for the global batch and keeps
    this rank's rows."""
    token = _DATA_PARALLEL.set(
        mesh if mesh is not None and mesh.data_group is not None else None)
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_mesh() -> Optional["Mesh"]:
    """The mesh :func:`data_parallel` put in force, or None: a
    rematerialised block's recompute (made in the backward pass) enters
    ``data_parallel`` with the forward's, so it runs the same all-reduces
    on every rank."""
    return _DATA_PARALLEL.get()


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` for a tensor whose leading
    axis is the batch. In a data-parallel step it draws for the global
    batch (``data_size`` times the rows) and keeps this rank's rows, so
    every rank's generator moves as one device's would and the masks are
    the single-device run's."""
    mesh = _DATA_PARALLEL.get()
    if mesh is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    n = shape[0]
    full = torch.rand((n * mesh.data_size, *shape[1:]), generator=generator, device=device)
    return full[mesh.data_rank * n:(mesh.data_rank + 1) * n]


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    """``bn`` applied as flax's ``BatchNorm`` with ``use_running_average=not
    train``. Statistics and the normalisation are fp32 whatever the input's
    dtype, and the output is rounded once to it. In training the batch's
    mean and **biased** variance normalise the input and update the running
    statistics (``stat ← (1 − m)·stat + m·batch``, torch momentum m = 1 −
    flax momentum); torch's ``BatchNorm`` would update the variance with the
    unbiased one, n/(n − 1) larger. ``bn.training`` plays no part.

    In a data-parallel step (:func:`data_parallel`) the statistics are the
    global batch's, as GSPMD takes them, in two passes as the single-rank
    path takes them: each rank's fp32 sum over every axis but the channels,
    with its count, summed over the data group by an autograd-aware
    all-reduce, gives the mean; the sum of squared deviations from it,
    summed the same way, the biased variance. (E[x²] − E[x]² in one
    all-reduce cancels where the mean dwarfs the spread: 0.24% off in the
    gradient at ``tests/test_torch_dist.py``'s BatchNorm case.)"""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    mesh = _DATA_PARALLEL.get()
    if mesh is None:
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
        var = invstd.pow(-2) - bn.eps
    else:
        out, mean, var = _global_batch_norm(bn, x, mesh)
    if not _STATS_FROZEN.get():
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return out


def _global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                       mesh: "Mesh") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(output, mean, biased variance) of training BatchNorm over the global
    batch of which ``x`` [N, C, ...] holds this rank's rows."""
    from asltpu_torch.dist.mesh import all_reduce_sum

    c = x.shape[1]
    dims = [0, *range(2, x.dim())]
    shape = (1, c) + (1,) * (x.dim() - 2)
    xf = x.float()
    sums = all_reduce_sum(torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // c)]),
                          mesh.data_group)
    n = sums[-1]
    mean = sums[:c] / n
    centred = xf - mean.view(shape)
    var = all_reduce_sum((centred * centred).sum(dims), mesh.data_group) / n
    out = centred * (torch.rsqrt(var + bn.eps) * bn.weight).view(shape) + bn.bias.view(shape)
    return out.to(x.dtype), mean, var


class Dropout(nn.Module):
    """Dropout whose mask is drawn with ``torch.rand(..., generator=g)``
    from the generator the caller passes (the train state's), as flax's
    ``Dropout`` draws from the step's key: kept values are divided by
    1 − p in the input's dtype, dropped ones are 0. Identity unless
    ``train``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.p == 0.0:
            return x
        keep = batch_rand(x.shape, generator, x.device) >= self.p
        return torch.where(keep, x / in_dtype(1.0 - self.p, x.dtype), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def in_dtype(value: float, dtype: torch.dtype) -> torch.Tensor:
    """``value`` rounded to ``dtype`` (a 0-d CPU tensor, which an op on any
    device takes as a scalar of that dtype), as JAX rounds a Python float
    that meets an array."""
    return torch.tensor(value, dtype=dtype)


def attention_dropout(weights: torch.Tensor, p: float, train: bool,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout on attention weights [B, H, q, k] as flax's
    ``dot_product_attention_weights`` applies it (``broadcast_dropout=True``):
    one keep mask of shape [1, 1, q, k] from ``generator``, shared by the
    whole batch and every head, and the weights multiplied by
    ``keep / (1 − p)`` computed in the weights' dtype (under bf16 the
    factor is bf16(1 / bf16(1 − p))). Identity unless ``train``."""
    if not train or p == 0.0:
        return weights
    q, k = weights.shape[-2:]
    keep = torch.rand((1, 1, q, k), generator=generator, device=weights.device) >= p
    return weights * (keep.to(weights.dtype) / in_dtype(1.0 - p, weights.dtype))


class _SpanEdge(torch.autograd.Function):
    """The identity at an edge of a sub-layer. In the backward pass the
    first of its outputs' edges to be reached opens the sub-layer's span,
    and the last of its inputs' edges closes it: the gradient of an input
    is whole only once every operation of the sub-layer that reads it has
    run its backward."""

    @staticmethod
    def forward(ctx, x, state, opens):
        ctx.state, ctx.opens = state, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        state = ctx.state
        if ctx.opens:
            if state["span"] is None:
                state["span"] = span(state["name"]).__enter__()
                state["left"] = state["inputs"]
        elif state["span"] is not None:
            state["left"] -= 1
            if state["left"] == 0:
                opened, state["span"] = state["span"], None
                opened.__exit__(None, None, None)
        return grad, None, None


def sublayer(name: str, fn: Callable[..., Tuple[torch.Tensor, ...]],
             *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)`` (a tuple of tensors) inside the span ``name``
    (:class:`~asltpu_torch.utils.profiling.span`), and, where a gradient is
    taken, its backward inside a span of the same name on the thread that
    runs it: from the first gradient to reach one of the outputs to the
    last of the inputs' gradients."""
    track = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    with span(name):
        if not track:
            return fn(*inputs)
        state = {"name": name, "span": None, "inputs": sum(x.requires_grad for x in inputs)}
        inputs = tuple(_SpanEdge.apply(x, state, False) if x.requires_grad else x
                       for x in inputs)
        return tuple(_SpanEdge.apply(y, state, True) for y in fn(*inputs))


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: an fp32 master cast inside the layer (the
    gradient reaches it), a weight already in ``dtype`` as it is (a
    ``.to`` that changes nothing still costs a dispatch)."""
    return t if t.dtype == dtype else t.to(dtype)


def dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` in the input's dtype: the weight and bias cast to it,
    the product rounds, then the bias is added and rounds again."""
    return torch.matmul(x, cast(linear.weight, x.dtype).t()) + cast(linear.bias, x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in the dtype of ``x``, its weight and bias cast to it: one
    product with the bias (where it has one) added in its epilogue, as
    ``nn.Linear`` computes it (:func:`dense` rounds the product and the sum
    apart, as flax does)."""
    bias = None if layer.bias is None else cast(layer.bias, x.dtype)
    return F.linear(x, cast(layer.weight, x.dtype), bias)


def keep_mask(n: int, p: float, train: bool, generator: Optional[torch.Generator],
              device: torch.device) -> Optional[torch.Tensor]:
    """Stochastic depth's draw for a branch whose first axis has ``n``
    samples: True where a sample's branch is kept (its uniform draw at
    least ``p``, by :func:`batch_rand`); None outside training or at ``p``
    0, where nothing is drawn."""
    if not train or p == 0.0:
        return None
    return batch_rand((n,), generator, device) >= p


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """The branch ``x`` with the samples (its first axis) that ``keep``
    drops at 0 and the kept ones divided by 1 − p in the dtype of ``x``."""
    if keep is None:
        return x
    keep = keep.view(-1, *([1] * (x.dim() - 1)))
    return torch.where(keep, x / in_dtype(1.0 - p, x.dtype), 0.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as ``jax.nn.gelu(approximate=False)`` computes it:
    0.5·x·erfc(−x·√½), with √½ rounded to the input's dtype and each
    operation rounding to it."""
    return 0.5 * x * torch.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm`` with fp32 parameters: statistics and the
    normalisation in the parameters' dtype (fp32), one rounding to the
    input's dtype."""
    return cast(F.layer_norm(cast(x, ln.weight.dtype), ln.normalized_shape, ln.weight,
                             ln.bias, ln.eps), x.dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` applied in the dtype of ``x``: its weight (and bias) cast
    to it inside the layer."""
    bias = None if conv.bias is None else cast(conv.bias, x.dtype)
    return F.conv2d(x, cast(conv.weight, x.dtype), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


class ConvBN(nn.Sequential):
    """Conv → BatchNorm → ReLU6, laid out as torchvision's
    ``Conv2dNormActivation``: child ``0`` the conv, ``1`` the BN, ``2`` the
    activation. Padding is torch-style symmetric ``k//2`` (the JAX
    package's default), BN eps 1e-5 and torch momentum 0.1 (flax 0.9).
    Every ConvBN of MobileNetV2 ends in ReLU6; its linear project conv is
    a plain conv + BN in torchvision's layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                      groups=groups, bias=False),
            nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            relu6(),
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """In the dtype of ``x``: the conv's weight cast to it, BN through
        :func:`batch_norm` (fp32 statistics, one rounding), ReLU6."""
        return self[2](batch_norm(self[1], conv2d(self[0], x), train))


def same_pads(lengths: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> List[Tuple[int, int]]:
    """TF/flax "SAME" padding, (lo, hi) per axis: the output has
    ``ceil(L / s)`` positions, the total pad is ``max((out − 1)·s + k − L,
    0)`` and the lower side takes ``total // 2``. At stride 2 it is
    asymmetric, which torch's ``padding=`` cannot express."""
    pads = []
    for n, k, s in zip(lengths, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``x`` [N, C, *spatial] made ready for a "SAME" conv (``value`` 0) or
    max-pool (``value`` −inf) of ``kernel`` and ``stride``: returns
    ``(x, padding)`` for the op's own symmetric ``padding=``. SAME's upper
    pad exceeds the lower by 0 or 1; where it is 1 on some axis, ``x`` is
    padded there with ``value`` first (a copy), else it is returned as
    is."""
    pads = same_pads(x.shape[2:], kernel, stride)
    extra: List[int] = []
    for lo, hi in reversed(pads):
        extra += [0, hi - lo]  # F.pad takes the last axis first
    if any(extra):
        x = F.pad(x, extra, value=value)
    return x, tuple(lo for lo, _ in pads)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialisation, in place: convs (2D and 3D)
    kaiming-normal over fan-out with a zero bias where they have one, BN as
    identity (torchvision's MobileNetV2 and ResNet),
    linears (and I3D's 1×1×1 logits) as ``nn.Linear``'s default, LayerNorm
    as identity, attention's
    packed q/k/v projection as ``nn.MultiheadAttention``'s (Xavier-uniform,
    zero bias), GRUs and LSTMs U(-1/√H, 1/√H), the transformer's CLS token
    and positions truncated-normal (std 0.02), the fusion model's positions
    too, and TimeSformer, Video Swin and MViT as their references
    initialise them
    (:meth:`~asltpu_torch.models.timesformer.TimeSformer.reset_parameters`,
    :meth:`~asltpu_torch.models.video_swin.VideoSwin.reset_parameters`,
    :meth:`~asltpu_torch.models.mvit.MViT.reset_parameters`)."""
    # These modules import this one.
    from asltpu_torch.models.fusion import TwoStreamFusion
    from asltpu_torch.models.i3d import Logits
    from asltpu_torch.models.mvit import MViT
    from asltpu_torch.models.temporal import TransformerHead
    from asltpu_torch.models.timesformer import TimeSformer
    from asltpu_torch.models.video_swin import VideoSwin
    from asltpu_torch.ops.recurrent import GRU

    with torch.no_grad():
        # The transformers' parameters are drawn once, by their reset_parameters.
        own = {s for t in module.modules() if isinstance(t, (TimeSformer, VideoSwin, MViT))
               for s in t.modules()}
        for m in module.modules():
            if m in own:
                continue
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                fan_out = m.out_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, NORMS):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.MultiheadAttention):
                nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (GRU, TransformerHead, TwoStreamFusion)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LSTM):
                k = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-k, k, generator=generator)
        # I3D's classifier is a 1×1×1 conv, drawn above as one; it is a dense
        # layer over 1024 features.
        for m in module.modules():
            if isinstance(m, (Logits, TimeSformer, VideoSwin, MViT)):
                m.reset_parameters(generator)


def cast_for_compute(module: nn.Module, dtype: torch.dtype,
                     keep_fp32: Iterable[nn.Module] = ()) -> nn.Module:
    """Cast ``module``'s parameters (convs, linears, attention, the CLS
    token and positions) to ``dtype`` in place, except those of every
    BatchNorm2d, BatchNorm3d and LayerNorm and of the submodules in
    ``keep_fp32``: those
    parameters and the norms' running statistics stay fp32. Names are
    unchanged, and a later ``load_state_dict`` keeps each tensor's dtype."""
    keep = set()
    for m in keep_fp32:
        keep.update(m.modules())
    for m in module.modules():
        if isinstance(m, NORMS) or m in keep:
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def merge_time_into_batch(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, T, ...] → ([B·T, ...], (B, T)) — the per-frame backbone runs all
    frames as one large batch."""
    b, t = x.shape[:2]
    return x.reshape((b * t,) + tuple(x.shape[2:])), (b, t)


def split_time_from_batch(x: torch.Tensor, bt: Tuple[int, int]) -> torch.Tensor:
    b, t = bt
    return x.reshape((b, t) + tuple(x.shape[1:]))


def per_frame(backbone, clip: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, T, H, W, 3] NHWC clip → [B, T, F] features of the per-frame
    ``backbone`` (NCHW frames → [N, F]) run in ``dtype``, the caller's
    compute dtype."""
    frames, bt = merge_time_into_batch(clip)
    # NHWC → NCHW view: channels_last strides, no copy.
    return split_time_from_batch(backbone(cast(frames.permute(0, 3, 1, 2), dtype)), bt)
