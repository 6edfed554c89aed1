"""Softmax attention over heads, ``softmax(q·kᵀ / √D + bias)·v``, for
TimeSformer's temporal and spatial sub-layers and Video Swin's window
sub-layers. :func:`attention` is where the port chooses the kernel, from
what it sees of the packed q/k/v projection (its device, dtype, head size
and sequence length) and of the bias.

Without a bias:

- The short-sequence op
  (:func:`asltpu_torch.ops.short_attention_kernels.short_attention`) on a
  CUDA tensor whose shape and dtype its kernels take
  (:func:`~asltpu_torch.ops.short_attention_kernels.kernel_takes`: bf16
  heads of 64, 1 to 32 tokens; the temporal sub-layer's 16 frames), and on
  a CPU tensor of at most 32 tokens, where the op runs its plain version.
  It reads the packed projection and returns its gradient packed.
- Otherwise q, k and v as strided views of the projection, then
  :func:`fused_attention` on the card and :func:`plain_attention` on the
  CPU.

With a bias by index, a
:class:`~asltpu_torch.ops.window_attention_kernels.WindowBias` (Video
Swin's window sub-layers: the relative-position table, the window whose
index reads it, and the shift regions of a clip's windows):

- The window op
  (:func:`asltpu_torch.ops.window_attention_kernels.window_attention_kernel`)
  on a CUDA tensor whose shape and dtype its kernels take
  (:func:`~asltpu_torch.ops.window_attention_kernels.kernel_takes`: bf16
  heads of 32, 1 to 448 tokens, a table of at most 4096 rows). It reads
  the table by index and the regions, never a materialised bias, and
  returns the table's gradient itself.
- Otherwise the bias materialised
  (:func:`~asltpu_torch.ops.window_attention_kernels.dense_bias`: the
  table's gather cast to the projection's dtype plus the −100 mask), taken
  as a dense bias below.

With a dense additive bias [W, H, L, L] (W the windows of one group, or
1), broadcast over the N = G·W sequences of the projection, which come
group-major (Video Swin: a clip's windows in a row): q, k and v as the same
views, then :func:`biased_attention` on the card and :func:`plain_attention`
with the bias on the CPU. The bias takes a gradient (the relative-position
table's) wherever it requires one.

:func:`fused_attention` is PyTorch's ``scaled_dot_product_attention`` held
to the backends that never write the [q, k] weights to memory
(:data:`FUSED`: cuDNN's, FlashAttention-2 and the memory-efficient
kernel), forward and backward, so that a spatial layer at 785 tokens keeps
only q, k, v, the output and one log-sum-exp a row for its backward. Where
none of them takes the inputs (float64, say) it raises; it never falls
back to the math backend, which materialises the weights. Each call adds
one to ``fused_attention.calls``.

:func:`biased_attention` is the same call with the bias as its additive
mask, held to the memory-efficient kernel (:data:`BIASED`), the fused
backend that takes an additive bias and returns its gradient
(FlashAttention takes no bias; cuDNN's is left out, as its bias gradient
is not promised). It raises where that kernel does not take the inputs.
The bias is laid out as the kernel reads it without a copy of its own:
each row padded to a multiple of 16 keys in storage, and the windows of a
group repeated over the groups (one copy where W > 1, a broadcast view
where W = 1). Each call adds one to ``biased_attention.calls``.

:func:`plain_attention` is the reference's order of operations: the
product scaled, the bias added, its softmax, the weighted sum. Each call
adds one to ``plain_attention.calls``.

All take [N, H, L, D] views whose last axis is contiguous, as a packed
q/k/v projection's output gives them after ``transpose(1, 2)``; no
dropout."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from asltpu_torch.ops import window_attention_kernels as windowed
from asltpu_torch.ops.short_attention_kernels import MAX_LEN, kernel_takes, short_attention

# The backends that keep the weights on chip, in the order tried.
FUSED = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
         SDPBackend.EFFICIENT_ATTENTION]
# The one of them that takes an additive bias and returns its gradient.
BIASED = [SDPBackend.EFFICIENT_ATTENTION]
# The memory-efficient kernel reads a bias whose rows start at multiples of
# this many elements.
BIAS_ALIGN = 16


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention of ``q`` [N, H, Lq, D] over ``k``, ``v`` [N, H, Lk, D] on a
    fused backend (:data:`FUSED`); raises ``RuntimeError`` where none takes
    the inputs. Scale 1/√D."""
    with sdpa_kernel(FUSED, set_priority=True):
        out = F.scaled_dot_product_attention(q, k, v)
    fused_attention.calls += 1
    return out


fused_attention.calls = 0


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """:func:`fused_attention` with ``bias`` [N, H, Lq, Lk] (a broadcast
    view will do) added to the scaled scores, on the memory-efficient
    kernel alone (:data:`BIASED`); raises ``RuntimeError`` where it does
    not take the inputs."""
    with sdpa_kernel(BIASED):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    biased_attention.calls += 1
    return out


biased_attention.calls = 0


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same attention written out: (q·kᵀ)·(1/√D), plus ``bias`` (one
    that broadcasts to [N, H, Lq, Lk]) where given, softmax over the keys,
    times v, each in the inputs' dtype. It holds the [N, H, Lq, Lk]
    weights."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias
    out = torch.matmul(scores.softmax(dim=-1), v)
    plain_attention.calls += 1
    return out


plain_attention.calls = 0


def per_sequence(bias: torch.Tensor, n: int) -> torch.Tensor:
    """``bias`` [W, H, L, L] as [n, H, L, L] for n = G·W group-major
    sequences: a broadcast view where W = 1, else the W windows repeated
    over the G groups (one copy); laid out row-major whatever its own
    strides (a bias whose heads are innermost would keep them so through
    the pad and a view), each row at a multiple of :data:`BIAS_ALIGN`
    elements in storage (padded, then sliced)."""
    w, length = bias.shape[0], bias.shape[-1]
    if n % w:
        raise ValueError(f"{n} sequences are not whole groups of the bias's {w} windows")
    pad = -length % BIAS_ALIGN
    bias = bias.contiguous()
    if pad:
        bias = F.pad(bias, (0, pad))
    if w == 1:
        full = bias.expand(n, *bias.shape[1:])
    else:
        full = bias.unsqueeze(0).expand(n // w, *bias.shape).reshape(n, *bias.shape[1:])
    return full[..., :length] if pad else full


def attention(qkv: torch.Tensor, heads: int,
              bias: Union[None, torch.Tensor, windowed.WindowBias] = None) -> torch.Tensor:
    """Attention of each of ``heads`` heads over the sequences of the packed
    projection ``qkv`` [N, L, 3·d] (columns q; k; v) → [N, L, d], the
    heads side by side, on the kernel the module docstring names; with
    ``bias`` added to the scaled scores: a ``WindowBias`` over N windows,
    clip-major, or a dense [W or 1, heads, L, L] (the dtype of ``qkv``)
    broadcast over N group-major sequences."""
    n, length, width = qkv.shape
    d = width // 3
    head_dim = d // heads
    if isinstance(bias, windowed.WindowBias):
        table = bias.table
        if qkv.is_cuda and windowed.kernel_takes(qkv.dtype, head_dim, length, table.shape[0]):
            # A model cast for inference holds its table in the compute dtype.
            table = table if table.dtype == torch.float32 else table.float()
            return windowed.window_attention_kernel(qkv, heads, table, bias.window,
                                                    bias.regions)
        bias = windowed.dense_bias(bias, length, qkv.dtype)
    if bias is None:
        # On the CPU the op runs its plain version, which takes any dtype and head.
        short = kernel_takes(qkv.dtype, head_dim, length) if qkv.is_cuda else length <= MAX_LEN
        if short:
            return short_attention(qkv, heads)
    packed = qkv.view(n, length, 3, heads, head_dim)
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    if bias is None:
        out = fused_attention(q, k, v) if qkv.is_cuda else plain_attention(q, k, v)
    elif qkv.is_cuda:
        out = biased_attention(q, k, v, per_sequence(bias, n))
    else:
        out = plain_attention(q, k, v, per_sequence(bias, n))
    return out.transpose(1, 2).reshape(n, length, d)
