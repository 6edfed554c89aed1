"""Softmax attention over heads, ``softmax(q·kᵀ / √D)·v``, for TimeSformer's
temporal and spatial sub-layers. :func:`attention` is where the port
chooses the kernel, from what it sees of the packed q/k/v projection: its
device, dtype, head size and sequence length.

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

:func:`fused_attention` is PyTorch's ``scaled_dot_product_attention`` held
to the backends that never write the [q, k] weights to memory
(:data:`FUSED`: cuDNN's, FlashAttention-2 and the memory-efficient
kernel), forward and backward, so that a spatial layer at 785 tokens keeps
only q, k, v, the output and one log-sum-exp a row for its backward. Where
none of them takes the inputs (float64, say) it raises; it never falls
back to the math backend, which materialises the weights. Each call adds
one to ``fused_attention.calls``.

:func:`plain_attention` is the reference's order of operations: the
product scaled, its softmax, the weighted sum. Each call adds one to
``plain_attention.calls``.

Both take [N, H, L, D] views whose last axis is contiguous, as a packed
q/k/v projection's output gives them after ``transpose(1, 2)``; no mask,
no dropout."""

from __future__ import annotations

import math

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from asltpu_torch.ops.short_attention_kernels import MAX_LEN, kernel_takes, short_attention

# The backends that keep the weights on chip, in the order tried.
FUSED = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
         SDPBackend.EFFICIENT_ATTENTION]


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention of ``q`` [N, H, Lq, D] over ``k``, ``v`` [N, H, Lk, D] on a
    fused backend (:data:`FUSED`); raises ``RuntimeError`` where none takes
    the inputs. Scale 1/√D."""
    with sdpa_kernel(FUSED, set_priority=True):
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    fused_attention.calls += 1
    return out


fused_attention.calls = 0


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same attention written out: (q·kᵀ)·(1/√D), softmax over the
    keys, times v, each in the inputs' dtype. It holds the [N, H, Lq, Lk]
    weights."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    out = torch.matmul(scores.softmax(dim=-1), v)
    plain_attention.calls += 1
    return out


plain_attention.calls = 0


def attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention of each of ``heads`` heads over the sequences of the packed
    projection ``qkv`` [N, L, 3·d] (columns q; k; v) → [N, L, d], the
    heads side by side, on the kernel the module docstring names."""
    n, length, width = qkv.shape
    d = width // 3
    head_dim = d // heads
    # On the CPU the op runs its plain version, which takes any dtype and head.
    short = kernel_takes(qkv.dtype, head_dim, length) if qkv.is_cuda else length <= MAX_LEN
    if short:
        return short_attention(qkv, heads)
    packed = qkv.view(n, length, 3, heads, head_dim)
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    out = fused_attention(q, k, v) if qkv.is_cuda else plain_attention(q, k, v)
    return out.transpose(1, 2).reshape(n, length, d)
