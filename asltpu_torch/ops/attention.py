"""Softmax attention over heads, ``softmax(q·kᵀ / √D)·v``, for TimeSformer's
temporal and spatial sub-layers: a fused backend on the card, the plain
math on the CPU.

On a CUDA tensor :func:`attention` runs :func:`fused_attention`: PyTorch's
``scaled_dot_product_attention`` held to the backends that never write the
[q, k] weights to memory (:data:`FUSED`: cuDNN's, FlashAttention-2 and the
memory-efficient kernel), forward and backward, so that a spatial layer at
785 tokens keeps only q, k, v, the output and one log-sum-exp a row for its
backward. Where none of them takes the inputs (float64, say) it raises; it
never falls back to the math backend, which materialises the weights. Each
call adds one to ``fused_attention.calls``.

On a CPU tensor it runs :func:`plain_attention`, the reference's order of
operations: the product scaled, its softmax, the weighted sum. Each call
adds one to ``plain_attention.calls``.

Inputs are [N, H, L, D] views whose last axis is contiguous, as a packed
q/k/v projection's output gives them after ``transpose(1, 2)``; no mask,
no dropout."""

from __future__ import annotations

import math

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`fused_attention` on the card, :func:`plain_attention` on the
    CPU."""
    if q.is_cuda:
        return fused_attention(q, k, v)
    return plain_attention(q, k, v)
