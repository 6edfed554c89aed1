"""Temporal classification heads over per-frame feature sequences: the GRU
head and the pre-LN transformer encoder head. Counterpart of
``asltpu/models/temporal.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.ops.recurrent import GRU


class GRUHead(nn.Module):
    """GRU over [B, T, F] features → logits [B, num_classes].

    The recurrence runs in fp32 whatever the backbone's dtype (the loop over
    T amplifies low-precision error). Dropout goes where torch puts it: on
    each GRU layer's output sequence except the last (inside :class:`GRU`),
    and on the final hidden state before ``fc``.
    """

    def __init__(self, num_classes: int, feature_dim: int, hidden: int = 512,
                 num_layers: int = 1, dropout: float = 0.2):
        super().__init__()
        self.gru = GRU(feature_dim, hidden, num_layers, dropout)
        self.dropout = nn.Dropout(dropout)
        self.fc = nn.Linear(hidden, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        _, h_last = self.gru(feats.to(torch.float32))
        return self.fc(self.dropout(h_last[-1]))


def _dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` in the input's dtype: the product rounds, then the
    bias is added and rounds again."""
    return torch.matmul(x, linear.weight.t()) + linear.bias


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as ``jax.nn.gelu(approximate=False)`` computes it:
    0.5·x·erfc(−x·√½), with √½ rounded to the input's dtype and each
    operation rounding to it."""
    return 0.5 * x * torch.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, each operation rounding to the
    input's dtype: exp(s − max), then divided by its sum."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm`` with fp32 parameters: statistics and the
    normalisation in fp32, one rounding to the input's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def attention(mha: nn.MultiheadAttention, q_in: torch.Tensor,
              kv_in: torch.Tensor) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention(q_in, kv_in)`` with the
    parameters of ``mha`` (``in_proj_weight``/``in_proj_bias`` rows q;k;v,
    ``out_proj``): q from ``q_in``, k and v from ``kv_in``, each projected
    and rounded, q scaled by 1/√head_dim, QKᵀ, softmax, the weighted sum of
    v, the output projection, each rounding to the compute dtype.
    ``nn.MultiheadAttention``'s own forward is not used, since its fused
    inference path rounds elsewhere."""
    b, n, d = q_in.shape
    heads = mha.num_heads
    (wq, wk, wv), (bq, bk, bv) = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)
    q, k, v = ((torch.matmul(x, w.t()) + bias).view(b, x.shape[1], heads, d // heads)
               for x, w, bias in ((q_in, wq, bq), (kv_in, wk, bk), (kv_in, wv, bv)))
    q = q / torch.tensor(math.sqrt(d // heads), dtype=q.dtype)
    weights = _softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
    weights = F.dropout(weights, mha.dropout, mha.training)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, d)
    return _dense(out, mha.out_proj)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: x + attn(ln1(x)), then x + mlp2(gelu(mlp1(ln2(x)))).

    ``attn`` is an ``nn.MultiheadAttention`` for its parameter names; the
    block runs it through :func:`attention` as self-attention."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 dropout: float):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = nn.MultiheadAttention(d_model, num_heads, dropout=dropout,
                                          batch_first=True)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp1 = nn.Linear(d_model, d_model * mlp_ratio)
        self.mlp2 = nn.Linear(d_model * mlp_ratio, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _layer_norm(x, self.ln1)
        x = x + self.dropout(attention(self.attn, y, y))
        y = _gelu(_dense(_layer_norm(x, self.ln2), self.mlp1))
        return x + self.dropout(_dense(y, self.mlp2))


class TransformerHead(nn.Module):
    """Pre-LN transformer encoder over [B, T, F] frame features with a
    learned CLS token and learned positions → logits [B, num_classes].

    It computes in the dtype of its parameters (bf16 under
    ``asltpu_torch.api.load_model``'s default), except that its LayerNorms
    and ``fc`` keep fp32 parameters, as the reference's do: the CLS token
    is concatenated and the positions added in the compute dtype, each
    LayerNorm normalises in fp32 and rounds once, and the CLS output goes
    to fp32 before ``fc``. ``in_proj`` exists only when the feature width
    differs from ``d_model``; ``pos`` has ``num_frames + 1`` rows.
    """

    def __init__(self, num_classes: int, feature_dim: int, num_frames: int,
                 d_model: int = 512, num_heads: int = 8, num_layers: int = 4,
                 mlp_ratio: int = 4, dropout: float = 0.1):
        super().__init__()
        self.in_proj: Optional[nn.Linear] = (
            nn.Linear(feature_dim, d_model) if feature_dim != d_model else None)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos = nn.Parameter(torch.zeros(1, num_frames + 1, d_model))
        self.dropout = nn.Dropout(dropout)
        self.layers = nn.ModuleList(
            EncoderBlock(d_model, num_heads, mlp_ratio, dropout)
            for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(d_model, eps=1e-5)
        self.fc = nn.Linear(d_model, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The CLS token and positions, truncated normal at ±2 std (flax's
        ``truncated_normal(0.02)``); the submodules initialise themselves."""
        with torch.no_grad():
            for p in (self.cls, self.pos):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        dtype = self.pos.dtype
        x = feats.to(dtype)
        if self.in_proj is not None:
            x = _dense(x, self.in_proj)
        cls = self.cls.to(dtype).expand(x.shape[0], 1, -1)
        x = self.dropout(torch.cat([cls, x], dim=1) + self.pos.to(dtype))
        for layer in self.layers:
            x = layer(x)
        return self.fc(_layer_norm(x, self.final_ln)[:, 0].float())
