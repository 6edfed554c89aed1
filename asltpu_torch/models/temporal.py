"""Temporal classification heads over per-frame feature sequences: the GRU
head and the pre-LN transformer encoder head. Counterpart of
``asltpu/models/temporal.py``.

Both train as the JAX heads do (``forward(feats, train=True,
generator=g)``): every dropout, attention's included, draws from ``g``
and only in training; linears cast their weights to the compute dtype
inside the layer, so fp32 masters take the gradient."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.dist.tp import copy_to_model_parallel, reduce_from_model_parallel, tp_mesh
from asltpu_torch.models.common import Dropout, attention_dropout, cast
from asltpu_torch.ops.recurrent import GRU


class GRUHead(nn.Module):
    """GRU over [B, T, F] features → logits [B, num_classes].

    The recurrence runs in the dtype of the head's parameters, fp32
    whatever the backbone's dtype (the loop over T amplifies low-precision
    error). Dropout goes where torch puts it: on
    each GRU layer's output sequence except the last (inside :class:`GRU`),
    and on the final hidden state before ``fc``.
    """

    def __init__(self, num_classes: int, feature_dim: int, hidden: int = 512,
                 num_layers: int = 1, dropout: float = 0.2):
        super().__init__()
        self.gru = GRU(feature_dim, hidden, num_layers, dropout)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(hidden, num_classes)

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h_last = self.gru(cast(feats, self.fc.weight.dtype), train, generator)
        return self.fc(self.dropout(h_last[-1], train, generator))


def _dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` in the input's dtype: the weight and bias cast to it,
    the product rounds, then the bias is added and rounds again."""
    return torch.matmul(x, cast(linear.weight, x.dtype).t()) + cast(linear.bias, x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as ``jax.nn.gelu(approximate=False)`` computes it:
    0.5·x·erfc(−x·√½), with √½ rounded to the input's dtype and each
    operation rounding to it."""
    return 0.5 * x * torch.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, each operation rounding to the
    input's dtype: exp(s − max), then divided by its sum. The max takes no
    gradient (``stop_gradient`` there)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm`` with fp32 parameters: statistics and the
    normalisation in the parameters' dtype (fp32), one rounding to the
    input's dtype."""
    return cast(F.layer_norm(cast(x, ln.weight.dtype), ln.normalized_shape, ln.weight,
                             ln.bias, ln.eps), x.dtype)


def _dense_reduced(x: torch.Tensor, linear: nn.Linear, mesh) -> torch.Tensor:
    """:func:`_dense` of a layer whose input columns are sharded over the
    model axis of ``mesh`` where it is not None (attention's ``out_proj``,
    an encoder block's ``mlp2``): each rank's partial product is summed
    over the model group before the whole bias is added, once."""
    if mesh is None:
        return _dense(x, linear)
    y = reduce_from_model_parallel(torch.matmul(x, cast(linear.weight, x.dtype).t()), mesh)
    return y + cast(linear.bias, x.dtype)


def attention(mha: nn.MultiheadAttention, q_in: torch.Tensor, kv_in: torch.Tensor,
              train: bool = False, generator: Optional[torch.Generator] = None
              ) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention(q_in, kv_in)`` with the
    parameters of ``mha`` (``in_proj_weight``/``in_proj_bias`` rows q;k;v,
    ``out_proj``): q from ``q_in``, k and v from ``kv_in``, each projected
    and rounded, q scaled by 1/√head_dim, QKᵀ, softmax, in training the
    weights' dropout (:func:`~asltpu_torch.models.common.attention_dropout`:
    one mask shared by batch and heads, from ``generator``), the weighted
    sum of v, the output projection, each rounding to the compute dtype
    (that of ``q_in``). ``nn.MultiheadAttention``'s own forward is not
    used, since its fused inference path rounds elsewhere.

    Sharded over the model axis (:mod:`asltpu_torch.dist.tp`), ``mha``
    holds this rank's heads: the head dim stays ``d / num_heads``, the
    heads are as many as its projection's rows hold, and the output
    projection's partial products are summed over the model group."""
    b, n, d = q_in.shape
    head_dim = d // mha.num_heads
    w_in, b_in = cast(mha.in_proj_weight, q_in.dtype), cast(mha.in_proj_bias, q_in.dtype)
    heads = w_in.shape[0] // (3 * head_dim)
    mesh = tp_mesh(mha)
    if mesh is not None:
        same = q_in is kv_in
        q_in = copy_to_model_parallel(q_in, mesh)
        kv_in = q_in if same else copy_to_model_parallel(kv_in, mesh)
    (wq, wk, wv), (bq, bk, bv) = w_in.chunk(3), b_in.chunk(3)
    q, k, v = ((torch.matmul(x, w.t()) + bias).view(b, x.shape[1], heads, head_dim)
               for x, w, bias in ((q_in, wq, bq), (kv_in, wk, bk), (kv_in, wv, bv)))
    q = q / torch.tensor(math.sqrt(head_dim), dtype=q.dtype)
    weights = _softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
    weights = attention_dropout(weights, mha.dropout, train, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, heads * head_dim)
    return _dense_reduced(out, mha.out_proj, mesh)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: x + attn(ln1(x)), then x + mlp2(gelu(mlp1(ln2(x)))).

    ``attn`` is an ``nn.MultiheadAttention`` for its parameter names; the
    block runs it through :func:`attention` as self-attention. Sharded
    over the model axis, the MLP is a Megatron pair: ``mlp1``'s output rows
    and ``mlp2``'s input columns on each rank, one reduction after
    ``mlp2``."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 dropout: float):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = nn.MultiheadAttention(d_model, num_heads, dropout=dropout,
                                          batch_first=True)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp1 = nn.Linear(d_model, d_model * mlp_ratio)
        self.mlp2 = nn.Linear(d_model * mlp_ratio, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In the dtype of ``x``; dropout on the attention weights, after
        attention and after the MLP, as flax's block."""
        y = _layer_norm(x, self.ln1)
        y = attention(self.attn, y, y, train, generator)
        x = x + self.dropout(y, train, generator)
        y = _layer_norm(x, self.ln2)
        mesh = tp_mesh(self.mlp1)
        if mesh is not None:
            y = copy_to_model_parallel(y, mesh)
        y = _gelu(_dense(y, self.mlp1))
        return x + self.dropout(_dense_reduced(y, self.mlp2, mesh), train, generator)


class TransformerHead(nn.Module):
    """Pre-LN transformer encoder over [B, T, F] frame features with a
    learned CLS token and learned positions → logits [B, num_classes].

    It computes in ``dtype`` (None: the dtype of ``pos``, as a head cast by
    ``cast_for_compute`` has it; bf16 under the config's default), except
    that its LayerNorms and ``fc`` stay fp32, as the reference's do: the
    CLS token and the positions are cast to the compute dtype, each
    LayerNorm normalises in fp32 and rounds once, and the CLS output goes
    to fp32 before ``fc``. ``in_proj`` exists only when the feature width
    differs from ``d_model``; ``pos`` has ``num_frames + 1`` rows.
    """

    def __init__(self, num_classes: int, feature_dim: int, num_frames: int,
                 d_model: int = 512, num_heads: int = 8, num_layers: int = 4,
                 mlp_ratio: int = 4, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.in_proj: Optional[nn.Linear] = (
            nn.Linear(feature_dim, d_model) if feature_dim != d_model else None)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos = nn.Parameter(torch.zeros(1, num_frames + 1, d_model))
        self.dropout = Dropout(dropout)
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

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.dtype or self.pos.dtype
        x = cast(feats, dtype)
        if self.in_proj is not None:
            x = _dense(x, self.in_proj)
        cls = cast(self.cls, dtype).expand(x.shape[0], 1, -1)
        x = self.dropout(torch.cat([cls, x], dim=1) + cast(self.pos, dtype), train, generator)
        for layer in self.layers:
            x = layer(x, train, generator)
        return self.fc(cast(_layer_norm(x, self.final_ln)[:, 0], self.fc.weight.dtype))
