"""GRU and LSTM layers with the input projection hoisted out of the time
loop.

Counterpart of ``asltpu/ops/recurrent.py`` (``gru_layer``, ``lstm_layer``,
``bilstm``). The JAX package leaves these to XLA (a ``lax.scan``); here
they are plain PyTorch: one ``[B·T, F] × [F, G·H]`` matmul for the input
projections of all steps, then a Python loop over T whose body is
``h @ W_hh`` and the gate math, in fp32.

Torch semantics throughout. GRU: gate order r, z, n; the reset gate applies
after the hidden matmul; separate input and hidden biases. So :class:`GRU`
computes what ``torch.nn.GRU`` computes and carries its parameter names.
LSTM: gate order i, f, g, o and one bias ``b`` (``torch.nn.LSTM``'s
``bias_ih + bias_hh``), as the JAX package keeps it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from asltpu_torch.models.common import Dropout


def lstm_layer(
    x: torch.Tensor,  # [B, T, F]
    w_ih: torch.Tensor,  # [4H, F]
    w_hh: torch.Tensor,  # [4H, H]
    b: torch.Tensor,  # [4H]
    reverse: bool = False,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One unidirectional LSTM layer, fp32. Returns ([B, T, H] outputs,
    (h_T, c_T)); ``reverse`` runs from the last step to the first and
    returns the outputs in input order."""
    bsz, t, f = x.shape
    hidden = w_hh.shape[1]
    x32 = x.to(torch.float32)
    x_proj = torch.addmm(b, x32.reshape(bsz * t, f), w_ih.t()).reshape(bsz, t, -1)
    if init is None:
        h = c = x32.new_zeros(bsz, hidden)
    else:
        h, c = init
    outs: List[torch.Tensor] = []
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = x_proj[:, s] + h @ w_hh.t()
        i, fg, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    if reverse:
        outs.reverse()
    return torch.stack(outs, dim=1), (h, c)


LSTMParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (w_ih, w_hh, b)


def bilstm(x: torch.Tensor, fwd: LSTMParams, bwd: LSTMParams) -> torch.Tensor:
    """Bidirectional LSTM layer → [B, T, 2H]: the forward outputs, then the
    backward ones (``torch.nn.LSTM(bidirectional=True)``'s layout)."""
    out_f, _ = lstm_layer(x, *fwd)
    out_b, _ = lstm_layer(x, *bwd, reverse=True)
    return torch.cat([out_f, out_b], dim=-1)


def gru_layer(
    x: torch.Tensor,  # [B, T, F]
    w_ih: torch.Tensor,  # [3H, F]
    w_hh: torch.Tensor,  # [3H, H]
    b_ih: torch.Tensor,  # [3H]
    b_hh: torch.Tensor,  # [3H]
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional GRU layer in the weights' dtype (fp32 in every
    model). Returns ([B, T, H] outputs, h_T)."""
    b, t, f = x.shape
    hidden = w_hh.shape[1]
    xw = x.to(w_ih.dtype)
    x_proj = torch.addmm(b_ih, xw.reshape(b * t, f), w_ih.t()).reshape(b, t, -1)
    h = xw.new_zeros(b, hidden) if h0 is None else h0
    outs: List[torch.Tensor] = []
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        gh = torch.addmm(b_hh, h, w_hh.t())  # [B, 3H]
        gx_r, gx_z, gx_n = x_proj[:, s].chunk(3, dim=-1)
        gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(gx_r + gh_r)
        z = torch.sigmoid(gx_z + gh_z)
        n = torch.tanh(gx_n + r * gh_n)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    if reverse:
        outs.reverse()
    return torch.stack(outs, dim=1), h


class GRU(nn.Module):
    """Stacked unidirectional GRU over batch-first ``[B, T, F]`` input, with
    ``torch.nn.GRU``'s parameter names (``weight_ih_l0`` …) and dropout on
    every layer's output sequence except the last, in training only, from
    the generator passed to ``forward``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = Dropout(dropout)
        for layer in range(num_layers):
            fan_in = input_size if layer == 0 else hidden_size
            g = 3 * hidden_size
            self.register_parameter(
                f"weight_ih_l{layer}", nn.Parameter(torch.empty(g, fan_in)))
            self.register_parameter(
                f"weight_hh_l{layer}", nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_l{layer}", nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_l{layer}", nn.Parameter(torch.empty(g)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's RNN default: every parameter from U(-1/√H, 1/√H)."""
        k = 1.0 / self.hidden_size ** 0.5
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T, F] → ([B, T, H] last layer's outputs, [L, B, H] final states)."""
        finals = []
        for layer in range(self.num_layers):
            x, h = gru_layer(
                x,
                getattr(self, f"weight_ih_l{layer}"),
                getattr(self, f"weight_hh_l{layer}"),
                getattr(self, f"bias_ih_l{layer}"),
                getattr(self, f"bias_hh_l{layer}"),
            )
            finals.append(h)
            if layer < self.num_layers - 1:
                x = self.dropout(x, train, generator)
        return x, torch.stack(finals)
