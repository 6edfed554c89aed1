"""GRU classification head over per-frame feature sequences. Counterpart of
``asltpu/models/temporal.py::GRUHead``."""

from __future__ import annotations

import torch
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
