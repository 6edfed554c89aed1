"""PoseBiLSTM — config #1: 543-landmark pose features → 2-layer
bidirectional LSTM → WLASL-100 gloss logits. Counterpart of
``asltpu/models/bilstm.py``.

Landmarks are in the MediaPipe Holistic layout, 543 × (x, y, z); missing
detections are all-zero rows. :func:`normalize_landmarks` recentres on the
mid-shoulder point and scales by shoulder width on the device, inside the
model. The recurrence is ``torch.nn.LSTM`` (cuDNN's fused LSTM on the
card), run in fp32 with TF32 off: PyTorch lets cuDNN use TF32 by default,
and the JAX package computes the LSTM in fp32. Its parameter names are the
ones ``asltpu.ckpt.import_torch_rnn`` reads (``lstm.weight_ih_l0``,
``lstm.weight_hh_l0_reverse``, … and ``fc.*``); its gates are those of
:func:`asltpu_torch.ops.recurrent.lstm_layer`, the plain version.

Training (``forward(landmarks, train=True, generator=g)``) draws dropout
between the layers and before ``fc`` from ``g``, as the JAX module does
with its dropout key: the layers then run one at a time, since
``nn.LSTM``'s own inter-layer dropout would draw from the global RNG
(``nn.LSTM`` is built with dropout 0, and its parameters keep their
names). The JAX model has one bias per gate, ``b = bias_ih + bias_hh``:
the hidden-side biases are not trained (``requires_grad`` off), so the
trained sum moves as the JAX bias does and weight decay reaches it once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asltpu_torch.config import LANDMARK_DIM, NUM_LANDMARKS
from asltpu_torch.models.common import Dropout

# MediaPipe Holistic pose indices of the shoulders (within the 33 pose
# landmarks that lead the 543-landmark layout).
_LEFT_SHOULDER = 11
_RIGHT_SHOULDER = 12


def normalize_landmarks(lm: torch.Tensor) -> torch.Tensor:
    """[..., T, 543, 3] raw landmarks → recentred, scale-normalised fp32.

    Recentre on the mid-shoulder point and scale by shoulder width, the
    divisor clamped at 1e-4; rows that are exactly zero (missing
    detections) stay zero, and a frame whose shoulder width is ≤ 1e-3 (no
    usable pose) becomes all zero.
    """
    lm = lm.to(torch.float32)
    left = lm[..., _LEFT_SHOULDER, :]
    right = lm[..., _RIGHT_SHOULDER, :]
    center = 0.5 * (left + right)  # [..., T, 3]
    scale = torch.linalg.vector_norm(left - right, dim=-1, keepdim=True)  # [..., T, 1]
    normed = (lm - center[..., None, :]) / scale.clamp_min(1e-4)[..., None, :]
    missing = (lm == 0.0).all(dim=-1, keepdim=True)
    keep = ~missing & (scale > 1e-3)[..., None, :]
    return torch.where(keep, normed, torch.zeros_like(normed))


class PoseBiLSTM(nn.Module):
    """2-layer BiLSTM gloss classifier over [B, T, 543, 3] landmarks."""

    # cuDNN's TF32 inside the LSTM: off, so the recurrence stays fp32. The
    # card checks turn it on once, to show that their bound would see it.
    lstm_tf32 = False

    def __init__(self, num_classes: int = 100, hidden: int = 256,
                 num_layers: int = 2, dropout: float = 0.3,
                 num_landmarks: int = NUM_LANDMARKS,
                 landmark_dim: int = LANDMARK_DIM):
        super().__init__()
        self.hidden = hidden
        self.lstm = nn.LSTM(num_landmarks * landmark_dim, hidden, num_layers,
                            batch_first=True, bidirectional=True)
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(2 * hidden, num_classes)

    def _layers(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The LSTM in training: one layer at a time (``nn.LSTM``'s weights
        of layer k, both directions), dropout between the layers."""
        lstm = self.lstm
        per_layer = len(lstm._flat_weights) // lstm.num_layers
        h0 = x.new_zeros(2, x.shape[0], self.hidden)
        for k in range(lstm.num_layers):
            if k:
                x = self.dropout(x, True, generator)
            weights = lstm._flat_weights[k * per_layer:(k + 1) * per_layer]
            x = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, True, True, True)[0]
        return x

    def forward(self, landmarks: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t = landmarks.shape[:2]
        x = normalize_landmarks(landmarks).reshape(b, t, -1)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=self.lstm_tf32):
            x = self._layers(x, generator) if train else self.lstm(x)[0]  # [B, T, 2H]
        # The forward direction's last step and the backward direction's
        # first: torch's (h_n forward, h_n backward).
        h = self.hidden
        pooled = torch.cat([x[:, -1, :h], x[:, 0, h:]], dim=-1)
        return self.fc(self.dropout(pooled, train, generator))
