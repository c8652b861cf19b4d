"""Bahdanau attention over brain regions, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/attention.py``:

    e     = V( dropout( tanh(act(W1 @ features) + act(W2 @ hidden)) ) )
    alpha = softmax(e, axis=regions)                             # (B, R, 1)
    ctx   = sum(alpha * features, regions)

``act`` is the LeakyReLU(0.2) that every AttemptFour model passes INTO the
W1/W2 Dense layers (lc_NIC.py:95-102). The dropout on the scores runs in
training only, drawn from the caller's generator. CNN_RNN's linear attention
waits for ROADMAP M11.
"""

from __future__ import annotations

import torch
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    Dense,
    dropout,
    he_normal,
    leaky_relu,
)


class BahdanauAttention(nn.Module):
    def __init__(self, units: int, features_dim: int, hidden_dim: int,
                 dropout: float = 0.0, generator=None):
        super().__init__()
        self.dropout = dropout
        self.W1 = Dense(features_dim, units, he_normal, generator)
        self.W2 = Dense(hidden_dim, units, he_normal, generator)
        self.V = Dense(units, 1, generator=generator)

    def forward(self, hidden: torch.Tensor, features: torch.Tensor,
                training: bool = False, generator=None):
        """hidden: (B, U); features: (B, R, D).

        Returns (context (B, D), weights (B, R, 1))."""
        if features.ndim != 3 or hidden.ndim != 2 \
                or hidden.shape[0] != features.shape[0]:
            raise ValueError(
                f"attention needs hidden (B, U) and features (B, R, D), got "
                f"{tuple(hidden.shape)} and {tuple(features.shape)}")
        hidden = hidden.to(features.dtype)
        scores = torch.tanh(
            leaky_relu(self.W1(features)) + leaky_relu(self.W2(hidden))[:, None]
        )                                                     # (B, R, A)
        scores = dropout(scores, self.dropout, generator, training)
        alpha = torch.softmax(self.V(scores), dim=1)          # (B, R, 1)
        context = torch.sum(alpha * features, dim=1)          # (B, D)
        return context, alpha
