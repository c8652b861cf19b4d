"""Bahdanau attention over brain regions (or image patches), in PyTorch.

Counterpart of ``masters_thesis_tpu/models/attention.py``:

    e     = V( dropout( tanh(act(W1 @ features) + act(W2 @ hidden)) ) )
    alpha = softmax(e, axis=regions)                             # (B, R, 1)
    ctx   = sum(alpha * features, regions)

``act`` is the inner activation: the LeakyReLU(0.2) that every AttemptFour
model passes INTO the W1/W2 Dense layers (lc_NIC.py:95-102), or ``linear``
for CNN_RNN's plain attention (CNN_RNN/model.py:38-61). The dropout on the
scores runs in training only, drawn from the caller's generator.
"""

from __future__ import annotations

import torch
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    Dense,
    activation,
    dropout,
    he_normal,
)

INNER_ACTIVATIONS = ("leaky_relu", "linear")


class BahdanauAttention(nn.Module):
    def __init__(self, units: int, features_dim: int, hidden_dim: int,
                 dropout: float = 0.0, inner_activation: str = "leaky_relu",
                 generator=None):
        super().__init__()
        if inner_activation not in INNER_ACTIVATIONS:
            raise ValueError(f"inner_activation {inner_activation!r}: "
                             f"expected one of {INNER_ACTIVATIONS}")
        self.dropout = dropout
        self.inner_activation = inner_activation
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
        act = self.inner_activation
        scores = torch.tanh(activation(self.W1(features), act)
                            + activation(self.W2(hidden), act)[:, None]
                            )                                 # (B, R, A)
        scores = dropout(scores, self.dropout, generator, training)
        alpha = torch.softmax(self.V(scores), dim=1)          # (B, R, 1)
        context = torch.sum(alpha * features, dim=1)          # (B, D)
        return context, alpha
