"""LSTM cell with exact Keras semantics, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/lstm.py``:

- gate packing order: [i | f | c̄ | o]
- kernel (in, 4U) glorot_uniform; recurrent (U, 4U) orthogonal
- bias zeros with unit forget bias (f-slice = 1)
- c' = sigmoid(f)·c + sigmoid(i)·tanh(c̄);  h' = sigmoid(o)·tanh(c')

The carry (h, c) stays fp32. The Keras GRU cell waits for ROADMAP M11.
"""

from __future__ import annotations

import torch
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    glorot_uniform,
    orthogonal,
    unit_forget_bias,
)


class KerasLSTMCell(nn.Module):
    def __init__(self, in_features: int, units: int, generator=None):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(
            glorot_uniform((in_features, 4 * units), generator))
        self.recurrent_kernel = nn.Parameter(
            orthogonal((units, 4 * units), generator))
        self.bias = nn.Parameter(unit_forget_bias((4 * units,)))

    def forward(self, carry, x: torch.Tensor):
        """carry = (h, c) each (B, U); x: (B, F). Returns ((h', c'), h')."""
        h, c = carry
        z = x @ self.kernel + h.to(x.dtype) @ self.recurrent_kernel + self.bias
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new.to(z.dtype)
