"""LSTM and GRU cells with exact Keras semantics, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/lstm.py``.

LSTM (``KerasLSTMCell``, parameters ``lstm/*``):

- gate packing order: [i | f | c̄ | o]
- kernel (in, 4U) glorot_uniform; recurrent (U, 4U) orthogonal
- bias zeros with unit forget bias (f-slice = 1)
- c' = sigmoid(f)·c + sigmoid(i)·tanh(c̄);  h' = sigmoid(o)·tanh(c')

GRU (``KerasGRUCell``, parameters ``gru/*``), Keras ``reset_after=True`` as
the CNN_RNN decoder uses it (CNN_RNN/model.py:67-115):

- gate packing order: [z | r | h̄]
- kernel (in, 3U) glorot_uniform; recurrent (U, 3U) orthogonal
- bias (2, 3U) zeros: row 0 the input bias, row 1 the recurrent bias
- xz = x·kernel + bias[0];  hz = h·recurrent + bias[1]
- z = sigmoid(xz_z + hz_z);  r = sigmoid(xz_r + hz_r)
- h̄ = tanh(xz_h + r·hz_h);  h' = z·h + (1 − z)·h̄

The carry stays fp32. Under a bf16 forward (``tpu.compute_dtype``) the
products promote as ``jnp``'s do: h is cast to the input's dtype, and a
bf16 input against bf16 kernels stays bf16 while an fp32 one promotes the
kernels (``models.common.matmul``); the new state takes the dtype its
terms promote to, and the output is cast to the gates' dtype, as in the
JAX cells (``models/lstm.py:46-59, 80-88``).
"""

from __future__ import annotations

import torch
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    glorot_uniform,
    matmul,
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
        z = (matmul(x, self.kernel) + matmul(h.to(x.dtype),
                                             self.recurrent_kernel)
             + self.bias)
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new.to(z.dtype)


class KerasGRUCell(nn.Module):
    def __init__(self, in_features: int, units: int, generator=None):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(
            glorot_uniform((in_features, 3 * units), generator))
        self.recurrent_kernel = nn.Parameter(
            orthogonal((units, 3 * units), generator))
        self.bias = nn.Parameter(torch.zeros(2, 3 * units))

    def forward(self, h: torch.Tensor, x: torch.Tensor):
        """h: (B, U); x: (B, F). Returns (h', h')."""
        xz = matmul(x, self.kernel) + self.bias[0]
        hz = matmul(h.to(x.dtype), self.recurrent_kernel) + self.bias[1]
        xz_z, xz_r, xz_h = torch.chunk(xz, 3, dim=-1)
        hz_z, hz_r, hz_h = torch.chunk(hz, 3, dim=-1)
        z = torch.sigmoid(xz_z + hz_z)
        r = torch.sigmoid(xz_r + hz_r)
        hh = torch.tanh(xz_h + r * hz_h)
        h_new = z * h + (1 - z) * hh
        return h_new, h_new.to(xz.dtype)
