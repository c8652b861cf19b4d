"""Image-patch encoder for the NIC family, in PyTorch.

Counterpart of ``PatchDense`` in ``masters_thesis_tpu/models/encoders.py``:
(B, P, C) conv-feature patches -> (B, P, D), in two reference flavours.

- shared (``per_patch=False``): ONE Dense ``proj`` over the channel axis,
  the CNN_RNN CNN_Encoder (CNN_RNN/model.py:23-36);
- per-patch (``per_patch=True``): a separate Dense per patch as one
  ``bpc,pcd->bpd`` einsum, kernel (P, C, D) and bias (P, D), the
  img_localDense of AttemptFour (img_localDense.py:20-38).

Then ``relu`` or LeakyReLU(0.2), the optional BatchNorm ``bn`` over D (the
port's flax-exact one), and dropout in training. Parameter names follow the
flax tree. The other encoders of that module wait for ROADMAP M11.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    BatchNorm,
    Dense,
    activation,
    dropout,
    he_normal,
    truncated_normal,
)

ACTIVATIONS = ("relu", "leaky_relu")


class PatchDense(nn.Module):
    """(B, P, C) -> (B, P, D). ``row_shape`` (P, C) is the shape of one
    input row, which the serving API checks requests against."""

    def __init__(self, n_patches: int, in_channels: int, out_dim: int,
                 dropout: float = 0.0, activation: str = "relu",
                 per_patch: bool = False, use_bn: bool = False,
                 generator=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: expected one of "
                             f"{ACTIVATIONS}")
        self.row_shape = (n_patches, in_channels)
        self.out_dim = out_dim
        self.dropout = dropout
        self.activation = activation
        self.per_patch = per_patch
        if per_patch:
            # he_normal with fan_in = C for each patch, as P separate Dense
            # layers would draw it (flax: variance_scaling, batch_axis=0)
            self.kernel = nn.Parameter(truncated_normal(
                (n_patches, in_channels, out_dim),
                math.sqrt(2.0 / in_channels), generator))
            self.bias = nn.Parameter(torch.zeros(n_patches, out_dim))
        else:
            self.proj = Dense(in_channels, out_dim, he_normal, generator)
        self.bn = BatchNorm(out_dim) if use_bn else None

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        if self.per_patch:
            y = torch.einsum("bpc,pcd->bpd", x, self.kernel) + self.bias
        else:
            y = self.proj(x)
        y = activation(y, self.activation)
        if self.bn is not None:
            y = self.bn(y, training)
        return dropout(y, self.dropout, generator, training)
