"""LocallyDense brain encoder in PyTorch: Glasser-region block-dense
projection.

Counterpart of ``masters_thesis_tpu/models/locally_dense.py``. Groups are
bucketed by padded width (``GroupLayout``, the port's copy), and
each bucket is one batched contraction:

    xg    = xpad[:, idx_b]                        # (B, G_b, P_b); pad -> zero col
    out_b = LeakyReLU(0.2)(einsum('bgp,gpd->bgd', xg, W_b) + b_b)
    out   = BatchNorm(concat(out_b)[:, unpermute])          # (B, G, D)
    out   = Dropout(out)                                    # training only

``use_bn=False`` drops the BatchNorm and ``activation="linear"`` the
LeakyReLU, as the concat and deep encoders build it
(``models/encoders.py``).

The gather is ``index_select`` and the contraction is ``einsum``: the JAX
package leaves both to XLA, outside any Pallas kernel. With
``pregathered=True`` the input is already in the grouped padded layout
(``GroupLayout.permute_rows``, or ``data.store.permute_rows`` on the device),
and each bucket is the slice at ``layout.bucket_offsets[b]``: the training
store is permuted once at upload, so a step skips the voxel gather.

Under a model axis (``parallel.sharding.shard_params``) a bucket kernel may
hold this rank's slice of its padded voxel axis, (G_b, P_b / M, D): the
input is then this rank's columns of the grouped layout, each bucket's
slice of every group side by side (``parallel.sharding.rank_columns``),
and the bucket's partial products are summed over the model group before
the bias (``parallel.collectives.reduce_from_model``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    BatchNorm,
    activation,
    dropout,
    truncated_normal,
)
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.parallel.collectives import reduce_from_model


def _bucket_kernel_init(sizes: np.ndarray, padded: int, out_dim: int,
                        generator=None) -> torch.Tensor:
    """he_normal per group with fan_in = true group size; padded rows zero."""
    w = truncated_normal((len(sizes), padded, out_dim), 1.0, generator)
    sizes_t = torch.as_tensor(sizes, dtype=torch.float32)
    std = torch.sqrt(2.0 / sizes_t)[:, None, None]
    mask = torch.arange(padded)[None, :, None] < sizes_t[:, None, None]
    return torch.where(mask, w * std, torch.zeros(()))


class LocallyDense(nn.Module):
    """Bucketed block-dense encoder: (B, n_voxels) -> (B, n_groups, out_dim),
    or (B, >= padded_total) -> (B, n_groups, out_dim) when ``pregathered``.

    Parameters ``kernel_{b}`` (G_b, P_b, D) and ``bias_{b}`` (G_b, D) per
    bucket, then ``input_bn`` over D (with ``use_bn``); ``dropout``
    (dropout_features) follows BatchNorm in training."""

    def __init__(self, layout: GroupLayout, out_dim: int = 32,
                 dropout: float = 0.2, pregathered: bool = False,
                 use_bn: bool = True, activation: str = "leaky_relu",
                 generator=None):
        super().__init__()
        if activation not in ("leaky_relu", "linear"):
            raise ValueError(f"activation {activation!r}: expected "
                             f"'leaky_relu' or 'linear'")
        self.layout = layout
        self.out_dim = out_dim
        self.dropout = dropout
        self.pregathered = pregathered
        self.activation = activation
        for b, bucket in enumerate(layout.buckets):
            gb, pb = len(bucket.group_ids), bucket.padded
            self.register_parameter(f"kernel_{b}", nn.Parameter(
                _bucket_kernel_init(bucket.sizes, pb, out_dim, generator)))
            self.register_parameter(
                f"bias_{b}", nn.Parameter(torch.zeros(gb, out_dim)))
            if not pregathered:
                # static gather indices ride with .to(device) but stay out
                # of the state dict, which mirrors the flax tree
                self.register_buffer(
                    f"indices_{b}",
                    torch.as_tensor(bucket.indices.reshape(-1),
                                    dtype=torch.long),
                    persistent=False)
        self.register_buffer(
            "unpermute", torch.as_tensor(layout.unpermute, dtype=torch.long),
            persistent=False)
        self.input_bn = BatchNorm(out_dim) if use_bn else None

    @property
    def row_shape(self) -> tuple[int]:
        """The shape of one raw (not pregathered) input row."""
        return (self.layout.n_voxels,)

    def _widths(self) -> list[int]:
        """Each bucket kernel's voxel width: P_b, or this rank's slice of
        it under a model axis."""
        return [getattr(self, f"kernel_{b}").shape[1]
                for b in range(len(self.layout.buckets))]

    def _bucket_inputs(self, x: torch.Tensor):
        """(B, G_b, P_b) input of every bucket (P_b this rank's slice under a
        model axis)."""
        B = x.shape[0]
        if self.pregathered:
            widths = self._widths()
            sizes = [len(bk.group_ids) * w
                     for bk, w in zip(self.layout.buckets, widths)]
            # >= : a wider row's tail past the layout is never read
            if x.shape[-1] < sum(sizes):
                raise ValueError(f"pregathered input must be >= "
                                 f"{sum(sizes)} wide, got {x.shape[-1]}")
            offset = 0
            for bucket, w, size in zip(self.layout.buckets, widths, sizes):
                yield x[:, offset:offset + size].view(B, len(bucket.group_ids),
                                                      w)
                offset += size
            return
        xpad = F.pad(x, (0, 1))       # column n_voxels is the zero pad slot
        for b, bucket in enumerate(self.layout.buckets):
            gb, pb = len(bucket.group_ids), bucket.padded
            idx = getattr(self, f"indices_{b}")
            yield xpad.index_select(1, idx).view(B, gb, pb)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        outs = []
        for b, xg in enumerate(self._bucket_inputs(x)):
            y = torch.einsum("bgp,gpd->bgd", xg, getattr(self, f"kernel_{b}"))
            if xg.shape[-1] != self.layout.buckets[b].padded:
                y = reduce_from_model(y)      # this rank's voxel slice
            outs.append(activation(y + getattr(self, f"bias_{b}"),
                                   self.activation))
        out = torch.cat(outs, dim=1).index_select(1, self.unpermute)
        if self.input_bn is not None:
            out = self.input_bn(out, training)
        return dropout(out, self.dropout, generator, training)
