"""Feature encoders for the NIC family besides LocallyDense, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/encoders.py``:

- ``PatchDense``: (B, P, C) conv-feature patches -> (B, P, D);
- ``PixelPatchDense``: (B, H, W, 3) images -> a named CNN backbone's top
  map as patches (InceptionV3's mixed10 by default, or EfficientNet-B3's
  head) -> the shared ``PatchDense`` -> (B, P, D), Show, Attend and Tell
  from pixels (the CNN_RNN's extractor and encoder in one module);
- ``FullyConnectedEncoder``: one Dense + BatchNorm + dropout over the whole
  flat input (AttemptFour/Model/fullyConnected.py:6-27) -> (B, 1, D);
- ``ConcatLocallyDense``: linear per-group projections concatenated flat,
  then a LeakyReLU(0.2) Dense bottleneck (localDense.py:44-63, the "concat
  method") -> (B, 1, embed_dim);
- ``DeepLocallyDense``: depth-n per-region stacks with BatchNorm between
  layers (deep_layers.py:6-75) -> (B, G, D).

``PatchDense`` comes in two reference flavours:

- shared (``per_patch=False``): ONE Dense ``proj`` over the channel axis,
  the CNN_RNN CNN_Encoder (CNN_RNN/model.py:23-36);
- per-patch (``per_patch=True``): a separate Dense per patch as one
  ``bpc,pcd->bpd`` einsum, kernel (P, C, D) and bias (P, D), the
  img_localDense of AttemptFour (img_localDense.py:20-38).

Then ``relu`` or LeakyReLU(0.2), the optional BatchNorm ``bn`` over D (the
port's flax-exact one), and dropout in training. It also takes a row flat,
(B, P·C), as the 2-D device store gathers it, and shapes it back.

The per-patch and per-region contractions sum in fp32 (the JAX einsums'
``preferred_element_type``); the per-patch one returns the input's dtype,
as the JAX one casts back.

Each encoder has the flax tree's parameter names, ``out_dim`` (the width of
a region's features) and ``row_shape`` (one input row's shape).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from masters_thesis_tpu_torch.models import efficientnet, inception
from masters_thesis_tpu_torch.models.common import (
    BatchNorm,
    Dense,
    activation,
    dropout,
    he_normal,
    leaky_relu,
    matmul_f32,
    truncated_normal,
)
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.utils.profiling import span

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
        if x.ndim == 2:
            x = x.reshape(x.shape[0], *self.row_shape)
        if self.per_patch:
            y = (matmul_f32("bpc,pcd->bpd", x, self.kernel)
                 + self.bias).to(x.dtype)
        else:
            y = self.proj(x)
        y = activation(y, self.activation)
        if self.bn is not None:
            y = self.bn(y, training)
        return dropout(y, self.dropout, generator, training)


class PixelBackbone(NamedTuple):
    """A CNN that a pixel encoder runs: its name in prose, its module
    built from a generator, the side of its top map for an image side, and
    that map's channels."""

    title: str
    build: Callable
    grid: Callable
    channels: int


# the backbones of ``PixelPatchDense``, by the ``features`` command's names
PIXEL_BACKBONES = {
    "inception_v3": PixelBackbone(
        "InceptionV3", lambda g: inception.InceptionV3(generator=g),
        inception.grid, 2048),
    "efficientnet_b3": PixelBackbone(
        "EfficientNet-B3", lambda g: efficientnet.efficientnet(
            "b3", generator=g)[0], efficientnet.grid, 1536),
}
DEFAULT_BACKBONE = "inception_v3"


def pixel_backbone(name: str) -> PixelBackbone:
    """The pixel backbone called ``name``; an unknown name raises."""
    if name not in PIXEL_BACKBONES:
        raise ValueError(f"backbone {name!r}: expected one of "
                         f"{sorted(PIXEL_BACKBONES)}")
    return PIXEL_BACKBONES[name]


class PixelPatchDense(PatchDense):
    """(B, H·W·3) or (B, H, W, 3) images, preprocessed as the ``features``
    command preprocesses them for the backbone (``inception.preprocess``
    to [-1, 1], ``efficientnet.preprocess`` to ImageNet's mean and
    deviation) -> (B, P, D): ``backbone``, the module of the ``features``
    command named ``backbone_name`` (``PIXEL_BACKBONES``), gives the
    patches of its top map (InceptionV3's mixed10, 8 x 8 x 2,048 at 299 x
    299; EfficientNet-B3's head, 10 x 10 x 1,536 at 300 x 300; P =
    ``grid(H) · grid(W)``), which the shared relu ``PatchDense`` (``proj``,
    the CNN_RNN's CNN_Encoder) projects. ``row_shape`` is (H, W, 3). The
    backbone's forward is the span ``encode.backbone``
    (``utils.profiling.span``). Its BatchNorms always take their running
    statistics: nothing here trains the backbone. Its convolutions run in
    fp32 whatever ``torch.backends.cudnn.allow_tf32`` says (PyTorch's
    default lets cuDNN take TF32, which moves the greedy words of these
    deep stacks), and so on CUDA in the NCHW-contiguous layout that
    cuDNN's float32 kernels read (``backbones.conv_memory_format``); the
    flag is the caller's again after the call."""

    def __init__(self, image_size, out_dim: int,
                 backbone: str = DEFAULT_BACKBONE, generator=None):
        h, w = image_size
        spec = pixel_backbone(backbone)
        super().__init__(spec.grid(h) * spec.grid(w), spec.channels,
                         out_dim, activation="relu", generator=generator)
        self.backbone_name = backbone
        self.backbone = spec.build(generator)
        self.row_shape = (h, w, 3)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        images = x.reshape(x.shape[0], *self.row_shape)
        with span("encode.backbone", images), fp32_convolutions():
            patches = self.backbone(images)["patches"]
        return super().forward(patches, training, generator)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN's float32 convolutions without TF32 inside the block; the
    flag is restored after it. The port runs a model on one thread at a
    time (``server.DynamicBatcher``'s worker), so no other call sees the
    flag changed."""
    kept = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = kept


class FullyConnectedEncoder(nn.Module):
    """(B, N) -> (B, 1, D): Dense ``fc`` + LeakyReLU + BatchNorm ``bn`` +
    dropout on the whole input."""

    def __init__(self, n_inputs: int, out_dim: int, dropout: float = 0.2,
                 generator=None):
        super().__init__()
        self.row_shape = (n_inputs,)
        self.out_dim = out_dim
        self.dropout = dropout
        self.fc = Dense(n_inputs, out_dim, he_normal, generator)
        self.bn = BatchNorm(out_dim)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        y = self.bn(leaky_relu(self.fc(x)), training)
        return dropout(y, self.dropout, generator, training)[:, None, :]


class ConcatLocallyDense(nn.Module):
    """(B, N) -> (B, 1, embed_dim): per-group linear Dense ``groups``
    (no BatchNorm, as the reference configures it, lc_NIC.py:71-80),
    concatenated to (B, G·D), dropout, then Dense ``embed`` to
    ``embed_dim`` with LeakyReLU(0.2) (localDense.py:36-39, 58-63)."""

    def __init__(self, layout: GroupLayout, out_dim: int = 32,
                 embed_dim: int = 512, dropout: float = 0.2,
                 generator=None):
        super().__init__()
        self.row_shape = (layout.n_voxels,)
        self.out_dim = embed_dim
        self.dropout = dropout
        self.groups = LocallyDense(layout, out_dim, dropout=0.0,
                                   use_bn=False, activation="linear",
                                   generator=generator)
        self.embed = Dense(layout.n_groups * out_dim, embed_dim, he_normal,
                           generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        y = self.groups(x, training, generator)
        y = dropout(y.reshape(y.shape[0], -1), self.dropout, generator,
                    training)
        return leaky_relu(self.embed(y))[:, None, :]


class DeepLocallyDense(nn.Module):
    """(B, N) -> (B, G, D): LocallyDense ``block0`` (no BatchNorm), then
    ``depth - 1`` times BatchNorm ``bn{d}`` and a per-region Dense
    (``kernel{d}`` (G, D, D), ``bias{d}`` (G, D)) with LeakyReLU(0.2), then
    dropout. Each region's kernel is he_normal with fan_in D, as G separate
    Dense layers would draw it (deep_layers.py)."""

    def __init__(self, layout: GroupLayout, out_dim: int = 32,
                 depth: int = 2, dropout: float = 0.2, generator=None):
        super().__init__()
        self.row_shape = (layout.n_voxels,)
        self.out_dim = out_dim
        self.depth = depth
        self.dropout = dropout
        self.block0 = LocallyDense(layout, out_dim, dropout=0.0, use_bn=False,
                                   generator=generator)
        G = layout.n_groups
        for d in range(1, depth):
            self.add_module(f"bn{d}", BatchNorm(out_dim))
            self.register_parameter(f"kernel{d}", nn.Parameter(
                truncated_normal((G, out_dim, out_dim),
                                 math.sqrt(2.0 / out_dim), generator)))
            self.register_parameter(
                f"bias{d}", nn.Parameter(torch.zeros(G, out_dim)))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        y = self.block0(x, training, generator)
        for d in range(1, self.depth):
            y = getattr(self, f"bn{d}")(y, training)
            y = leaky_relu(matmul_f32("bgd,gde->bge", y,
                                      getattr(self, f"kernel{d}"))
                           + getattr(self, f"bias{d}"))
        return dropout(y, self.dropout, generator, training)
