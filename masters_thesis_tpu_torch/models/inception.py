"""InceptionV3 backbone (Szegedy et al. 2016) in PyTorch.

Counterpart of ``masters_thesis_tpu/models/inception.py``: the reference's
CNN_RNN generation extracts (8, 8, 2048) feature maps from Keras
``InceptionV3`` and trains Show-Attend-Tell on the flattened (64, 2048)
patches (CNN_RNN/train.py). The canonical graph (mixed0..mixed10),
Conv -> BatchNorm (no scale, eps 1e-3) -> ReLU throughout, with the flax
tree's parameter names and layouts (``models.backbones``); the branches'
3x3 average pool divides by the count of real elements (Keras
``AveragePooling2D(padding='same')``).

``InceptionV3()`` on (B, 299, 299, 3) NHWC in [-1, 1] gives patches
(B, 64, 2048), pooled (B, 2048), and with ``include_top`` logits (B, 1000);
``grid`` is the side of the patch map for another image side.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from masters_thesis_tpu_torch.models.backbones import (
    BatchNorm,
    Conv,
    nchw,
    patches,
)
from masters_thesis_tpu_torch.models.common import Dense


class ConvBN(nn.Module):
    """conv2d (no bias) + BatchNorm(center, no scale) + ReLU."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=(1, 1), padding: str = "SAME", generator=None):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, strides, padding,
                         use_bias=False, generator=generator)
        self.bn = BatchNorm(features, epsilon=1e-3, use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, SAME padding, count excluding pads."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    """mixed0-2: 1x1 / 5x5 / double-3x3 / pool-proj branches."""

    def __init__(self, c_in: int, pool_features: int, generator=None):
        super().__init__()
        g = generator
        self.b1x1 = ConvBN(c_in, 64, (1, 1), generator=g)
        self.b5x5_1 = ConvBN(c_in, 48, (1, 1), generator=g)
        self.b5x5_2 = ConvBN(48, 64, (5, 5), generator=g)
        self.b3x3dbl_1 = ConvBN(c_in, 64, (1, 1), generator=g)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), generator=g)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), generator=g)
        self.bpool = ConvBN(c_in, pool_features, (1, 1), generator=g)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(nn.Module):
    """mixed3: stride-2 3x3 + stride-2 double-3x3 + maxpool."""

    def __init__(self, c_in: int, generator=None):
        super().__init__()
        g = generator
        self.b3x3 = ConvBN(c_in, 384, (3, 3), (2, 2), "VALID", generator=g)
        self.b3x3dbl_1 = ConvBN(c_in, 64, (1, 1), generator=g)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), generator=g)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID", generator=g)
        self.out_features = 384 + 96 + c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_valid(x)], dim=1)


class InceptionB(nn.Module):
    """mixed4-7: factorized 7x7 branches; c7 = 128/160/160/192."""

    def __init__(self, c_in: int, c7: int, generator=None):
        super().__init__()
        g = generator
        self.b1x1 = ConvBN(c_in, 192, (1, 1), generator=g)
        self.b7x7_1 = ConvBN(c_in, c7, (1, 1), generator=g)
        self.b7x7_2 = ConvBN(c7, c7, (1, 7), generator=g)
        self.b7x7_3 = ConvBN(c7, 192, (7, 1), generator=g)
        self.b7x7dbl_1 = ConvBN(c_in, c7, (1, 1), generator=g)
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1), generator=g)
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7), generator=g)
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1), generator=g)
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7), generator=g)
        self.bpool = ConvBN(c_in, 192, (1, 1), generator=g)
        self.out_features = 4 * 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"b7x7dbl_{i}")(bd)
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(nn.Module):
    """mixed8: stride-2 3x3 + 7x7-then-3x3 + maxpool -> 8x8x1280."""

    def __init__(self, c_in: int, generator=None):
        super().__init__()
        g = generator
        self.b3x3_1 = ConvBN(c_in, 192, (1, 1), generator=g)
        self.b3x3_2 = ConvBN(192, 320, (3, 3), (2, 2), "VALID", generator=g)
        self.b7x7x3_1 = ConvBN(c_in, 192, (1, 1), generator=g)
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7), generator=g)
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1), generator=g)
        self.b7x7x3_4 = ConvBN(192, 192, (3, 3), (2, 2), "VALID",
                               generator=g)
        self.out_features = 320 + 192 + c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"b7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_valid(x)], dim=1)


class InceptionC(nn.Module):
    """mixed9-10: expanded (split 1x3 / 3x1) branches -> 2048 channels."""

    def __init__(self, c_in: int, generator=None):
        super().__init__()
        g = generator
        self.b1x1 = ConvBN(c_in, 320, (1, 1), generator=g)
        self.b3x3_1 = ConvBN(c_in, 384, (1, 1), generator=g)
        self.b3x3_2a = ConvBN(384, 384, (1, 3), generator=g)
        self.b3x3_2b = ConvBN(384, 384, (3, 1), generator=g)
        self.b3x3dbl_1 = ConvBN(c_in, 448, (1, 1), generator=g)
        self.b3x3dbl_2 = ConvBN(448, 384, (3, 3), generator=g)
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3), generator=g)
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1), generator=g)
        self.bpool = ConvBN(c_in, 192, (1, 1), generator=g)
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], dim=1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], dim=1)
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """Input (B, 299, 299, 3) NHWC, values preprocessed to [-1, 1].

    Outputs: patches (B, 64, 2048) — the CNN_RNN attention features —
    pooled (B, 2048), and logits (B, 1000) when ``include_top``."""

    def __init__(self, include_top: bool = False, generator=None):
        super().__init__()
        g = generator
        self.include_top = include_top
        self.stem1 = ConvBN(3, 32, (3, 3), (2, 2), "VALID", generator=g)
        self.stem2 = ConvBN(32, 32, (3, 3), padding="VALID", generator=g)
        self.stem3 = ConvBN(32, 64, (3, 3), generator=g)
        self.stem4 = ConvBN(64, 80, (1, 1), padding="VALID", generator=g)
        self.stem5 = ConvBN(80, 192, (3, 3), padding="VALID", generator=g)
        c = 192
        blocks = []
        for pool in (32, 64, 64):
            blocks.append(InceptionA(c, pool, generator=g))
            c = blocks[-1].out_features
        blocks.append(ReductionA(c, generator=g))
        c = blocks[-1].out_features
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionB(c, c7, generator=g))
            c = blocks[-1].out_features
        blocks.append(ReductionB(c, generator=g))
        c = blocks[-1].out_features
        for _ in range(2):
            blocks.append(InceptionC(c, generator=g))
            c = blocks[-1].out_features
        for i, block in enumerate(blocks):
            self.add_module(f"mixed{i}", block)
        self.n_mixed = len(blocks)
        if include_top:
            self.predictions = Dense(c, 1000, generator=g)

    def forward(self, images: torch.Tensor) -> dict:
        x = self.stem2(self.stem1(nchw(images)))
        x = _max_pool_valid(self.stem3(x))
        x = _max_pool_valid(self.stem5(self.stem4(x)))
        for i in range(self.n_mixed):
            x = getattr(self, f"mixed{i}")(x)
        out = {"patches": patches(x), "pooled": x.mean(dim=(2, 3))}
        if self.include_top:
            out["logits"] = self.predictions(out["pooled"])
        return out


def grid(size: int) -> int:
    """The side of the mixed10 map (the patch grid) for an image side of
    ``size`` pixels: stem1 (3x3, stride 2) and stem2 (3x3), a max pool and
    stem5 (3x3), then three 3x3 stride-2 reductions (a max pool, mixed3,
    mixed8), all VALID; 8 at 299, 1 at 75, the least side that runs."""
    if size < 75:
        raise ValueError(f"image side {size}: InceptionV3 needs 75 or more")
    side = (size - 3) // 2 + 1 - 2
    side = (side - 3) // 2 + 1 - 2
    for _ in range(3):
        side = (side - 3) // 2 + 1
    return side


def preprocess(images: np.ndarray) -> np.ndarray:
    """Inception preprocessing: scale uint8 RGB to [-1, 1]."""
    return np.asarray(images, np.float32) / 127.5 - 1.0
