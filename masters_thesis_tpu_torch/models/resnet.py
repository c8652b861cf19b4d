"""ResNet-v1.5 (He et al. 2016) in PyTorch — bottleneck-block family.

Counterpart of ``masters_thesis_tpu/models/resnet.py``: the torchvision-style
v1.5 graph (stride 2 in the 3x3 of each downsampling bottleneck), with the
flax tree's parameter names and layouts (``models.backbones``), BatchNorm
eps 1e-5, flax "SAME" padding, and the stem's 3x3/2 max-pool padded with
-inf as flax pads a max window.

``resnet("resnet50")`` -> (B, 224, 224, 3) NHWC -> pooled (B, 2048),
patches (B, 49, 2048), optional logits (B, 1000).
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
    pad_same,
    patches,
)
from masters_thesis_tpu_torch.models.common import Dense

# blocks per stage
DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 strides: int = 1, act: bool = True, generator=None):
        super().__init__()
        self.act = act
        self.conv = Conv(in_features, features, kernel, strides,
                         use_bias=False, generator=generator)
        self.bn = BatchNorm(features, epsilon=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride here, v1.5) -> 1x1 expand x4, residual."""

    def __init__(self, in_features: int, width: int, strides: int = 1,
                 generator=None):
        super().__init__()
        out_ch = width * 4
        g = generator
        if strides != 1 or in_features != out_ch:
            self.downsample = ConvBN(in_features, out_ch, 1, strides,
                                     act=False, generator=g)
        else:
            self.downsample = None
        self.conv1 = ConvBN(in_features, width, 1, generator=g)
        self.conv2 = ConvBN(width, width, 3, strides, generator=g)
        self.conv3 = ConvBN(width, out_ch, 1, act=False, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    def __init__(self, depths=(3, 4, 6, 3), include_top: bool = False,
                 generator=None):
        super().__init__()
        self.depths = tuple(depths)
        self.include_top = include_top
        self.stem = ConvBN(3, 64, 7, 2, generator=generator)
        c_in = 64
        for stage, n_blocks in enumerate(self.depths):
            width = 64 * 2 ** stage
            for b in range(n_blocks):
                self.add_module(f"layer{stage + 1}_{b}", Bottleneck(
                    c_in, width, strides=2 if (b == 0 and stage > 0) else 1,
                    generator=generator))
                c_in = width * 4
        if include_top:
            self.predictions = Dense(c_in, 1000, generator=generator)

    def forward(self, images: torch.Tensor) -> dict:
        x = self.stem(nchw(images))
        x = F.max_pool2d(pad_same(x, (3, 3), (2, 2), value=-float("inf")),
                         3, 2)
        for stage, n_blocks in enumerate(self.depths):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        out = {"patches": patches(x), "pooled": x.mean(dim=(2, 3))}
        if self.include_top:
            out["logits"] = self.predictions(out["pooled"])
        return out


def resnet(variant: str = "resnet50", include_top: bool = False,
           generator=None) -> ResNet:
    return ResNet(depths=DEPTHS[variant], include_top=include_top,
                  generator=generator)


def preprocess(images: np.ndarray) -> np.ndarray:
    """torchvision-style: [0,1] scale + ImageNet normalization."""
    x = np.asarray(images, np.float32) / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (x - mean) / std
