"""EfficientNet (Tan & Le 2019) in PyTorch — the ENB3 feature extractor.

Counterpart of ``masters_thesis_tpu/models/efficientnet.py``: the reference
dumps 1536-d global-average-pooled EfficientNet-B3 features for all 73k NSD
images (feature_extractor_enb3.py:31-60). The same compound-scaled MBConv
graph: Conv -> BatchNorm (eps 1e-3) -> swish (SiLU); depthwise convs are
grouped by channel; squeeze-excite with ratio 0.25 of the block *input*
channels; width by ``round_filters`` (divisor 8), depth by ceil-scaled
repeats; flax's "SAME" padding and parameter names (``models.backbones``).

``efficientnet("b3")`` -> (B, 300, 300, 3) NHWC -> pooled (B, 1536) and
the top map's patches (B, 100, 1536); ``grid`` is the side of that map for
another image side. Each MBConv's depthwise convolution, its BatchNorm and
swish, and its squeeze-excite up to the gated output are the span
``encode.depthwise_se`` (``utils.profiling.span``), a no-op while no
profiler records.
"""

from __future__ import annotations

import math

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
from masters_thesis_tpu_torch.utils.profiling import span

# B0 baseline: (kernel, stride, expand, in_ch, out_ch, repeats)
_B0_BLOCKS = (
    (3, 1, 1, 32, 16, 1),
    (3, 2, 6, 16, 24, 2),
    (5, 2, 6, 24, 40, 2),
    (3, 2, 6, 40, 80, 3),
    (5, 1, 6, 80, 112, 3),
    (5, 2, 6, 112, 192, 4),
    (3, 1, 6, 192, 320, 1),
)

# model: (width_mult, depth_mult, resolution, dropout)
SCALINGS = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:  # never drop >10%
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class ConvBNAct(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 strides: int = 1, groups: int = 1, act: bool = True,
                 generator=None):
        super().__init__()
        self.act = act
        self.conv = Conv(in_features, features, kernel, strides,
                         groups=groups, use_bias=False, generator=generator)
        self.bn = BatchNorm(features, epsilon=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, in_ch: int, kernel: int, strides: int, expand: int,
                 out_ch: int, se_ch: int, generator=None):
        super().__init__()
        g = generator
        mid = in_ch * expand
        self.skip = strides == 1 and in_ch == out_ch
        self.expand = (ConvBNAct(in_ch, mid, 1, generator=g) if expand != 1
                       else None)
        self.depthwise = ConvBNAct(mid, mid, kernel, strides, groups=mid,
                                   generator=g)
        self.se_reduce = Conv(mid, se_ch, 1, generator=g)
        self.se_expand = Conv(se_ch, mid, 1, generator=g)
        self.project = ConvBNAct(mid, out_ch, 1, act=False, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        if self.expand is not None:
            x = self.expand(x)
        with span("encode.depthwise_se", x):
            x = self.depthwise(x)
            # squeeze-excite: global pool -> reduce -> swish -> expand ->
            # sigmoid -> the gate on every channel
            se = x.mean(dim=(2, 3), keepdim=True)
            se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se))))
            x = x * se
        x = self.project(x)
        if self.skip:
            x = x + inp  # (drop-connect omitted: inference extractor)
        return x


class EfficientNet(nn.Module):
    """Outputs pooled (B, head_ch), patches, and optionally logits."""

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 include_top: bool = False, generator=None):
        super().__init__()
        g = generator
        self.include_top = include_top
        c = round_filters(32, width)
        self.stem = ConvBNAct(3, c, 3, 2, generator=g)
        bi = 0
        for kernel, stride, expand, in_ch, out_ch, repeats in _B0_BLOCKS:
            in_r = round_filters(in_ch, width)
            out_r = round_filters(out_ch, width)
            for r in range(round_repeats(repeats, depth)):
                blk_in = in_r if r == 0 else out_r
                self.add_module(f"block{bi}", MBConv(
                    c, kernel, stride if r == 0 else 1, expand, out_r,
                    se_ch=max(1, blk_in // 4), generator=g))
                c = out_r
                bi += 1
        self.n_blocks = bi
        head = round_filters(1280, width)
        self.head = ConvBNAct(c, head, 1, generator=g)
        if include_top:
            self.predictions = Dense(head, 1000, generator=g)

    def forward(self, images: torch.Tensor) -> dict:
        x = self.stem(nchw(images))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = self.head(x)
        out = {"pooled": x.mean(dim=(2, 3)), "patches": patches(x)}
        if self.include_top:
            out["logits"] = self.predictions(out["pooled"])
        return out


def efficientnet(variant: str = "b3", include_top: bool = False,
                 generator=None):
    """Build a scaled variant; returns (module, input_resolution)."""
    width, depth, res, _ = SCALINGS[variant]
    return EfficientNet(width=width, depth=depth, include_top=include_top,
                        generator=generator), res


def grid(size: int) -> int:
    """The side of the top map (the patch grid) for an image side of
    ``size`` pixels: the stem and the first block of four stages halve it,
    each "SAME" at stride 2 rounding up; 10 at 300, 2 at 64. The same in
    every variant."""
    for stride in (2,) + tuple(b[1] for b in _B0_BLOCKS):
        size = -(-size // stride)
    return size


def preprocess(images: np.ndarray) -> np.ndarray:
    """Keras EfficientNet 'torch'-style: scale to [0,1], ImageNet norm."""
    x = np.asarray(images, np.float32) / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (x - mean) / std
