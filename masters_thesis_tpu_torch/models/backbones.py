"""Image feature extraction backbones (offline preprocessing), in PyTorch.

Counterpart of ``masters_thesis_tpu/models/backbones.py``. The reference
dumps per-image CNN features once and trains on them (SURVEY.md §2): VGG16
fc2 4096-d and block5-conv (196, 512) patches
(AttemptFour/CNN/feature_extractor.py:38-101), InceptionV3 (64, 2048)
(``models.inception``), EfficientNet-B3 1536-d (``models.efficientnet``),
ResNet-50 (``models.resnet``).

The modules take NHWC images and return the JAX modules' dict of heads;
inside they run NCHW-indexed tensors in the memory layout that
``conv_memory_format`` picks once, at the stem, and every later layer
keeps: NCHW-contiguous for float32 on CUDA with cuDNN's TF32 off, since
cuDNN's float32 convolutions read NCHW and would wrap each channels-last
one in layout transposes; channels-last otherwise (the NHWC input
permuted, no copy), which the TF32 and half-type tensor-core kernels
read. Parameters keep the flax tree's names and layouts, so
``transplant.from_flax`` / ``to_flax`` move weights both ways: a conv
kernel is flax's HWIO (turned into OIHW where ``F.conv2d`` is called), a
Dense kernel (in, out), a BatchNorm's running statistics the buffers
``mean``/``var`` (flax's ``batch_stats``). Flax's "SAME" padding is
asymmetric when the stride is 2, the extra row and column going to the
bottom and right (pad_total = max((ceil(H/s) - 1)·s + k - H, 0), before it
pad_total // 2): ``Conv`` pads explicitly with ``F.pad`` where the two sides
differ, since ``torch``'s ``padding="same"`` refuses a stride and symmetric
padding would move every feature map by a pixel.

``load_npz_variables`` reads the ``.npz`` weight files that
``scripts/convert_*.py`` write for the JAX package ('/'-joined flax paths,
``stats/`` before the BatchNorm statistics); ``extract_features`` runs a
backbone over images in batches on the model's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from masters_thesis_tpu_torch.models.common import Dense, lecun_normal

# conv channels per VGG16 block (Simonyan & Zisserman 2015)
VGG16_CFG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
             (512, 512, 512))


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding of one spatial axis: (before, after)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0):
    """Pad NCHW ``x`` as flax's "SAME" would for a window of ``kernel``
    (kh, kw) at ``stride`` (sh, sw)."""
    top, bottom = same_pads(x.shape[2], kernel[0], stride[0])
    left, right = same_pads(x.shape[3], kernel[1], stride[1])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors: ``kernel`` (kh, kw, in/groups,
    out), an optional ``bias``, "SAME" or "VALID" padding, a stride and
    ``groups`` (flax's ``feature_group_count``)."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 strides=(1, 1), padding: str = "SAME", groups: int = 1,
                 use_bias: bool = True, generator=None):
        super().__init__()
        self.kernel_size = (kernel, kernel) if isinstance(kernel, int) \
            else tuple(kernel)
        self.strides = (strides, strides) if isinstance(strides, int) \
            else tuple(strides)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: expected SAME or VALID")
        self.padding = padding
        self.groups = groups
        self.kernel = nn.Parameter(lecun_normal(
            (*self.kernel_size, in_features // groups, features), generator))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def padded(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
        """(x, pad): ``x`` padded where the two sides differ, and the
        symmetric (top, left) padding left for the convolution."""
        if self.padding == "VALID":
            return x, (0, 0)
        (top, bottom), (left, right) = (
            same_pads(x.shape[2], self.kernel_size[0], self.strides[0]),
            same_pads(x.shape[3], self.kernel_size[1], self.strides[1]))
        if top == bottom and left == right:
            return x, (top, left)
        return F.pad(x, (left, right, top, bottom)), (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = self.padded(x)
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        stride=self.strides, padding=pad, groups=self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over the channels
    of NCHW tensors: ``(x - mean) * rsqrt(var + epsilon) * scale + bias``,
    without ``scale`` when ``use_scale`` is False (InceptionV3's)."""

    def __init__(self, features: int, epsilon: float,
                 use_scale: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.scale = (nn.Parameter(torch.ones(features)) if use_scale
                      else None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + self.epsilon)
        if self.scale is not None:
            mul = mul * self.scale
        return ((x - self.mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def conv_memory_format(device, dtype: torch.dtype) -> torch.memory_format:
    """The memory layout in which cuDNN convolves tensors of ``dtype`` on
    ``device`` without layout transposes: NCHW-contiguous for float32 on
    CUDA while ``torch.backends.cudnn.allow_tf32`` is off (cuDNN's float32
    kernels read NCHW), channels-last otherwise (its TF32 and half-type
    tensor-core kernels read NHWC; on the CPU the permuted images as they
    are)."""
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and not torch.backends.cudnn.allow_tf32):
        return torch.contiguous_format
    return torch.channels_last


def nchw(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images -> (B, C, H, W) in ``conv_memory_format``'s
    layout: channels-last is the images permuted, without a copy."""
    return images.permute(0, 3, 1, 2).contiguous(
        memory_format=conv_memory_format(images.device, images.dtype))


def patches(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H·W, C), rows in the NHWC order flax reshapes."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


class VGG16(nn.Module):
    """Outputs a dict: fc2 (B, 4096), conv5 (B, P, 512), logits (B, 1000)
    (with ``include_top``). Input: (B, H, W, 3) RGB of ``image_size``
    (224 in the reference), caller-normalised (``preprocess``); fc1 reads
    the (H/32)·(W/32)·512 flattened block-5 output, as flax sizes it from
    its input."""

    def __init__(self, include_top: bool = True, image_size=224,
                 generator=None):
        super().__init__()
        self.include_top = include_top
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else image_size)
        c_in = 3
        for b, widths in enumerate(VGG16_CFG, start=1):
            for c, width in enumerate(widths, start=1):
                self.add_module(f"block{b}_conv{c}",
                                Conv(c_in, width, generator=generator))
                c_in = width
            h, w = h // 2, w // 2
        if include_top:
            self.fc1 = Dense(h * w * 512, 4096, generator=generator)
            self.fc2 = Dense(4096, 4096, generator=generator)
            self.predictions = Dense(4096, 1000, generator=generator)

    def forward(self, images: torch.Tensor) -> dict:
        x = nchw(images)
        out = {}
        for b, widths in enumerate(VGG16_CFG, start=1):
            for c in range(1, len(widths) + 1):
                x = F.relu(getattr(self, f"block{b}_conv{c}")(x))
            if b == 5:
                # (B, 512, 14, 14) -> (B, 196, 512): the attention patches
                out["conv5"] = patches(x)
            x = F.max_pool2d(x, 2, 2)
        if self.include_top:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
            x = F.relu(self.fc1(x))
            x = F.relu(self.fc2(x))
            out["fc2"] = x
            out["logits"] = self.predictions(x)
        return out


def preprocess(images: np.ndarray) -> np.ndarray:
    """Keras VGG16 'caffe' preprocessing: RGB->BGR, subtract ImageNet means."""
    x = np.asarray(images, np.float32)[..., ::-1]
    return x - np.array([103.939, 116.779, 123.68], np.float32)


def _state_key(path: str) -> str:
    return path.replace("/", ".")


def _merge(model: nn.Module, flat: dict) -> nn.Module:
    """Copy the arrays of ``flat`` ({state-dict key: array}) whose key the
    model has into it (shapes must match); other keys are ignored, as the
    JAX ``_merge_flat`` ignores paths its tree lacks."""
    state = model.state_dict()
    with torch.no_grad():
        for key, arr in flat.items():
            if key in state:
                if tuple(arr.shape) != tuple(state[key].shape):
                    raise ValueError(f"{key}: npz shape {arr.shape}, model "
                                     f"{tuple(state[key].shape)}")
                state[key].copy_(torch.from_numpy(np.asarray(arr)))
    return model


def load_npz_weights(model: nn.Module, path: str) -> nn.Module:
    """Merge a {param_path: array} npz into the model's parameters.

    Keys use '/'-joined flax paths, e.g. 'block1_conv1/kernel'. Shapes must
    match (conv kernels HWIO; dense kernels (in, out))."""
    blob = dict(np.load(path))
    return _merge(model, {_state_key(k): v for k, v in blob.items()
                          if not k.startswith("stats/")})


def load_npz_variables(model: nn.Module, path: str) -> nn.Module:
    """Merge an npz into the parameters AND the BatchNorm statistics: plain
    keys are parameters, keys prefixed ``stats/`` the running mean/var
    (without these a pretrained BN backbone would run on the init
    statistics mean=0/var=1 and emit wrong features)."""
    blob = dict(np.load(path))
    flat = {}
    for k, v in blob.items():
        if k.startswith("stats/"):
            k = k[len("stats/"):]
            if k.rsplit("/", 1)[-1] not in ("mean", "var"):
                continue
        elif k.rsplit("/", 1)[-1] in ("mean", "var"):
            continue
        flat[_state_key(k)] = v
    return _merge(model, flat)


@torch.no_grad()
def extract_features(model: nn.Module, images: np.ndarray,
                     batch_size: int = 64, head: str = "fc2") -> np.ndarray:
    """Batched feature extraction (the reference's per-key dump loop,
    feature_extractor.py:67-84) on the model's device, in eval mode: the
    ``head`` output of every image, (N, ...) float32. The short tail batch
    runs as it is (the JAX package pads it to a static shape; in eval mode
    a row's features do not depend on its batch)."""
    model.eval()
    device = next(model.parameters()).device
    outs = []
    for i in range(0, len(images), batch_size):
        batch = np.require(images[i:i + batch_size], np.float32, ("C", "W"))
        outs.append(model(torch.from_numpy(batch).to(device))[head]
                    .float().cpu().numpy())
    return np.concatenate(outs)


class GlobalPoolExtractor(nn.Module):
    """EfficientNet-style pooled-feature head over any backbone trunk
    (feature_extractor_enb3.py:31-60 semantics: global-avg-pool -> (C,))."""

    def __init__(self, trunk: nn.Module, head: str = "conv5"):
        super().__init__()
        self.trunk = trunk
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.trunk(images)[self.head].mean(dim=1)
