"""The program's CnnRnn on pixels (EfficientNet-B3 inside its encoder),
holding the benchmark's weights."""

from __future__ import annotations

import torch

from port_bench.programs.cnn_rnn import LEAVES  # noqa: F401  (the decoder's)
from port_bench.reference.cnn_rnn_efficientnet import (
    BLOCKS,
    LAYERS,
    preprocess,
    row_width,
)


def build(cfg: dict, device):
    """The model at the configuration's widths, on ``device``, its
    backbone named."""
    from masters_thesis_tpu_torch.models import nic

    return nic.CnnRnnNIC(
        embed_dim=cfg["embed_dim"], units=cfg["units"],
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        image_size=tuple(cfg["image_size"]), backbone="efficientnet_b3",
        generator=torch.Generator().manual_seed(0)).to(device)


def convolutions(backbone) -> list:
    """(the program's layer, the reference's convolution name) of every
    convolution, in ``LAYERS``' order: the stem, each block's expansion
    (none in the first stage), depthwise, squeeze-and-excitation pair and
    projection, the head."""
    out = [(backbone.stem, "stem_conv")]
    for i, (name, *_) in enumerate(BLOCKS):
        block = getattr(backbone, f"block{i}")
        if block.expand is not None:
            out.append((block.expand, f"{name}_expand_conv"))
        out += [(block.depthwise, f"{name}_dwconv"),
                (block.se_reduce, f"{name}_se_reduce"),
                (block.se_expand, f"{name}_se_expand"),
                (block.project, f"{name}_project_conv")]
    out.append((backbone.head, "top_conv"))
    return out


@torch.no_grad()
def load_encoder(m, weights: dict) -> None:
    """The backbone's kernels (the program's are HWIO), BatchNorm scales,
    shifts and running statistics, and the squeeze-and-excitation biases,
    layer by layer. The patch projection is one of ``LEAVES``."""
    layers = convolutions(m.encoder.backbone)
    if [name for _, name in layers] != [row[0] for row in LAYERS]:
        raise ValueError(f"the program's backbone has {len(layers)} "
                         f"convolutions, the reference {len(LAYERS)}")
    for layer, name in layers:
        conv = getattr(layer, "conv", layer)
        kernel = weights[f"{name}.w"].permute(2, 3, 1, 0)
        if kernel.shape != conv.kernel.shape:
            raise ValueError(f"{name}: reference kernel {tuple(kernel.shape)}"
                             f", program {tuple(conv.kernel.shape)}")
        conv.kernel.copy_(kernel)
        if conv is layer:
            conv.bias.copy_(weights[f"{name}.b"])
            continue
        layer.bn.scale.copy_(weights[f"{name}.gamma"])
        layer.bn.bias.copy_(weights[f"{name}.beta"])
        layer.bn.mean.copy_(weights[f"{name}.mean"])
        layer.bn.var.copy_(weights[f"{name}.var"])


def store_width(cfg: dict, m) -> int:
    """Columns of a stored row: the raw row's, H·W·3."""
    return row_width(cfg)


def to_store(m, rows: torch.Tensor) -> torch.Tensor:
    """Raw rows as stored: the pixels rescaled and normalised once
    (EfficientNet's ImageNet mean and deviation), by the same arithmetic
    as the reference's."""
    return preprocess(rows)
