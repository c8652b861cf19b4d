"""The program's CnnRnn on pixels (InceptionV3 inside its encoder),
holding the benchmark's weights."""

from __future__ import annotations

import torch

from port_bench.programs.cnn_rnn import LEAVES  # noqa: F401  (the decoder's)
from port_bench.reference.cnn_rnn_inception import (
    LAYERS,
    preprocess,
    row_width,
)


def build(cfg: dict, device):
    """The model at the configuration's widths, on ``device``."""
    from masters_thesis_tpu_torch.models import nic

    return nic.CnnRnnNIC(
        embed_dim=cfg["embed_dim"], units=cfg["units"],
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        image_size=tuple(cfg["image_size"]),
        generator=torch.Generator().manual_seed(0)).to(device)


@torch.no_grad()
def load_encoder(m, weights: dict) -> None:
    """The backbone's kernels (the program's are HWIO), BatchNorm shifts and
    running statistics, layer by layer: the program registers its
    convolutions in Keras' order (``LAYERS``). The patch projection is one
    of ``LEAVES``."""
    from masters_thesis_tpu_torch.models.inception import ConvBN

    convs = [mod for mod in m.encoder.backbone.modules()
             if isinstance(mod, ConvBN)]
    if len(convs) != len(LAYERS):
        raise ValueError(f"the program's backbone has {len(convs)} "
                         f"convolutions, the reference {len(LAYERS)}")
    for mod, (name, *_) in zip(convs, LAYERS):
        kernel = weights[f"{name}.w"].permute(2, 3, 1, 0)
        if kernel.shape != mod.conv.kernel.shape:
            raise ValueError(f"{name}: reference kernel {tuple(kernel.shape)}"
                             f", program {tuple(mod.conv.kernel.shape)}")
        mod.conv.kernel.copy_(kernel)
        mod.bn.bias.copy_(weights[f"{name}.beta"])
        mod.bn.mean.copy_(weights[f"{name}.mean"])
        mod.bn.var.copy_(weights[f"{name}.var"])


def store_width(cfg: dict, m) -> int:
    """Columns of a stored row: the raw row's, H·W·3."""
    return row_width(cfg)


def to_store(m, rows: torch.Tensor) -> torch.Tensor:
    """Raw rows as stored: the pixels scaled to [-1, 1] once, by the same
    arithmetic as the reference's."""
    return preprocess(rows)
