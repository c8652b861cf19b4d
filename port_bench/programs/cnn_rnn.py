"""The program's CnnRnn, holding the benchmark's weights."""

from __future__ import annotations

import torch

from port_bench.reference.cnn_rnn import row_width

# the program's parameter names -> the benchmark's leaf names
LEAVES = {
    "attention.W1.kernel": "att.w1", "attention.W1.bias": "att.b1",
    "attention.W2.kernel": "att.w2", "attention.W2.bias": "att.b2",
    "attention.V.kernel": "att.v", "attention.V.bias": "att.bv",
    "gru.kernel": "cell.wx", "gru.recurrent_kernel": "cell.wh",
    "gru.bias": "cell.b", "embedding": "emb",
    "dense_inter.kernel": "head.wi", "dense_inter.bias": "head.bi",
    "dense_out.kernel": "head.wo", "dense_out.bias": "head.bo",
    "encoder.proj.kernel": "enc.w", "encoder.proj.bias": "enc.b",
}


def build(cfg: dict, device):
    """The model at the configuration's widths, on ``device``."""
    from masters_thesis_tpu_torch.models import nic

    return nic.CnnRnnNIC(
        embed_dim=cfg["embed_dim"], units=cfg["units"],
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        n_patches=cfg["n_patches"], in_channels=cfg["in_channels"],
        generator=torch.Generator().manual_seed(0)).to(device)


def load_encoder(m, weights: dict) -> None:
    """Nothing beyond ``LEAVES``: the patch projection is one of them."""


def store_width(cfg: dict, m) -> int:
    """Columns of a stored row: the raw row's."""
    return row_width(cfg)


def to_store(m, rows: torch.Tensor) -> torch.Tensor:
    """Raw rows as stored: the patch rows as drawn."""
    return rows
