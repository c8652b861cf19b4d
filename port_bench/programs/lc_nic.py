"""The program's LcNIC on pregathered rows, holding the benchmark's
weights, and its recipe as the program's ``Config``."""

from __future__ import annotations

import torch

from port_bench.reference.atlas import group_bounds

# the program's parameter names -> the benchmark's leaf names
LEAVES = {
    "attention.W1.kernel": "att.w1", "attention.W1.bias": "att.b1",
    "attention.W2.kernel": "att.w2", "attention.W2.bias": "att.b2",
    "attention.V.kernel": "att.v", "attention.V.bias": "att.bv",
    "lstm.kernel": "cell.wx", "lstm.recurrent_kernel": "cell.wh",
    "lstm.bias": "cell.b", "embedding": "emb",
    "dense_inter.kernel": "head.wi", "dense_inter.bias": "head.bi",
    "dense_out.kernel": "head.wo", "dense_out.bias": "head.bo",
    "encoder.input_bn.scale": "bn.scale", "encoder.input_bn.bias": "bn.bias",
}


def layout(cfg: dict):
    """The program's ``GroupLayout`` of the configuration's atlas."""
    import numpy as np

    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

    b = group_bounds(cfg)
    groups = [np.arange(b[i], b[i + 1]) for i in range(len(b) - 1)]
    return GroupLayout(groups, cfg["n_voxels"])


def build(cfg: dict, device):
    """The model at the configuration's widths, on ``device``."""
    from masters_thesis_tpu_torch.models import nic

    d = cfg["dropout"]
    return nic.LcNIC(
        layout(cfg), units=cfg["units"], group_size=cfg["group_size"],
        embedding_text=cfg["embedding_text"], attn_units=cfg["attn_units"],
        vocab_size=cfg["vocab_size"], max_length=cfg["max_length"],
        dropout_input=d["input"], dropout_features=d["features"],
        dropout_text=d["text"], dropout_attn=d["attn"],
        dropout_lstm=d["lstm"], dropout_out=d["out"],
        head_dim=cfg["head_dim"], pregathered=True,
        generator=torch.Generator().manual_seed(0)).to(device)


@torch.no_grad()
def load_encoder(m, weights: dict) -> None:
    """The LocallyDense's bucket kernels take their groups' rows of
    ``enc.w`` at the bucket's padded slots (zeros in the padding), its
    biases their groups' rows of ``enc.b``; BatchNorm its statistics."""
    enc = m.encoder
    padded = torch.cat([weights["enc.w"],
                        weights["enc.w"].new_zeros(1, enc.out_dim)])
    for b, bucket in enumerate(enc.layout.buckets):
        idx = torch.as_tensor(bucket.indices, dtype=torch.long,
                              device=padded.device)
        gid = torch.as_tensor(bucket.group_ids, dtype=torch.long,
                              device=padded.device)
        getattr(enc, f"kernel_{b}").copy_(padded[idx])
        getattr(enc, f"bias_{b}").copy_(weights["enc.b"][gid])
    enc.input_bn.mean.copy_(weights["bn.mean"])
    enc.input_bn.var.copy_(weights["bn.var"])


def leaf_key(m, name: str) -> str:
    """The benchmark's key of the clipped tensor a program parameter is:
    ``enc.w@<width>`` / ``enc.b@<width>`` for a bucket's kernel or bias."""
    if name.startswith("encoder.kernel_") or name.startswith("encoder.bias_"):
        width = getattr(m.encoder, "kernel_" + name.rsplit("_", 1)[1]).shape[1]
        leaf = "enc.w" if ".kernel_" in name else "enc.b"
        return f"{leaf}@{width}"
    return LEAVES[name]


def store_width(cfg: dict, m) -> int:
    """Columns of a stored row: every group at its bucket's width."""
    return m.encoder.layout.padded_total


def to_store(m, rows: torch.Tensor) -> torch.Tensor:
    """Raw rows pregathered into the layout by the program's
    ``permute_rows``."""
    from masters_thesis_tpu_torch.data.store import permute_rows

    return permute_rows(rows, m.encoder.layout)


def train_config(cfg: dict, seed: int):
    """The program's ``Config`` for the configuration's recipe."""
    from masters_thesis_tpu_torch.config import Config

    opt, d, l2 = cfg["optimizer"], cfg["dropout"], cfg["l2"]
    return Config(
        seed=seed, max_length=cfg["max_length"],
        top_k=cfg["vocab_size"] - 1, units=cfg["units"],
        attn_units=cfg["attn_units"], group_size=cfg["group_size"],
        embedding_text=cfg["embedding_text"], alpha=opt["alpha"],
        beta_1=opt["beta_1"], beta_2=opt["beta_2"], epsilon=opt["epsilon"],
        clipnorm=opt["clipnorm"], dropout_input=d["input"],
        dropout_features=d["features"], dropout_text=d["text"],
        dropout_attn=d["attn"], dropout_lstm=d["lstm"],
        dropout_out=d["out"], input_reg=l2["input_reg"],
        attn_reg=l2["attn_reg"], lstm_reg=l2["lstm_reg"],
        output_reg=l2["output_reg"])
