"""Train state: the model (parameters and BatchNorm statistics), the
optimizer, the step and the dropout generator.

Counterpart of ``masters_thesis_tpu/train/state.py``. The JAX state is an
immutable pytree that each step replaces; here the step updates the model
and the optimizer in place and advances ``step``. The dropout masks of step
s are drawn from ``generator`` reseeded from (seed, s), as the JAX step
folds the step into its key, so they depend on the seed and s alone; the
fused sequence's attention masks are drawn from the integer key of (seed,
s) on the host (``dropout_key``). The two frameworks draw different masks
all the same.

Under a mesh (``parallel.sharding.shard_params``) the model's parameters
and the optimizer's moments hold this rank's shards: ``mesh`` is the
rank's ``parallel.mesh.Mesh`` and ``shards`` maps each sharded parameter's
name to its sharded axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.models.encoders import (
    ConcatLocallyDense,
    DeepLocallyDense,
    FullyConnectedEncoder,
)
from masters_thesis_tpu_torch.models.multisubject import Ms2NIC
from masters_thesis_tpu_torch.models.nic import NIC, CnnRnnNIC, ImgNIC, LcNIC
from masters_thesis_tpu_torch.models.showtell import GuseNIC, ShowTell
from masters_thesis_tpu_torch.train.optim import Optimizer, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    tx: Optimizer
    generator: torch.Generator
    seed: int
    step: int = 0
    mesh: object = None
    shards: dict = field(default_factory=dict)

    def dropout_key(self) -> int:
        """The current step's 64-bit dropout key, from (seed, step) alone,
        on the host. The mix reaches the low 32 bits, the only ones the CPU
        generator reads."""
        return (self.seed * 0x9E3779B97F4A7C15 + self.step) % 2**64

    def dropout_generator(self) -> torch.Generator:
        """The generator, reseeded from the current step's key."""
        return self.generator.manual_seed(self.dropout_key())


# the families whose encoder reads a GroupLayout
LAYOUT_MODELS = ("lc_nic", "ms_nic", "ms2_nic", "concat_lc_nic",
                 "deep_lc_nic")
MODELS = LAYOUT_MODELS + ("fc_nic", "img_nic", "cnn_rnn", "showtell",
                          "thinkandtell", "guse_nic")


def _nic_dropouts(cfg) -> dict:
    return {"dropout_input": cfg.dropout_input,
            "dropout_text": cfg.dropout_text,
            "dropout_attn": cfg.dropout_attn,
            "dropout_lstm": cfg.dropout_lstm,
            "dropout_out": cfg.dropout_out}


def model_for(cfg, layout=None, seed: int | None = None,
              pregathered: bool = False, row_shape=None,
              embedding_table=None) -> nn.Module:
    """The model family of ``cfg.model`` (the JAX ``experiment.build_model``)
    at ``cfg``'s widths and dropouts, initialised on the CPU from ``seed``
    (default ``cfg.seed``). ``layout`` is the GroupLayout of the families
    that read one (``LAYOUT_MODELS``); ``row_shape`` one input row's shape,
    (P, C) patches for ``img_nic`` and ``cnn_rnn``, by default
    (layout.n_voxels,). ``pregathered`` (``lc_nic``/``ms_nic``) takes the
    grouped padded input of a permuted store. ``embedding_table`` is a
    resolved (vocab, E) GloVe table (``lc_nic``/``ms_nic``)."""
    name = cfg.model.lower()
    if name not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if embedding_table is not None and name not in ("lc_nic", "ms_nic"):
        raise ValueError(
            f"glove_path is only supported for lc_nic/ms_nic (the glove_NIC "
            f"variant), not model={cfg.model!r}")
    if cfg.learned_init_state and name in ("ms2_nic", "guse_nic", "showtell",
                                           "thinkandtell"):
        # showtell primes the LSTM from the feature vector by construction
        # and ms2/guse have no single feature bank to pool
        raise ValueError(
            f"learned_init_state is not supported for model={cfg.model!r}")
    if name in LAYOUT_MODELS and layout is None:
        raise ValueError(f"model {cfg.model!r} needs a GroupLayout")
    if row_shape is None and layout is not None:
        row_shape = (layout.n_voxels,)
    if row_shape is None and name != "guse_nic":
        raise ValueError(f"model {cfg.model!r} needs the input's row_shape")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    V = cfg.padded_vocab_size
    vocab = dict(vocab_size=V,
                 true_vocab=cfg.vocab_size if V != cfg.vocab_size else 0,
                 max_length=cfg.max_length)
    if name in ("showtell", "thinkandtell"):
        return ShowTell(
            row_shape[0], units=cfg.units, embed_dim=cfg.embedding_features,
            embedding_text=cfg.embedding_features, **vocab,
            head_activation="relu" if name == "thinkandtell" else "linear",
            # ThinkAndTell supervises slots 0..T-1 against unshifted
            # targets (model.py:271), ShowAndTell skips slot 0
            align="self" if name == "thinkandtell" else "next",
            # ShowAndTell primes with relu(fc(x)) (model.py:19),
            # ThinkAndTell with tanh (model.py:21-28)
            encoder_activation="tanh" if name == "thinkandtell" else "relu",
            head_inter=name == "showtell", dropout=cfg.dropout_features,
            generator=gen)
    if name == "guse_nic":
        return GuseNIC(units=cfg.units, dropout=cfg.dropout_features,
                       generator=gen, **vocab)
    # remat reaches the NIC, ImgNIC and CnnRnnNIC factories, as in the JAX
    # build_model; Ms2NIC and the ShowTell family never see it
    nic = dict(units=cfg.units, learned_init_state=cfg.learned_init_state,
               remat=cfg.tpu.remat, generator=gen, **vocab,
               **_nic_dropouts(cfg))
    if name in ("lc_nic", "ms_nic"):
        glove = {}
        if embedding_table is not None:
            glove = dict(pretrained_embedding=embedding_table,
                         embedding_trainable=cfg.glove_trainable)
        return LcNIC(
            layout, group_size=cfg.group_size,
            embedding_text=(int(embedding_table.shape[1])
                            if embedding_table is not None
                            else cfg.embedding_text),
            attn_units=cfg.attn_units,
            dropout_features=cfg.dropout_features, pregathered=pregathered,
            **glove, **nic)
    if name == "ms2_nic":
        del nic["learned_init_state"], nic["remat"]
        return Ms2NIC(layout, layout, group_size=cfg.group_size,
                      embedding_text=cfg.embedding_text,
                      attn_units=cfg.attn_units,
                      dropout_features=cfg.dropout_features, **nic)
    if name == "img_nic":
        # patches project to group_size, not embedding_features
        # (img_NIC.py:60-62, config_img.yaml:59)
        return ImgNIC(embed_dim=cfg.group_size, attn_units=cfg.attn_units,
                      embedding_text=cfg.embedding_text,
                      dropout_features=cfg.dropout_features,
                      n_patches=row_shape[0], in_channels=row_shape[1],
                      **nic)
    if name == "cnn_rnn":
        return CnnRnnNIC(embed_dim=256, n_patches=row_shape[0],
                         in_channels=row_shape[1], **nic)
    # the alternate brain encoders the reference swaps into lc_NIC
    # (lc_NIC.py:60-91)
    if name == "concat_lc_nic":
        encoder = ConcatLocallyDense(layout, out_dim=cfg.group_size,
                                     embed_dim=cfg.embedding_features,
                                     dropout=cfg.dropout_features,
                                     generator=gen)
    elif name == "deep_lc_nic":
        encoder = DeepLocallyDense(layout, out_dim=cfg.group_size,
                                   dropout=cfg.dropout_features,
                                   generator=gen)
    else:
        encoder = FullyConnectedEncoder(row_shape[0],
                                        cfg.embedding_features,
                                        dropout=cfg.dropout_features,
                                        generator=gen)
    return NIC(encoder, embedding_text=cfg.embedding_text,
               attn_units=cfg.attn_units, **nic)


def new_state(model: nn.Module, cfg, device=None,
              seed: int | None = None) -> TrainState:
    """``model`` on ``device`` (by default ``cuda``) with a fresh optimizer
    of ``cfg`` and the dropout generator of ``seed`` (default
    ``cfg.seed``)."""
    device = resolve_device(device)
    model = model.to(device)
    return TrainState(model=model,
                      tx=make_optimizer(cfg, model.parameters()),
                      generator=torch.Generator(device=device),
                      seed=cfg.seed if seed is None else seed)


def init_model(cfg, layout=None, device=None, seed: int | None = None,
               pregathered: bool = False, row_shape=None,
               embedding_table=None) -> TrainState:
    """The model of ``cfg.model`` (``model_for``) initialised from ``seed``
    (default ``cfg.seed``), on ``device`` (by default ``cuda``; pass
    ``device="cpu"`` for the CPU), with its optimizer and dropout
    generator."""
    device = resolve_device(device)
    return new_state(model_for(cfg, layout, seed, pregathered, row_shape,
                               embedding_table), cfg, device, seed)
