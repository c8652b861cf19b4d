"""NIC — the attention caption-decoder family, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/nic.py`` for two of its reference
configurations:

- ``LcNIC`` (AttemptFour/Model/lc_NIC.py:42-263): LocallyDense brain encoder,
  LSTM(512), LeakyReLU Dense(256) + Dense(vocab) head;
- ``CnnRnnNIC`` (CNN_RNN/model.py:23-115): InceptionV3 patches through a
  shared relu ``PatchDense``, linear attention, a GRU cell whose recurrence
  restarts from zeros every step (``gru_zero_state``), and a linear
  Dense(units) + Dense(vocab) head.

Forward:

  features = encoder(x)                                  # (B, R, D)
  for t < max_len:  ctx_t  = BahdanauAttention(h_t, features)
                    h_t+1  = Cell([ctx_t ; emb(word_t)])
  logits = dense_out(act(dense_inter(h_seq)))            # -1e9 on padded vocab

Submodule and parameter names follow the flax tree (``encoder``,
``attention``, ``lstm`` or ``gru``, ``embedding``, ``dense_inter``,
``dense_out``), so ``transplant.from_flax`` loads a JAX checkpoint without a
key map.

The port covers both cells, the zero initial carry and a trainable
embedding, in eval mode and in training. The training forward has flax's
four dropout sites of the decoder, in its order: ``drop_input`` on the
inputs, ``drop_text`` on the embedded tokens, ``drop_lstm`` on each cell
output (not on the carry) and ``drop_out`` after the head's activation; the
encoder and the attention hold the other two. Masks are drawn from the
caller's ``torch.Generator``. The learned initial carry and pretrained
embeddings raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.common import (
    ACTIVATION_SLOPES,
    Dense,
    activation,
    dropout,
    embedding_init,
    glorot_normal,
    mask_padded_vocab,
    pad_zero_cols,
    pad_zero_rows,
)
from masters_thesis_tpu_torch.models.encoders import PatchDense
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.lstm import KerasGRUCell, KerasLSTMCell
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

CELL_TYPES = ("lstm", "gru")


class NIC(nn.Module):
    """``true_vocab`` > 0 and < ``vocab_size`` marks a padded vocab axis:
    padded embedding rows and head columns start at zero and padded logits
    are masked to -1e9, as in the JAX package.

    ``gru_zero_state`` is the CNN_RNN decoder's quirk: it calls its GRU
    without an initial state (CNN_RNN/model.py:103), so the recurrence
    restarts from zeros every step and the carried h feeds only the
    attention query."""

    def __init__(self, encoder: nn.Module, units: int = 512,
                 embedding_text: int = 512, attn_units: int = 32,
                 vocab_size: int = 5001, true_vocab: int = 0,
                 max_length: int = 15, cell_type: str = "lstm",
                 gru_zero_state: bool = False, head_dim: int = 256,
                 head_activation: str = "leaky_relu",
                 attn_inner_activation: str = "leaky_relu",
                 pretrained_embedding=None,
                 learned_init_state: bool = False,
                 dropout_input: float = 0.0, dropout_text: float = 0.2,
                 dropout_attn: float = 0.2, dropout_lstm: float = 0.2,
                 dropout_out: float = 0.2, generator=None):
        super().__init__()
        if cell_type not in CELL_TYPES:
            raise ValueError(f"cell_type {cell_type!r}: expected one of "
                             f"{CELL_TYPES}")
        if head_activation not in ACTIVATION_SLOPES:
            raise ValueError(f"head_activation {head_activation!r}: expected "
                             f"one of {sorted(ACTIVATION_SLOPES)}")
        if learned_init_state:
            raise NotImplementedError(
                "learned_init_state is ported with the other families "
                "(ROADMAP M11)")
        if pretrained_embedding is not None:
            raise NotImplementedError(
                "pretrained (GloVe) embeddings are ported with the other "
                "families (ROADMAP M11)")
        self.units = units
        self.vocab_size = vocab_size
        self.true_vocab = true_vocab
        self.max_length = max_length
        self.cell_type = cell_type
        self.gru_zero_state = gru_zero_state
        self.head_activation = head_activation
        self.attn_inner_activation = attn_inner_activation
        self.dropout_input = dropout_input
        self.dropout_text = dropout_text
        self.dropout_lstm = dropout_lstm
        self.dropout_out = dropout_out
        tv = true_vocab or vocab_size
        features_dim = encoder.out_dim

        self.encoder = encoder
        self.attention = BahdanauAttention(
            attn_units, features_dim, units, dropout=dropout_attn,
            inner_activation=attn_inner_activation, generator=generator)
        cell = KerasLSTMCell if cell_type == "lstm" else KerasGRUCell
        self.add_module(cell_type, cell(features_dim + embedding_text, units,
                                        generator))
        self.embedding = nn.Parameter(pad_zero_rows(embedding_init, tv)(
            (vocab_size, embedding_text), generator))
        self.dense_inter = Dense(units, head_dim, glorot_normal, generator)
        self.dense_out = Dense(head_dim, vocab_size,
                               pad_zero_cols(glorot_normal, tv), generator)

    @property
    def cell(self) -> nn.Module:
        """The recurrent cell: ``self.lstm`` or ``self.gru``."""
        return getattr(self, self.cell_type)

    # ---- pieces ----
    def encode(self, x: torch.Tensor, training: bool = False,
               generator=None) -> torch.Tensor:
        x = dropout(x, self.dropout_input, generator, training)
        return self.encoder(x, training, generator)          # (B, R, D)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)

    def head(self, h: torch.Tensor, training: bool = False,
             generator=None) -> torch.Tensor:
        x = activation(self.dense_inter(h), self.head_activation)
        x = dropout(x, self.dropout_out, generator, training)
        return mask_padded_vocab(self.dense_out(x), self.true_vocab)

    def _step(self, h, c, x):
        """The cell on input x from carry (h, c): returns (h', c', out).
        A GRU carries c through unchanged; under ``gru_zero_state`` it
        starts from zeros instead of h."""
        if self.cell_type == "lstm":
            (h, c), out = self.cell((h, c), x)
            return h, c, out
        h_in = torch.zeros_like(h) if self.gru_zero_state else h
        h, out = self.cell(h_in, x)
        return h, c, out

    # ---- teacher-forced forward (lc_NIC.call_attention) ----
    def forward(self, inputs, tokens, a0, c0, training: bool = False,
                generator=None):
        """Returns (logits (B, T, V), attn (B, T, R)). ``training`` turns on
        dropout, with masks from ``generator``, and BatchNorm's batch
        statistics, whose running averages move in place."""
        features = self.encode(inputs, training, generator)
        emb = self.embed(tokens)                              # (B, T, E)
        emb = dropout(emb, self.dropout_text, generator, training)
        h, c = a0.float(), c0.float()
        hseq, alphas = [], []
        for t in range(tokens.shape[1]):
            context, alpha = self.attention(h, features, training, generator)
            h, c, out = self._step(h, c, torch.cat([context, emb[:, t]], -1))
            hseq.append(dropout(out, self.dropout_lstm, generator, training))
            alphas.append(alpha[..., 0])
        logits = self.head(torch.stack(hseq, dim=1), training,
                           generator)                         # (B, T, V)
        return logits, torch.stack(alphas, dim=1)

    # ---- single decode step (shared by the greedy decoders) ----
    def init_carry(self, features: torch.Tensor):
        """Zeros, as the reference's a0/c0."""
        z = torch.zeros(features.shape[0], self.units, dtype=features.dtype,
                        device=features.device)
        return z, z

    def decode_step(self, h, c, features, token):
        """One inference step. token: (B,) int.

        Returns (h', c', logits (B, V), alpha (B, R)); a GRU carries ``c``
        through unchanged."""
        context, alpha = self.attention(h, features)
        x = torch.cat([context, self.embed(token)], dim=-1)
        h, c, _ = self._step(h, c, x)
        return h, c, self.head(h), alpha[..., 0]


def LcNIC(layout: GroupLayout, units: int = 512, group_size: int = 32,
          embedding_text: int = 512, attn_units: int = 32,
          vocab_size: int = 5001, max_length: int = 15,
          dropout_input: float = 0.0, dropout_features: float = 0.2,
          dropout_text: float = 0.2, dropout_attn: float = 0.2,
          dropout_lstm: float = 0.2, dropout_out: float = 0.2,
          pregathered: bool = False, generator=None, **kw) -> NIC:
    """Flagship brain decoder (lc_NIC.py configuration), initialised on the
    CPU from ``generator``; move it with ``.to(device)``. Extra kwargs pass
    through to ``NIC``.

    ``pregathered=True`` takes inputs already in the grouped padded layout
    (the training store, permuted once at upload). Same parameters either
    way."""
    return NIC(
        encoder=LocallyDense(layout, out_dim=group_size,
                             dropout=dropout_features,
                             pregathered=pregathered, generator=generator),
        units=units,
        embedding_text=embedding_text,
        attn_units=attn_units,
        vocab_size=vocab_size,
        max_length=max_length,
        dropout_input=dropout_input,
        dropout_text=dropout_text,
        dropout_attn=dropout_attn,
        dropout_lstm=dropout_lstm,
        dropout_out=dropout_out,
        generator=generator,
        **kw,
    )


def CnnRnnNIC(embed_dim: int = 256, units: int = 512, vocab_size: int = 5001,
              max_length: int = 15, n_patches: int = 64,
              in_channels: int = 2048, generator=None, **kw) -> NIC:
    """The CNN_RNN GRU captioner (CNN_RNN/model.py) on (``n_patches``,
    ``in_channels``) patch rows, by default InceptionV3's (64, 2048): relu
    patch encoder, GRU cell, plain (no-activation, no-dropout) textbook
    attention (model.py:38-61), a linear fc1 Dense(units) head
    (model.py:77-78), and the zero-initial-state GRU recurrence
    (model.py:103, ``NIC.gru_zero_state``). Initialised on the CPU from
    ``generator``; extra kwargs pass through to ``NIC``."""
    kw.setdefault("dropout_attn", 0.0)
    kw.setdefault("gru_zero_state", True)
    return NIC(
        encoder=PatchDense(n_patches, in_channels, embed_dim,
                           activation="relu", generator=generator),
        units=units,
        embedding_text=embed_dim,
        attn_units=units,
        vocab_size=vocab_size,
        max_length=max_length,
        cell_type="gru",
        head_dim=units,
        head_activation="linear",
        attn_inner_activation="linear",
        generator=generator,
        **kw,
    )
