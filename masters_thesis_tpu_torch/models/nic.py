"""NIC — the attention caption-decoder family, in PyTorch.

Counterpart of ``masters_thesis_tpu/models/nic.py`` and its reference
configurations:

- ``LcNIC`` (AttemptFour/Model/lc_NIC.py:42-263): LocallyDense brain encoder,
  LSTM(512), LeakyReLU Dense(256) + Dense(vocab) head; ``GloveNIC`` is the
  same on a pretrained (GloVe) embedding table (glove_NIC.py);
- ``ImgNIC`` (img_NIC.py): conv-feature patches through a per-patch
  LeakyReLU ``PatchDense`` with BatchNorm, the same decoder;
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
``dense_out``, and ``hidden_init``/``carry_init`` for the learned initial
carry), so ``transplant.from_flax`` loads a JAX checkpoint without a key
map. A frozen pretrained table is a non-persistent buffer: the flax tree has
no ``params/embedding`` then, and the run directory keeps the table
(``glove_table.npy``).

The training forward has flax's four dropout sites of the decoder, in its
order: ``drop_input`` on the inputs, ``drop_text`` on the embedded tokens,
``drop_lstm`` on each cell output (not on the carry) and ``drop_out`` after
the head's activation; the encoder and the attention hold the other two.
Masks are drawn from the caller's ``torch.Generator``.

The carry rides fp32 whatever the compute dtype and is re-cast after every
cell (JAX ``nic.py:183-193``; a float64 model's stays float64). ``remat`` (``tpu.remat``; the NIC, ImgNIC
and CnnRnnNIC factories take it, as the JAX ones do) runs each time step,
the attention, the cell and ``drop_lstm``, under
``torch.utils.checkpoint``: the backward recomputes the step instead of
keeping its activations. The recompute replays the forward's dropout masks
exactly: ``checkpoint`` restores only the global RNG states, never a
generator passed in, so the step keeps its generator's state from its
start, draws from it again in the recompute and puts the generator back
after; and it takes the step's weights as inputs, so that it reads the
tensors the forward read (bf16 copies, or a sharded run's gathered
leaves) after those have left the modules.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    parameters_from,
    widen_carry,
)
from masters_thesis_tpu_torch.models.encoders import PatchDense
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.lstm import KerasGRUCell, KerasLSTMCell
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.parallel.collectives import (
    vocab_parallel_dense,
    vocab_parallel_embedding,
)

CELL_TYPES = ("lstm", "gru")


class NIC(nn.Module):
    """``true_vocab`` > 0 and < ``vocab_size`` marks a padded vocab axis:
    padded embedding rows and head columns start at zero and padded logits
    are masked to -1e9, as in the JAX package.

    ``gru_zero_state`` is the CNN_RNN decoder's quirk: it calls its GRU
    without an initial state (CNN_RNN/model.py:103), so the recurrence
    restarts from zeros every step and the carried h feeds only the
    attention query.

    ``pretrained_embedding`` is a (true vocab, embedding_text) table (the
    glove_NIC variant), padded with zero rows to ``vocab_size``; it trains
    under ``embedding_trainable`` and is a fixed buffer otherwise.
    ``learned_init_state`` makes the initial carry two Dense layers on the
    mean of the features (Xu et al.; lc_NIC.learn_init_state :169-173)."""

    def __init__(self, encoder: nn.Module, units: int = 512,
                 embedding_text: int = 512, attn_units: int = 32,
                 vocab_size: int = 5001, true_vocab: int = 0,
                 max_length: int = 15, cell_type: str = "lstm",
                 gru_zero_state: bool = False, head_dim: int = 256,
                 head_activation: str = "leaky_relu",
                 attn_inner_activation: str = "leaky_relu",
                 pretrained_embedding=None,
                 embedding_trainable: bool = True,
                 learned_init_state: bool = False,
                 dropout_input: float = 0.0, dropout_text: float = 0.2,
                 dropout_attn: float = 0.2, dropout_lstm: float = 0.2,
                 dropout_out: float = 0.2, remat: bool = False,
                 generator=None):
        super().__init__()
        if cell_type not in CELL_TYPES:
            raise ValueError(f"cell_type {cell_type!r}: expected one of "
                             f"{CELL_TYPES}")
        if head_activation not in ACTIVATION_SLOPES:
            raise ValueError(f"head_activation {head_activation!r}: expected "
                             f"one of {sorted(ACTIVATION_SLOPES)}")
        self.units = units
        self.vocab_size = vocab_size
        self.true_vocab = true_vocab
        self.max_length = max_length
        self.cell_type = cell_type
        self.gru_zero_state = gru_zero_state
        self.learned_init_state = learned_init_state
        self.head_activation = head_activation
        self.attn_inner_activation = attn_inner_activation
        self.dropout_input = dropout_input
        self.dropout_text = dropout_text
        self.dropout_lstm = dropout_lstm
        self.dropout_out = dropout_out
        self.remat = remat
        tv = true_vocab or vocab_size
        features_dim = encoder.out_dim

        self.encoder = encoder
        self.attention = BahdanauAttention(
            attn_units, features_dim, units, dropout=dropout_attn,
            inner_activation=attn_inner_activation, generator=generator)
        cell = KerasLSTMCell if cell_type == "lstm" else KerasGRUCell
        self.add_module(cell_type, cell(features_dim + embedding_text, units,
                                        generator))
        if pretrained_embedding is None:
            self.embedding = nn.Parameter(pad_zero_rows(embedding_init, tv)(
                (vocab_size, embedding_text), generator))
        else:
            table = torch.as_tensor(np.asarray(pretrained_embedding,
                                               np.float32))
            if tuple(table.shape) != (tv, embedding_text):
                raise ValueError(f"pretrained embedding {tuple(table.shape)}:"
                                 f" expected {(tv, embedding_text)}")
            table = F.pad(table, (0, 0, 0, vocab_size - tv))
            if embedding_trainable:
                self.embedding = nn.Parameter(table)
            else:
                self.register_buffer("embedding", table, persistent=False)
        if learned_init_state:
            self.hidden_init = Dense(features_dim, units, generator=generator)
            self.carry_init = Dense(features_dim, units, generator=generator)
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
        x = dropout(x, self.dropout_input, generator, training, columns=True)
        return self.encoder(x, training, generator)          # (B, R, D)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.embedding.shape[0] != self.vocab_size:
            # this rank's rows of a vocab-sharded table (parallel/)
            return vocab_parallel_embedding(tokens, self.embedding)
        return F.embedding(tokens, self.embedding)

    def head(self, h: torch.Tensor, training: bool = False,
             generator=None, rounded=None) -> torch.Tensor:
        """``rounded`` (a dtype) rounds each product's input to it and sums
        in fp32 against the (bf16) kernels: the fused train route's ``_mm``
        at bf16 (``ops.fused_seq.make_train_forward_loss``)."""
        def operand(x):
            return x if rounded is None else x.to(rounded).float()

        x = activation(self.dense_inter(operand(h)), self.head_activation)
        x = operand(dropout(x, self.dropout_out, generator, training))
        out = self.dense_out
        if out.kernel.shape[1] != self.vocab_size:
            # this rank's columns of a vocab-sharded head (parallel/)
            logits = vocab_parallel_dense(x, out.kernel, out.bias)
        else:
            logits = out(x)
        return mask_padded_vocab(logits, self.true_vocab)

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
        if self.learned_init_state:
            a0, c0 = self.init_carry(features)
        h, c = a0.float(), c0.float()
        step = (self._checkpointed_step
                if self.remat and torch.is_grad_enabled() else
                self._teacher_step)
        hseq, alphas = [], []
        for t in range(tokens.shape[1]):
            h, c, out, alpha = step(h, c, features, emb[:, t], training,
                                    generator)
            hseq.append(out)
            alphas.append(alpha)
        logits = self.head(torch.stack(hseq, dim=1), training,
                           generator)                         # (B, T, V)
        return logits, torch.stack(alphas, dim=1)

    def _teacher_step(self, h, c, features, emb_t, training, generator):
        """One teacher-forced step: (h', c', the dropped cell output, alpha
        (B, R)), the carry re-cast to fp32."""
        context, alpha = self.attention(h, features, training, generator)
        h, c, out = self._step(h, c, torch.cat([context, emb_t], -1))
        out = dropout(out, self.dropout_lstm, generator, training)
        return widen_carry(h), widen_carry(c), out, alpha[..., 0]

    def _checkpointed_step(self, h, c, features, emb_t, training, generator):
        """``_teacher_step`` under ``checkpoint``, its recompute on the
        forward's weights and dropout masks (the module docstring)."""
        slots = [(m, name) for part in (self.attention, self.cell)
                 for m in part.modules() for name in m._parameters]
        weights = [m._parameters[name] for m, name in slots]
        start = generator.get_state() if generator is not None else None
        calls = []

        def run(h, c, features, emb_t, *weights):
            # a recompute may stop early (checkpoint's early stop raises out
            # of the step), so the generator is put back in a finally
            now = None
            if calls and generator is not None:
                now = generator.get_state()
                generator.set_state(start)
            calls.append(True)
            try:
                with parameters_from(slots, weights):
                    return self._teacher_step(h, c, features, emb_t,
                                              training, generator)
            finally:
                if now is not None:
                    generator.set_state(now)

        # the generator is replayed above; no global RNG is drawn from
        return checkpoint(run, h, c, features, emb_t, *weights,
                          use_reentrant=False, preserve_rng_state=False)

    # ---- single decode step (shared by the decoders) ----
    def init_carry(self, features: torch.Tensor):
        """Zeros, as the reference's a0/c0, or the two Dense layers on the
        mean of the features under ``learned_init_state``."""
        if self.learned_init_state:
            mean = features.mean(dim=1)
            return self.hidden_init(mean), self.carry_init(mean)
        z = torch.zeros(features.shape[0], self.units, dtype=features.dtype,
                        device=features.device)
        return z, z

    @property
    def row_shape(self) -> tuple[int, ...]:
        """The shape of one input row (the encoder's)."""
        return tuple(self.encoder.row_shape)

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


def GloveNIC(layout: GroupLayout, embedding_table, trainable: bool = True,
             **kw) -> NIC:
    """LcNIC on a pretrained (true vocab, E) text-embedding table built
    offline (glove_NIC.py variant); frozen unless ``trainable``."""
    return LcNIC(layout, pretrained_embedding=embedding_table,
                 embedding_trainable=trainable,
                 embedding_text=int(np.shape(embedding_table)[1]), **kw)


def ImgNIC(embed_dim: int = 32, units: int = 512, attn_units: int = 32,
           vocab_size: int = 5001, max_length: int = 15,
           embedding_text: int = 512, dropout_features: float = 0.2,
           n_patches: int = 196, in_channels: int = 512, generator=None,
           **kw) -> NIC:
    """Show-Attend-Tell on (``n_patches``, ``in_channels``) conv-feature
    patches, by default VGG16's (196, 512) (img_NIC.py): a separate Dense
    per patch to ``embed_dim`` (config group_size) with LeakyReLU and
    BatchNorm over the stack (img_localDense.py:20-38), then the LcNIC
    decoder. Initialised on the CPU from ``generator``; extra kwargs pass
    through to ``NIC``."""
    return NIC(
        encoder=PatchDense(n_patches, in_channels, embed_dim,
                           dropout=dropout_features, activation="leaky_relu",
                           per_patch=True, use_bn=True, generator=generator),
        units=units,
        embedding_text=embedding_text,
        attn_units=attn_units,
        vocab_size=vocab_size,
        max_length=max_length,
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
