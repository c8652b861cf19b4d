"""ShowTell — the Vinyals Show-and-Tell family (no attention), in PyTorch.

Counterpart of ``masters_thesis_tpu/models/showtell.py``, which covers four
reference generations with one module (SURVEY.md §2.2-2.5): ThinkAndTell
(a tanh Dense encoder over betas, the LSTM primed with the feature vector,
masked SCCE, a relu vocab head), ShowAndTell (the same on VGG16 fc
features, a relu prime and a linear fc1), the soloist Keras original, and
guse_NIC (AttemptFour/Model/guse_NIC.py:90-130), whose 512-d GUSE sentence
embedding goes straight into the priming slot (``input_dense=False``).

Forward (Vinyals): x = [encode(input) ; emb(w_0..w_{T-1})] -> LSTM -> head.
``align`` picks which T of the T+1 LSTM outputs carry the loss: "next"
(ShowAndTell/model.py:154) drops the feature slot, so logits[:, t] predicts
the shifted target w_{t+1}; "self" (ThinkAndTell/model.py:271) drops the
last slot, so logits[:, t] predicts the unshifted w_t.

The call signature is the NIC family's ((inputs, tokens, a0, c0, training,
generator) -> (logits, attn)), so the same train and eval steps run it;
``attn`` is a zero (B, max_length, 1) placeholder. ``init_carry`` primes the
LSTM with the encoded feature, and ``decode_step`` returns (B, 1) zero
alphas, so the greedy, beam and sampling decoders run it unchanged.
Parameter names follow the flax tree (``fc_embedding``, ``embedding``,
``lstm``, ``fc1``, ``fc_vocab``). The JAX package has no kernel for this
family; it decodes through the step loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from masters_thesis_tpu_torch.models.common import (
    Dense,
    dropout,
    glorot_uniform,
    mask_padded_vocab,
    pad_zero_cols,
    pad_zero_rows,
)
from masters_thesis_tpu_torch.models.lstm import KerasLSTMCell

ENCODER_ACTIVATIONS = ("tanh", "relu", "linear")
ALIGNS = ("next", "self")


def _uniform_005(shape, generator=None) -> torch.Tensor:
    """flax ``nn.initializers.uniform(scale=0.05)``: U[0, 0.05)."""
    return torch.empty(shape).uniform_(0.0, 0.05, generator=generator)


class ShowTell(nn.Module):
    def __init__(self, in_features: int, units: int = 512,
                 embed_dim: int = 512, embedding_text: int = 512,
                 vocab_size: int = 5001, true_vocab: int = 0,
                 max_length: int = 15, input_dense: bool = True,
                 encoder_activation: str = "tanh",
                 head_activation: str = "linear", head_inter: bool = False,
                 align: str = "next", dropout: float = 0.2, generator=None):
        super().__init__()
        # the feature prime and the word embeddings share the LSTM's input
        if embed_dim != embedding_text:
            raise ValueError(f"embed_dim ({embed_dim}) must equal "
                             f"embedding_text ({embedding_text}): both feed "
                             f"the same LSTM input")
        if not input_dense and in_features != embed_dim:
            raise ValueError(f"without input_dense the {in_features}-wide "
                             f"input must be embed_dim ({embed_dim}) wide")
        if encoder_activation not in ENCODER_ACTIVATIONS:
            raise ValueError(f"encoder_activation {encoder_activation!r}: "
                             f"expected one of {ENCODER_ACTIVATIONS}")
        if head_activation not in ("linear", "relu"):
            raise ValueError(f"head_activation {head_activation!r}: expected "
                             f"'linear' or 'relu'")
        if align not in ALIGNS:
            raise ValueError(f"align {align!r}: expected one of {ALIGNS}")
        self.row_shape = (in_features,)
        self.units = units
        self.vocab_size = vocab_size
        self.true_vocab = true_vocab
        self.max_length = max_length
        self.input_dense = input_dense
        self.encoder_activation = encoder_activation
        self.head_activation = head_activation
        self.head_inter = head_inter
        self.align = align
        self.dropout = dropout
        tv = true_vocab or vocab_size
        if input_dense:
            self.fc_embedding = Dense(in_features, embed_dim, glorot_uniform,
                                      generator)
        self.embedding = nn.Parameter(pad_zero_rows(_uniform_005, tv)(
            (vocab_size, embedding_text), generator))
        self.lstm = KerasLSTMCell(embed_dim, units, generator)
        if head_inter:
            # ShowAndTell's linear fc1 Dense(units) (model.py:37,60-63);
            # ThinkAndTell comments it out (model.py:77,105-109)
            self.fc1 = Dense(units, units, glorot_uniform, generator)
        self.fc_vocab = Dense(units, vocab_size,
                              pad_zero_cols(glorot_uniform, tv), generator)

    # ---- pieces ----
    def encode(self, x: torch.Tensor, training: bool = False,
               generator=None) -> torch.Tensor:
        """(B, in_features) -> (B, E)."""
        if not self.input_dense:
            return x
        y = self.fc_embedding(x)
        if self.encoder_activation == "tanh":
            y = torch.tanh(y)
        elif self.encoder_activation == "relu":
            y = torch.relu(y)
        return dropout(y, self.dropout, generator, training)

    def head(self, h: torch.Tensor, training: bool = False,
             generator=None) -> torch.Tensor:
        x = dropout(h, self.dropout, generator, training)
        if self.head_inter:
            x = self.fc1(x)
        logits = self.fc_vocab(x)
        if self.head_activation == "relu":
            logits = torch.relu(logits)
        # after the activation: relu(-1e9) would let padded slots back in
        return mask_padded_vocab(logits, self.true_vocab)

    # ---- teacher-forced forward ----
    def forward(self, inputs, tokens, a0, c0, training: bool = False,
                generator=None):
        """Returns (logits (B, T, V), attn zeros (B, max_length, 1)). The
        LSTM runs T+1 steps over [feat ; emb(tokens[0..T-1])]."""
        feat = self.encode(inputs, training, generator)          # (B, E)
        emb = F.embedding(tokens, self.embedding)                # (B, T, E)
        xs = torch.cat([feat[:, None, :], emb], dim=1)           # (B, T+1, E)
        carry = (a0.float(), c0.float())
        hseq = []
        for t in range(xs.shape[1]):
            carry, out = self.lstm(carry, xs[:, t])
            hseq.append(out)
        hseq = torch.stack(hseq, dim=1)                          # (B, T+1, U)
        kept = hseq[:, :-1] if self.align == "self" else hseq[:, 1:]
        logits = self.head(kept, training, generator)            # (B, T, V)
        attn = torch.zeros(inputs.shape[0], self.max_length, 1,
                           dtype=logits.dtype, device=logits.device)
        return logits, attn

    # ---- decode API (shared with the NIC decoders) ----
    def init_carry(self, features: torch.Tensor):
        """Prime the LSTM with the encoded feature from a zero state."""
        z = torch.zeros(features.shape[0], self.units, dtype=features.dtype,
                        device=features.device)
        (h, c), _ = self.lstm((z, z), features)
        return h, c

    def decode_step(self, h, c, features, token):
        """One inference step (``features`` is used up by the prime).
        Returns (h', c', logits (B, V), zero alphas (B, 1))."""
        (h, c), out = self.lstm((h, c), F.embedding(token, self.embedding))
        logits = self.head(out)
        return h, c, logits, torch.zeros(token.shape[0], 1,
                                         dtype=logits.dtype,
                                         device=logits.device)


def showtell_l2_rules(cfg) -> list[tuple[tuple[str, ...], float]]:
    """ThinkAndTell regularises the encoder kernel and bias and both LSTM
    kernels (model.py:18-26, 62-63)."""
    c = cfg.lstm_reg
    return [
        (("fc_embedding", "kernel"), cfg.input_reg),
        (("fc_embedding", "bias"), cfg.input_reg),
        (("lstm", "kernel"), c),
        (("lstm", "recurrent_kernel"), c),
    ]


def GuseNIC(units: int = 512, vocab_size: int = 5001, max_length: int = 15,
            **kw) -> ShowTell:
    """GUSE-conditioned caption decoder (guse_NIC.py): the 512-d sentence
    embedding is fed straight into the priming slot."""
    kw.setdefault("embedding_text", 512)
    return ShowTell(512, units=units, vocab_size=vocab_size,
                    max_length=max_length, input_dense=False, embed_dim=512,
                    **kw)
