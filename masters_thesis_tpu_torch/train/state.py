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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.train.optim import Optimizer, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    tx: Optimizer
    generator: torch.Generator
    seed: int
    step: int = 0

    def dropout_key(self) -> int:
        """The current step's 64-bit dropout key, from (seed, step) alone,
        on the host. The mix reaches the low 32 bits, the only ones the CPU
        generator reads."""
        return (self.seed * 0x9E3779B97F4A7C15 + self.step) % 2**64

    def dropout_generator(self) -> torch.Generator:
        """The generator, reseeded from the current step's key."""
        return self.generator.manual_seed(self.dropout_key())


def lc_nic_for(cfg, layout, seed: int | None = None,
               pregathered: bool = False):
    """A flagship LcNIC of ``cfg``'s widths and dropouts on ``layout``,
    initialised on the CPU from ``seed`` (default ``cfg.seed``).
    ``pregathered`` takes the grouped padded input of a permuted store."""
    seed = cfg.seed if seed is None else seed
    return LcNIC(
        layout, units=cfg.units, group_size=cfg.group_size,
        embedding_text=cfg.embedding_text, attn_units=cfg.attn_units,
        vocab_size=cfg.vocab_size, max_length=cfg.max_length,
        dropout_input=cfg.dropout_input,
        dropout_features=cfg.dropout_features,
        dropout_text=cfg.dropout_text, dropout_attn=cfg.dropout_attn,
        dropout_lstm=cfg.dropout_lstm, dropout_out=cfg.dropout_out,
        pregathered=pregathered,
        generator=torch.Generator().manual_seed(seed))


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


def init_model(cfg, layout, device=None, seed: int | None = None,
               pregathered: bool = False) -> TrainState:
    """A flagship LcNIC from ``cfg`` initialised from ``seed`` (default
    ``cfg.seed``), on ``device`` (by default ``cuda``; pass ``device="cpu"``
    for the CPU), with its optimizer and dropout generator. ``pregathered``
    takes the grouped padded input of a permuted store."""
    device = resolve_device(device)
    return new_state(lc_nic_for(cfg, layout, seed, pregathered), cfg,
                     device, seed)
