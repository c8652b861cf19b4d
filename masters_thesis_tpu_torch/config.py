"""The training subset of the run configuration, in plain Python.

Counterpart of ``masters_thesis_tpu/config.py::Config`` for the fields the
ported train path reads, with the same names and defaults
(reference AttemptFour/config.yaml), plus ``tpu.scan_steps`` and
``tpu.store_dtype``. Build it from keyword arguments or from a dict such as
the JAX package's ``Config.to_dict()``; unknown keys are ignored, as the
JAX package ignores unknown reference keys. YAML loading waits for the
training product (ROADMAP M10): the card's machine has no PyYAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TPUConfig:
    """The three ``tpu:`` knobs the ported train path reads."""

    scan_steps: int = 0              # > 0: K optimisation steps per call
    store_dtype: str = "float32"     # device store: float32 | bfloat16
    fused_seq: bool = False          # train the decoder through the fused
    #                                  sequence's custom backward
    #                                  (ops/fused_seq.py)


@dataclass
class Config:
    seed: int = 42

    # training (config.yaml:26-34)
    epochs: int = 100
    batch_size: int = 64
    max_length: int = 15
    top_k: int = 5_000
    optimizer: str = "Adam"
    alpha: float = 1.0e-4            # learning rate
    clipnorm: float = 0.1            # per-tensor clipnorm (Keras semantics)
    warmup_steps: int = 0            # linear LR warmup
    cosine_decay_steps: int = 0      # > 0: cosine LR decay over N steps
    beta_1: float = 0.9
    beta_2: float = 0.98
    epsilon: float = 1.0e-8

    # dropout (config.yaml:36-41)
    dropout_input: float = 0.0
    dropout_features: float = 0.2
    dropout_text: float = 0.2
    dropout_lstm: float = 0.2
    dropout_attn: float = 0.2
    dropout_out: float = 0.2

    # L2 regularisers (config.yaml:43-46)
    input_reg: float = 0.01
    attn_reg: float = 0.001
    lstm_reg: float = 3.0e-5
    output_reg: float = 1.0e-5

    # model sizes (config.yaml:55-60)
    units: int = 512
    attn_units: int = 32
    group_size: int = 32
    embedding_text: int = 512

    attn_loss: bool = False          # off in the reference (lc_NIC.py:384)
    sam_rho: float = 0.0             # > 0 enables SAM (lc_NIC.py:713-838)
    agc_clip: float = 0.0            # > 0 enables adaptive gradient clipping

    tpu: TPUConfig = field(default_factory=TPUConfig)

    @property
    def vocab_size(self) -> int:
        """top_k + 1, as the reference (main.py)."""
        return self.top_k + 1

    @classmethod
    def from_dict(cls, raw: dict[str, Any] | None) -> "Config":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known and k != "tpu"}
        tpu_fields = {f.name for f in dataclasses.fields(TPUConfig)}
        kwargs["tpu"] = TPUConfig(**{k: v for k, v in (raw.get("tpu") or {})
                                     .items() if k in tpu_fields})
        return cls(**kwargs)
