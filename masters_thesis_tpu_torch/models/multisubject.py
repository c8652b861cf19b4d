"""Multi-subject training (two subjects), in PyTorch.

Counterpart of ``masters_thesis_tpu/models/multisubject.py``. The shared-
encoder flavour of the reference (``ms_NIC``, main_ms_single_enc.py) is the
flagship LcNIC on a mixed-subject pair list. ``ms2_NIC`` (main_ms.py) has
two per-subject encoders (ms2_NIC.py:88-103) and a shared attention, LSTM
and head; each training batch is [A-half ; B-half] (:177-205). Here that is
a ``DualSubjectEncoder`` under the NIC core, so the train steps and the
decoders run it unchanged.

``mode``: "split" for the training batch layout; "a" or "b" runs every row
through one subject's encoder (per-subject eval, as eval.py does one subject
at a time). Both encoders' parameters exist in every mode
(``encoder_a``/``encoder_b``), so a split-trained checkpoint loads into a
per-subject model; the mode is an attribute a caller may set.
"""

from __future__ import annotations

import torch
from torch import nn

from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.nic import NIC
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.parallel.collectives import active, sub_rows

MODES = ("split", "a", "b")


class DualSubjectEncoder(nn.Module):
    def __init__(self, layout_a: GroupLayout, layout_b: GroupLayout,
                 out_dim: int = 32, dropout: float = 0.2,
                 mode: str = "split", generator=None):
        super().__init__()
        if layout_a.n_voxels != layout_b.n_voxels:
            raise ValueError(f"the subjects' rows must be equally wide: "
                             f"{layout_a.n_voxels} and {layout_b.n_voxels}")
        self.out_dim = out_dim
        self.row_shape = (layout_a.n_voxels,)
        self.mode = mode
        self.encoder_a = LocallyDense(layout_a, out_dim, dropout=dropout,
                                      generator=generator)
        self.encoder_b = LocallyDense(layout_b, out_dim, dropout=dropout,
                                      generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None) -> torch.Tensor:
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: expected one of {MODES}")
        if self.mode == "a":
            return self.encoder_a(x, training, generator)
        if self.mode == "b":
            return self.encoder_b(x, training, generator)
        # inside a sharded step this rank's rows are a block of the global
        # batch, whose first half is subject A's (parallel.sharding)
        p = active()
        n = p.n_rows if p is not None else x.shape[0]
        if n % 2:
            raise ValueError(f"split mode needs an even batch (A-half ; "
                             f"B-half), got {n} rows")
        a = (int((p.rows < n // 2).sum()) if p is not None
             else x.shape[0] // 2)
        with sub_rows(0, a, n // 2):
            out_a = self.encoder_a(x[:a], training, generator)
        with sub_rows(a, x.shape[0] - a, n // 2):
            out_b = self.encoder_b(x[a:], training, generator)
        return torch.cat([out_a, out_b])


def Ms2NIC(layout_a: GroupLayout, layout_b: GroupLayout, units: int = 512,
           group_size: int = 32, embedding_text: int = 512,
           attn_units: int = 32, vocab_size: int = 5001,
           max_length: int = 15, dropout_features: float = 0.2,
           mode: str = "split", generator=None, **kw) -> NIC:
    """Two-encoder multi-subject NIC (ms2_NIC configuration), initialised on
    the CPU from ``generator``; extra kwargs pass through to ``NIC``."""
    return NIC(
        encoder=DualSubjectEncoder(layout_a, layout_b, out_dim=group_size,
                                   dropout=dropout_features, mode=mode,
                                   generator=generator),
        units=units,
        embedding_text=embedding_text,
        attn_units=attn_units,
        vocab_size=vocab_size,
        max_length=max_length,
        generator=generator,
        **kw,
    )
