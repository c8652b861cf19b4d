"""Serving API in PyTorch: caption brain data with a port model in one call.

Counterpart of ``masters_thesis_tpu/serve.py``:

    cap = Captioner.from_components(model, params, batch_stats, tokenizer,
                                    units, max_length, device="cuda")
    texts = cap.caption(betas)                       # greedy

Greedy decoding goes through ``make_whole_fused_greedy_decoder`` on every
device: on CUDA that is the hand-written kernel, on the CPU its plain
PyTorch version; ``use_fused=False`` selects the unfused step loop
(``decode.greedy``). The JAX package instead takes its kernel on the TPU only
(``Captioner._fused_eligible``). Requests are cut into chunks of the service
batch, and the last chunk is padded by repeating its final row, through the
JAX package's own ``padded_chunk_ids``.

Beam and sampling decoders wait for ROADMAP M9; ``from_run_dir`` waits for
M10, because the run directory's orbax checkpoint and ``config.yaml`` need
libraries that the port does not use.
"""

from __future__ import annotations

import numpy as np
import torch

from masters_thesis_tpu.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu.serve import padded_chunk_ids
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.transplant import from_flax

_DECODERS = ("greedy", "beam", "sample")


class Captioner:
    def __init__(self, model, tokenizer, units: int, max_length: int,
                 batch_size: int = 64, input_width: int | None = None,
                 use_fused: bool = True, device=None):
        """``device`` moves the model there; by default it stays where its
        parameters are. ``input_width`` defaults to the encoder layout's
        voxel count."""
        if device is not None:
            model = model.to(device)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.units = units
        self.max_length = max_length
        self.batch_size = batch_size
        self.use_fused = use_fused
        if input_width is None:
            input_width = model.encoder.layout.n_voxels
        self.input_width = int(input_width)
        self.input_row_shape = (self.input_width,)
        self._greedy = None

    @classmethod
    def from_components(cls, model, params, batch_stats, tokenizer, units,
                        max_length, **kw) -> "Captioner":
        """``params``/``batch_stats``: the flax variable tree as numpy
        arrays (``transplant.from_flax``), loaded into ``model``."""
        model.load_state_dict(
            from_flax({"params": params, "batch_stats": batch_stats}))
        return cls(model, tokenizer, units, max_length, **kw)

    def _decoder(self):
        """decode(betas, start_id) -> a tuple that starts with the words."""
        if self._greedy is None:
            make = (make_whole_fused_greedy_decoder if self.use_fused
                    else make_greedy_decoder)
            self._greedy = make(self.model, self.max_length)
        return self._greedy

    def caption_ids(self, inputs: np.ndarray, decoder: str = "greedy"):
        """(N, D) inputs -> (N, T) token ids; pads to the service batch."""
        if decoder not in _DECODERS:
            raise ValueError(f"unknown decoder {decoder!r}")
        if decoder != "greedy":
            raise NotImplementedError(
                f"decoder={decoder!r} is ported with beam search and "
                "sampling (ROADMAP M9)")
        dec = self._decoder()

        def run_chunk(chunk):
            # torch wants writable memory; copies only a read-only view
            chunk = np.require(chunk, np.float32, ("C", "W"))
            betas = torch.from_numpy(chunk).to(self.device)
            return dec(betas, self.tokenizer.start_id)[0].cpu().numpy()

        return padded_chunk_ids(inputs, self.batch_size, self.max_length,
                                self.input_width, run_chunk)

    def caption(self, inputs: np.ndarray,
                decoder: str = "greedy") -> list[str]:
        ids = self.caption_ids(inputs, decoder)
        return [ids_to_caption(row, self.tokenizer) for row in ids]
