"""Serving API in PyTorch: caption brain data or image features with a port
model in one call.

Counterpart of ``masters_thesis_tpu/serve.py``:

    cap = Captioner.from_components(model, params, batch_stats, tokenizer,
                                    units, max_length)
    texts = cap.caption(rows)                        # greedy

The Captioner runs on the card (``cuda``) unless it is given
``device="cpu"``. Greedy decoding goes through
``make_whole_fused_greedy_decoder`` on every device: on CUDA that is the
hand-written kernel of the model's cell (K2 for an LSTM, K3 for a GRU), on
the CPU its plain PyTorch version; ``use_fused=False`` selects the unfused
step loop (``decode.greedy``). The JAX package instead takes its kernel on
the TPU only (``Captioner._fused_eligible``). Requests are cut into chunks
of the service batch, and the last chunk is padded by repeating its final
row (``padded_chunk_ids``, the port's copy of the JAX package's).

A row is whatever the model's encoder reads: (n_voxels,) betas for LcNIC,
(64, 2048) InceptionV3 patches for CnnRnn. ``input_row_shape`` is that shape
and ``input_width`` its last dimension, as in the JAX ``Captioner`` and
server.

Beam and sampling decoders wait for ROADMAP M9; ``from_run_dir`` waits for
M10, because the run directory's orbax checkpoint and ``config.yaml`` need
libraries that the port does not use.
"""

from __future__ import annotations

import numpy as np
import torch

from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.transplant import from_flax

_DECODERS = ("greedy", "beam", "sample")


def padded_chunk_ids(inputs, batch_size: int, max_length: int,
                     input_width: int | None, run_chunk) -> np.ndarray:
    """The static-shape serving contract, the port's copy of the JAX
    package's ``serve.padded_chunk_ids``: validate the feature width, pad
    the last chunk to ``batch_size`` by repeating its final row, run each
    chunk, slice the padding back off.

    ``run_chunk((batch_size, ...)) -> (batch_size, T) ids``. Empty input
    returns a (0, max_length) matrix (a request whose rows were all
    filtered upstream must not reach ``np.concatenate([])``).
    """
    inputs = np.asarray(inputs, np.float32)
    if input_width is not None and inputs.shape[-1] != input_width:
        raise ValueError(
            f"input width {inputs.shape[-1]} != model's expected "
            f"{input_width} voxels/features"
        )
    n = len(inputs)
    if n == 0:
        return np.zeros((0, max_length), np.int32)
    out = []
    for i in range(0, n, batch_size):
        chunk = inputs[i:i + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad, axis=0)]
            )
        words = np.asarray(run_chunk(chunk))
        out.append(words[: len(words) - pad] if pad else words)
    return np.concatenate(out)


class Captioner:
    def __init__(self, model, tokenizer, units: int, max_length: int,
                 batch_size: int = 64, use_fused: bool = True, device=None):
        """Moves ``model`` to ``device`` (by default ``cuda``; raises
        without a card unless ``device="cpu"``). A request row has the
        shape of the encoder's ``row_shape``."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.units = units
        self.max_length = max_length
        self.batch_size = batch_size
        self.use_fused = use_fused
        self.input_row_shape = tuple(model.encoder.row_shape)
        self.input_width = self.input_row_shape[-1]
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
        """decode(rows, start_id) -> a tuple that starts with the words."""
        if self._greedy is None:
            make = (make_whole_fused_greedy_decoder if self.use_fused
                    else make_greedy_decoder)
            self._greedy = make(self.model, self.max_length)
        return self._greedy

    def caption_ids(self, inputs: np.ndarray, decoder: str = "greedy"):
        """(N, *input_row_shape) inputs -> (N, T) token ids; pads to the
        service batch."""
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
            rows = torch.from_numpy(chunk).to(self.device)
            return dec(rows, self.tokenizer.start_id)[0].cpu().numpy()

        return padded_chunk_ids(inputs, self.batch_size, self.max_length,
                                self.input_width, run_chunk)

    def caption(self, inputs: np.ndarray,
                decoder: str = "greedy") -> list[str]:
        ids = self.caption_ids(inputs, decoder)
        return [ids_to_caption(row, self.tokenizer) for row in ids]
