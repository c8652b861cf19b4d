"""Serving API in PyTorch: caption brain data or image features with a port
model in one call.

Counterpart of ``masters_thesis_tpu/serve.py``:

    cap = Captioner.from_components(model, params, batch_stats, tokenizer,
                                    units, max_length)
    cap = Captioner.from_run_dir("Log/run")          # a port training run
    texts = cap.caption(rows)                        # greedy
    texts = cap.caption(rows, decoder="beam")        # or "sample"

The Captioner runs on the card (``cuda``) unless it is given
``device="cpu"``. Decoders are chosen by the model's class, never by
catching a failure: a ``NIC`` (every LSTM and GRU variant) decodes greedily
through ``make_whole_fused_greedy_decoder``, which on CUDA is the
hand-written kernel of its cell (K2 for an LSTM, K3 for a GRU) and on the
CPU its plain PyTorch version; ``use_fused=False`` selects the unfused step
loop (``decode.greedy``), which is also the greedy decoder of the ShowTell
family (``ShowTell``, ``GuseNIC``), as in the JAX package, whose kernel
takes ``NIC`` only. ``weights_bf16=True`` runs that kernel with its weights
and embedding table in bf16, as the JAX ``Captioner`` serves through its
kernel on the TPU (the bf16-weight K2 or K3; the plain version's bf16 mode on
the CPU); it applies to the greedy kernel route only, so beam and sampling
stay fp32, and it raises where greedy decoding would not take the kernel
(``use_fused=False``, a ShowTell-family model). ``decoder="beam"`` runs the
fixed-lattice beam of
``beam_width``, and ``decoder="sample"`` draws with ``temperature`` and
``sample_top_k``; each call's draw comes from a generator seeded by
(``seed``, the call's index) alone, as the JAX ``fold_in(PRNGKey(seed),
calls)``, so two Captioners built alike give the same words on their n-th
call. Requests are cut into chunks of the service batch, and the last chunk
is padded by repeating its final row (``padded_chunk_ids``, the port's copy
of the JAX package's).

A row is whatever the model reads: (n_voxels,) betas for the brain
families, (P, C) patches for the image ones, a 512-wide GUSE vector for
``guse_nic``. ``input_row_shape`` is that shape and ``input_width`` its last
dimension, as in the JAX ``Captioner`` and server.

``shard=N`` serves N replicas of the model, one a device (the JAX
``Captioner``'s data-parallel ``mesh``): each decodes an equal share of
every chunk with the single-device decoders, and a sampling replica draws
the whole chunk's uniforms and keeps its rows, so that every decoder gives
one device's words at the same service batch.

``from_run_dir`` rebuilds the model of a run directory that the port's
``experiment.run_training`` wrote (``config.yaml``, ``tokenizer.json``,
``run_meta.json``, ``layout.npz`` where the family reads a layout,
``glove_table.npy`` for a GloVe run, and the best or latest checkpoint under
``model/``), taking raw rows whether or not the run trained from a
pregathered store; an ``ms2_nic`` run serves one subject's encoder
(``subject="a"|"b"``). ``PreTransformCaptioner`` puts a preprocess run's
transform chain (``experiment.apply_preprocess_chain``) in front of a
captioner, so that it takes raw rows.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.decode.sampling import make_sampling_decoder
from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu_torch.models.multisubject import DualSubjectEncoder
from masters_thesis_tpu_torch.models.nic import NIC
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


class PreTransformCaptioner:
    """Wrap a captioner so every request replays a preprocess transform
    chain first (``caption/serve --pre``): the service then takes the RAW
    rows the offline pipeline started from, and the chain's recorded raw
    shape becomes the service's input contract. The chain runs on the host
    (``experiment.apply_preprocess_chain``), the decode on the captioner's
    device."""

    def __init__(self, captioner, pre_dir: str):
        import json
        import os

        self.inner = captioner
        self.pre_dir = pre_dir
        with open(os.path.join(pre_dir, "transform.json")) as f:
            meta = json.load(f)
        raw = meta.get("input_row_shape")
        self.input_row_shape = tuple(raw) if raw else None
        self.input_width = (self.input_row_shape[-1]
                            if self.input_row_shape else None)

    def _transform(self, inputs):
        from masters_thesis_tpu_torch.experiment import (
            apply_preprocess_chain,
        )

        return apply_preprocess_chain(self.pre_dir, inputs)

    def caption(self, inputs, decoder: str = "greedy"):
        return self.inner.caption(self._transform(inputs), decoder=decoder)

    def caption_ids(self, inputs, decoder: str = "greedy"):
        return self.inner.caption_ids(self._transform(inputs),
                                      decoder=decoder)


def _replicas(model, device: torch.device, n: int) -> tuple[list, list]:
    """(models, devices): ``model`` on the first of ``n`` devices of
    ``device``'s type and a copy on each other one."""
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"--shard {n} needs {n} CUDA devices; "
                             f"{have} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [device] * n
    models = [(model if i == 0 else copy.deepcopy(model)).to(dev).eval()
              for i, dev in enumerate(devices)]
    return models, devices


def sample_seed(seed: int, call: int) -> int:
    """The 64-bit seed of the sampler's ``call``-th draw, from (seed, call)
    alone."""
    return (seed * 0x9E3779B97F4A7C15 + call) % 2**64


class Captioner:
    def __init__(self, model, tokenizer, units: int, max_length: int,
                 batch_size: int = 64, use_fused: bool = True, device=None,
                 beam_width: int = 5, temperature: float = 1.0,
                 sample_top_k: int = 0, seed: int = 0, shard: int = 0,
                 weights_bf16: bool = False):
        """Moves ``model`` to ``device`` (by default ``cuda``; raises
        without a card unless ``device="cpu"``). A request row has the
        shape of the model's ``row_shape``. ``beam_width`` sizes the beam;
        ``temperature``, ``sample_top_k`` and ``seed`` set the sampler.
        ``weights_bf16`` decodes greedily through the decode kernel with
        bf16 weights (the module docstring); without the kernel route it
        raises.

        ``shard`` N > 0 serves N replicas of the model on the first N
        devices (``cuda:0`` .. ``cuda:N-1``, or N on the CPU): the service
        batch is rounded up to a multiple of N and each replica decodes an
        equal share of each chunk through the single-device decoders (K2 or
        K3 on the card), so greedy and beam give the words of one device;
        every replica draws the whole chunk's uniforms from the stream of
        (seed, call) and keeps its own rows, so sampling gives the words of
        one device at the same service batch. Fewer than N devices raise."""
        if weights_bf16 and not (use_fused and isinstance(model, NIC)):
            raise ValueError(
                "weights_bf16 needs the greedy decode kernel: use_fused=True "
                f"and a NIC model (got use_fused={use_fused}, "
                f"{type(model).__name__})")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.shard = int(shard)
        self.replicas, self.replica_devices = [self.model], [self.device]
        if self.shard:
            self.replicas, self.replica_devices = _replicas(
                self.model, self.device, self.shard)
            # each replica holds an equal share of every chunk
            batch_size = -(-batch_size // self.shard) * self.shard
        self.tokenizer = tokenizer
        self.units = units
        self.max_length = max_length
        self.batch_size = batch_size
        self.use_fused = use_fused
        self.weights_bf16 = weights_bf16
        self.beam_width = beam_width
        self.temperature = temperature
        self.sample_top_k = sample_top_k
        self.seed = seed
        self._sample_calls = 0
        self.input_row_shape = tuple(model.row_shape)
        self.input_width = self.input_row_shape[-1]
        self._decoders: dict = {}

    @classmethod
    def from_components(cls, model, params, batch_stats, tokenizer, units,
                        max_length, **kw) -> "Captioner":
        """``params``/``batch_stats``: the flax variable tree as numpy
        arrays (``transplant.from_flax``), loaded into ``model``."""
        model.load_state_dict(
            from_flax({"params": params, "batch_stats": batch_stats}))
        return cls(model, tokenizer, units, max_length, **kw)

    @classmethod
    def from_run_dir(cls, run_path: str, best: bool = True, device=None,
                     subject: str = "a", **kw) -> "Captioner":
        """Rebuild the model and its weights from a training run directory
        (the JAX ``Captioner.from_run_dir``): the best checkpoint by val
        loss, or the latest with ``best=False``, on ``device`` (by default
        ``cuda``). An ``ms2_nic`` run serves the encoder of ``subject``.
        Other keyword arguments go to ``Captioner``."""
        import json
        import os

        from masters_thesis_tpu_torch.config import Config
        from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
        from masters_thesis_tpu_torch.experiment import build_model
        from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
        from masters_thesis_tpu_torch.train.checkpoint import (
            CheckpointManager,
        )

        cfg = Config.load(os.path.join(run_path, "config.yaml"))
        tokenizer = Tokenizer.load(os.path.join(run_path, "tokenizer.json"))
        # the trained row shape, recorded before any permutation of the store
        with open(os.path.join(run_path, "run_meta.json")) as f:
            row_shape = tuple(json.load(f)["input_row_shape"])
        groups = []
        layout_path = os.path.join(run_path, "layout.npz")
        if os.path.exists(layout_path):
            layout = GroupLayout.load(layout_path)
            if row_shape != (layout.n_voxels,):
                raise ValueError(f"run_meta.json's input_row_shape "
                                 f"{row_shape} does not match layout.npz's "
                                 f"{layout.n_voxels} voxels")
            groups = layout.to_groups()
        # a frozen GloVe table is no checkpoint entry: the run keeps it
        glove_path = os.path.join(run_path, "glove_table.npy")
        glove_table = (np.load(glove_path) if os.path.exists(glove_path)
                       else None)
        model, _, _ = build_model(cfg, groups, row_shape[0],
                                  embedding_table=glove_table,
                                  row_shape=row_shape)
        encoder = getattr(model, "encoder", None)
        if isinstance(encoder, DualSubjectEncoder):
            # a request's rows all come from one subject
            encoder.mode = subject
        mgr = CheckpointManager(os.path.join(run_path, "model"))
        epoch = mgr.best_epoch() if best else None
        epoch = mgr.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"{run_path!r} holds no saved checkpoint")
        saved = mgr.read(epoch)
        model.load_state_dict(from_flax(
            {c: saved[c] for c in ("params", "batch_stats") if saved[c]}))
        inst = cls(model, tokenizer, cfg.units, cfg.max_length,
                   device=device, **kw)
        inst.epoch = epoch
        return inst

    def _decoder(self, kind: str):
        """decode(rows) -> (B, T) words of the ``kind`` decoder: each
        replica's share of the rows on its device under ``shard``."""
        if kind in self._decoders:
            return self._decoders[kind]
        if kind not in _DECODERS:
            raise ValueError(f"unknown decoder {kind!r}: expected one of "
                             f"{_DECODERS}")
        decoders = [self._replica_decoder(kind, model)
                    for model in self.replicas]

        def decode(rows):
            if len(decoders) == 1:
                return decoders[0](rows, None)
            words, offset = [], 0
            for dec, share, dev in zip(decoders, rows.chunk(len(decoders)),
                                       self.replica_devices):
                words.append(dec(share.to(dev), (offset, len(rows))))
                offset += len(share)
            return torch.cat([w.to(rows.device) for w in words])

        if kind == "sample":
            base = decode

            def decode(rows):
                try:
                    return base(rows)
                finally:
                    self._sample_calls += 1
        self._decoders[kind] = decode
        return decode

    def _replica_decoder(self, kind: str, model):
        """decode(rows, window) -> words: ``window`` (offset, total) places
        a replica's share in its chunk, None for a whole chunk; only the
        sampler reads it."""
        start, end = self.tokenizer.start_id, self.tokenizer.end_id
        if kind == "greedy":
            if self.use_fused and isinstance(model, NIC):
                greedy = make_whole_fused_greedy_decoder(
                    model, self.max_length, weights_bf16=self.weights_bf16)
            else:
                greedy = make_greedy_decoder(model, self.max_length)
            return lambda rows, window: greedy(rows, start)[0]
        if kind == "beam":
            beam = make_beam_decoder(model, self.max_length,
                                     beam_width=self.beam_width)
            return lambda rows, window: beam(rows, start, end)[0]
        sample = make_sampling_decoder(
            model, self.max_length, temperature=self.temperature,
            top_k=self.sample_top_k)

        def decode(rows, window):
            gen = torch.Generator(device=rows.device).manual_seed(
                sample_seed(self.seed, self._sample_calls))
            return sample(rows, start, gen, window)

        return decode

    def caption_ids(self, inputs: np.ndarray, decoder: str = "greedy"):
        """(N, *input_row_shape) inputs -> (N, T) token ids; pads to the
        service batch."""
        dec = self._decoder(decoder)

        def run_chunk(chunk):
            # torch wants writable memory; copies only a read-only view
            chunk = np.require(chunk, np.float32, ("C", "W"))
            return dec(torch.from_numpy(chunk).to(self.device)).cpu().numpy()

        return padded_chunk_ids(inputs, self.batch_size, self.max_length,
                                self.input_width, run_chunk)

    def caption(self, inputs: np.ndarray,
                decoder: str = "greedy") -> list[str]:
        ids = self.caption_ids(inputs, decoder)
        return [ids_to_caption(row, self.tokenizer) for row in ids]
