"""Serialized inference artifacts: freeze a trained run's decode program and
its weights into one file (``torch.export``).

Counterpart of ``masters_thesis_tpu/export.py``, which freezes the decode
into StableHLO with ``jax.export``. ``export`` (the CLI command) bakes the
decode program and the trained weights into a single artifact that serves
without the model's code: loading needs only torch and the bundled
tokenizer, so a captioning endpoint can run from a checkout that holds
neither the model classes' checkpoints nor a run directory.

Artifact layout (one zip, written atomically):
    meta.json           version, decoder, shapes, platforms, provenance
                        (the JAX artifact's keys and meanings)
    tokenizer.json      the run's tokenizer (Keras-compatible format)
    decode.<p>.pt2      ``torch.export.save`` of decode(rows) -> words, one
                        program for each platform ``p`` (``cpu``, ``cuda``)

The program has a static batch: inputs are padded to the exported
``batch_size`` exactly as ``serve.Captioner`` pads its service batch
(``padded_chunk_ids``). As in the JAX package, export freezes the unfused
decoders (``Captioner(use_fused=False)``): the whole-decode kernel (K2, K3)
is a runtime specialisation of the card, not a portable program. A
platform's program is traced with the model on that platform's device,
since tensors that the decode makes (``torch.full``, ``torch.tensor``) are
baked in on the device they were made on.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from masters_thesis_tpu_torch.device import resolve_device

ARTIFACT_VERSION = 1
_META = "meta.json"
_TOKENIZER = "tokenizer.json"
_PLATFORMS = ("cpu", "cuda")


def _program(platform: str) -> str:
    return f"decode.{platform}.pt2"


def _chain_as_torch(pre_dir: str, device):
    """The preprocess transform chain (vc mask -> normalize -> pca) as a
    torch function over raw rows on ``device``, the raw row shape it
    expects, and its stage names. Every stage is a gather, an affine map or
    a product with constants, so ``export --pre`` bakes the chain into the
    program: the artifact takes the raw betas the offline pipeline started
    from."""
    from masters_thesis_tpu_torch.data.preprocess.pca import PCAModel

    with open(os.path.join(pre_dir, "transform.json")) as f:
        meta = json.load(f)

    def const(a):
        return torch.as_tensor(np.asarray(a), device=device)

    stages = []
    for st in meta["stages"]:
        path = os.path.join(pre_dir, st["file"])
        if st["stage"] == "vc_mask":
            mask = const(np.load(path)).long()
            stages.append(lambda x, m=mask: x.index_select(1, m))
        elif st["stage"] == "normalize":
            d = np.load(path)
            mean, std = const(d["mean"]), const(d["std"])
            stages.append(lambda x, m=mean, s=std: (x - m) / s)
        elif st["stage"] == "pca":
            p = PCAModel.load(path)
            mean, comps = const(p.mean), const(p.components)
            stages.append(lambda x, m=mean, c=comps: (x - m) @ c.T)
        else:
            raise ValueError(f"unknown transform stage {st['stage']!r}")

    def chain(x):
        for fn in stages:
            x = fn(x)
        return x

    raw_shape = meta.get("input_row_shape")
    if not raw_shape:
        raise ValueError(
            f"{pre_dir!r}/transform.json records no input_row_shape — "
            "re-run preprocess to refresh it")
    return (chain, tuple(int(d) for d in raw_shape),
            [s["stage"] for s in meta["stages"]])


class _Decode(torch.nn.Module):
    """decode(rows) -> words, the module ``torch.export`` traces: the
    optional transform chain, then the plain greedy or beam decode under
    ``no_grad`` (the decoders' own ``inference_mode`` wrappers are left
    out: export traces the functions they wrap)."""

    def __init__(self, model, decode, chain):
        super().__init__()
        self.model = model
        self._decode = decode
        self._chain = chain

    def forward(self, rows: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._decode(self._chain(rows))


def _decode_fn(cap, decoder: str, beam_width: int):
    """rows -> (B, T) words of the Captioner's unfused ``decoder``."""
    from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
    from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder

    start, end = cap.tokenizer.start_id, cap.tokenizer.end_id
    if decoder == "greedy":
        greedy = make_greedy_decoder(cap.model, cap.max_length).__wrapped__
        return lambda rows: greedy(rows, start)[0]
    beam = make_beam_decoder(cap.model, cap.max_length,
                             beam_width=beam_width).__wrapped__
    return lambda rows: beam(rows, start, end)[0]


def export_run(run_path: str, out_path: str, decoder: str = "greedy",
               batch_size: int = 64, beam_width: int = 5,
               platforms=None, best: bool = True,
               subject: str = "a", pre: str | None = None) -> dict:
    """Export a trained run's decode path to ``out_path``; returns meta.

    ``platforms``: a sequence of ``"cpu"`` and ``"cuda"``; None exports for
    the card (``cuda``), like every entry point of the port. Each
    platform's program is traced with the model on that device, and the
    weights ride inside it: the artifact is self-contained.
    ``subject``: which per-subject encoder an ms2_nic artifact freezes (one
    artifact per subject, as eval and serving). ``pre``: a preprocess output
    dir whose transform chain is baked into the program; the artifact then
    takes the raw rows the offline pipeline started from.
    """
    from masters_thesis_tpu_torch.models.multisubject import (
        DualSubjectEncoder,
    )
    from masters_thesis_tpu_torch.serve import Captioner

    if decoder not in ("greedy", "beam"):
        raise ValueError(
            f"unknown decoder {decoder!r} (greedy|beam; sampling draws fresh "
            "random numbers each call and is not a fixed program)")
    platforms = ["cuda"] if platforms is None else list(platforms)
    unknown = sorted(set(platforms) - set(_PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms!r}: each must be one of "
                         f"{_PLATFORMS}")

    programs, meta = {}, None
    for platform in platforms:
        # the fused kernels are a runtime specialisation of the card:
        # export always freezes the unfused decoders
        cap = Captioner.from_run_dir(run_path, best=best, device=platform,
                                     batch_size=batch_size,
                                     beam_width=beam_width, use_fused=False,
                                     subject=subject)
        model = cap.model
        is_ms2 = isinstance(getattr(model, "encoder", None),
                            DualSubjectEncoder)
        if not is_ms2 and subject != "a":
            # from_run_dir ignores the subject of a single-encoder model;
            # an artifact whose meta claimed subject=b would be a lie
            raise ValueError(
                f"run {run_path!r} is not an ms2_nic run; --subject does "
                "not apply")
        chain, chain_stages = (lambda x: x), []
        row_shape = cap.input_row_shape
        if pre:
            chain, row_shape, chain_stages = _chain_as_torch(pre, cap.device)
        module = _Decode(model, _decode_fn(cap, decoder, beam_width), chain)
        module.eval()
        example = torch.zeros((cap.batch_size, *row_shape),
                              dtype=torch.float32, device=cap.device)
        program = torch.export.export(module, (example,))
        # the example batch would ride along in the archive: at full width
        # it is as large as the weights
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[platform] = buf.getvalue()
        meta = {
            "version": ARTIFACT_VERSION,
            "decoder": decoder,
            "batch_size": int(cap.batch_size),
            "input_width": int(row_shape[-1]),
            "input_row_shape": [int(d) for d in row_shape],
            "max_length": int(cap.max_length),
            "vocab_size": int(model.vocab_size),
            "beam_width": int(beam_width) if decoder == "beam" else None,
            "platforms": platforms,
            "run_path": os.path.abspath(run_path),
            "subject": subject if is_ms2 else None,
            "pre_stages": chain_stages,  # the chain baked into the program
        }
        del cap, model, module, program

    with open(os.path.join(run_path, "tokenizer.json")) as f:
        tok_json = f.read()
    tmp = f"{out_path}.tmp-{os.getpid()}"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr(_META, json.dumps(meta, indent=1))
            z.writestr(_TOKENIZER, tok_json)
            for platform, blob in programs.items():
                # a .pt2 is itself a zip of raw weights: stored, not
                # deflated again
                z.writestr(_program(platform), blob,
                           compress_type=zipfile.ZIP_STORED)
        os.replace(tmp, out_path)  # atomic: no truncated artifacts
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return meta


class ExportedCaptioner:
    """Serve captions from an exported artifact — no model code needed.

    ``program(rows) -> words`` runs one padded batch on ``device`` (by
    default ``cuda``; raises without a card unless ``device="cpu"``, as
    ``load_exported``). Same padding contract as ``serve.Captioner``: any
    request size runs through the one exported batch shape.
    """

    def __init__(self, program, tokenizer, meta: dict, device=None):
        self._program = program
        self.tokenizer = tokenizer
        self.meta = meta
        self.device = resolve_device(device)
        self.batch_size = meta["batch_size"]
        self.input_width = meta["input_width"]
        self.input_row_shape = tuple(
            meta.get("input_row_shape") or (meta["input_width"],))

    def _check_decoder(self, decoder):
        if decoder is not None and decoder != self.meta["decoder"]:
            raise ValueError(
                f"this artifact freezes the {self.meta['decoder']!r} "
                f"decoder; cannot serve decoder={decoder!r}"
            )

    def caption_ids(self, inputs: np.ndarray,
                    decoder: str | None = None) -> np.ndarray:
        from masters_thesis_tpu_torch.serve import padded_chunk_ids

        self._check_decoder(decoder)

        def run_chunk(chunk):
            rows = torch.from_numpy(np.require(chunk, np.float32, ("C", "W")))
            with torch.inference_mode():
                words = self._program(rows.to(self.device))
            return np.asarray(torch.as_tensor(words).cpu())

        return padded_chunk_ids(inputs, self.batch_size,
                                self.meta["max_length"], self.input_width,
                                run_chunk)

    def caption(self, inputs: np.ndarray,
                decoder: str | None = None) -> list[str]:
        from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption

        return [ids_to_caption(row, self.tokenizer)
                for row in self.caption_ids(inputs, decoder)]


def load_exported(path: str, device=None) -> ExportedCaptioner:
    """The artifact at ``path`` on ``device`` (by default ``cuda``; raises
    without a card unless ``device="cpu"``). Refuses an artifact of another
    version, one with no program for ``device``'s platform, and one the
    JAX package exported (StableHLO, not a torch program)."""
    from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        meta = json.loads(z.read(_META))
        if meta.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact {path!r} has version {meta.get('version')}; "
                f"this build reads version {ARTIFACT_VERSION}"
            )
        if "decode.stablehlo" in names and not any(
                n.endswith(".pt2") for n in names):
            raise ValueError(
                f"artifact {path!r} holds a StableHLO program, which the JAX "
                "package exported; export the run with this package")
        name = _program(device.type)
        if name not in names:
            raise ValueError(
                f"artifact {path!r} has no program for platform "
                f"{device.type!r} (it was exported for "
                f"{meta.get('platforms')}); export it with --platforms "
                f"{device.type}")
        tok = Tokenizer.from_json(z.read(_TOKENIZER).decode())
        program = torch.export.load(io.BytesIO(z.read(name)))
    # .module() once, here: it builds the callable graph
    return ExportedCaptioner(program.module(), tok, meta, device)
