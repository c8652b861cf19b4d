#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``masters_thesis_tpu_torch/csrc`` (one
``nvcc`` a source, in parallel), then drives eight paths, each at the full
width of its model or at its probe's own sizes:

- LcNIC serving: holds the LSTM whole-decode kernel (K2) against its plain
  PyTorch version, serves three HTTP caption requests through the port's
  ``Captioner`` and caption server, and times the kernel, the plain
  version, the unfused greedy decoder and captions per second;
- CnnRnn serving (GRU, on (64, 2048) InceptionV3 patch rows): holds the GRU
  whole-decode kernel (K3) against its plain version for both values of
  ``gru_zero_state``, serves 256 host rows through ``Captioner`` and one
  ``.npy`` request through the server, and times K3, its plain version and
  captions per second;
- LcNIC training: puts the flagship store (2,571 keys, pregathered, 4.86 GB fp32)
  on the card, holds the store row gather (K1) against its plain version and
  a 3-step dropout-off trajectory through K1 against the same steps through
  the plain gather, trains one epoch of 140 scanned steps with the scanned
  validation pass through ``Trainer.fit``, and times K1 and ``index_select``
  (each's device time by ``torch.profiler``, host time a call, and CUDA
  events in 7 alternate turns), the plain gather and the train step;
- the fused teacher-forced sequence, on the flagship model and the same
  store: holds the whole-sequence forward kernel (K4) against its plain
  version (and both against float64) residual by residual, the loss and
  every gradient through ``make_fused_forward_loss(backend="kernel")``
  against autograd, times K4, its plain version and a decoder fwd+bwd three
  ways (autograd, the custom backward with the scan forward, with K4) at
  the flagship and at the wide shape of ``scripts/fused_seq_probe.py``
  (with a K4 check there too), holds three ``tpu.fused_seq`` train steps
  against the autograd steps, and trains one epoch with ``tpu.fused_seq``;
- the gather probe (``masters_thesis_tpu_torch.scripts.gather_probe``, the
  port of ``scripts/gather_probe.py``) on its 1,024 x 327,684 fp32 store
  (1.34 GB): holds P1 (``gather_rows_chunked``) at its four chunks and P2
  (``gather_rows_bulk``) at its four stage counts against their plain
  version bit for bit, checks P3 (the bulk gather at 4 stages) exactly,
  times each beside the plain version and ``index_select``, runs the probe
  through its entry point, and times P1 and P2 at their best settings
  beside K1 on the training store;
- the training product: ``experiment.run_training`` of
  ``configs/flagship_synth.yaml`` (2 of its 10 epochs at its 2,571 keys,
  caption metrics every epoch) writes a run directory, training from the
  pregathered store through K1 and decoding the val captions through K2;
  ``run_eval`` decodes the test split through K2 and ``run_metrics`` scores
  it; a fresh ``CheckpointManager`` restores the trained state on the card
  bit for bit, and ``Captioner.from_run_dir`` gives ``run_eval``'s words on
  raw test rows (near-ties excepted). It prints each epoch's loss and
  steps/s, the checkpoint saves' blocking and commit times and bytes,
  captions/s through ``run_eval``, BLEU-4, CIDEr and METEOR_lite, and the
  run directory's files, and fails unless K1 and K2 ran on every batch of
  the path and the loss fell;
- the other model families: K2 on the flagship LcNIC with a learned initial
  carry, a frozen seeded (5001, 512) GloVe table, and that table over a
  padded vocab of 5,120, and K3 on a learned-init CnnRnn (both zero-state
  values), each against its plain version and float64; beam-1 and the
  top-1 sampler against K2's greedy words, beam-5 in fp32 against beam-5
  in float64, near-ties excepted and counted, and beam-5's and sampling's
  captions/s through ``Captioner``; then, with the launch counts set to 0,
  ``run_training`` of every family's config (``cnn_rnn``, ``showtell``,
  ``thinkandtell``, ``guse_nic``, ``ms2_nic``, and on
  ``flagship_synth.yaml`` the learned-init and frozen-GloVe ``lc_nic``,
  ``deep_lc_nic``, ``concat_lc_nic``, ``fc_nic`` and ``img_nic``) for 2
  epochs at 256 keys, each at its config's widths, then ``run_eval``
  greedy and beam-3; it fails unless each val loss fell, K1 ran on every
  train and val batch, K2 or K3 on every greedy test batch of a NIC, and
  the step loop for the ShowTell family, and prints each run's wall time;
- the input side (the ``ingest`` phase): writes a subject's NSD session
  files at full width (2 of its 40 sessions of 750 trials, one ``.npy`` and
  one ``.mgh``, 163,842 vertices a hemisphere; 1,200 of its 10,000 keys,
  300 of them shown twice), a behavior CSV, captions, the split CSVs and a
  2 x 180-label atlas whose visual parcels cover 62,756 vertices; runs
  ``preprocess`` through the CLI (sessions, pack, statistics, vc mask,
  normalize, a 512-component PCA fitted and applied on the card), printing
  each stage's seconds; uploads the pack in blocks against a whole copy,
  bit for bit; trains LcNIC (``configs/attempt_four.yaml``) and ThinkAndTell
  (``configs/think_and_tell_pca.yaml``) one epoch each on the packs, each
  failing unless its val loss fell from before training, K1 ran on every
  train and val batch of the epoch and K2 on every greedy test batch of the
  LcNIC; holds K1 against its plain version on each run's uploaded store
  (and times it beside ``index_select`` there, as in training) and
  each NIC's K2 or K3 against its plain version on 64 of the run's rows,
  on a copy of the trained model spread by ``spread_for_check`` (launches
  of these checks are not counted); holds ``PreTransformCaptioner`` on raw
  rows to the run's captioner on the PCA pack's rows, by the greedy
  decode's logits (and shows that other keys' rows fail that check); fits the PCA at ThinkAndTell's reference shape (27,000 x
  62,756 -> 5,000, components orthonormal within 1e-4, timed) and at a
  reduced shape on the card against the CPU (1e-4, up to sign); runs
  ``features`` on 256 images per backbone at its published resolution
  (each file against the CPU forward within 1e-4 of its largest value,
  images/s), and trains ``cnn_rnn`` on the InceptionV3 pack and
  ``img_nic`` on the VGG16 conv5 pack, K1, K2 and K3 counted as above.

Every number is printed beside the card's name and power limit.
The device time of a train step, the sum of its kernels' times by
``torch.profiler``, is printed in every run, for the autograd and the
``tpu.fused_seq`` step; ``--profile`` adds tables of device time by kernel
for one served batch and for the scanned train steps, and the time a step
of K2, K3 and K4 (at both shapes) by part, each launch of a step in turn:
K2's h W2, attention, cell, Wi, Wo and argmax; K3's h W2, attention, cell
and head; K4's h W2, attention and cell. K2's words and alphas on the
seeded LcNIC inputs are printed as a SHA-256 digest, so that two builds can
be told apart or shown bit-identical.

The weights are random, made from a seed, and spread by
``ops.fused_decode.spread_for_check`` so that every bias and BatchNorm
statistic is live and the greedy words vary; the run fails if they do not.
The flagship layout is the synthetic 360-group one of ``bench.py``. The last
line is the JSON object ``{"ok": true, "device": {...}}``; the line before
it lists each kernel with its launches on its path (K2 while serving LcNIC,
K3 while serving CnnRnn, K1 while training, K4 through the eval-mode fused
loss with ``backend="kernel"``, P1, P2 and P3 through the probe's run; K1
and K2 also under ``launches_experiment``, their launches in the training
product's phase, K1, K2 and K3 under ``launches_families``, theirs in
the families' runs, and under ``launches_ingest``, theirs in the ingest
phase's runs), its
error against the plain
version, both times, the least time the card could take for the same work
(``bound_ms``, from the bytes and operations of this run's inputs) and,
where one PyTorch call computes the same function, that call's time; K4's
entry holds its check, times and bound at the wide shape under ``wide``,
K2's, K3's and K4's name the tile kernel's plans they ran under ``tiles``,
and P3's holds its and ``index_select``'s times in turns under ``turns``;
K1's holds, for the training store and each ingest run's store, its and
``index_select``'s device, host and event times under ``stores``. Any
failed phase raises, and the script then exits non-zero without those
lines. It needs CUDA and the rest of the repository beside it; it imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# flagship LcNIC (lc_NIC.py widths) at the service batch, fp32, eval mode
N_VOXELS, N_GROUPS = 327_684, 360
WIDTHS = dict(units=512, group_size=32, embedding_text=512, attn_units=32,
              vocab_size=5001, max_length=15)
BATCH = 64
SEED = 0
ALPHA_ATOL = 1e-6   # fp32, summation order only (measured ~3e-7)
TIE_MARGIN = 1e-3   # a top-2 logit margin below this is a near-tie
MIN_DISTINCT_WORDS = 16     # over the B x T greedy words of the check
MIN_NONEMPTY_SHARE = 0.9    # of the served captions
REQUEST_ROWS = (1, 5, 64)   # .npy, JSON, .npy
THROUGHPUT_ROWS = 4 * BATCH
WINDOWS, WINDOW_S = 5, 2.0  # captions/s: repeated timing windows
# CnnRnn (configs/cnn_rnn.yaml, experiment.py:408-413): InceptionV3 patches
CNN_RNN_WIDTHS = dict(embed_dim=256, units=512, vocab_size=5001,
                      max_length=15, n_patches=64, in_channels=2048)
CNN_RNN_REQUEST_ROWS = 5    # one .npy request through the server
# the card's peaks (H100 SXM datasheet: dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
# training: configs/flagship_synth.yaml's 2,571 keys give 8,995 train pairs,
# 140 steps of 64, and 1,925 val pairs, 30 batches
TRAIN_KEYS = 2571
SCAN_STEPS = 140
GATHER_TURNS = 7            # K1 and index_select timed in turns, as P3
EDGE_STEPS = 20             # the loss must fall from the first to the last
TRAJ_STEPS, TRAJ_RTOL = 3, 1e-6
STEP_WINDOW, STEP_REPS = 10, 5  # ms a step: calls of scanned steps, timed
# the fused sequence: K4 against its plain version (fp32 and float64), the
# custom backward against autograd (the JAX package's criteria,
# tests/test_fused_seq.py), and the decoder-only shapes of
# scripts/fused_seq_probe.py
SEQ_ATOL = 1e-5     # h, c, z and hw_pre; alpha is held to ALPHA_ATOL
GRAD_RTOL = 2e-5    # of max(1, the leaf's largest entry)
FUSED_LOSS_ATOL, FUSED_PARAM_ATOL = 2e-5, 5e-5
FLAGSHIP_DECODER = dict(units=512, group_size=32, embedding_text=512,
                        attn_units=32, vocab_size=5001, max_length=15,
                        head_dim=256)
PROBE_WIDE = dict(units=2048, group_size=128, embedding_text=1024,
                  attn_units=256, vocab_size=8192, max_length=15,
                  head_dim=2048)
PROBE_WIDE_BATCH = 256
DEC_REPS = 5
P3_TURNS = 7        # P3 and index_select timed in turns
# the training product: configs/flagship_synth.yaml through
# experiment.run_training (2 of its 10 epochs, caption metrics every epoch),
# run_eval, run_metrics, a restore on the card and from_run_dir
EXPERIMENT_CONFIG = Path(__file__).resolve().parent / "configs" / (
    "flagship_synth.yaml")
EXPERIMENT_EPOCHS = 2
EXPERIMENT_KEYS = TRAIN_KEYS
SERVED_ROWS = 64            # test rows through Captioner.from_run_dir
# the other model families: the NIC variants at flagship width through K2
# and K3, the beam and the sampler on the flagship LcNIC, and 2 epochs of
# run_training at 256 keys for each family of experiment.build_model (each
# at its config's widths), then run_eval greedy and beam
FAMILY_KEYS, FAMILY_EPOCHS, FAMILY_BEAM = 256, 2, 3
SERVE_BEAM = 5              # the beam's captions/s through Captioner
PADDED_VOCAB = 5120         # a padded vocab axis over the true 5,001
CONFIG_DIR = Path(__file__).resolve().parent / "configs"
# (label, config, overrides); "glove" is a seeded (5001, 512) .npy table
FAMILY_RUNS = (
    ("cnn_rnn", "cnn_rnn.yaml", {}),
    ("showtell", "show_and_tell.yaml", {}),
    ("thinkandtell", "think_and_tell_pca.yaml", {}),
    ("guse_nic", "guse_nic.yaml", {}),
    ("ms2_nic", "multi_subject.yaml", {}),
    ("lc_nic learned init", "flagship_synth.yaml",
     {"learned_init_state": True}),
    ("lc_nic frozen GloVe", "flagship_synth.yaml", {"glove": True}),
    ("deep_lc_nic", "flagship_synth.yaml", {"model": "deep_lc_nic"}),
    ("concat_lc_nic", "flagship_synth.yaml", {"model": "concat_lc_nic"}),
    ("fc_nic", "flagship_synth.yaml", {"model": "fc_nic"}),
    ("img_nic", "flagship_synth.yaml", {"model": "img_nic"}),
)
STEP_LOOP_FAMILIES = ("showtell", "thinkandtell", "guse_nic")
# the keys of the JAX package's run_metrics without a USE bundle or a
# METEOR synonym table (masters_thesis_tpu/evalsuite/metric_suite.py)
JAX_METRIC_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR_lite",
                   "ROUGE_L", "CIDEr", "SPICE_lite", "GUSE_hash_pearson_r",
                   "GUSE_hash_mean_corr")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def release() -> None:
    """Free what the last phase left on the card: first the reference
    cycles it left, which Python's cyclic collector would otherwise free at
    a moment set by how many objects the program has made, then the
    allocator's cache. Where the next phase's tensors land then does not
    depend on that moment: K3, bound by L2 latency, read 3.10-3.17 ms a
    decode on an H100 when the LcNIC phase's memory was still held as the
    CnnRnn weights were placed, and 2.80-2.81 ms when it was not."""
    gc.collect()
    torch.cuda.empty_cache()


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` fp32 operations: the larger of the two
    times at the card's peaks, and which of them it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def decode_bound(cell: str, inputs, opts: dict, T: int, vocab: int) -> dict:
    """``bound`` of one whole greedy decode on ``inputs`` (the kernel's
    arguments): each input read once (the head's and the embedding's true
    vocab only; no Wh under zero state, whose cell never reads it), words
    and alphas written once, and per row and step the fp32 multiply-adds of
    the attention (h W2, the scores, the context), the cell and the head."""
    from masters_thesis_tpu_torch.ops.fused_decode import DECODE_ARGS

    a = dict(zip(DECODE_ARGS[cell], inputs))
    B, R, A = a["pre"].shape
    D, (U, H) = a["features"].shape[2], a["wi"].shape
    skip = {"wo", "bo"} | ({"wh"} if opts.get("zero_state") else set())
    read = sum(t.numel() for n, t in a.items() if n not in skip)
    read += H * vocab + vocab
    written = B * T * (1 + R)
    cell_fma = a["wx"].numel() + (0 if "wh" in skip else a["wh"].numel())
    fma = B * T * (U * A + R * A + R * D + cell_fma + U * H + H * vocab)
    return bound(4 * (read + written), 2 * fma)


def build_kernels() -> None:
    from masters_thesis_tpu_torch.ops import _build

    out = _build.library_path()
    seconds = _build.build(out) if not out.exists() else 0.0
    _build.load_library()
    print(f"build: {out.name} in {seconds:.1f} s (nvcc, sm_90a)")
    for line in out.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def flagship_model(device, **variant):
    """The flagship LcNIC, seeded and spread, on ``device``; ``variant``
    overrides its keyword arguments (a learned carry, a GloVe table, a
    padded vocab)."""
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.models.nic import LcNIC
    from masters_thesis_tpu_torch.ops.fused_decode import spread_for_check
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=SEED),
                         N_VOXELS)
    gen = torch.Generator().manual_seed(SEED)
    model = LcNIC(layout, generator=gen, **{**WIDTHS, **variant})
    spread_for_check(model, gen)
    return model.to(device).eval()


@torch.inference_mode()
def check_kernel(model, rows, card: str, label: str, timed: bool = True,
                 profile: bool = False) -> dict:
    """The model's decode kernel (K2 or K3) against its plain version on the
    same inputs, on the card, and both against the plain version in
    float64; with ``timed``, then both timed, and the
    fused decoder with the encoder against the unfused one; with
    ``profile``, the kernel's per-step split. Returns the kernel's entry of
    the kernels line, less its launches."""
    from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    T, V = model.max_length, model.vocab_size
    kernel, reference = fd.decode_kernel(model)
    opts = fd.decode_options(model)
    inputs = fd.decode_inputs(model, rows, 1)
    words, alphas = kernel(*inputs, max_length=T, **opts)
    torch.cuda.synchronize()
    ref_words, ref_alphas, margins = reference(
        *inputs, max_length=T, return_margins=True, **opts)
    B, R = len(rows), inputs[0].shape[1]
    if words.shape != (B, T) or alphas.shape != (B, T, R):
        raise RuntimeError(f"kernel output shapes {tuple(words.shape)}, "
                           f"{tuple(alphas.shape)}; expected {(B, T)}, "
                           f"{(B, T, R)}")
    if not (0 <= int(words.min()) and int(words.max()) < V):
        raise RuntimeError("kernel produced an id outside the vocabulary")
    sums = alphas.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise RuntimeError("kernel alphas do not sum to 1 over regions")
    report = fd.compare_with_reference(
        words, alphas, ref_words, ref_alphas, margins,
        alpha_atol=ALPHA_ATOL, tie_margin=TIE_MARGIN)
    distinct = len(torch.unique(ref_words))
    print(f"{label} vs plain at B={B} R={R} T={T} V={V}: "
          f"max |alpha err| {report['max_abs_err']:.3e} (limit {ALPHA_ATOL}), "
          f"rows identical {B - report['near_tie_rows']}/{B}, near-tie rows "
          f"{report['near_tie_rows']} (margin < {TIE_MARGIN}), distinct "
          f"words {distinct} (floor {MIN_DISTINCT_WORDS}), smallest top-2 "
          f"margin {float(margins.min()):.3e}, largest alpha "
          f"{float(ref_alphas.max()):.3f} [{card}]")
    if report["bad_rows"]:
        raise RuntimeError(f"kernel disagrees with its plain version on rows "
                           f"{report['bad_rows']}: {report}")
    # a second witness: the kernel and the plain version each against the
    # plain version in float64, so that the limit is seen to sit above the
    # fp32 rounding of both and not only above their difference
    wide = [t.double() if t.is_floating_point() else t for t in inputs]
    words64, alphas64, margins64 = reference(
        *wide, max_length=T, return_margins=True, **opts)
    vs64 = {who: fd.compare_with_reference(
        w, a.double(), words64, alphas64, margins64,
        alpha_atol=ALPHA_ATOL, tie_margin=TIE_MARGIN)
        for who, w, a in (("kernel", words, alphas),
                          ("plain", ref_words, ref_alphas))}
    print(f"{label} and its plain version vs the plain version in float64: "
          f"max |alpha err| {vs64['kernel']['max_abs_err']:.3e} and "
          f"{vs64['plain']['max_abs_err']:.3e} (limit {ALPHA_ATOL}), "
          f"near-tie rows {vs64['kernel']['near_tie_rows']} and "
          f"{vs64['plain']['near_tie_rows']} [{card}]")
    for who, rep in vs64.items():
        if rep["bad_rows"]:
            raise RuntimeError(f"the {who} decode disagrees with the float64 "
                               f"plain version on rows {rep['bad_rows']}: "
                               f"{rep}")
    if distinct < MIN_DISTINCT_WORDS:
        raise RuntimeError(f"the check's greedy words are degenerate: "
                           f"{distinct} distinct < {MIN_DISTINCT_WORDS}")
    entry = {"max_abs_err": report["max_abs_err"]}
    if model.cell_type == "gru":
        entry["tiles"] = {"h W2": fd.gru_hw_plan(inputs).describe()}
        print(f"{label}: h W2 on the tile kernel's plan "
              f"{entry['tiles']['h W2']}")
    else:
        entry["tiles"] = {part: p.describe() for part, p in zip(
            ("h W2", "cell", "Wi", "Wo"), fd.lstm_decode_plans(inputs))}
        print(f"{label}: the tile kernel's plans, " + ", ".join(
            f"{part} {plan}" for part, plan in entry["tiles"].items()))
        digest = hashlib.sha256(words.cpu().numpy().tobytes())
        digest.update(alphas.cpu().numpy().tobytes())
        print(f"{label}: SHA-256 of its words (int32) and alphas (fp32) on "
              f"the seeded inputs: {digest.hexdigest()}")
    if not timed:
        return entry

    ms = cuda_ms(lambda: kernel(*inputs, max_length=T, **opts))
    plain_ms = cuda_ms(lambda: reference(*inputs, max_length=T, **opts))
    fused = fd.make_whole_fused_greedy_decoder(model, T)
    unfused = make_greedy_decoder(model, T)
    fused_e2e = cuda_ms(lambda: fused(rows, 1))
    unfused_e2e = cuda_ms(lambda: unfused(rows, 1))
    cell = model.cell_type
    work = decode_bound(cell, inputs, opts, T, V)
    print(f"decode loop at B={B}, T={T}: {label} kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms, bound {work['bound_ms']:.4f} ms (by "
          f"{work['bound_by']}) [{card}]")
    print(f"greedy decode with encoder at B={B}: fused ({label}) "
          f"{fused_e2e:.4f} ms, unfused decode/greedy.py {unfused_e2e:.4f} ms "
          f"[{card}]")
    if profile:
        step_split(lambda: kernel(*inputs, max_length=T, **opts), label, T,
                   STEP_PARTS[cell], card)
    return {**entry, "ms": ms, "plain_ms": plain_ms, **work,
            "library_ms": None}


def _post(url: str, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise RuntimeError(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read().decode())


def _npy(rows: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, rows)
    return buf.getvalue()


def serve(captioner, rows: np.ndarray, card: str,
          request_rows=REQUEST_ROWS) -> list[str]:
    """POST /caption requests of ``request_rows`` rows each (the second as
    JSON, the others as .npy) through the port's HTTP server; returns the
    captions, one per row, in row order."""
    from masters_thesis_tpu_torch.server import make_caption_server

    server = make_caption_server(captioner, port=0)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bounds = np.cumsum((0,) + tuple(request_rows))
        answers = []
        for i, n in enumerate(request_rows):
            part = rows[bounds[i]:bounds[i + 1]]
            t0 = time.perf_counter()
            if i == 1:
                out = _post(f"{base}/caption",
                            json.dumps({"betas": part.tolist()}).encode(),
                            "application/json")
            else:
                out = _post(f"{base}/caption", _npy(part),
                            "application/octet-stream")
            caps = out["captions"]
            if len(caps) != n or not all(isinstance(c, str) for c in caps):
                raise RuntimeError(f"request of {n} rows got {len(caps)} "
                                   f"captions")
            answers.extend(caps)
            print(f"POST /caption {n} rows ({'json' if i == 1 else 'npy'}): "
                  f"200, {len(caps)} captions, "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms host [{card}]")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read().decode())
        print(f"GET /stats: {stats}")
        if (stats["requests"] != len(request_rows)
                or stats["rows"] != sum(request_rows)):
            raise RuntimeError(f"/stats does not count the requests: {stats}")
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    return answers


def throughput(captioner, rows: np.ndarray, card: str,
               label: str = "", decoder: str = "greedy") -> float:
    """Captions/s of ``decoder`` over ``WINDOWS`` windows of at least
    ``WINDOW_S`` s of ``caption`` calls; prints the median and the spread
    across windows."""
    captioner.caption(rows[:BATCH], decoder)             # warm
    rates = []
    for _ in range(WINDOWS):
        n, t0 = 0, time.perf_counter()
        while (seconds := time.perf_counter() - t0) < WINDOW_S:
            captioner.caption(rows, decoder)
            n += len(rows)
        rates.append(n / seconds)
    median = float(np.median(rates))
    print(f"{label}{decoder} captions/s through Captioner (batch {BATCH}, "
          f"{len(rows)} host rows a call, fp32): median {median:.1f} over "
          f"{WINDOWS} windows of >= {WINDOW_S} s, min {min(rates):.1f}, max "
          f"{max(rates):.1f}, spread {(max(rates) - min(rates)) / median:.1%}"
          f" [{card}]")
    return median


# kernel name fragments -> the part of the work a kernel does, first match
KERNEL_GROUPS = (
    ("K1 gather_rows", ("gather_rows_kernel",)),
    ("K2/K3/K4 tile kernel (h W2; K2's, K4's cell; K2's head)",
     ("tile_kernel",)),
    ("K2/K3/K4 step kernels", ("attention_kernel", "rows_kernel",
                               "argmax_embed_kernel")),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "splitkreduce")),
    ("index, gather, scatter, embedding", ("index", "gather", "scatter",
                                           "embedding")),
    ("reductions, softmax, norms", ("reduce", "softmax", "norm")),
    ("copies, fills, concatenation", ("memcpy", "memset", "copy", "fill",
                                      "cat")),
    ("elementwise", ("elementwise",)),
)


def device_time(fn, what: str, per: int = 1, unit: str = "call",
                table: bool = False, rows: int = 15) -> float:
    """Device time of one call of ``fn`` by ``torch.profiler``: the sum of
    its kernels' times, over ``per`` (the ``unit``s the call makes), in ms.
    Prints it beside the call's wall time under the profiler; ``table`` adds
    the kernels grouped by what they do, a step each, and the busiest ops of
    the whole call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile of {what}: {launches / per:.0f} kernels and {busy / per:.3f}"
          f" ms of device time a {unit}, in {wall / per:.3f} ms of wall time a "
          f"{unit} under the profiler (device busy {busy / wall:.1%})")
    if table:
        groups: dict[str, list] = {}
        for e in kernels:
            name = e.key.lower()
            group = next((g for g, keys in KERNEL_GROUPS
                          if any(k in name for k in keys)), "other")
            acc = groups.setdefault(group, [0.0, 0])
            acc[0] += e.self_device_time_total / 1e3
            acc[1] += e.count
        for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {group:36s} {ms / per:8.3f} ms {ms / busy:6.1%} "
                  f"{n / per:8.1f} kernels a {unit}")
        print(events.table(sort_by="self_cuda_time_total", row_limit=rows))
    return busy / per


# a decode step's launches in order, for each decode kernel (--profile):
# the part of the step each does, and the name it has in the profile
_HW, _ATTN = ("h W2 (tile)", ("tile_kernel<1,",)), \
    ("attention", ("attention_kernel",))
STEP_PARTS = {
    "lstm": (_HW, _ATTN, ("cell (tile)", ("tile_kernel<4,",)),
             ("Wi (tile)", ("tile_kernel<1,",)),
             ("Wo (tile)", ("tile_kernel<1,",)),
             ("argmax", ("argmax_embed_kernel",))),
    "gru": (_HW, _ATTN, ("cell (rows)", ("rows_kernel<2>",)),
            ("head", ("rows_kernel<0>",)), ("head", ("rows_kernel<0>",)),
            ("head", ("argmax_embed_kernel",))),
    "seq": (_HW, _ATTN,
            ("cell (tile)", ("tile_kernel<4,", "tile_kernel_tma<4,"))),
}


def step_split(fn, what: str, steps: int, parts, card: str) -> None:
    """Device time of one call of ``fn`` (a decode kernel's whole run of
    ``steps`` steps) by ``torch.profiler``, split by the part of a step
    each kernel does, in us a step. The call's kernels, in the order they
    ran, are matched to ``steps`` runs of ``parts`` (``STEP_PARTS``), each
    to the next part whose name it has, so that a kernel the profile lost
    shifts no other; the count of such kernels is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {k for _, keys in parts for k in keys}
    launched = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and any(k in e.name for k in names)),
                      key=lambda e: e.time_range.start)
    split = {name: [0.0, 0] for name, _ in parts}
    at = 0                      # the part the next kernel should be
    for e in launched:
        while not any(k in e.name for k in parts[at % len(parts)][1]):
            at += 1
        acc = split[parts[at % len(parts)][0]]
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
        at += 1
    total = sum(us for us, _ in split.values())
    lost = steps * len(parts) - len(launched)
    print(f"per-step split of {what} ({steps} steps, torch.profiler): "
          + ", ".join(f"{name} {us / steps:.2f} us ({n / steps:.0f} a step)"
                      for name, (us, n) in split.items())
          + f"; {total / steps:.2f} us a step in all"
          + (f" ({lost} of {steps * len(parts)} kernels not in the profile)"
             if lost else "") + f" [{card}]")


# ---- CnnRnn serving ----

def cnn_rnn(device, tok, card: str, with_profile: bool) -> dict:
    """The CnnRnn serving phase; returns K3's entry of the kernels line."""
    from masters_thesis_tpu_torch.models.nic import CnnRnnNIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    gen = torch.Generator().manual_seed(SEED)
    model = CnnRnnNIC(generator=gen, **CNN_RNN_WIDTHS)
    fd.spread_for_check(model, gen)
    model = model.to(device).eval()
    row_shape = model.encoder.row_shape
    mb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e6
    print(f"CnnRnn (GRU) on {row_shape} patch rows: embed "
          f"{CNN_RNN_WIDTHS['embed_dim']}, units {model.units}, attention "
          f"{model.attention.W1.kernel.shape[1]}, vocab {model.vocab_size}, "
          f"zero-state GRU {model.gru_zero_state}; {mb:.1f} MB fp32")

    dev_gen = torch.Generator(device=device).manual_seed(SEED)
    rows = torch.randn(BATCH, *row_shape, generator=dev_gen, device=device)
    # the family's default (zero state) last, so that it is the one timed
    model.gru_zero_state = False
    errs = [check_kernel(model, rows, card, "K3 (carried GRU state)",
                         timed=False)["max_abs_err"]]
    model.gru_zero_state = True
    k3 = check_kernel(model, rows, card, "K3 (zero-state GRU)",
                      profile=with_profile)
    k3["max_abs_err"] = max(errs + [k3["max_abs_err"]])

    captioner = Captioner(model, tok, model.units, model.max_length,
                          batch_size=BATCH, device=device)
    host = np.random.default_rng(SEED).standard_normal(
        (THROUGHPUT_ROWS, *row_shape), dtype=np.float32)
    fd.fused_greedy_decode_gru.launches = 0
    captions = captioner.caption(host)
    served = serve(captioner, host, card, request_rows=(CNN_RNN_REQUEST_ROWS,))
    launches = fd.fused_greedy_decode_gru.launches
    print(f"K3 launches while serving {len(host)} rows through Captioner and "
          f"{CNN_RNN_REQUEST_ROWS} through the server: {launches}")
    if launches < 1:
        raise RuntimeError("CnnRnn serving never launched the GRU kernel")
    if len(captions) != len(host) or not all(
            isinstance(c, str) for c in captions):
        raise RuntimeError("Captioner.caption did not return one caption a "
                           "row")
    if served != captions[:len(served)]:
        raise RuntimeError("served CnnRnn captions differ from "
                           "Captioner.caption on the same rows")
    nonempty = sum(map(bool, captions)) / len(captions)
    print(f"served captions equal Captioner.caption on the same rows; "
          f"{nonempty:.1%} of {len(captions)} non-empty (floor "
          f"{MIN_NONEMPTY_SHARE:.0%}), {len(set(captions))} distinct, e.g. "
          f"{captions[0]!r}")
    if nonempty < MIN_NONEMPTY_SHARE:
        raise RuntimeError(f"only {nonempty:.1%} of the CnnRnn captions are "
                           f"non-empty")
    throughput(captioner, host, card, label="CnnRnn ")
    if with_profile:
        device_time(lambda: captioner.caption(host[:BATCH]),
                    "one served CnnRnn batch", table=True)
    return {"launches": launches, **k3}


# ---- training ----

def flagship_train_data(device, cfg):
    """The flagship store on the card, pregathered, in ``cfg.tpu.store_dtype``,
    and the shared pipes.

    The pairs and the tokenizer come from ``synthetic_dataset`` at a small
    voxel width; the store's rows are drawn on the card from a seeded
    generator and permuted there with ``GroupLayout.permute_rows``'s
    indices. A host draw of 2,571 x 327,684 doubles, and its copy to the
    card, would cost more than the rest of the phase."""
    from masters_thesis_tpu_torch.data.pairs import encode_pairs
    from masters_thesis_tpu_torch.data.pipeline import BatchPipeline
    from masters_thesis_tpu_torch.data.store import ArrayStore, permute_rows
    from masters_thesis_tpu_torch.data.synthetic import (
        synthetic_dataset,
        synthetic_groups,
    )
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=SEED),
                         N_VOXELS)
    _, pairs, tok, _, keys, _ = synthetic_dataset(
        n_keys=TRAIN_KEYS, n_voxels=8, n_groups=2,
        top_k=WIDTHS["vocab_size"] - 1, seed=SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn(len(keys), N_VOXELS, generator=gen, device=device)
    store = ArrayStore(permute_rows(raw, layout), keys, device=device,
                       dtype=cfg.tpu.store_dtype)
    del raw
    T = WIDTHS["max_length"]
    train_pipe = BatchPipeline(encode_pairs(pairs["train"], tok, T), store,
                               BATCH, seed=SEED)
    val_pipe = BatchPipeline(encode_pairs(pairs["val"], tok, T), store,
                             BATCH, seed=SEED, shuffle=False)
    return layout, store, train_pipe, val_pipe


def train_config(**kw):
    from masters_thesis_tpu_torch.config import Config

    cfg = Config(seed=SEED, epochs=1, batch_size=BATCH,
                 max_length=WIDTHS["max_length"],
                 top_k=WIDTHS["vocab_size"] - 1, units=WIDTHS["units"],
                 attn_units=WIDTHS["attn_units"],
                 group_size=WIDTHS["group_size"],
                 embedding_text=WIDTHS["embedding_text"], **kw)
    cfg.tpu.scan_steps = SCAN_STEPS
    return cfg


def check_gather(store, card: str) -> dict:
    """K1 against its plain version on 64 rows of the store, with repeated
    ids and ids out of range, then K1 and ``index_select`` (the library's
    yardstick) on 64 ids in range, each split into its device time
    (``torch.profiler``) and its host time a call, and timed by CUDA events
    in turns (``scripts.gather_timing.compare``), and the plain version
    timed. Returns K1's entry of the kernels line, with the split under
    ``stores``."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_reference,
    )
    from masters_thesis_tpu_torch.scripts import gather_timing

    data = store.device_array()
    n = data.shape[0]
    gen = torch.Generator(device=data.device).manual_seed(SEED)
    ids = torch.randint(0, n, (BATCH,), generator=gen, device=data.device,
                        dtype=torch.int32)
    ids[1] = ids[0]
    ids[2], ids[3], ids[4] = -3, n, n + 1000
    got = gather_rows(data, ids)
    torch.cuda.synchronize()
    want = gather_rows_reference(data, ids)
    err = float((got - want).abs().max())
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"K1 differs from its plain version: max abs "
                           f"error {err}, shapes {tuple(got.shape)} "
                           f"{tuple(want.shape)}")
    ids = torch.randint(0, n, (BATCH,), generator=gen, device=data.device,
                        dtype=torch.int32)
    split = gather_timing.compare(data, ids, turns=GATHER_TURNS)
    plain_ms = cuda_ms(lambda: gather_rows_reference(data, ids), reps=50,
                       warmup=5)
    moved = 2 * BATCH * data.shape[1] * data.element_size()
    work = bound(moved + ids.numel() * ids.element_size(), 0)
    ms = split["K1"]["median_us"] / 1e3
    print(f"K1 vs plain on {BATCH} rows of the {n} x {data.shape[1]} "
          f"{str(data.dtype)[6:]} store (repeated ids, ids -3, {n}, "
          f"{n + 1000}): identical [{card}]")
    print(gather_timing.line(
        f"K1 and index_select on {BATCH} rows of the {n} x {data.shape[1]} "
        f"store ({moved / 2e6:.1f} MB), events in {GATHER_TURNS} turns",
        split, card))
    print(f"K1 {ms * 1e3:.2f} us ({moved / ms / 1e6:.1f} GB/s read+write), "
          f"plain clamp + index_select {plain_ms * 1e3:.2f} us, bound "
          f"{work['bound_ms'] * 1e3:.2f} us (by {work['bound_by']}) [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work,
            "library_ms": split["index_select"]["median_us"] / 1e3,
            "stores": [{"store": list(data.shape), **split}]}


def check_trajectory(layout, store, pipe, device, card: str) -> None:
    """Three dropout-off steps gathering their batches through K1 against
    the same steps fed by the plain gather, from the same weights."""
    from masters_thesis_tpu_torch.ops.gather import gather_rows_reference
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import init_model

    cfg = train_config(dropout_features=0.0, dropout_text=0.0,
                       dropout_attn=0.0, dropout_lstm=0.0, dropout_out=0.0)
    rules = lc_nic_l2_rules(cfg)
    tables = tuple(torch.as_tensor(t, device=device) for t in (
        pipe.store_idx, pipe.pairs.tokens, pipe.targets))
    sel = torch.as_tensor(np.stack([b["sel"] for _, b in zip(
        range(TRAJ_STEPS), pipe.epoch(0))]), device=device)
    a = init_model(cfg, layout, device, pregathered=True)
    a, ma = steps.make_scanned_train_steps_from_tables(cfg, rules)(
        a, store.device_array(), *tables, sel)
    b = init_model(cfg, layout, device, pregathered=True)
    one = steps.make_train_step(cfg, rules)
    store_idx, tokens, target = tables
    mb = []
    for p in sel:
        b, m = one(b, gather_rows_reference(store.device_array(),
                                            store_idx[p]),
                   tokens[p], target[p])
        mb.append(m)
    worst = 0.0
    for key in ("loss", "total", "grad_norm"):
        want = torch.stack([m[key] for m in mb])
        worst = max(worst, float(((ma[key] - want).abs() / want.abs()).max()))
    with torch.no_grad():
        diff = torch.stack([torch.linalg.vector_norm(pa - pb) for pa, pb in
                            zip(a.model.parameters(), b.model.parameters())])
        norm = torch.stack([torch.linalg.vector_norm(p)
                            for p in b.model.parameters()])
        params = float(torch.linalg.vector_norm(diff)
                       / torch.linalg.vector_norm(norm))
    print(f"{TRAJ_STEPS}-step dropout-off trajectory, K1 vs plain gather: "
          f"metrics max rel err {worst:.3e}, parameters rel err {params:.3e} "
          f"(limit {TRAJ_RTOL}), losses {ma['loss'].tolist()} [{card}]")
    if not (worst <= TRAJ_RTOL and params <= TRAJ_RTOL):
        raise RuntimeError("the trajectory through K1 leaves the one through "
                           "the plain gather")


def fit_epoch(cfg, layout, store, train_pipe, val_pipe, device):
    """One epoch of ``Trainer.fit`` on a fresh state, scanned from the
    device tables with the scanned validation pass; returns the state, the
    trainer, the logs and the per-step losses."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.loop import Callback, Trainer
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import init_model

    class Rows(Callback):
        """The per-step metric rows, as the batch hook delivers them."""

        def __init__(self):
            self.rows = []

        def on_batch_end(self, trainer, step, logs):
            self.rows.append(logs)

    rules = lc_nic_l2_rules(cfg)
    state = init_model(cfg, layout, device, pregathered=True)
    hook = Rows()
    trainer = Trainer(cfg, steps.make_train_step(cfg, rules),
                      steps.make_eval_step(cfg, rules), state, train_pipe,
                      val_pipe, callbacks=[hook], store=store)
    trainer.use_scanned_steps(
        steps.make_scanned_train_steps_from_tables(cfg, rules), tables=True)
    trainer.use_scanned_eval(
        steps.make_scanned_eval_steps_from_tables(cfg, rules))
    logs = trainer.fit()
    losses = np.array([r["loss"] for r in hook.rows])
    if len(losses) != len(train_pipe) or not np.isfinite(losses).all() \
            or not np.isfinite(logs["val_loss"]):
        raise RuntimeError("a training loss is not finite, or steps are "
                           "missing")
    first, last = losses[:EDGE_STEPS].mean(), losses[-EDGE_STEPS:].mean()
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    return state, trainer, logs, losses


def time_steps(cfg, state, trainer, train_pipe, device, card: str,
               label: str, with_profile: bool) -> float:
    """A scanned train step's time: CUDA events around calls of STEP_WINDOW
    scanned steps, STEP_REPS of them, then the kernels' own time in one more
    such call. Returns the median ms a step."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules

    scanned = steps.make_scanned_train_steps_from_tables(
        cfg, lc_nic_l2_rules(cfg))
    sel = torch.as_tensor(np.stack([b["sel"] for _, b in zip(
        range(STEP_WINDOW), train_pipe.epoch(1))]), device=device)
    data = trainer.store.device_array()

    def window():
        scanned(state, data, *trainer._scan_tables, sel)

    window()
    wall = [cuda_ms(window, reps=1, warmup=0) / STEP_WINDOW
            for _ in range(STEP_REPS)]
    med = float(np.median(wall))
    print(f"{label} at B={BATCH}: {med:.3f} ms a step by CUDA events, "
          f"median of {STEP_REPS} calls of {STEP_WINDOW} scanned steps (min "
          f"{min(wall):.3f}, max {max(wall):.3f}; {1e3 / med:.2f} steps/s); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    busy = device_time(window, f"{STEP_WINDOW} scanned steps ({label})",
                       per=STEP_WINDOW, unit="step", table=with_profile,
                       rows=25)
    if busy > 0:
        print(f"{label} device time {busy:.3f} ms a step (kernels, "
              f"torch.profiler), {busy / med:.1%} of the median ms a step by "
              f"CUDA events above [{card}]")
    else:
        print(f"{label} device time: not measured (the profiler saw no "
              f"kernels)")
    return med


def train(device, card: str, with_profile: bool):
    """The training phase; returns K1's entry of the kernels line and what
    the fused-sequence phase reuses: the layout, the store, the pipes and
    the epoch's steps/s."""
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    cfg = train_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    layout, store, train_pipe, val_pipe = flagship_train_data(device, cfg)
    torch.cuda.synchronize()
    data = store.device_array()
    print(f"flagship store on the card: {tuple(data.shape)} "
          f"{str(data.dtype)[6:]}, {data.numel() * data.element_size() / 1e9:.2f}"
          f" GB, pregathered, built in {time.perf_counter() - t0:.1f} s; "
          f"{len(train_pipe.pairs)} train pairs = {len(train_pipe)} steps, "
          f"{len(val_pipe)} val batches of {BATCH}")
    k1 = check_gather(store, card)
    check_trajectory(layout, store, train_pipe, device, card)

    gather_rows.launches = 0
    state, trainer, logs, losses = fit_epoch(cfg, layout, store, train_pipe,
                                             val_pipe, device)
    launches = gather_rows.launches
    batches = len(train_pipe) + len(val_pipe)
    print(f"one flagship epoch through Trainer.fit (scan_steps {SCAN_STEPS}, "
          f"dropout 0.2, Adam beta_2 0.98, clipnorm 0.1, L2): {len(losses)} "
          f"steps, loss {losses[:EDGE_STEPS].mean():.4f} (first {EDGE_STEPS}) "
          f"-> {losses[-EDGE_STEPS:].mean():.4f} (last {EDGE_STEPS}), "
          f"val_loss {logs['val_loss']:.4f}, val_accuracy "
          f"{logs['val_accuracy']:.4f}; K1 launches {launches} (train + val "
          f"batches {batches})")
    print(f"train steps/s over the epoch: {logs['steps_per_sec']:.2f} "
          f"(epoch {logs['epoch_time']:.2f} s with validation) [{card}]")
    if launches < batches:
        raise RuntimeError(f"K1 launched {launches} times for {batches} "
                           f"train and val batches")
    time_steps(cfg, state, trainer, train_pipe, device, card, "train step",
               with_profile)
    return ({"launches": launches, **k1},
            (layout, store, train_pipe, val_pipe, logs["steps_per_sec"]))


# ---- the fused teacher-forced sequence (K4 and the custom backward) ----

class GivenFeatures(torch.nn.Module):
    """An encoder that passes its input through: a decoder-only NIC on
    seeded random features, as ``scripts/fused_seq_probe.py`` measures."""

    def __init__(self, dim: int):
        super().__init__()
        self.out_dim = dim

    def forward(self, x, training=False, generator=None):
        return x


def seq_inputs(model, betas, tokens) -> tuple:
    """K4's arguments for ``betas`` and ``tokens`` through ``model`` in eval
    mode: pre, features, the embedded tokens and the seven weights."""
    from masters_thesis_tpu_torch.models.common import activation
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    with torch.no_grad():
        features = model.encode(betas)
        pre = activation(model.attention.W1(features),
                         model.attn_inner_activation)
        sp = fs.extract_seq_params(model)
        return (pre, features, model.embed(tokens),
                *(sp[k].detach() for k in fs.W_KEYS))


def seq_bound(inputs) -> dict:
    """``bound`` of one K4 forward on ``inputs``: each input read once, the
    five residuals written once, and per row and step the fp32
    multiply-adds of h W2, the scores, the context and the cell."""
    pre, features, emb, w2 = inputs[:4]
    B, R, A = pre.shape
    T, E = emb.shape[1:]
    D, U = features.shape[2], w2.shape[0]
    read = sum(t.numel() for t in inputs)
    written = T * B * (U + U + R + 4 * U + A)
    fma = B * T * (U * A + R * A + R * D + (D + E + U) * 4 * U)
    return bound(4 * (read + written), 2 * fma)


@torch.inference_mode()
def check_seq_kernel(inputs, attn_slope: float, card: str, label: str,
                     profile: bool = False) -> dict:
    """K4 against its plain version on the same inputs, and both against
    the plain version in float64, residual by residual, then both timed;
    with ``profile``, K4's per-step split. Returns K4's entry of the
    kernels line, less its launches."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    names = ("h", "c", "alpha", "z", "hw_pre")
    got = fs.fused_seq_forward(*inputs, attn_slope)
    torch.cuda.synchronize()
    want = fs.fused_seq_forward_reference(*inputs, attn_slope)
    wide = fs.fused_seq_forward_reference(*(t.double() for t in inputs),
                                          attn_slope)
    err = lambda a, b: float((a.double() - b.double()).abs().max())  # noqa
    errs = {n: err(g, w) for n, g, w in zip(names, got, want)}
    vs64 = {who: {n: err(x, w) for n, x, w in zip(names, out, wide)}
            for who, out in (("kernel", got), ("plain", want))}
    B, T, R = got[2].shape
    shapes = ", ".join(f"{n} {tuple(g.shape)}" for n, g in zip(names, got))
    print(f"{label} vs plain at B={B} T={T} R={R} ({shapes}): max abs err "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (limits: alpha {ALPHA_ATOL}, others {SEQ_ATOL}) [{card}]")
    for who, e in vs64.items():
        print(f"{label}: the {who} version vs the plain version in float64: "
              + ", ".join(f"{n} {x:.3e}" for n, x in e.items()))
    for e in (errs, *vs64.values()):
        if not (e["alpha"] <= ALPHA_ATOL
                and all(e[n] <= SEQ_ATOL for n in names if n != "alpha")):
            raise RuntimeError(f"{label} disagrees with its plain version "
                               f"or with float64: {errs} {vs64}")
    if not all(torch.isfinite(g).all() for g in got):
        raise RuntimeError(f"{label} produced a value that is not finite")
    cell, hw = fs.seq_plans(inputs)
    entry = {"max_abs_err": max(errs.values()),
             "tiles": {"cell": cell.describe(), "h W2": hw.describe()}}
    print(f"{label}: the tile kernel's plans, cell {cell.describe()}, h W2 "
          f"{hw.describe()}")
    ms = cuda_ms(lambda: fs.fused_seq_forward(*inputs, attn_slope))
    plain_ms = cuda_ms(lambda: fs.fused_seq_forward_reference(*inputs,
                                                              attn_slope))
    work = seq_bound(inputs)
    print(f"{label} forward at B={B}, T={T}: kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms, bound {work['bound_ms']:.4f} ms (by "
          f"{work['bound_by']}) [{card}]")
    if profile:
        step_split(lambda: fs.fused_seq_forward(*inputs, attn_slope), label,
                   T, STEP_PARTS["seq"], card)
    return {**entry, "ms": ms, "plain_ms": plain_ms, **work,
            "library_ms": None}


def check_seq_gradients(model, betas, tokens, card: str) -> None:
    """Loss and every parameter's gradient through
    ``make_fused_forward_loss(backend="kernel")`` against autograd of the
    model's eval forward and ``caption_loss`` on the same weights, the
    encoder included, within GRAD_RTOL; against autograd in float64 no
    farther than fp32 autograd is, plus GRAD_RTOL; and the custom backward
    in float64 against autograd in float64, within 1e-9."""
    import copy

    from masters_thesis_tpu_torch.ops import fused_seq as fs
    from masters_thesis_tpu_torch.train.losses import caption_loss

    target = torch.roll(tokens, -1, 1)

    def autograd(m, x):
        a0 = torch.zeros(len(x), m.units, dtype=x.dtype, device=x.device)
        loss = caption_loss(m(x, tokens, a0, a0)[0], target)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    loss = fs.make_fused_forward_loss(model, None, "kernel")(betas, tokens,
                                                             target)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref_loss, ref = autograd(model, betas)
    model64 = copy.deepcopy(model).double()
    loss64, ref64 = autograd(model64, betas.double())
    names = [n for n, _ in model.named_parameters()]

    def worst(gs, want):
        """The largest error over the leaves, each in units of max(1, the
        leaf's largest entry); attention.V.bias apart (its gradient is
        exactly 0: softmax ignores a shift of every score)."""
        out = {}
        for n, g, w in zip(names, gs, want):
            if n != "attention.V.bias":
                scale = max(1.0, float(w.abs().max()))
                out[n] = float((g.double() - w.double()).abs().max()) / scale
        top = max(out, key=out.get)
        return out[top], top

    e, leaf = worst(grads, ref)
    e64, leaf64 = worst(grads, ref64)
    a64, aleaf64 = worst(ref, ref64)
    v_bias = max(float(g[names.index("attention.V.bias")].abs().max())
                 for g in (grads, ref))
    # the custom backward in float64 (scan forward) against autograd in
    # float64: equal algebra, so what parts the fp32 routes from float64 is
    # fp32's own rounding, shared by both
    loss_s64 = fs.make_fused_forward_loss(model64, None, "scan")(
        betas.double(), tokens, target)
    s64, _ = worst(torch.autograd.grad(loss_s64, list(model64.parameters())),
                   ref64)
    print(f"fused loss (K4 forward, custom backward) {loss.item():.6f}, "
          f"autograd {ref_loss.item():.6f}, float64 {loss64.item():.6f}; "
          f"gradients of {len(names)} leaves: max err {e:.3e} x max(1, "
          f"|leaf|) ({leaf}) vs autograd (limit {GRAD_RTOL}), {e64:.3e} "
          f"({leaf64}) vs float64, where autograd is {a64:.3e} ({aleaf64}) "
          f"from float64 (limit: autograd's + {GRAD_RTOL}); the custom "
          f"backward in float64 {s64:.1e} from autograd in float64; "
          f"|d attention.V.bias| {v_bias:.1e} [{card}]")
    if not (abs(loss.item() - ref_loss.item()) <= 1e-5 and e <= GRAD_RTOL
            and e64 <= a64 + GRAD_RTOL and s64 <= 1e-9 and v_bias <= 1e-5):
        raise RuntimeError("the fused sequence's gradients disagree with "
                           "autograd")


def decoder_rows(model, features, tokens, card: str, label: str) -> None:
    """A decoder fwd+bwd a step, the three rows of
    ``scripts/fused_seq_probe.py``: autograd of the model's step loop, the
    custom backward with the scan forward, and with K4; every gradient
    consumed."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs
    from masters_thesis_tpu_torch.train.losses import caption_loss

    target = torch.roll(tokens, -1, 1)
    params = list(model.parameters())
    a0 = torch.zeros(len(tokens), model.units, device=tokens.device)
    losses = {
        "autograd": lambda: caption_loss(
            model(features, tokens, a0, a0)[0], target),
        "custom backward, scan forward":
            lambda: fs.make_fused_forward_loss(model, None, "scan")(
                features, tokens, target),
        "custom backward, K4 forward":
            lambda: fs.make_fused_forward_loss(model, None, "kernel")(
                features, tokens, target),
    }
    times = {name: cuda_ms(lambda fn=fn: torch.autograd.grad(fn(), params),
                           reps=DEC_REPS, warmup=1)
             for name, fn in losses.items()}
    print(f"decoder fwd+bwd a step at {label}: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in times.items()) + f" [{card}]")


def decoder_model(device, widths: dict, generator):
    from masters_thesis_tpu_torch.models.nic import NIC

    w = dict(widths)
    return NIC(GivenFeatures(w.pop("group_size")), units=w["units"],
               embedding_text=w["embedding_text"],
               attn_units=w["attn_units"], vocab_size=w["vocab_size"],
               max_length=w["max_length"], head_dim=w["head_dim"],
               generator=generator).to(device).eval()


def check_fused_trajectory(layout, store, pipe, device, card: str) -> None:
    """Three dropout-off steps with ``tpu.fused_seq`` against the autograd
    steps, from the same weights over the same batches of the store."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import init_model

    tables = tuple(torch.as_tensor(t, device=device) for t in (
        pipe.store_idx, pipe.pairs.tokens, pipe.targets))
    sel = torch.as_tensor(np.stack([b["sel"] for _, b in zip(
        range(TRAJ_STEPS), pipe.epoch(0))]), device=device)
    out = []
    for fused in (True, False):
        cfg = train_config(dropout_features=0.0, dropout_text=0.0,
                           dropout_attn=0.0, dropout_lstm=0.0,
                           dropout_out=0.0)
        cfg.tpu.fused_seq = fused
        state = init_model(cfg, layout, device, pregathered=True)
        state, m = steps.make_scanned_train_steps_from_tables(
            cfg, lc_nic_l2_rules(cfg))(state, store.device_array(), *tables,
                                       sel)
        out.append((m["loss"], dict(state.model.named_parameters())))
    (fl, fp), (al, ap) = out
    loss_err = float((fl - al).abs().max())
    lr_bound = TRAJ_STEPS * cfg.alpha * 1.001
    with torch.no_grad():
        errs = {n: float((p - ap[n]).abs().max()) for n, p in fp.items()}
    v_bias = errs.pop("attention.V.bias")
    leaf = max(errs, key=errs.get)
    print(f"{TRAJ_STEPS}-step dropout-off trajectory, tpu.fused_seq vs "
          f"autograd: losses {fl.tolist()} vs {al.tolist()}, max err "
          f"{loss_err:.3e} (limit {FUSED_LOSS_ATOL}); parameters max err "
          f"{errs[leaf]:.3e} ({leaf}; limit {FUSED_PARAM_ATOL}), "
          f"attention.V.bias {v_bias:.3e} (zero gradient: held to lr a "
          f"step, {lr_bound:.1e}) [{card}]")
    if not (loss_err <= FUSED_LOSS_ATOL and errs[leaf] <= FUSED_PARAM_ATOL
            and v_bias <= lr_bound):
        raise RuntimeError("the tpu.fused_seq trajectory leaves the "
                           "autograd one")


def fused_seq(data, device, card: str, with_profile: bool) -> dict:
    """The fused-sequence phase on the flagship model (``flagship_model``,
    built again: the serving phase frees it, so the CnnRnn phase finds the
    card as before this phase existed) and the training store of the train
    phase; returns K4's entry of the kernels line."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    layout, store, train_pipe, val_pipe, autograd_steps_per_s = data
    model = flagship_model(device)
    slope = 0.2
    gen = torch.Generator(device=device).manual_seed(SEED)
    T, V = WIDTHS["max_length"], WIDTHS["vocab_size"]
    betas = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    tokens = torch.randint(1, V, (BATCH, T), generator=gen, device=device)
    k4 = check_seq_kernel(seq_inputs(model, betas, tokens), slope, card,
                          "K4 (flagship)", with_profile)
    fs.fused_seq_forward.launches = 0
    check_seq_gradients(model, betas, tokens, card)
    launches = fs.fused_seq_forward.launches
    print(f"K4 launches through make_fused_forward_loss(backend='kernel'): "
          f"{launches}")
    if launches < 1:
        raise RuntimeError("the fused loss never launched K4")

    # the probe's two shapes, decoder only, on seeded random features
    # (the flagship model's K4 is checked above; the wide shape's here)
    for label, widths, batch, check in (
            ("flagship", FLAGSHIP_DECODER, BATCH, False),
            ("the probe's wide shape", PROBE_WIDE, PROBE_WIDE_BATCH, True)):
        dec = decoder_model(device, widths,
                            torch.Generator().manual_seed(SEED))
        features = torch.randn(batch, N_GROUPS, widths["group_size"],
                               generator=gen, device=device)
        toks = torch.randint(1, widths["vocab_size"],
                             (batch, widths["max_length"]), generator=gen,
                             device=device)
        if check:
            wide = check_seq_kernel(seq_inputs(dec, features, toks), slope,
                                    card, f"K4 ({label})", with_profile)
            k4["wide"] = {"shape": f"B {batch}, U {widths['units']}, A "
                          f"{widths['attn_units']}, D {widths['group_size']}"
                          f", E {widths['embedding_text']}, R {N_GROUPS}, T "
                          f"{widths['max_length']}", **wide}
        decoder_rows(dec, features, toks, card, f"{label} (B={batch}, "
                     f"U={widths['units']}, A={widths['attn_units']}, "
                     f"D={widths['group_size']}, R={N_GROUPS}, "
                     f"E={widths['embedding_text']}, "
                     f"head {widths['head_dim']}, V={widths['vocab_size']})")
        del dec
        torch.cuda.empty_cache()

    # the production route: tpu.fused_seq through the train steps
    check_fused_trajectory(layout, store, train_pipe, device, card)
    cfg = train_config()
    cfg.tpu.fused_seq = True
    state, trainer, logs, losses = fit_epoch(cfg, layout, store, train_pipe,
                                             val_pipe, device)
    route = ("the fused sequence (custom backward, scan forward)"
             if fs.fused_train_supported(state.model, cfg) else "autograd")
    print(f"one flagship epoch with tpu.fused_seq through Trainer.fit, route "
          f"{route}: {len(losses)} steps, loss "
          f"{losses[:EDGE_STEPS].mean():.4f} (first {EDGE_STEPS}) -> "
          f"{losses[-EDGE_STEPS:].mean():.4f} (last {EDGE_STEPS}), val_loss "
          f"{logs['val_loss']:.4f}")
    print(f"train steps/s over the epoch: tpu.fused_seq "
          f"{logs['steps_per_sec']:.2f}, autograd {autograd_steps_per_s:.2f} "
          f"(epoch {logs['epoch_time']:.2f} s with validation) [{card}]")
    time_steps(cfg, state, trainer, train_pipe, device, card,
               "tpu.fused_seq train step", with_profile)
    return {"launches": launches, **k4}


# ---- the gather probe (P1, P2, P3) ----

def check_probe_kernels(device, card: str) -> dict:
    """P1 at the probe's four chunks (over the store padded to 328,704
    columns) and P2 at its four stage counts (over the raw store), on the
    probe's 1,024 x 327,684 fp32 store: each bit for bit against the plain
    version on 64 ids with repeats and ids -3, N and N + 1000, then each
    timed beside the plain version and ``index_select`` on 64 ids in range;
    P3, the bulk gather at 4 stages, exact against ``index_select`` on the
    probe's first row of ids, and timed. Returns the three entries of the
    kernels line, less their launches."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows_bulk,
        gather_rows_chunked,
        gather_rows_reference,
    )
    from masters_thesis_tpu_torch.scripts import gather_probe as gp

    raw = gp.make_store(gp.N, gp.V, device)
    padded = gp.pad_store(raw)
    n, batch = gp.N, gp.B
    gen = torch.Generator(device=device).manual_seed(SEED)
    edge = torch.randint(0, n, (batch,), generator=gen, device=device,
                         dtype=torch.int32)
    edge[1] = edge[0]
    edge[2], edge[3], edge[4] = -3, n, n + 1000
    ids = torch.randint(0, n, (batch,), generator=gen, device=device,
                        dtype=torch.int32)

    def timed(fn, store, ids) -> dict:
        """``fn``'s ms beside the plain version's, ``index_select``'s and
        the bound, on ``ids`` of ``store``."""
        moved = 2 * len(ids) * store.shape[1] * store.element_size()
        ids_long = ids.long()
        return {"ms": cuda_ms(fn, reps=50, warmup=5),
                "plain_ms": cuda_ms(
                    lambda: gather_rows_reference(store, ids), reps=50,
                    warmup=5),
                **bound(moved + ids.numel() * ids.element_size(), 0),
                "library_ms": cuda_ms(
                    lambda: store.index_select(0, ids_long), reps=50,
                    warmup=5)}

    entries = {}
    for key, wrapper, store, settings in (
            ("P1", gather_rows_chunked, padded,
             {f"s_block={sb}": {"chunk_cols": sb * gp.LANES}
              for sb in gp.S_BLOCKS}),
            ("P2", gather_rows_bulk, raw,
             {f"nb={nb}": {"stages": nb} for nb in gp.STAGES})):
        want = gather_rows_reference(store, edge)
        times = {}
        for label, kw in settings.items():
            got = wrapper(store, edge, **kw)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise RuntimeError(
                    f"{key} ({wrapper.__name__} {label}) differs from its "
                    f"plain version: max abs error "
                    f"{float((got - want).abs().max())}")
            times[label] = cuda_ms(lambda: wrapper(store, ids, **kw),
                                   reps=50, warmup=5)
        best = min(times, key=times.get)
        entry = timed(lambda: wrapper(store, ids, **settings[best]), store,
                      ids)
        print(f"{key} {wrapper.__name__} vs plain on {batch} rows of the "
              f"{n} x {store.shape[1]} fp32 store at every setting "
              f"(repeated ids, ids -3, {n}, {n + 1000}): identical; "
              + ", ".join(f"{s} {ms * 1e3:.2f} us" for s, ms in
                          times.items())
              + f"; plain clamp + index_select {entry['plain_ms'] * 1e3:.2f}"
              f" us, index_select alone {entry['library_ms'] * 1e3:.2f} us, "
              f"bound {entry['bound_ms'] * 1e3:.2f} us (by "
              f"{entry['bound_by']}) [{card}]")
        entries[key] = {"max_abs_err": 0.0, **entry, "best": best,
                        "best_kwargs": settings[best], "settings_ms": times}

    one = torch.as_tensor(gp.make_ids(gp.N, gp.B, gp.K)[0], device=device)
    if not gp.exact_check(raw, one):
        raise RuntimeError("P3: the bulk gather at 4 stages is not exact")
    entry = timed(lambda: gather_rows_bulk(raw, one, gp.EXACT_STAGES), raw,
                  one)
    print(f"P3 gather_rows_bulk at {gp.EXACT_STAGES} stages on the probe's "
          f"first {batch} ids: exact: True; {entry['ms'] * 1e3:.2f} us, "
          f"plain {entry['plain_ms'] * 1e3:.2f} us, index_select "
          f"{entry['library_ms'] * 1e3:.2f} us, bound "
          f"{entry['bound_ms'] * 1e3:.2f} us [{card}]")
    # P3 and index_select in turns, so that their medians can be set
    # against the spread of one run
    one_long = one.long()
    turns = {"P3": [], "index_select": []}
    for _ in range(P3_TURNS):
        turns["P3"].append(cuda_ms(
            lambda: gather_rows_bulk(raw, one, gp.EXACT_STAGES), reps=50,
            warmup=5))
        turns["index_select"].append(cuda_ms(
            lambda: raw.index_select(0, one_long), reps=50, warmup=5))
    print(f"P3 and index_select in {P3_TURNS} turns: " + ", ".join(
        f"{name} median {np.median(ts) * 1e3:.2f} us (min "
        f"{min(ts) * 1e3:.2f}, max {max(ts) * 1e3:.2f}, spread "
        f"{(max(ts) - min(ts)) * 1e3:.2f} us)" for name, ts in turns.items())
        + f" [{card}]")
    entries["P3"] = {"max_abs_err": 0.0, **entry, "turns": turns}
    return entries


def probe_at_k1_shape(store, entries: dict, card: str) -> None:
    """P1 and P2 at their best settings on the probe's store, beside K1 and
    ``index_select``, on 64 rows of the training store (K1's real shape):
    equal to K1, then timed in the order K1, P1, P2, index_select and back.
    Adds ``at_k1_shape`` to the P1 and P2 entries."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_bulk,
        gather_rows_chunked,
    )

    data = store.device_array()
    n = data.shape[0]
    gen = torch.Generator(device=data.device).manual_seed(SEED + 1)
    ids = torch.randint(0, n, (BATCH,), generator=gen, device=data.device,
                        dtype=torch.int32)
    p1, p2 = entries["P1"]["best"], entries["P2"]["best"]
    p1_kw, p2_kw = entries["P1"]["best_kwargs"], entries["P2"]["best_kwargs"]
    ids_long = ids.long()
    runs = {"K1": lambda: gather_rows(data, ids),
            "P1": lambda: gather_rows_chunked(data, ids, **p1_kw),
            "P2": lambda: gather_rows_bulk(data, ids, **p2_kw),
            "index_select": lambda: data.index_select(0, ids_long)}
    k1 = runs["K1"]()
    for key in ("P1", "P2"):
        if not torch.equal(runs[key](), k1):
            raise RuntimeError(f"{key} differs from K1 on the training store")
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(cuda_ms(runs[name], reps=50, warmup=5))
    moved = 2 * BATCH * data.shape[1] * data.element_size()
    print(f"at K1's shape ({BATCH} rows of the {n} x {data.shape[1]} "
          f"training store, {moved / 2e6:.1f} MB), in turns: "
          + ", ".join(f"{name} "
                      + "/".join(f"{ms * 1e3:.2f}" for ms in ts) + " us"
                      for name, ts in times.items())
          + f" (P1 at {p1}, P2 at {p2}; bound "
          f"{bound(moved, 0)['bound_ms'] * 1e3:.2f} us) [{card}]")
    for key, setting in (("P1", p1), ("P2", p2)):
        entries[key]["at_k1_shape"] = {
            "setting": setting, "ms": times[key], "k1_ms": times["K1"],
            "library_ms": times["index_select"]}


def gather_probe(train_data, device, card: str) -> list[dict]:
    """The gather-probe phase: the probe's kernels checked and timed
    (``check_probe_kernels``), then the probe itself through its entry point
    at its own sizes with the P1 and P2 launch counts set to 0 before and
    read after, then P1 and P2 at K1's shape on the training store. Returns
    the P1, P2 and P3 entries of the kernels line."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows_bulk,
        gather_rows_chunked,
    )
    from masters_thesis_tpu_torch.scripts import gather_probe as gp

    entries = check_probe_kernels(device, card)
    release()
    gather_rows_chunked.launches = 0
    gather_rows_bulk.launches = 0
    result = gp.run(device=device)
    launches = {"P1": gather_rows_chunked.launches,
                "P3": result["exact_launches"]}
    launches["P2"] = gather_rows_bulk.launches - launches["P3"]
    print(f"launches through the probe's run: P1 {launches['P1']}, P2 "
          f"{launches['P2']}, P3 {launches['P3']}")
    if not result["exact"] or min(launches.values()) < 1:
        raise RuntimeError(f"the probe's run: exact {result['exact']}, "
                           f"launches {launches}")
    release()
    probe_at_k1_shape(train_data[1], entries, card)
    return [{
        "name": "gather_rows_chunked", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/gather_probe.cu",
        "replaces": "scripts/gather_probe.py:44",
        "launches": launches["P1"], **entries["P1"]}, {
        "name": "gather_rows_bulk", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/gather_probe.cu",
        "replaces": "scripts/gather_probe.py:82",
        "launches": launches["P2"], **entries["P2"]}, {
        "name": f"gather_rows_bulk[stages={gp.EXACT_STAGES}]",
        "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/gather_probe.cu",
        "replaces": "scripts/gather_probe.py:146",
        "launches": launches["P3"], **entries["P3"]}]


# ---- the training product: config -> run_training -> run_eval ->
# run_metrics -> restore -> from_run_dir ----

def raw_rows(rows: torch.Tensor, layout) -> torch.Tensor:
    """Rows of a pregathered store back in voxel order: each voxel's one
    slot in the grouped padded layout (the synthetic groups cover every
    voxel once)."""
    flat = layout.flat_indices()
    real = np.nonzero(flat < layout.n_voxels)[0]
    slot = np.empty(layout.n_voxels, np.int64)
    slot[flat[real]] = real
    return rows.index_select(1, torch.as_tensor(slot, device=rows.device))


def check_restore(bundle, device, card: str) -> None:
    """A fresh manager's restore, on the card, into a fresh state gives
    back every parameter, BatchNorm statistic, mu, nu, count and step of
    the trained state bit for bit."""
    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
    from masters_thesis_tpu_torch.train.state import new_state

    cfg, trained = bundle["cfg"], bundle["state"]
    layout = trained.model.encoder.layout
    model, _, _ = experiment.build_model(cfg, layout.to_groups(),
                                         layout.n_voxels, pregathered=True)
    fresh = new_state(model, cfg, device, seed=cfg.seed + 1)
    mgr = CheckpointManager(bundle["manager"].directory)
    fresh, epoch = mgr.restore(fresh)
    pairs = [(f"model.{k}", v, fresh.model.state_dict()[k])
             for k, v in trained.model.state_dict().items()]
    for slot in ("mu", "nu"):
        pairs += [(f"{slot}.{i}", a, b) for i, (a, b) in enumerate(
            zip(getattr(trained.tx, slot), getattr(fresh.tx, slot)))]
    bad = [name for name, a, b in pairs
           if a.device != b.device or not torch.equal(a, b)]
    if bad or (fresh.tx.count, fresh.step, fresh.seed) != (
            trained.tx.count, trained.step, trained.seed):
        raise RuntimeError(f"the restore of epoch {epoch} differs: {bad[:5]}, "
                           f"count/step/seed {fresh.tx.count}/{fresh.step}/"
                           f"{fresh.seed}")
    print(f"restore of epoch {epoch} on the card: {len(pairs)} tensors, "
          f"count {fresh.tx.count}, step {fresh.step}, seed {fresh.seed}: "
          f"bit for bit [{card}]")


def check_served(run_path: str, bundle, out: dict, device, card: str) -> None:
    """``Captioner.from_run_dir`` on the card, on raw rows of the first
    SERVED_ROWS test keys, gives ``run_eval``'s words and attention
    (``attention_scores_{e}.npy``): a row may take another word only at a
    near-tie of the plain version, and its alphas agree within ALPHA_ATOL
    up to that step. A model two epochs into random captions emits the same
    words for every row, so the alphas, which depend on the row, carry the
    check: they must differ between rows, and the same rows in a wrong
    voxel order must fail it on every row."""
    from masters_thesis_tpu_torch.ops.fused_decode import (
        compare_with_reference,
        decode_inputs,
        fused_greedy_decode_reference,
        make_whole_fused_greedy_decoder,
    )
    from masters_thesis_tpu_torch.serve import Captioner

    store, layout = bundle["store"], bundle["model"].encoder.layout
    # a key's pairs share its row: one pair of each key
    _, first = np.unique(out["keys"], return_index=True)
    pick = np.sort(first)[:SERVED_ROWS]
    keys = out["keys"][pick]
    idx = torch.as_tensor(store.indices_for(keys), device=store.device)
    rows = store.device_array().index_select(0, idx.long()).float()
    if bundle["model"].encoder.pregathered:
        rows = raw_rows(rows, layout)
    cap = Captioner.from_run_dir(run_path, best=False, device=device)
    start_id = bundle["tokenizer"].start_id
    served = cap.caption_ids(rows.cpu().numpy())
    decode = make_whole_fused_greedy_decoder(cap.model, cap.max_length)
    words, alphas = decode(rows, start_id)
    if not np.array_equal(served, words.cpu().numpy()):
        raise RuntimeError("Captioner.caption_ids and its decoder disagree "
                           "on the same rows")
    want_words = torch.as_tensor(out["words"][pick], device=device)
    want_alphas = torch.as_tensor(np.load(
        Path(run_path) / f"attention_scores_{out['epoch']}.npy")[pick],
        device=device)
    with torch.inference_mode():
        _, _, margins = fused_greedy_decode_reference(
            *decode_inputs(cap.model, rows, start_id),
            max_length=cap.max_length, return_margins=True)
    report = compare_with_reference(words, alphas, want_words, want_alphas,
                                    margins, alpha_atol=ALPHA_ATOL,
                                    tie_margin=TIE_MARGIN)
    if report["bad_rows"]:
        raise RuntimeError(f"from_run_dir differs from run_eval on test rows "
                           f"{report['bad_rows']}: {report}")
    spread = float((alphas[:, 0] - alphas[:1, 0]).abs().max())
    if not spread > ALPHA_ATOL:
        raise RuntimeError(f"the alphas of {len(keys)} different rows agree "
                           f"within {spread}: the check cannot see the rows")
    wrong = compare_with_reference(*decode(rows.roll(1, dims=1), start_id),
                                   want_words, want_alphas, margins,
                                   alpha_atol=ALPHA_ATOL,
                                   tie_margin=TIE_MARGIN)
    if len(wrong["bad_rows"]) != len(keys):
        raise RuntimeError(f"rows in a wrong voxel order passed the "
                           f"from_run_dir check: {wrong}")
    print(f"Captioner.from_run_dir on {len(keys)} raw test rows: run_eval's "
          f"words ({len(set(map(bytes, served)))} distinct captions), "
          f"{report['near_tie_rows']} rows apart at near-ties; alphas within "
          f"{report['max_abs_err']:.3g} of attention_scores_{out['epoch']}"
          f".npy (tolerance {ALPHA_ATOL:g}; step-0 spread across rows "
          f"{spread:.3g}); the rows rolled by one voxel fail on all "
          f"{len(wrong['bad_rows'])} (max alpha error "
          f"{wrong['max_abs_err']:.3g}) [{card}]")


def experiment_phase(device, card: str) -> dict:
    """The training product at flagship width: ``run_training`` of
    ``configs/flagship_synth.yaml`` (EXPERIMENT_EPOCHS epochs, caption
    metrics every epoch, scanned steps from the pregathered store through
    K1), ``run_eval`` (K2), ``run_metrics``, a restore on the card and
    ``from_run_dir``. Returns K1's and K2's launches on this path."""
    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    cfg = Config.load(EXPERIMENT_CONFIG)
    with tempfile.TemporaryDirectory(prefix="mtt_run_") as log:
        cfg.log = log
        cfg.epochs = EXPERIMENT_EPOCHS
        cfg.caption_metrics_every = 1
        gather_rows.launches = 0
        fd.fused_greedy_decode.launches = 0
        t0 = time.perf_counter()
        run_path, logs, bundle = experiment.run_training(
            cfg, smoke_keys=EXPERIMENT_KEYS, device=device)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        k1, k2_train = gather_rows.launches, fd.fused_greedy_decode.launches
        steps = len(bundle["pairs"]["train"]) // cfg.batch_size
        val_batches = len(bundle["pairs"]["val"]) // cfg.batch_size
        epochs = [json.loads(line) for line in
                  open(Path(run_path) / "metrics.jsonl")]
        losses = [r["loss"] for r in epochs if r["kind"] == "epoch"]
        meta = json.loads((Path(run_path) / "run_meta.json").read_text())
        print(f"experiment: {EXPERIMENT_CONFIG.name}, {EXPERIMENT_KEYS} keys, "
              f"{EXPERIMENT_EPOCHS} epochs, run_training {run_s:.2f} s (data, "
              f"store, fit), fit {meta['train_wall_s']} s; backend "
              f"{meta['backend']} [{card}]")
        for r in epochs:
            if r["kind"] == "epoch":
                print(f"  epoch {int(r['epoch'])}: loss {r['loss']}, "
                      f"val_loss {r['val_loss']}, {r['steps_per_sec']} "
                      f"steps/s, epoch {r['epoch_time']} s [{card}]")
            else:
                print(f"  caption metrics epoch {int(r['epoch'])}: "
                      f"val BLEU-1 {r['val_bleu1']}, BLEU-4 {r['val_bleu4']}, "
                      f"CIDEr {r['val_cider']} ({int(r['n_captions'])} "
                      f"captions)")
        print(f"  run_meta.json: steps_per_sec_final_epoch "
              f"{meta['steps_per_sec_final_epoch']}, steps_per_sec_median "
              f"{meta.get('steps_per_sec_median')}, epochs_ran "
              f"{meta['epochs_ran']} [{card}]")
        for t in bundle["manager"].timings:
            print(f"  checkpoint epoch {t['epoch']}: save blocked "
                  f"{t['blocked_ms']:.1f} ms, committed after "
                  f"{t['commit_ms']:.1f} ms, {t['bytes']} bytes (parameters, "
                  f"BatchNorm statistics, Adam mu and nu) [{card}]")
        train_batches = EXPERIMENT_EPOCHS * (steps + val_batches)
        if k1 < train_batches:
            raise RuntimeError(f"K1 launched {k1} times in run_training, for "
                               f"{train_batches} train and val batches")
        if len(losses) != EXPERIMENT_EPOCHS or not losses[1] < losses[0]:
            raise RuntimeError(f"the epoch losses did not fall: {losses}")

        fd.fused_greedy_decode.launches = 0
        t0 = time.perf_counter()
        out = experiment.run_eval(bundle, run_path)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        k2 = fd.fused_greedy_decode.launches
        n = len(out["texts"])
        test_batches = -(-n // min(cfg.batch_size, n))
        print(f"run_eval: {n} test captions in {eval_s:.3f} s, "
              f"{n / eval_s:.1f} captions/s (host clock, K2 in "
              f"{test_batches} batches) [{card}]")
        if k2 < test_batches:
            raise RuntimeError(f"K2 launched {k2} times for {test_batches} "
                               f"test batches")
        t0 = time.perf_counter()
        scores = experiment.run_metrics(bundle, out)
        missing = set(JAX_METRIC_KEYS) - set(scores)
        print(f"run_metrics in {time.perf_counter() - t0:.2f} s: "
              + ", ".join(f"{k} {scores[k]}" for k in
                          ("Bleu_4", "CIDEr", "METEOR_lite") if k in scores))
        if missing:
            raise RuntimeError(f"run_metrics lacks {sorted(missing)}")
        check_restore(bundle, device, card)
        check_served(run_path, bundle, out, device, card)
        files = sorted(str(p.relative_to(run_path))
                       for p in Path(run_path).rglob("*") if p.is_file())
        print(f"run directory: {', '.join(files)}")
        del bundle
    print(f"K1 launches in run_training: {k1} (train and val batches "
          f"{train_batches}); K2 launches in run_training {k2_train}, in "
          f"run_eval {k2}")
    return {"K1": k1, "K2": k2_train + k2}


# ---- the other model families ----

def glove_table(vocab: int, dim: int) -> np.ndarray:
    """A seeded stand-in for a GloVe table (there is no download): N(0,
    0.05), the spread of the trained embedding's initialiser."""
    return np.random.default_rng(SEED).normal(0.0, 0.05, (vocab, dim)).astype(
        np.float32)


def first_end(words: torch.Tensor, end_id: int) -> torch.Tensor:
    """(B,) the step of each row's first ``<end>`` from the second step on,
    else the last step."""
    T = words.shape[1]
    hit = words == end_id
    hit[:, 0] = False
    steps = torch.arange(T, device=words.device).expand_as(words)
    return torch.where(hit, steps, T - 1).amin(dim=1)


def held_to(words, want, margins, stop, what: str, card: str) -> int:
    """``words`` equal ``want`` on every row up to its ``stop`` step, but on
    rows whose ``margins`` (B,) make them near-ties; returns their count."""
    steps = torch.arange(words.shape[1], device=words.device)
    upto = steps[None, :] <= stop[:, None]
    differs = ((words != want) & upto).any(dim=1)
    near_tie = margins < TIE_MARGIN
    bad = (differs & ~near_tie).nonzero().flatten().tolist()
    print(f"{what}: {int((~differs).sum())}/{len(words)} rows identical, "
          f"{int((differs & near_tie).sum())} apart at near-ties, near-tie "
          f"rows {int(near_tie.sum())} (margin < {TIE_MARGIN}) [{card}]")
    if bad:
        raise RuntimeError(f"{what}: rows {bad} differ at no near-tie")
    return int(near_tie.sum())


@torch.inference_mode()
def check_decoders(device, tok, card: str) -> dict:
    """Beam and sampling on the flagship LcNIC: beam-1 is K2's greedy
    decode up to ``<end>``, the sampler from the top 1 is K2's greedy
    decode, the beam of SERVE_BEAM in fp32 is the same beam in float64,
    near-ties excepted and counted; then each decoder's captions/s through
    Captioner on THROUGHPUT_ROWS host rows."""
    import copy

    from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
    from masters_thesis_tpu_torch.decode.sampling import (
        make_sampling_decoder,
    )
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    model = flagship_model(device)
    T, start, end = model.max_length, tok.start_id, tok.end_id
    rows = torch.randn(BATCH, N_VOXELS, device=device,
                       generator=torch.Generator(device=device)
                       .manual_seed(SEED + 1))
    greedy, _ = fd.make_whole_fused_greedy_decoder(model, T)(rows, start)
    _, _, margins = fd.fused_greedy_decode_reference(
        *fd.decode_inputs(model, rows, start), max_length=T,
        return_margins=True)
    greedy_margin = margins.amin(dim=1)
    stop = first_end(greedy, end)
    beam1 = make_beam_decoder(model, T, beam_width=1)(rows, start, end)[0]
    ties = {"beam-1": held_to(beam1, greedy, greedy_margin, stop,
                              "beam-1 vs K2's greedy words up to <end>",
                              card)}
    top1 = make_sampling_decoder(model, T, top_k=1)(
        rows, start, torch.Generator(device=device).manual_seed(SEED))
    ties["sample top-1"] = held_to(
        top1, greedy, greedy_margin, torch.full_like(stop, T - 1),
        "sample (top_k 1) vs K2's greedy words", card)
    beam = make_beam_decoder(model, T, beam_width=SERVE_BEAM)(rows, start,
                                                             end)
    wide = copy.deepcopy(model).double()
    beam64 = make_beam_decoder(wide, T, beam_width=SERVE_BEAM,
                               return_margins=True)(rows.double(), start, end)
    del wide
    ties[f"beam-{SERVE_BEAM}"] = held_to(
        beam[0], beam64[0], beam64[5], torch.full_like(stop, T - 1),
        f"beam-{SERVE_BEAM} in fp32 vs in float64 on the card", card)
    if len(torch.unique(beam[0])) < MIN_DISTINCT_WORDS:
        raise RuntimeError("the beam's words are degenerate")

    captioner = Captioner(model, tok, model.units, T, batch_size=BATCH,
                          device=device, beam_width=SERVE_BEAM)
    host = np.random.default_rng(SEED).standard_normal(
        (THROUGHPUT_ROWS, N_VOXELS), dtype=np.float32)
    rates = {f"beam-{SERVE_BEAM}": throughput(
        captioner, host, card, label=f"width {SERVE_BEAM} ", decoder="beam"),
        "sample": throughput(captioner, host, card, decoder="sample")}
    return {"near_ties": ties, "captions_per_s": rates}


def family_batches(n_train: int, n_val: int, cfg, subject_split: bool) -> int:
    """The train and val batches of an epoch of run_training on ``n_train``
    and ``n_val`` pairs (an ms2_nic run's pseudo-subjects alternate, and
    each of its batches takes half of them from each)."""
    bs = min(cfg.batch_size, max(2, n_train // 2))
    if not subject_split:
        return n_train // bs + n_val // bs
    half = (bs - bs % 2) // 2
    return sum((n // 2) // half for n in (n_train, n_val))


def family_run(label: str, config: str, overrides: dict, log: str,
               device, card: str) -> dict:
    """run_training of one family for FAMILY_EPOCHS epochs at FAMILY_KEYS
    keys, then run_eval greedy and beam; returns its launches and times."""
    import dataclasses

    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.models.nic import NIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    cfg = Config.load(CONFIG_DIR / config)
    overrides = dict(overrides)
    if overrides.pop("glove", False):
        path = Path(log) / "glove.npy"
        np.save(path, glove_table(cfg.vocab_size, cfg.embedding_text))
        overrides.update(glove_path=str(path), glove_trainable=False)
    cfg = dataclasses.replace(cfg, log=log, epochs=FAMILY_EPOCHS,
                              run=label.replace(" ", "_"), **overrides)
    kernels = (gather_rows, fd.fused_greedy_decode,
               fd.fused_greedy_decode_gru)
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    run_path, _, bundle = experiment.run_training(
        cfg, smoke_keys=FAMILY_KEYS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1 = gather_rows.launches - before[0]
    model, tok, pairs = bundle["model"], bundle["tokenizer"], bundle["pairs"]
    epochs = [r for r in map(json.loads, open(
        Path(run_path) / "metrics.jsonl")) if r["kind"] == "epoch"]
    losses = [r["loss"] for r in epochs]
    # the val loss carries no dropout noise: at the SGD rate of 1e-2 of
    # think_and_tell_pca.yaml an epoch moves the train loss by ~1e-4, less
    # than its dropout noise (the JAX package's runs alike)
    val_losses = [r["val_loss"] for r in epochs]
    split = cfg.model == "ms2_nic"
    batches = FAMILY_EPOCHS * family_batches(len(pairs["train"]),
                                             len(pairs["val"]), cfg, split)
    nic = isinstance(model, NIC)
    kernel = fd.decode_kernel(model)[0] if nic else None
    steps = []
    if not nic:
        # the step loop: count the decode steps it takes
        def counted(*args, _step=model.decode_step):
            steps.append(1)
            return _step(*args)
        model.decode_step = counted
    k23 = kernel.launches if nic else 0
    t0 = time.perf_counter()
    out = experiment.run_eval(bundle, run_path)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    k23 = (kernel.launches - k23) if nic else 0
    loop_steps = len(steps)
    t0 = time.perf_counter()
    beam = experiment.run_eval(bundle, run_path, decoder="beam",
                               beam_width=FAMILY_BEAM)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    if not nic:
        del model.decode_step
    n = len(out["texts"])
    test_batches = -(-n // min(cfg.batch_size, n))
    attn = np.load(Path(run_path) / f"attention_scores_{beam['epoch']}.npy")
    T = cfg.max_length
    print(f"family {label} ({config}, model {cfg.model}, row "
          f"{bundle['store'].row_shape}): run_training {train_s:.2f} s, "
          f"losses {[round(x, 5) for x in losses]}, val losses "
          f"{[round(x, 5) for x in val_losses]}, K1 {k1} (train and val "
          f"batches {batches}); run_eval greedy {greedy_s:.2f} s "
          + (f"({kernel.__name__} {k23} for {test_batches} test batches)"
             if nic else f"(step loop, {loop_steps} decode steps for "
             f"{test_batches} test batches of {T} steps)")
          + f", beam-{FAMILY_BEAM} {beam_s:.2f} s; {n} test captions, "
          f"e.g. {out['texts'][0]!r} [{card}]")
    if len(val_losses) != FAMILY_EPOCHS or not val_losses[-1] < val_losses[0]:
        raise RuntimeError(f"{label}: the epoch val losses did not fall: "
                           f"{val_losses}")
    if k1 < batches:
        raise RuntimeError(f"{label}: K1 launched {k1} times for {batches} "
                           f"train and val batches")
    if nic and k23 < test_batches:
        raise RuntimeError(f"{label}: {kernel.__name__} launched {k23} times "
                           f"for {test_batches} greedy test batches")
    if not nic and loop_steps < test_batches * T:
        raise RuntimeError(f"{label}: the step loop took {loop_steps} steps "
                           f"for {test_batches} batches of {T}")
    if (beam["words"].shape != out["words"].shape
            or attn.shape[:2] != out["words"].shape
            or not np.isfinite(attn).all()):
        raise RuntimeError(f"{label}: the beam's words {beam['words'].shape} "
                           f"or attention {attn.shape} are malformed")
    del bundle, model
    release()
    return {"K1": k1, "K2/K3": k23, "seconds": train_s + greedy_s + beam_s}


def families(device, tok, card: str) -> dict:
    """The families phase: K2 on the NIC variants and K3 on a learned-init
    CnnRnn against their plain versions (and float64), the beam and the
    sampler on the flagship LcNIC, then every family's run_training with
    the launch counts set to 0 just before and read just after. Returns
    K1's, K2's and K3's launches there, the variants' errors, the near-tie
    counts and the decoders' captions/s."""
    from masters_thesis_tpu_torch.models.nic import CnnRnnNIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    betas = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    frozen = dict(pretrained_embedding=glove_table(
        WIDTHS["vocab_size"], WIDTHS["embedding_text"]),
        embedding_trainable=False)
    errs = {"K2": [], "K3": []}
    for label, variant in (
            ("learned initial carry", dict(learned_init_state=True)),
            ("frozen GloVe", frozen),
            (f"frozen GloVe, vocab {PADDED_VOCAB} over true "
             f"{WIDTHS['vocab_size']}",
             dict(frozen, vocab_size=PADDED_VOCAB,
                  true_vocab=WIDTHS["vocab_size"]))):
        model = flagship_model(device, **variant)
        errs["K2"].append(check_kernel(model, betas, card, f"K2 ({label})",
                                       timed=False)["max_abs_err"])
        del model
        release()
    gen_m = torch.Generator().manual_seed(SEED)
    model = CnnRnnNIC(generator=gen_m, learned_init_state=True,
                      **CNN_RNN_WIDTHS)
    fd.spread_for_check(model, gen_m)
    model = model.to(device).eval()
    rows = torch.randn(BATCH, *model.encoder.row_shape, generator=gen,
                       device=device)
    for zero_state in (True, False):
        model.gru_zero_state = zero_state
        errs["K3"].append(check_kernel(
            model, rows, card, f"K3 (learned initial carry, zero state "
            f"{zero_state})", timed=False)["max_abs_err"])
    del model, rows, betas
    release()
    decoders = check_decoders(device, tok, card)
    release()

    runs = {}
    kernels = (gather_rows, fd.fused_greedy_decode,
               fd.fused_greedy_decode_gru)
    for k in kernels:
        k.launches = 0
    t_runs = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_families_") as log:
        for label, config, overrides in FAMILY_RUNS:
            runs[label] = family_run(label, config, overrides, log, device,
                                     card)
    launches = {k.__name__: k.launches for k in kernels}
    runs_s = time.perf_counter() - t_runs
    print(f"families: {len(runs)} runs in {runs_s:.1f} s, the phase in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches} "
          f"[{card}]")
    return {"launches": launches, "errors": errs, **decoders}


# the ingest phase: a subject's NSD session files at full width (2 of its
# 40 sessions, 1,200 of its 10,000 keys) -> preprocess -> LcNIC and
# ThinkAndTell trained and captioning; the ThinkAndTell PCA at its reference
# shape; CNN features at the backbones' published resolutions -> packs ->
# cnn_rnn and img_nic trained
HEMI_VERTICES = N_VOXELS // 2
INGEST_SESSIONS, INGEST_TRIALS = 2, 750
INGEST_UNIQUE, INGEST_SHARED, INGEST_TEST = 1_000, 200, 100
VISUAL_VERTICES = 62_756            # the reference's visual-cortex mask
VISUAL_PARCELS = 30                 # labels 1..30 of each hemisphere
ATLAS_LABELS = 180
INGEST_PCA = 512
INGEST_EPOCHS = 1
PRE_TRANSFORM_ROWS = 64             # raw test rows through --pre serving
PRE_LOGIT_RTOL = 1e-4               # of the largest |logit| of the decode
PCA_REF = (27_000, VISUAL_VERTICES, 5_000)     # ThinkAndTell SVD/svd.py
PCA_CHECK = (2_000, 256)            # card against CPU, one test matrix
PCA_ATOL, ORTHO_ATOL = 1e-4, 1e-4
FEATURE_IMAGES, FEATURE_CHECK, FEATURE_BATCH = 256, 8, 64
FEATURE_TRAIN, FEATURE_SHARED, FEATURE_TEST = 200, 56, 28
FEATURE_RTOL = 1e-4                 # of the largest |feature|
# (backbone, published resolution, head of the features command)
BACKBONES = (("vgg16", 224, "fc2"), ("resnet50", 224, "pooled"),
             ("inception_v3", 299, "patches"),
             ("efficientnet_b3", 300, "pooled"))


def val_loss_at_start():
    """A callback that runs the validation pass once before training, so
    that a one-epoch run can show its val loss fall; ``.loss`` holds it, and
    ``.k1`` K1's count just after it, where the epoch's batches start."""
    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.train.loop import Callback

    class ValLossAtStart(Callback):
        loss = k1 = None

        def on_train_begin(self, trainer) -> None:
            self.loss = float(trainer._run_validation()["loss"])
            self.k1 = gather_rows.launches

    return ValLossAtStart()


@contextlib.contextmanager
def uncounted():
    """The launches made inside are checks of a kernel against its plain
    version, not the main path's: K1's, K2's and K3's counts are put back
    on leaving as they were on entering."""
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    kernels = (gather_rows, fd.fused_greedy_decode,
               fd.fused_greedy_decode_gru)
    before = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, n in zip(kernels, before):
            k.launches = n


def check_ingest_kernels(label: str, bundle, device, card: str) -> tuple:
    """K1 against its plain version on the run's uploaded store; for a NIC,
    its decode kernel (K2 or K3) against its plain version (and float64) on
    BATCH of the store's rows, the run's test keys first (patch rows with
    each column standardised over them), on a copy of the trained model whose weights
    ``spread_for_check`` spreads, so that the greedy words vary. Returns
    the errors by kernel and K1's timing on the store (``check_gather``'s
    ``stores``)."""
    import copy

    from masters_thesis_tpu_torch.models.nic import NIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    store, model = bundle["store"], bundle["model"]
    k1 = check_gather(store, card)
    errs = {"K1": k1["max_abs_err"]}
    if not isinstance(model, NIC):
        return errs, k1["stores"]
    test = list(dict.fromkeys(int(p[0]) for p in bundle["pairs"]["test"]))
    seen = set(test)
    keys = (test + [int(k) for k in store.keys if int(k) not in seen])[:BATCH]
    idx = torch.as_tensor(store.indices_for(keys), dtype=torch.long,
                          device=device)
    rows = store.device_array().index_select(0, idx)
    if len(store.row_shape) > 1:
        # a random-init backbone's features are ~1e-4 and alike from image
        # to image, and any decode of them settles on a few words: each
        # column is standardised over the rows, which keeps the path's
        # shapes and lets the images' and the patches' differences reach
        # the words (the betas are N(0, 1) already)
        rows = (rows - rows.mean(0)) / rows.std(0).clamp_min(1e-12)
    spread = copy.deepcopy(model)
    fd.spread_for_check(spread, torch.Generator().manual_seed(SEED))
    name = "K3" if model.cell_type == "gru" else "K2"
    errs[name] = check_kernel(
        spread.eval(), rows, card, f"{name} on the ingest {label} run's "
        f"store rows ({len(test)} test keys first), weights spread",
        timed=False)["max_abs_err"]
    del spread, rows
    return errs, k1["stores"]


def write_split(nsd: Path, unique, shared, test) -> None:
    nsd.mkdir(parents=True, exist_ok=True)
    (nsd / "subj01_conditions.csv").write_text(
        "nsd_key,is_shared\n" + "".join(f"{k},0\n" for k in unique)
        + "".join(f"{k},1\n" for k in shared))
    (nsd / "test_conditions.csv").write_text(
        "nsd_key\n" + "".join(f"{k}\n" for k in test))


def write_ingest_fixture(root: Path, device) -> dict:
    """A subject's session files in the real formats: session 1 as .npy and
    session 2 as .mgh, each hemisphere (163,842, 750) fp32 drawn on the card;
    every key once and 300 keys twice; the behavior CSV, the captions JSON,
    the split CSVs and a 2 x 180-label atlas whose labels 1..30 cover
    62,756 vertices."""
    from masters_thesis_tpu_torch.data.preprocess.mgh import write_mgh
    from masters_thesis_tpu_torch.data.synthetic import synthetic_captions

    rng = np.random.default_rng(SEED)
    sessions, nsd = root / "sessions", root / "nsd"
    sessions.mkdir()
    unique = list(range(1, INGEST_UNIQUE + 1))
    shared = list(range(INGEST_UNIQUE + 1,
                        INGEST_UNIQUE + INGEST_SHARED + 1))
    keys = unique + shared
    n_trials = INGEST_SESSIONS * INGEST_TRIALS
    schedule = np.concatenate([keys, rng.choice(keys, n_trials - len(keys),
                                                replace=False)])
    rng.shuffle(schedule)
    gen = torch.Generator(device=device).manual_seed(SEED)
    lines = ["SUBJECT,SESSION,RUN,TRIAL,73KID"]
    for s in range(1, INGEST_SESSIONS + 1):
        for hemi in ("lh", "rh"):
            arr = torch.randn(HEMI_VERTICES, INGEST_TRIALS, generator=gen,
                              device=device).cpu().numpy()
            path = sessions / f"{hemi}.betas_session{s:02d}"
            if s % 2:
                np.save(f"{path}.npy", arr)
            else:
                write_mgh(f"{path}.mgh", arr)
            del arr
        for t in range(INGEST_TRIALS):
            lines.append(f"1,{s},{1 + t // 75},{1 + t % 75},"
                         f"{schedule[(s - 1) * INGEST_TRIALS + t]}")
    (root / "behavior.csv").write_text("\n".join(lines) + "\n")
    (root / "captions.json").write_text(json.dumps(
        {str(k): v for k, v in synthetic_captions(keys, seed=SEED).items()}))
    write_split(nsd, unique, shared, shared[:INGEST_TEST])
    per_hemi = VISUAL_VERTICES // 2
    for hemi in ("lh", "rh"):
        labels = np.empty(HEMI_VERTICES, np.int32)
        order = rng.permutation(HEMI_VERTICES)
        labels[order[:per_hemi]] = 1 + np.arange(per_hemi) % VISUAL_PARCELS
        rest = HEMI_VERTICES - per_hemi
        labels[order[per_hemi:]] = (VISUAL_PARCELS + 1 + np.arange(rest)
                                    % (ATLAS_LABELS - VISUAL_PARCELS + 1))
        labels[labels > ATLAS_LABELS] = 0      # unlabelled vertices
        np.save(nsd / f"glasser_{hemi}.npy", labels)
    return {"sessions": sessions, "nsd": nsd, "keys": keys,
            "test": shared[:INGEST_TEST], "repeats": n_trials - len(keys)}


def ingest_config(name: str, log: str, **dataset):
    import dataclasses

    from masters_thesis_tpu_torch.config import Config

    cfg = Config.load(CONFIG_DIR / name)
    cfg = dataclasses.replace(cfg, log=log, epochs=INGEST_EPOCHS)
    for key, value in dataset.items():
        setattr(cfg.dataset, key, str(value))
    return cfg


def ingest_run(label: str, cfg, device, card: str) -> dict:
    """run_training of ``cfg`` on the card, then run_eval greedy; fails
    unless K1 ran on every train and val batch of the epoch, the greedy
    decode kernel (or ShowTell's step loop) on every test batch, and the val
    loss fell from before training; then ``check_ingest_kernels``, its
    launches not counted. Returns the bundle, run path, eval output, the
    checks' errors and K1's timing on the run's store."""
    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.models.nic import NIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    start = val_loss_at_start()
    t0 = time.perf_counter()
    run_path, logs, bundle = experiment.run_training(
        cfg, device=device, extra_callbacks=(start,))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1 = gather_rows.launches - start.k1
    model, pairs = bundle["model"], bundle["pairs"]
    batches = INGEST_EPOCHS * family_batches(len(pairs["train"]),
                                             len(pairs["val"]), cfg, False)
    nic = isinstance(model, NIC)
    kernel = fd.decode_kernel(model)[0] if nic else None
    k23 = kernel.launches if nic else 0
    t0 = time.perf_counter()
    out = experiment.run_eval(bundle, run_path)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    k23 = kernel.launches - k23 if nic else 0
    n = len(out["texts"])
    test_batches = -(-n // min(cfg.batch_size, n))
    store = bundle["store"]
    print(f"ingest {label} ({cfg.model}, store {len(store)} x "
          f"{store.row_shape}): run_training {train_s:.2f} s, "
          f"{logs['steps_per_sec']:.2f} steps/s, val loss {start.loss:.5f} "
          f"-> {logs['val_loss']:.5f}; K1 {k1} after the val pass before "
          f"training (the epoch's train and val batches {batches}); run_eval greedy {eval_s:.2f} s, "
          + (f"{kernel.__name__} {k23} for {test_batches} test batches"
             if nic else "step loop")
          + f"; {n} test captions, {len(set(out['texts']))} distinct, e.g. "
          f"{out['texts'][0]!r} [{card}]")
    if not logs["val_loss"] < start.loss:
        raise RuntimeError(f"ingest {label}: the val loss did not fall: "
                           f"{start.loss} -> {logs['val_loss']}")
    if k1 < batches:
        raise RuntimeError(f"ingest {label}: K1 launched {k1} times for "
                           f"{batches} train and val batches")
    if nic and k23 < test_batches:
        raise RuntimeError(f"ingest {label}: {kernel.__name__} launched "
                           f"{k23} times for {test_batches} test batches")
    with uncounted():
        errs, k1_stores = check_ingest_kernels(label, bundle, device, card)
    return {"bundle": bundle, "run_path": run_path, "out": out,
            "errors": errs, "k1_stores": k1_stores}


def check_upload(pack_dir: Path, device, card: str) -> None:
    """The pack's rows to the card in blocks through the pinned staging
    buffer, against a whole copy bit for bit; both rates."""
    from masters_thesis_tpu_torch.data.pack import open_pack
    from masters_thesis_tpu_torch.data.store import upload_rows

    mm = open_pack(str(pack_dir)).data
    gb = mm.nbytes / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = upload_rows(mm, device)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = torch.from_numpy(np.array(mm)).to(device)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    same = torch.equal(got, whole.reshape(got.shape))
    print(f"pack upload: {mm.shape[0]} x {mm.shape[1]} fp32, {gb:.3f} GB in "
          f"{block_s:.3f} s by blocks ({gb / block_s:.2f} GB/s; a whole "
          f"host copy and .to: {whole_s:.3f} s, {gb / whole_s:.2f} GB/s); "
          f"bit for bit: {same} [{card}]")
    if not same:
        raise RuntimeError("the block upload differs from a whole copy")
    del got, whole


def check_pre_transform(pre: Path, run_path: str, device, card: str) -> None:
    """``PreTransformCaptioner`` on raw test rows gives the words the run's
    own captioner gives on the PCA pack's rows of the same keys; and the
    host chain's rows hold the greedy decode to the pack rows' decode by its
    logits, which vary where the words of a one-epoch ThinkAndTell do not:
    within PRE_LOGIT_RTOL of the largest, up to a row's first word apart at
    a near-tie. The pack's rows of other keys must fail that check on every
    row, or the check could not tell the rows apart."""
    from masters_thesis_tpu_torch.data.pack import open_pack
    from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
    from masters_thesis_tpu_torch.experiment import apply_preprocess_chain
    from masters_thesis_tpu_torch.ops.fused_decode import (
        compare_with_reference,
    )
    from masters_thesis_tpu_torch.serve import (
        Captioner,
        PreTransformCaptioner,
    )

    raw, pca = (open_pack(str(pre / name))
                for name in ("betas_pack", "betas_pack_pca"))
    keys = pca.keys[-PRE_TRANSFORM_ROWS:]
    raw_rows = raw.gather_host(raw.indices_for(keys))
    pca_rows = pca.gather_host(pca.indices_for(keys))
    inner = Captioner.from_run_dir(run_path, device=device)
    outer = PreTransformCaptioner(inner, str(pre))
    t0 = time.perf_counter()
    got = outer.caption(raw_rows)
    wrapped_s = time.perf_counter() - t0
    want = inner.caption(pca_rows)
    replay = apply_preprocess_chain(str(pre), raw_rows)
    err = float(np.abs(replay - pca_rows).max() / np.abs(pca_rows).max())
    apart = sum(a != b for a, b in zip(got, want))

    greedy = make_greedy_decoder(inner.model, inner.max_length)
    start = inner.tokenizer.start_id

    def decode(rows):
        words, logits, _ = greedy(torch.from_numpy(
            np.ascontiguousarray(rows, np.float32)).to(device), start)
        return words, logits

    ref_words, ref_logits = decode(pca_rows)
    top2 = ref_logits.topk(2, dim=-1).values
    margins = top2[..., 0] - top2[..., 1]
    atol = PRE_LOGIT_RTOL * float(ref_logits.abs().max())
    held, control = (compare_with_reference(
        *decode(rows), ref_words, ref_logits, margins, alpha_atol=atol,
        tie_margin=TIE_MARGIN) for rows in (replay, np.roll(pca_rows, 1, 0)))
    print(f"PreTransformCaptioner: {len(got)} raw {raw_rows.shape[1]}-wide "
          f"rows -> {pca_rows.shape[1]} in {wrapped_s:.2f} s; the host "
          f"chain's rows against the card's PCA pack: {err:.2e} of max; "
          f"{apart} rows' words apart from the pack rows' words, "
          f"{len(set(got))} distinct; the greedy decode's logits on the "
          f"chain's rows {held['max_abs_err']:.3e} from the pack rows' "
          f"(limit {atol:.3e}, {PRE_LOGIT_RTOL} of the largest), near-tie "
          f"rows {held['near_tie_rows']}; on other keys' pack rows "
          f"{control['max_abs_err']:.3e}, {len(control['bad_rows'])} of "
          f"{len(pca_rows)} rows fail [{card}]")
    if err > PCA_ATOL or apart or held["bad_rows"]:
        raise RuntimeError(f"--pre serving: rows {err:.2e} apart, "
                           f"{apart} captions differ, logits apart on rows "
                           f"{held['bad_rows']}")
    if len(control["bad_rows"]) < len(pca_rows):
        raise RuntimeError(f"--pre serving: the logits check passes "
                           f"{len(pca_rows) - len(control['bad_rows'])} rows "
                           f"of other keys")


def check_pca(device, card: str) -> dict:
    """fit_pca at ThinkAndTell's reference shape on rows made on the card
    (components orthonormal), timed; and at a reduced shape of separated
    spectrum, the card's fit against the port's CPU fit (one numpy test
    matrix), components up to sign within PCA_ATOL."""
    from masters_thesis_tpu_torch.data.preprocess.pca import fit_pca

    n, v, k = PCA_REF
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(n, v, generator=gen, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = fit_pca(x, k, device=device)          # centres x in place
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    del x
    comps = torch.from_numpy(model.components).to(device)
    ortho = float((comps @ comps.T - torch.eye(k, device=device)).abs()
                  .max())
    del comps
    release()
    print(f"PCA at the reference shape: {n} x {v} -> {k} (oversample 10, 4 "
          f"power iterations) in {fit_s:.2f} s, peak {peak:.2f} GB; "
          f"|C C^T - I| max {ortho:.2e} [{card}]")
    # rank k2 with singular values 100 - 0.25 i, well apart and above the
    # noise's ~0.25: each component is determined to fp32 rounding over
    # its gap (on random rows the spectrum is clustered, and the components
    # are not determined to 1e-4 on any device)
    n2, k2 = PCA_CHECK
    u = torch.linalg.qr(torch.randn(n2, k2, generator=gen, device=device))[0]
    w = torch.linalg.qr(torch.randn(v, k2, generator=gen, device=device))[0]
    spec = 100.0 - 0.25 * torch.arange(k2, device=device)
    x2 = (u * spec) @ w.T + 1e-3 * torch.randn(n2, v, generator=gen,
                                               device=device)
    del u, w
    want = fit_pca(x2.cpu(), k2, device="cpu")
    got = fit_pca(x2, k2, device=device)
    del x2
    sign = np.sign((got.components * want.components).sum(axis=1))
    err = float(np.abs(got.components * sign[:, None]
                       - want.components).max())
    ev = float(np.abs(got.explained_variance / want.explained_variance
                      - 1).max())
    print(f"PCA {n2} x {v} -> {k2}, card against CPU: components up to "
          f"sign {err:.2e}, explained variance {ev:.2e} relative [{card}]")
    if ortho > ORTHO_ATOL or err > PCA_ATOL or ev > PCA_ATOL:
        raise RuntimeError(f"PCA: orthonormality {ortho:.2e}, components "
                           f"{err:.2e}, variance {ev:.2e}")
    return {"fit_s": fit_s, "ortho": ortho, "err": err}


def check_features(root: Path, device, card: str) -> dict:
    """``features`` on FEATURE_IMAGES random images per backbone at its
    published resolution: the file's first FEATURE_CHECK rows against the
    same model's CPU forward, images/s of the card's forward and the
    seconds of one build of the model (its seeded initialisation on the
    host's CPU, as the command builds it). Returns the images files by
    backbone."""
    import argparse as _argparse

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.models.backbones import extract_features

    rng = np.random.default_rng(SEED)
    files = {}
    for name, res, head in BACKBONES:
        images = rng.integers(0, 256, (FEATURE_IMAGES, res, res, 3),
                              dtype=np.uint8)
        files[name] = root / f"images_{name}.npy"
        np.save(files[name], images)
        out = root / f"features_{name}.npy"
        t0 = time.perf_counter()
        with_stdout(cli.main, ["features", "--backbone", name, "--images",
                               str(files[name]), "--out", str(out),
                               "--batch-size", str(FEATURE_BATCH),
                               "--device", str(device)])
        torch.cuda.synchronize()
        command_s = time.perf_counter() - t0
        feats = np.load(out)
        args = _argparse.Namespace(backbone=name, head=head)
        t0 = time.perf_counter()
        model, _, prep = cli._backbone_for(
            args, (res, res), torch.Generator().manual_seed(0))
        build_s = time.perf_counter() - t0
        x = prep(images)
        with torch.no_grad():
            want = model.eval()(torch.from_numpy(
                np.ascontiguousarray(x[:FEATURE_CHECK])))[head].numpy()
        err = float(np.abs(feats[:FEATURE_CHECK] - want).max()
                    / np.abs(want).max())
        model = model.to(device)
        extract_features(model, x[:FEATURE_BATCH], FEATURE_BATCH, head)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_features(model, x, FEATURE_BATCH, head)
        torch.cuda.synchronize()
        rate = FEATURE_IMAGES / (time.perf_counter() - t0)
        print(f"features {name} ({head} {feats.shape[1:]}, {res}x{res}): "
              f"{rate:.1f} images/s on the card (batch {FEATURE_BATCH}, "
              f"host preprocessed, copy and fetch included); the command "
              f"{command_s:.2f} s, of which a build of the model on the "
              f"host's CPU takes {build_s:.2f} s; rows against the CPU forward "
              f"{err:.2e} of max [{card}]")
        if not np.isfinite(feats).all() or err > FEATURE_RTOL:
            raise RuntimeError(f"features {name}: {err:.2e} of max apart "
                               f"from the CPU forward")
        del model, feats
        release()
    return files


def with_stdout(main, argv) -> dict:
    """Run a CLI ``main(argv)``, return its last-line JSON."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    if code != 0:
        raise RuntimeError(f"{argv[0]} exited {code}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def ingest(device, card: str) -> dict:
    """The ingest phase: NSD session files written at full width ->
    ``preprocess`` (sessions, pack, stats, vc mask, normalize, PCA on the
    card) -> the pack uploaded -> LcNIC (attempt_four.yaml) and
    ThinkAndTell (think_and_tell_pca.yaml) trained and captioning, the
    latter also through ``PreTransformCaptioner`` on raw rows; the PCA at
    its reference shape; ``features`` with every backbone, and the
    InceptionV3 and VGG16 conv5 packs training cnn_rnn and img_nic. K1's,
    K2's and K3's counts are set to 0 before the runs and read after; each
    run's checks of its kernels against their plain versions
    (``check_ingest_kernels``) take their own launches back out."""
    import shutil

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_ingest_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        fx = write_ingest_fixture(root, device)
        print(f"ingest fixture: {INGEST_SESSIONS} sessions x "
              f"{INGEST_TRIALS} trials x {2 * HEMI_VERTICES} vertices (.npy "
              f"and .mgh), {len(fx['keys'])} keys ({fx['repeats']} shown "
              f"twice), written in {time.perf_counter() - t0:.2f} s [{card}]")
        pre = root / "pre"
        yaml = root / "pre.yaml"
        ingest_config("attempt_four.yaml", str(root / "logs"),
                      nsd_dir=fx["nsd"]).save(yaml)
        report = with_stdout(cli.main, [
            "preprocess", "--config", str(yaml), "--out", str(pre),
            "--from-sessions", str(fx["sessions"]), "--behavior",
            str(root / "behavior.csv"), "--captions-json",
            str(root / "captions.json"), "--n-sessions",
            str(INGEST_SESSIONS), "--vc-parcels",
            ",".join(str(i) for i in range(1, VISUAL_PARCELS + 1)),
            "--normalize", "--pca", str(INGEST_PCA), "--device",
            str(device)])
        print("preprocess stages, s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in report["seconds"].items())
            + f"; {report['ingest']['trials']} trials -> "
            f"{report['pack']['n_rows']} rows, vc {report['vc']['n_vertices']}"
            f" vertices, PCA {report['pca']['components']} fitted on "
            f"{report['pca']['fit_on']} [{card}]")
        if (report["vc"]["n_vertices"] != VISUAL_VERTICES
                or report["pack"]["n_rows"] != len(fx["keys"])):
            raise RuntimeError(f"preprocess report {report}")
        # what training reads stays; the sessions and trial files go
        shutil.rmtree(fx["sessions"])
        shutil.rmtree(pre / "ingest" / "subj_1" / "betas")
        check_upload(pre / "betas_pack", device, card)
        captions = pre / "ingest" / "subj_1" / "captions"
        kernels = (gather_rows, fd.fused_greedy_decode,
                   fd.fused_greedy_decode_gru)
        errs = {"K1": [], "K2": [], "K3": []}
        k1_stores = []

        def run(label, cfg):
            out = ingest_run(label, cfg, device, card)
            for name, err in out.pop("errors").items():
                errs[name].append(err)
            k1_stores.extend(out["k1_stores"])
            return out["run_path"]

        for k in kernels:
            k.launches = 0
        run("LcNIC", ingest_config(
            "attempt_four.yaml", str(root / "logs"),
            betas_path=pre / "betas_pack", captions_path=captions,
            nsd_dir=fx["nsd"]))
        release()
        run_path = run("ThinkAndTell", ingest_config(
            "think_and_tell_pca.yaml", str(root / "logs"),
            betas_path=pre / "betas_pack_pca", captions_path=captions,
            nsd_dir=fx["nsd"]))
        release()
        check_pre_transform(pre, run_path, device, card)
        counts = {k.__name__: k.launches for k in kernels}
        release()
        pca = check_pca(device, card)
        release()
        files = check_features(root, device, card)
        fkeys = np.arange(1, FEATURE_IMAGES + 1, dtype=np.int64)
        np.save(root / "feature_keys.npy", fkeys)
        img_nsd = root / "img_nsd"
        shared = fkeys[FEATURE_TRAIN:].tolist()
        write_split(img_nsd, fkeys[:FEATURE_TRAIN].tolist(), shared,
                    shared[:FEATURE_TEST])
        for hemi in ("lh", "rh"):       # build_data reads the atlas always
            shutil.copy(fx["nsd"] / f"glasser_{hemi}.npy", img_nsd)
        for k in kernels:
            k.launches = 0
        for label, backbone, head, config, model in (
                ("cnn_rnn on InceptionV3 patches", "inception_v3", "patches",
                 "cnn_rnn.yaml", "cnn_rnn"),
                ("img_nic on VGG16 conv5", "vgg16", "conv5",
                 "flagship_synth.yaml", "img_nic")):
            pack = root / f"pack_{backbone}"
            out = with_stdout(cli.main, [
                "features", "--backbone", backbone, "--head", head,
                "--images", str(files[backbone]), "--keys",
                str(root / "feature_keys.npy"), "--pack", "--out",
                str(pack), "--batch-size", str(FEATURE_BATCH), "--device",
                str(device)])
            print(f"features --pack {backbone} {head}: {out['pack']}")
            cfg = ingest_config(config, str(root / "logs"), betas_path=pack,
                                captions_path=captions, nsd_dir=img_nsd)
            import dataclasses

            run(label, dataclasses.replace(cfg, model=model))
            release()
        for name, n in zip(counts, (k.launches for k in kernels)):
            counts[name] += n
    print(f"ingest: the phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}; the checks' largest errors "
          f"{ {k: max(v) for k, v in errs.items()} } [{card}]")
    return {"launches": counts, "errors": errs, "pca_fit_s": pca["fit_s"],
            "k1_stores": k1_stores}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="print tables of device time by kernel for one "
                        "served batch and for the scanned train steps")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    from masters_thesis_tpu_torch.data.pairs import clean_caption
    from masters_thesis_tpu_torch.data.synthetic import synthetic_captions
    from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
    from masters_thesis_tpu_torch.device import card_line
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line(device)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")

    build_kernels()
    model = flagship_model(device)
    enc_mb = sum(p.numel() * p.element_size()
                 for p in model.encoder.parameters()) / 1e6
    print(f"flagship LcNIC: {N_VOXELS} voxels in {N_GROUPS} groups, "
          f"{len(model.encoder.layout.buckets)} buckets, encoder "
          f"{enc_mb:.1f} MB fp32")

    gen = torch.Generator(device=device).manual_seed(SEED)
    betas = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    k2 = check_kernel(model, betas, card, "K2", profile=args.profile)

    # synthetic captions plus a made-up lexicon, so every id of the
    # vocabulary names a word and the served captions are not empty
    tok = Tokenizer(num_words=WIDTHS["vocab_size"])
    tok.fit_on_texts([clean_caption(c)
                      for lines in synthetic_captions(range(200)).values()
                      for c in lines]
                     + [" ".join(f"w{i}" for i in range(WIDTHS["vocab_size"]))])
    tok.install_pad()
    captioner = Captioner(model, tok, WIDTHS["units"], WIDTHS["max_length"],
                          batch_size=BATCH, device=device)
    rows = np.random.default_rng(SEED).standard_normal(
        (THROUGHPUT_ROWS, N_VOXELS), dtype=np.float32)

    fd.fused_greedy_decode.launches = 0
    served = serve(captioner, rows, card)
    launches = fd.fused_greedy_decode.launches
    print(f"K2 launches while serving: {launches}")
    if launches < 1:
        raise RuntimeError("serving never launched the decode kernel")
    if served != captioner.caption(rows[:len(served)]):
        raise RuntimeError("served captions differ from Captioner.caption "
                           "on the same rows")
    nonempty = sum(map(bool, served)) / len(served)
    print(f"served captions equal Captioner.caption on the same rows; "
          f"{nonempty:.1%} non-empty (floor {MIN_NONEMPTY_SHARE:.0%}), "
          f"{len(set(served))} distinct of {len(served)}, e.g. {served[-1]!r}")
    if nonempty < MIN_NONEMPTY_SHARE:
        raise RuntimeError(f"only {nonempty:.1%} of the served captions are "
                           f"non-empty")

    throughput(captioner, rows, card)
    if args.profile:
        device_time(lambda: captioner.caption(rows[:BATCH]),
                    "one served batch", table=True)
    del model, captioner, rows, betas
    release()

    k3 = cnn_rnn(device, tok, card, args.profile)
    release()

    k1, train_data = train(device, card, args.profile)
    k4 = fused_seq(train_data, device, card, args.profile)
    probes = gather_probe(train_data, device, card)
    del train_data
    release()
    product = experiment_phase(device, card)
    release()
    fam = families(device, tok, card)
    release()
    ingested = ingest(device, card)
    ing = ingested["launches"]
    release()
    k1["max_abs_err"] = max([k1["max_abs_err"], *ingested["errors"]["K1"]])
    k1["stores"] += ingested["k1_stores"]
    k2["max_abs_err"] = max([k2["max_abs_err"], *fam["errors"]["K2"],
                             *ingested["errors"]["K2"]])
    k3["max_abs_err"] = max([k3["max_abs_err"], *fam["errors"]["K3"],
                             *ingested["errors"]["K3"]])
    counts = fam["launches"]
    print(json.dumps({"kernels": [{
        "name": "fused_greedy_decode", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_decode.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:211",
        "launches": launches, "launches_experiment": product["K2"],
        "launches_families": counts["fused_greedy_decode"],
        "launches_ingest": ing["fused_greedy_decode"], **k2}, {
        "name": "fused_greedy_decode_gru", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_decode.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:276",
        "launches_families": counts["fused_greedy_decode_gru"],
        "launches_ingest": ing["fused_greedy_decode_gru"], **k3}, {
        "name": "gather_rows", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/gather.cu",
        "replaces": "masters_thesis_tpu/ops/gather.py:49",
        "launches_experiment": product["K1"],
        "launches_families": counts["gather_rows"],
        "launches_ingest": ing["gather_rows"], **k1}, {
        "name": "fused_seq_forward", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_seq.cu",
        "replaces": "masters_thesis_tpu/ops/fused_seq.py:204", **k4},
        *probes]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
