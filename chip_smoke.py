#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``masters_thesis_tpu_torch/csrc`` (one
``nvcc`` a source, in parallel), then drives fourteen paths, each at the full
width of its model or at its probe's own sizes:

- LcNIC serving: holds the LSTM whole-decode kernel (K2) against its plain
  PyTorch version (its words and alphas must have K2_DIGEST, PR 7's),
  serves three HTTP caption requests through the port's ``Captioner`` and
  caption server, and times the kernel, the plain version, the unfused
  greedy decoder and captions per second; then the bf16-weight K2 (the
  TPU kernel as the TPU runs it, ``feat_bf16`` off and on: one persistent
  cooperative launch a decode, ``csrc/decode_bf16.cu``) against its bf16
  plain version and that version summed in float64, a one-step decode
  within the fp32 limits and the whole decode within BF16_ALPHA_ATOL and
  BF16_TIE_MARGIN, which the fp32 decode must fail, two calls equal bit
  for bit, with the rows whose words differ from the fp32 kernel's and
  their fp32 margins, timed beside the fp32 K2; captions/s through
  ``Captioner(weights_bf16=True)`` as for the fp32 one, and three HTTP
  requests through it, which must launch it;
- CnnRnn serving (GRU, on (64, 2048) InceptionV3 patch rows): holds the GRU
  whole-decode kernel (K3) against its plain version for both values of
  ``gru_zero_state``, serves 256 host rows through ``Captioner`` and one
  ``.npy`` request through the server, and times K3, its plain version and
  captions per second; then the bf16-weight K3, both zero-state values, as
  the bf16 K2, with its captions/s and one request through
  ``Captioner(weights_bf16=True)``;
- the pixel CnnRnn's gather: holds K1 against its plain version on a store
  of 1,000 299 x 299 x 3 images (1.07 MB rows, K1's 4-byte-load plan),
  with repeated ids and ids out of range, and times it as below;
- the pixel CnnRnn's backbone: InceptionV3 with its BatchNorm folded into
  each convolution (64 images at 299, fp32 NCHW and TF32 channels-last),
  every layer equal bit for bit to its folded convolution with the bias
  and the ReLU as separate passes, and one fp32 forward's kernels, none
  of them a BatchNorm, ReLU or weight-copy pass;
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
  (with a K4 check there too), takes the bf16-weight K4's device time a
  step by part (h W2, attention, the cell) at both shapes by
  ``torch.profiler``, with the cell's TFLOP/s, holds three
  ``tpu.fused_seq`` train steps against the autograd steps, and trains one
  epoch with ``tpu.fused_seq``;
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
- the deploy phase, on that run directory: ``export`` greedy through the
  CLI on the card (``torch.export``; export wall s, artifact bytes, load
  s), its words on 256 raw test rows equal to the live unfused
  ``Captioner``'s bit for bit and to K2's but at near-ties (counted); the
  same on a copy of the run whose weights ``spread_for_check`` spreads (two
  epochs on random captions leave one caption for every row), and there
  exported beam-5 equal to the live beam-5; captions/s
  through ``ExportedCaptioner`` beside the live unfused ``Captioner`` and
  K2's; three HTTP requests through ``serve --export``; then, with the
  counts set to 0, ``run_training`` of ``configs/flagship_synth.yaml`` (1
  epoch at 256 keys) with ``tpu.profile_steps`` 5 and ``tpu.profile_trace``
  on, whose ``torch.profiler`` trace must name K1's and K2's kernels, whose
  ``profile.json`` must have the JAX keys and whose ``tb/events.captions``
  must hold the preview images (trace bytes, and the traced epoch's steps/s
  beside an untraced run's); ``device_memory_stats`` beside
  ``mem_get_info``; and the analysis functions that draw nothing on the run
  directory and on 1,200 x 327,684 rows, timed (``analyze`` itself draws
  with matplotlib, which the card's machine lacks, and is held to the JAX
  command on the CPU only). The ingest phase adds ``export --pre`` of its
  ThinkAndTell run: the artifact takes raw rows and gives the words of the
  host chain's replay and the live decode;
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
  ``img_nic`` on the VGG16 conv5 pack, K1, K2 and K3 counted as above;
- the sweep phase: the USE-DAN sentence encoder at the class's full width
  (embed 512, hidden 512 x 3, out 512) over a random 200,000-token bundle
  with 256 OOV buckets, its goldens from a CPU forward of 64 sentences,
  loaded on the card through ``from_npz`` (golden check), a copy with two
  embedding rows swapped refused, and the card's vectors within 1e-5 of
  the CPU's on 4,096 sentences; ``guse`` through the CLI on synthetic
  captions for NSD's 73,000 keys x 5 (365,000 sentences, about a tenth of
  their words outside the bundle's vocabulary), with sentences/s, the host
  tokenization and device seconds and the peak device memory; guse_nic one
  epoch on 1,200 keys of the per-key vectors it wrote (K1 on every train
  and val batch); ``score`` through the CLI on the training product's
  captions with the bundle, its ``GUSE_*`` equal to ``run_metrics``'; and
  ``tune`` through the CLI on ``configs/flagship_synth.yaml`` at 384 keys,
  4 trials of 2 epochs in 2 spawned processes, then a ``--queue`` with
  this process as its coordinator and one ``--worker`` process over 2
  trials, each trial's wall s and launches, the sweep's wall s and trials
  an hour and each process's peak device memory; K1 and K2 are counted in
  the processes that ran the trials, every trial must be recorded, none
  in error, and each must have launched K1;
- the parallel phase (``parallel/``): ``run_training`` of
  ``configs/flagship_synth.yaml`` at full width with its vocab padded to
  5,008 (``tpu.vocab_pad_multiple: 8``), 1 epoch at 256 keys, four ways:
  in this process, with ``mesh_data: 0`` over a process group of one
  rank (NCCL), and through ``train --processes 2 --devices-per-process
  1`` at data 1 x model 2 and data 2 x model 1, two ranks sharing the
  card under gloo; each epoch loss within 1e-4 of the single process's,
  K1 counted in every rank (on every train and val batch), the 1 x 2
  run's checkpoint restored here bit for bit; K1 against its plain version
  (and timed beside ``index_select``) on rank 0's columns of the store of
  a 1 x 2 mesh; K2 against its plain version at vocab 5,008; ``caption
  --shard 1`` against K2's plain words (near-ties counted) and against
  ``caption`` on the run; ``dryrun --devices 4`` and ``dryrun
  --flagship``. One card cannot show scaling over cards;
- the precision phase (``tpu.compute_dtype: bfloat16`` and ``tpu.remat``):
  ``run_training`` of ``configs/flagship_synth.yaml`` (1 epoch at 256 keys,
  from the device store through K1) in fp32, bf16, fp32 + remat and
  bf16 + remat, then fp32 and bf16 under ``tpu.fused_seq`` from a bf16
  store, each run's epoch loss, steps/s, peak device memory and K1 and K4
  launches; each remat run's loss within 1e-5 (relative) of its twin's,
  each bf16 run's within 1% of its fp32 twin's; peak memory of one train step with and
  without remat at units 2,048, batch 256 in both dtypes; the bf16-weight
  K4 against its plain version at the flagship and the wide shape (step by
  step on the kernel's carries, and the whole sequence no farther than the
  fp32 plain version), timed beside the fp32 K4 in alternate turns (its
  device time a step by part is taken in the fused-sequence phase); then,
  its count set to 0, the bf16 sequence's forward
  and custom backward through ``make_fused_sequence(backend="kernel",
  compute_dtype=bfloat16)``, which must launch it;
- the plain-route phase (``tpu.use_pallas: false``, the scanned
  decoders): ``run_training`` of ``configs/flagship_synth.yaml`` (1 epoch
  at 256 keys) and ``run_eval`` greedy, once with ``use_pallas: true`` and
  once with ``false``, from one seed: K1 and K2 launched in the first, K1,
  K2 and K3 never in the second; the epoch and val losses equal bit for
  bit (or, should a second true run differ from the first, the false run
  within that spread); the eval words equal K2's but at near-ties
  (counted); steps/s and eval captions/s of both routes; ``false`` again on
  a mesh of one rank (NCCL), no launch there either; then the scanned
  greedy decoder (16 stacked batches of 64) and beam-5 (4 of 64) on the
  flagship LcNIC, each slice equal to a single unfused call bit for bit,
  their captions/s beside K2's on the same greedy rows.

Every number is printed beside the card's name and power limit.
The device time of a train step, the sum of its kernels' times by
``torch.profiler``, is printed in every run, for the autograd and the
``tpu.fused_seq`` step; ``--profile`` adds tables of device time by kernel
for one served batch and for the scanned train steps, and the time a step
of K2, K3 and K4 (at both shapes) by part, each launch of a step in turn:
K2's and K3's h W2, attention, cell, Wi, Wo and argmax; K4's h W2,
attention and cell; and the bf16-weight K2's and K3's
(one launch a decode) by phase, from the ``%globaltimer`` stamps its block
0 writes (``phase_split``: argmax and embed, attention, cell, Wi and h W2,
Wo and the partial argmax, and the share of the decode at barriers). K2's
words and alphas on the seeded LcNIC inputs, and K3's on the seeded CnnRnn
inputs in both zero-state modes, are printed as a SHA-256 digest and must
equal ``K2_DIGEST`` and ``K3_DIGESTS``, so that two builds can be told
apart or shown bit-identical.

The weights are random, made from a seed, and spread by
``ops.fused_decode.spread_for_check`` so that every bias and BatchNorm
statistic is live and the greedy words vary; the run fails if they do not.
The flagship layout is the synthetic 360-group one of ``bench.py``. The last
line is the JSON object ``{"ok": true, "device": {...}}``; the line before
it lists each kernel with its launches on its path (K2 while serving LcNIC,
K3 while serving CnnRnn, the bf16-weight K2 and K3 while serving through
``Captioner(weights_bf16=True)``, K1 while training, K4 through the
eval-mode fused loss with ``backend="kernel"``, P1, P2 and P3 through the
probe's run; K1
and K2 also under ``launches_experiment``, their launches in the training
product's phase, K1, K2 and K3 under ``launches_families``, theirs in
the families' runs, under ``launches_ingest``, theirs in the ingest
phase's runs, K1 and K2 under ``launches_sweep``, theirs in the sweep
phase's runs, summed over its processes, under ``launches_deploy``,
theirs in the deploy phase's profiled run, and under
``launches_parallel``, theirs in the parallel phase, summed over its
ranks, and under ``launches_plain_route`` (K1, K2 and K3), theirs in the
plain-route phase's ``use_pallas: false`` run, which must be 0, with
K1's and K2's in its ``use_pallas: true`` twin under
``launches_plain_twin``; the bf16-weight K4 through the bf16 sequence of
the precision phase), its
error against the plain
version, both times, the least time the card could take for the same work
(``bound_ms``, from the bytes and operations of this run's inputs) and,
where one PyTorch call computes the same function, that call's time; K4's
entry holds its check, times and bound at the wide shape under ``wide``,
K2's, K3's and K4's name the tile kernel's plans they ran under ``tiles``
(K2's and K3's also their digest under ``sha256``),
the bf16-weight K2's holds its check and times with ``feat_bf16`` under
``feat_bf16``, the bf16 K3's its check and times at the carried state
under ``carried``, and the bf16 K2's and K3's the fp32 kernel's time under
``fp32_ms``, their plan (blocks, each operand resident or streamed, the
largest block's shared memory) under ``plan`` and, with ``--profile``,
their phases under ``phases``, the bf16-weight K4's holds its device time a step by part under
``us_a_step`` and the cell's rate under ``cell_tflops`` at both shapes,
and P3's holds its and ``index_select``'s times in turns under ``turns``;
K1's holds, for the training store and each ingest and sweep run's store,
its and ``index_select``'s device, host and event times under ``stores``,
and its times on a rank's store under ``rank_store``; K2's its times at
vocab 5,008 under ``vocab_5008``.
Any failed phase raises, and the script then exits non-zero without those
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
# K2's words and alphas on the seeded flagship inputs, unchanged since K2's
# cell and head moved onto the tile kernel; K3's on the seeded CnnRnn inputs
# by zero-state mode, unchanged since its head moved there
K2_DIGEST = "3e0a4c5e5f56edebf92f2811205bef7a3ddd16f6bb8217194dcf154995eed0cb"
K3_DIGESTS = {
    True: "7f1d7f7c3207f764e99ccefa046bfbab1a4a2375460ab52b8ddf94b7b0300a7e",
    False: "ab415d35a08efbdc119656f0d65fa614b31eff374692b2d6a5e940e42ef34193"}
# The bf16-weight decode (K2 and K3 as the TPU runs them) against its plain
# version: a one-step decode (T = 1) is held to the fp32 limits above. Over
# 15 steps the bf16 rounding of h turns the last-bit differences of two
# summation orders into bf16 ones wherever a value lies near a rounding
# boundary (PR 16's finding for the bf16 K4), and they grow with the
# recurrence: the alphas are held to BF16_ALPHA_ATOL up to a row's first
# differing word, and a row may take another word only where the plain
# version's top-2 margin is under BF16_TIE_MARGIN. The fp32 plain version
# must fail the same check against the bf16 one, so the limits are tighter
# than the bf16 rounding they look for.
BF16_ALPHA_ATOL = 1e-3
BF16_TIE_MARGIN = 1e-2
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
BF16_FLOPS = 989e12         # bf16, dense, on the tensor cores
# training: configs/flagship_synth.yaml's 2,571 keys give 8,995 train pairs,
# 140 steps of 64, and 1,925 val pairs, 30 batches
TRAIN_KEYS = 2571
SCAN_STEPS = 140
GATHER_TURNS = 7            # K1 and index_select timed in turns, as P3
PIXEL_KEYS = 1000           # the pixel CnnRnn's store: 1.07 GB of images
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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS,
          bf16_flops: float = 0.0) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flops`` operations at ``peak`` (by default fp32)
    and ``bf16_flops`` more on the bf16 tensor cores: the larger of the two
    times at the card's peaks, and which of them it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (flops / peak + bf16_flops / BF16_FLOPS) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def decode_bound(cell: str, inputs, opts: dict, T: int, vocab: int) -> dict:
    """``bound`` of one whole greedy decode on ``inputs`` (the kernel's
    arguments): each input read once at its dtype's size (the head's and
    the embedding's true vocab only; no Wh under zero state, whose cell
    never reads it), words and alphas written once, and per row and step
    the multiply-adds of the attention (h W2, the scores, the context), the
    cell and the head: all fp32, or with bf16 weights the cell's and the
    head's on the bf16 tensor cores."""
    from masters_thesis_tpu_torch.ops.fused_decode import DECODE_ARGS

    a = dict(zip(DECODE_ARGS[cell], inputs))
    B, R, A = a["pre"].shape
    D, (U, H) = a["features"].shape[2], a["wi"].shape
    skip = {"wo", "bo"} | ({"wh"} if opts.get("zero_state") else set())
    read = sum(t.numel() * t.element_size()
               for n, t in a.items() if n not in skip)
    read += H * vocab * a["wo"].element_size() + vocab * 4
    written = 4 * B * T * (1 + R)
    cell_fma = a["wx"].numel() + (0 if "wh" in skip else a["wh"].numel())
    attn = B * T * (U * A + R * A + R * D)
    weights = B * T * (cell_fma + U * H + H * vocab)
    if a["wx"].dtype == torch.bfloat16:
        return bound(read + written, 2 * attn, bf16_flops=2 * weights)
    return bound(read + written, 2 * (attn + weights))


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
                 profile: bool = False, digest: str | None = None) -> dict:
    """The model's decode kernel (K2 or K3) against its plain version on the
    same inputs, on the card, and both against the plain version in
    float64; with ``timed``, then both timed, and the
    fused decoder with the encoder against the unfused one; with
    ``profile``, the kernel's per-step split; with ``digest``, the kernel's
    words and alphas must have that SHA-256. Returns the kernel's entry of
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
    parts = (("h W2", "Wi", "Wo") if model.cell_type == "gru"
             else ("h W2", "cell", "Wi", "Wo"))
    # the plans the launch above ran, as the wrapper recorded them
    entry = {"max_abs_err": report["max_abs_err"],
             "tiles": {part: p.describe()
                       for part, p in zip(parts, kernel.plans)}}
    print(f"{label}: the tile kernel's plans, " + ", ".join(
        f"{part} {plan}" for part, plan in entry["tiles"].items()))
    sha = hashlib.sha256(words.cpu().numpy().tobytes())
    sha.update(alphas.cpu().numpy().tobytes())
    entry["sha256"] = sha.hexdigest()
    print(f"{label}: SHA-256 of its words (int32) and alphas (fp32) on "
          f"the seeded inputs: {entry['sha256']}"
          + ("" if digest is None else f" (must be {digest})"))
    if digest is not None and entry["sha256"] != digest:
        raise RuntimeError(f"{label}'s words and alphas are no longer the "
                           f"ones recorded for the fp32 kernel: "
                           f"{entry['sha256']} != {digest}")
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


@torch.inference_mode()
def check_kernel_bf16(model, rows, card: str, label: str,
                      feat_bf16: bool = False, timed: bool = True,
                      profile: bool = False) -> dict:
    """The model's bf16-weight decode kernel (K2 or K3 with the weights and
    the embedding table in bf16, and with ``feat_bf16`` pre and features:
    the persistent kernel of ``csrc/decode_bf16.cu``) against its bf16
    plain version on the same inputs, and both against that plain version
    summed in float64 on the same bf16 operands: a one-step decode within
    the fp32 limits, the whole decode within ``BF16_ALPHA_ATOL`` and
    ``BF16_TIE_MARGIN``, which the fp32 plain version must fail; and two
    calls must give the same words and alphas bit for bit. Prints the rows
    whose words differ from the fp32 kernel's, with the fp32 plain
    version's margin at each first differing step, and the kernel's plan.
    With ``timed``, the kernel and its plain version timed; with
    ``profile``, the kernel's phases (``phase_split``). Returns the kernel's
    entry of the kernels line, less its launches."""
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    T, V = model.max_length, model.vocab_size
    kernel, reference = fd.decode_kernel(model)
    opts = fd.decode_options(model)
    fp32 = fd.decode_inputs(model, rows, 1)
    half = fd.cast_decode_inputs(model.cell_type, fp32, weights_bf16=True,
                                 feat_bf16=feat_bf16)
    wide = [t.double() if t.dtype == torch.float32 else t for t in half]
    B, R = len(rows), half[0].shape[1]
    err = 0.0
    for steps, atol, tie in ((1, ALPHA_ATOL, TIE_MARGIN),
                             (T, BF16_ALPHA_ATOL, BF16_TIE_MARGIN)):
        words, alphas = kernel(*half, max_length=steps, **opts)
        torch.cuda.synchronize()
        if words.shape != (B, steps) or alphas.shape != (B, steps, R):
            raise RuntimeError(f"{label}: output shapes "
                               f"{tuple(words.shape)}, {tuple(alphas.shape)}")
        if not (0 <= int(words.min()) and int(words.max()) < V):
            raise RuntimeError(f"{label} produced an id outside the "
                               f"vocabulary")
        ref = reference(*half, max_length=steps, return_margins=True,
                        **opts)
        ref64 = reference(*wide, max_length=steps, return_margins=True,
                          **opts)
        reports = {who: fd.compare_with_reference(
            w, a.double(), *want, alpha_atol=atol, tie_margin=tie)
            for who, w, a, want in (
                ("kernel vs plain", words, alphas, ref),
                ("kernel vs float64", words, alphas, ref64),
                ("plain vs float64", ref[0], ref[1], ref64))}
        print(f"{label} at B={B} R={R} T={steps} V={V}: " + "; ".join(
            f"{who} max |alpha err| {r['max_abs_err']:.3e}, near-tie rows "
            f"{r['near_tie_rows']}, bad rows {len(r['bad_rows'])}"
            for who, r in reports.items())
            + f" (limits {atol}, margin {tie}) [{card}]")
        for who, r in reports.items():
            if r["bad_rows"]:
                raise RuntimeError(f"{label}: {who} disagree on rows "
                                   f"{r['bad_rows']}: {r}")
        err = max(err, reports["kernel vs plain"]["max_abs_err"])
    # the fp32 decode under the same limits: the check must tell it apart
    ref32 = reference(*fp32, max_length=T, return_margins=True, **opts)
    control = fd.compare_with_reference(
        ref32[0], ref32[1], *ref, alpha_atol=BF16_ALPHA_ATOL,
        tie_margin=BF16_TIE_MARGIN)
    words32, _ = kernel(*fp32, max_length=T, **opts)
    diff = words32 != words
    moved = diff.any(dim=1).nonzero().flatten()
    first = diff.int().argmax(dim=1)
    margins = [f"{float(ref32[2][r, first[r]]):.2e}" for r in moved]
    distinct = len(torch.unique(words))
    print(f"{label}: the fp32 plain version against the bf16 one under the "
          f"same limits: max |alpha err| {control['max_abs_err']:.3e}, bad "
          f"rows {len(control['bad_rows'])} of {B} (must be some); rows "
          f"whose words differ from the fp32 kernel's {len(moved)} of {B}, "
          f"the fp32 margin at each first differing step "
          f"[{', '.join(margins)}]; distinct words {distinct} [{card}]")
    if not control["bad_rows"]:
        raise RuntimeError(f"{label}: the check cannot tell the fp32 decode "
                           f"from the bf16 one: {control}")
    if distinct < MIN_DISTINCT_WORDS:
        raise RuntimeError(f"{label}'s greedy words are degenerate: "
                           f"{distinct} distinct < {MIN_DISTINCT_WORDS}")
    again = kernel(*half, max_length=T, **opts)
    if not (torch.equal(again[0], words) and torch.equal(again[1], alphas)):
        raise RuntimeError(f"{label}: two calls on the same inputs gave "
                           f"different words or alphas")
    plan = fd.bf16_decode_plan(model.cell_type, half, T,
                               opts.get("zero_state", False)).describe()
    print(f"{label}: two calls bit for bit equal; plan {plan}")
    entry = {"max_abs_err": err, "plan": plan}
    if profile:
        entry["phases"] = phase_split(model.cell_type, half, opts, T, label,
                                      card)
    if not timed:
        return entry
    ms = cuda_ms(lambda: kernel(*half, max_length=T, **opts))
    plain_ms = cuda_ms(lambda: reference(*half, max_length=T, **opts))
    fp32_ms = cuda_ms(lambda: kernel(*fp32, max_length=T, **opts))
    work = decode_bound(model.cell_type, half, opts, T, V)
    print(f"{label} decode at B={B}, T={T}: kernel {ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms, the fp32 kernel {fp32_ms:.4f} ms, "
          f"bound {work['bound_ms']:.4f} ms (by {work['bound_by']}; 3.35 "
          f"TB/s, 989 TFLOP/s dense bf16 for the cell and head, 67 TFLOP/s "
          f"fp32 for the attention) [{card}]")
    return {**entry, "ms": ms, "plain_ms": plain_ms, **work,
            "library_ms": None, "fp32_ms": fp32_ms}


def serve_bf16(model, tok, rows: np.ndarray, card: str, label: str,
               request_rows=REQUEST_ROWS) -> int:
    """Captions/s through ``Captioner(weights_bf16=True)`` on ``rows`` (as
    ``throughput`` times the fp32 one), then ``rows`` through it and its
    HTTP server (``request_rows`` requests), counting the bf16-weight
    kernel's launches from 0: at least one, and the served captions must
    be ``caption``'s. Returns the launches."""
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    kernel, _ = fd.decode_kernel(model)
    captioner = Captioner(model, tok, model.units, model.max_length,
                          batch_size=BATCH,
                          device=next(model.parameters()).device,
                          weights_bf16=True)
    throughput(captioner, rows, card, label=f"{label}: ")
    kernel.launches_bf16 = 0
    served = serve(captioner, rows, card, request_rows=request_rows)
    launches = kernel.launches_bf16
    print(f"{label} launches while serving {sum(request_rows)} rows "
          f"through Captioner(weights_bf16=True): {launches}")
    if launches < 1:
        raise RuntimeError(f"Captioner(weights_bf16=True) never launched "
                           f"{label}")
    if served != captioner.caption(rows[:len(served)]):
        raise RuntimeError(f"captions served with bf16 weights differ from "
                           f"Captioner.caption on the same rows")
    print(f"served captions with bf16 weights equal Captioner.caption on the "
          f"same rows; {len(set(served))} distinct of {len(served)}, e.g. "
          f"{served[-1]!r}")
    return launches


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
          request_rows=REQUEST_ROWS, server=None) -> list[str]:
    """POST /caption requests of ``request_rows`` rows each (the second as
    JSON, the others as .npy) through the port's HTTP server over
    ``captioner``, or through ``server`` (built, not started); returns the
    captions, one per row, in row order."""
    from masters_thesis_tpu_torch.server import make_caption_server

    if server is None:
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
               label: str = "", decoder: str = "greedy",
               windows: int = WINDOWS, window_s: float = WINDOW_S) -> float:
    """Captions/s of ``decoder`` over ``windows`` windows of at least
    ``window_s`` s of ``caption`` calls; prints the median and the spread
    across windows."""
    captioner.caption(rows[:BATCH], decoder)             # warm
    rates = []
    for _ in range(windows):
        n, t0 = 0, time.perf_counter()
        while (seconds := time.perf_counter() - t0) < window_s:
            captioner.caption(rows, decoder)
            n += len(rows)
        rates.append(n / seconds)
    median = float(np.median(rates))
    print(f"{label}{decoder} captions/s through "
          f"{type(captioner).__name__} (batch {BATCH}, "
          f"{len(rows)} host rows a call, "
          f"{'bf16' if getattr(captioner, 'weights_bf16', False) else 'fp32'}"
          f"): median {median:.1f} over "
          f"{windows} windows of >= {window_s} s, min {min(rates):.1f}, max "
          f"{max(rates):.1f}, spread {(max(rates) - min(rates)) / median:.1%}"
          f" [{card}]")
    return median


# kernel name fragments -> the part of the work a kernel does, first match
KERNEL_GROUPS = (
    ("K1 gather_rows", ("gather_rows_kernel",)),
    ("K2/K3/K4 tile kernel (h W2; K2's, K4's cell; K2's, K3's head)",
     ("tile_kernel",)),
    ("K2/K3/K4 step kernels", ("attention_kernel", "rows_kernel",
                               "argmax_embed_kernel")),
    ("bf16-weight K2/K3 (persistent)", ("decode_bf16_kernel",)),
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
            ("Wi (tile)", ("tile_kernel<1,",)),
            ("Wo (tile)", ("tile_kernel<1,",)),
            ("argmax", ("argmax_embed_kernel",))),
    "seq": (_HW, _ATTN,
            ("cell (tile)", ("tile_kernel<4,", "tile_kernel_tma<4,"))),
    "seq_bf16": (("h W2 (mma)", ("mma_tile_kernel<1,",)), _ATTN,
                 ("cell (mma)", ("mma_tile_kernel<4,", "wgmma_cell_kernel"))),
}


def step_split(fn, what: str, steps: int, parts, card: str) -> dict:
    """Device time of one call of ``fn`` (a decode kernel's whole run of
    ``steps`` steps) by ``torch.profiler``, split by the part of a step
    each kernel does, in us a step. The call's kernels, in the order they
    ran, are matched to ``steps`` runs of ``parts`` (``STEP_PARTS``), each
    to the next part whose name it has, so that a kernel the profile lost
    shifts no other; the count of such kernels is printed. Returns the us
    a step of each part, None for a part none of whose kernels the profile
    kept."""
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
    return {name: us / steps if n else None
            for name, (us, n) in split.items()}


# the bf16-weight decode's phases in the order its kernel stamps them
# (csrc/decode_bf16.cu): block 0's time in each phase of a step, and at the
# barrier after it
BF16_PHASES = ("argmax and embed", "attention", "barrier", "cell", "barrier",
               "Wi and h W2", "barrier", "Wo and partial argmax", "barrier")


def phase_split(cell: str, inputs, opts: dict, steps: int, what: str,
                card: str, calls: int = 5) -> dict:
    """The bf16-weight decode's time by phase, from the ``%globaltimer``
    stamps its block 0 writes at each phase boundary (``calls`` decodes of
    ``steps`` steps on ``inputs``): us a step in each phase, the barriers'
    waits summed, their share of the decode, and the prologue that loads
    the resident weights (and the first h W2, and its barrier)."""
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    stamps = torch.zeros(calls, 5 + 9 * steps, dtype=torch.int64,
                         device=inputs[0].device)
    for i in range(calls):
        fd._launch(cell, inputs, max_length=steps, stamps=stamps[i], **opts)
    torch.cuda.synchronize()
    us = stamps.double().cpu().numpy() / 1e3
    gaps = np.diff(us[:, 3:4 + 9 * steps], axis=1).reshape(calls, steps, 9)
    per_step: dict[str, float] = {}
    for name, gap in zip(BF16_PHASES, gaps.mean(axis=(0, 1))):
        per_step[name] = per_step.get(name, 0.0) + float(gap)
    total = us[:, -1] - us[:, 0]
    waits = gaps[:, :, 2::2].sum(axis=(1, 2)) + us[:, 3] - us[:, 2]
    out = {"us_a_step": per_step,
           "prologue_us": float((us[:, 3] - us[:, 0]).mean()),
           "last_argmax_us": float((us[:, -1] - us[:, -2]).mean()),
           "decode_us": float(total.mean()),
           "barrier_share": float((waits / total).mean())}
    print(f"phases of {what} ({steps} steps, block 0's %globaltimer stamps, "
          f"{calls} decodes): " + ", ".join(
              f"{name} {v:.2f} us" for name, v in per_step.items())
          + f" a step; prologue (resident loads, first h W2) "
          f"{out['prologue_us']:.2f} us, decode {out['decode_us']:.2f} us, "
          f"barrier waits {out['barrier_share']:.1%} of it [{card}]")
    return out


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
    carried = check_kernel(model, rows, card, "K3 (carried GRU state)",
                           timed=False, digest=K3_DIGESTS[False])
    model.gru_zero_state = True
    k3 = check_kernel(model, rows, card, "K3 (zero-state GRU)",
                      profile=with_profile, digest=K3_DIGESTS[True])
    k3["max_abs_err"] = max(carried["max_abs_err"], k3["max_abs_err"])
    k3["carried_sha256"] = carried["sha256"]

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

    # the bf16-weight K3, both zero-state values, the default timed last
    model.gru_zero_state = False
    carried = check_kernel_bf16(model, rows, card, "bf16 K3 (carried GRU "
                                "state)", profile=with_profile)
    model.gru_zero_state = True
    k3b = check_kernel_bf16(model, rows, card, "bf16 K3 (zero-state GRU)",
                            profile=with_profile)
    k3b["max_abs_err"] = max(carried.pop("max_abs_err"), k3b["max_abs_err"])
    k3b["carried"] = carried
    k3b["launches"] = serve_bf16(model, tok, host, card, "bf16 K3",
                                 request_rows=(CNN_RNN_REQUEST_ROWS,))
    return {"launches": launches, **k3, "bf16": k3b}


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


def check_gather(data: torch.Tensor, card: str) -> dict:
    """K1 against its plain version on 64 rows of the store ``data`` (a
    store's ``device_array()``), with repeated
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


def pixel_gather(device, card: str) -> dict:
    """K1 on a store of 299 x 299 x 3 images as the pixel CnnRnn decode
    gathers them: 268,203 fp32 values a row (1,072,812 B, a multiple of 4
    but not of 8), which take K1's 4-byte-load plan; ``check_gather``'s
    checks and timings there."""
    from masters_thesis_tpu_torch.ops.gather import gather_plan, vector_bytes

    gen = torch.Generator(device=device).manual_seed(SEED)
    data = torch.rand(PIXEL_KEYS, 299 * 299 * 3, generator=gen,
                      device=device) * 2 - 1
    row_bytes = data.shape[1] * data.element_size()
    plan = gather_plan(row_bytes, vector_bytes(data.data_ptr() | row_bytes))
    print(f"pixel store on the card: {tuple(data.shape)} fp32, "
          f"{data.numel() * 4 / 1e9:.2f} GB; K1's plan {plan}")
    if plan.vec_bytes != 4:
        raise RuntimeError(f"pixel rows took {plan.vec_bytes}-byte loads, "
                           f"not the 4-byte plan they are checked for")
    k1 = check_gather(data, card)
    del data
    return k1


FOLD_IMAGES = 64    # the pixel cell's request
FOLD_SIDE = 299


def inception_fold(device, card: str) -> dict:
    """InceptionV3 with each ConvBN's BatchNorm folded into its
    convolution, on FOLD_IMAGES images at FOLD_SIDE, its BatchNorm
    statistics and shifts moved off their init values: in fp32 with TF32
    off in NCHW (the pixel cell's backbone) and under TF32 in channels-last
    (``features``), every layer's output, at the input the forward gives
    it, equal bit for bit to the folded convolution followed by the bias
    and the ReLU as separate passes (in fp32 the layer takes them in
    cuDNN's convolution, ``torch.cudnn_convolution_relu``, which must run
    once a layer; under TF32 it runs the passes), and its gap to conv ->
    BatchNorm -> ReLU; then one fp32 forward under ``torch.profiler``, its
    fold kept from the forward before: its kernels and device ms, none of
    them a BatchNorm, ReLU or weight-copy pass."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from masters_thesis_tpu_torch.models.inception import ConvBN, InceptionV3

    gen = torch.Generator().manual_seed(SEED)
    model = InceptionV3(generator=gen).eval()
    layers = [m for m in model.modules() if isinstance(m, ConvBN)]
    with torch.no_grad():
        for m in layers:
            c = m.bn.bias.shape[0]
            m.bn.mean.copy_(0.3 * torch.randn(c, generator=gen))
            m.bn.var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
            m.bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
    model = model.to(device)
    images = (torch.rand(FOLD_IMAGES, FOLD_SIDE, FOLD_SIDE, 3,
                         generator=gen) * 2 - 1).to(device)
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0]))) for m in layers]
    out = {"layers": len(layers)}
    kept = torch.backends.cudnn.allow_tf32
    try:
        for label, tf32 in (("fp32", False), ("tf32", True)):
            torch.backends.cudnn.allow_tf32 = tf32
            seen.clear()
            unequal, gap = 0, 0.0
            with torch.inference_mode():
                model(images)
                inputs = list(seen)     # the calls below add to seen
                fused = torch.cudnn_convolution_relu
                calls = []
                torch.cudnn_convolution_relu = (
                    lambda *args: calls.append(1) or fused(*args))
                try:
                    outs = [m(x) for m, x in inputs]
                finally:
                    torch.cudnn_convolution_relu = fused
                for (m, x), got in zip(inputs, outs):
                    w, b = m._folded(
                        torch.contiguous_format if x.is_contiguous()
                        else torch.channels_last)
                    xp, pad = m.conv.padded(x)
                    passes = F.conv2d(xp, w, None, m.conv.strides, pad).add_(
                        b[:, None, None]).relu_()
                    want = F.relu(m.bn(m.conv(x)))
                    unequal += not torch.equal(got, passes)
                    gap = max(gap, float((got - want).abs().max()
                                         / want.abs().max()))
            layouts = {"nchw" if x.is_contiguous() else "channels_last"
                       for _, x in inputs}
            print(f"InceptionV3 folded ConvBN, {label} ({sorted(layouts)}), "
                  f"{FOLD_IMAGES} images at {FOLD_SIDE}: {len(inputs)} layers, "
                  f"{len(calls)} through cuDNN's fused call, "
                  f"{unequal} unequal to the separate passes, at most "
                  f"{gap:.2e} x max from conv -> BatchNorm -> ReLU [{card}]")
            if (len(inputs) != len(layers) or unequal or len(calls)
                    != (0 if tf32 or device.type != "cuda" else len(layers))):
                raise RuntimeError(f"folded ConvBN ({label}): {unequal} of "
                                   f"{len(inputs)} layers differ from the "
                                   f"separate passes, {len(calls)} through "
                                   f"cuDNN's fused call")
            out[label] = {"fused": len(calls), "unequal": unequal,
                          "max_rel_gap": gap,
                          "layouts": sorted(layouts)}
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            model(images)       # the fold again in NCHW, kept from here
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model(images)
                torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = kept
        for h in handles:
            h.remove()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    passes = [e.name for e in kernels if any(
        k in e.name for k in ("Functor", "clamp", "rsqrt"))]
    copies = sum("direct_copy" in e.name for e in kernels)
    out["launches"] = len(kernels)
    out["device_ms"] = sum(e.device_time_total for e in kernels) / 1e3
    print(f"InceptionV3 fp32 forward of {FOLD_IMAGES} images: "
          f"{out['launches']} kernels, {out['device_ms']:.3f} ms; "
          f"{len(passes)} BatchNorm or ReLU passes, {copies} copies (the "
          f"images' layout at the stem) [{card}]")
    if passes or copies > 1:
        raise RuntimeError(f"the folded forward launched {len(passes)} "
                           f"passes ({sorted({n[:80] for n in passes})}) "
                           f"and {copies} copies")
    del model, images, seen, inputs, outs
    return out


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
    k1 = check_gather(data, card)
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
    inputs = seq_inputs(model, betas, tokens)
    k4 = check_seq_kernel(inputs, slope, card, "K4 (flagship)",
                          with_profile)
    bf16_parts = {"flagship": split_seq_bf16(inputs, slope, card,
                                             "bf16 K4 (flagship)")}
    del inputs
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
            inputs = seq_inputs(dec, features, toks)
            wide = check_seq_kernel(inputs, slope, card, f"K4 ({label})",
                                    with_profile)
            bf16_parts["wide"] = split_seq_bf16(inputs, slope, card,
                                                f"bf16 K4 ({label})")
            del inputs
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
    return {"launches": launches, **k4, "bf16_parts": bf16_parts}


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
        # what the sweep phase's ``score`` reads: the run's captions file,
        # and run_metrics' inputs (no tensor of the run)
        scored = {"captions": (Path(run_path) / f"captions_{out['epoch']}"
                               ".txt").read_text(),
                  "texts": out["texts"], "keys": out["keys"],
                  "pairs": bundle["pairs"], "scores": scores}
        rows = deploy_rows(bundle, out)
        del bundle
        print(f"K1 launches in run_training: {k1} (train and val batches "
              f"{train_batches}); K2 launches in run_training {k2_train}, "
              f"in run_eval {k2}")
        release()
        deployed = deploy(run_path, out, rows, scored["pairs"], device, card)
    return {"K1": k1, "K2": k2_train + k2, "scored": scored,
            "deploy": deployed}


# ---- the deploy phase: export, serve --export, profiling, monitor, analysis

DEPLOY_ROWS = 256                   # test rows through the exported programs
DEPLOY_BEAM = 5
DEPLOY_WINDOWS, DEPLOY_WINDOW_S = 3, 1.0
PROFILE_KEYS = 256                  # 13 train steps: the window 10..15 sees 3
PROFILE_STEPS = 5
ANALYSIS_ROWS = 1_200               # streamed statistics at full width
K1_KERNEL, K2_KERNEL = "gather_rows_kernel", "argmax_embed_kernel"


def deploy_rows(bundle, out) -> np.ndarray:
    """Raw host rows of the first DEPLOY_ROWS distinct test keys of
    ``run_eval``'s output ``out`` (a key's pairs share its row)."""
    store, layout = bundle["store"], bundle["model"].encoder.layout
    _, first = np.unique(out["keys"], return_index=True)
    keys = out["keys"][np.sort(first)[:DEPLOY_ROWS]]
    idx = torch.as_tensor(store.indices_for(keys), device=store.device)
    rows = store.device_array().index_select(0, idx.long()).float()
    if bundle["model"].encoder.pregathered:
        rows = raw_rows(rows, layout)
    return rows.cpu().numpy()


def near_tie_rows(model, rows: np.ndarray, words, want, start_id: int,
                  max_length: int, what: str, card: str) -> int:
    """Rows whose ``words`` differ from ``want``; each must differ first at a
    near-tie of the plain greedy decode (top-2 logit margin < TIE_MARGIN)."""
    from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder

    differs = np.nonzero((words != want).any(axis=1))[0]
    if len(differs):
        sub = torch.from_numpy(rows[differs]).to(
            next(model.parameters()).device)
        _, logits, _ = make_greedy_decoder(model, max_length)(sub, start_id)
        top2 = logits.topk(2, dim=-1).values.cpu().numpy()
        first = np.argmax(words[differs] != want[differs], axis=1)
        at = np.arange(len(differs))
        m = top2[at, first, 0] - top2[at, first, 1]
        if not (m < TIE_MARGIN).all():
            raise RuntimeError(f"{what}: rows {differs[m >= TIE_MARGIN]} "
                               f"differ at margins {m[m >= TIE_MARGIN]}")
    print(f"{what}: {len(rows) - len(differs)} of {len(rows)} rows equal, "
          f"{len(differs)} apart at near-ties (margin < {TIE_MARGIN:g}) "
          f"[{card}]")
    return len(differs)


def export_artifact(run_path: str, out: Path, device, card: str,
                    *extra) -> dict:
    """``export`` through the CLI on ``device``, then ``load_exported``;
    prints the export's wall s, the artifact's bytes and the load's s, and
    returns the loaded ``ExportedCaptioner``."""
    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.export import load_exported

    t0 = time.perf_counter()
    meta = with_stdout(cli.main, ["export", "--run", run_path, "--out",
                                  str(out), "--device", str(device), *extra])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp = load_exported(str(out), device=device)
    load_s = time.perf_counter() - t0
    what = meta["decoder"] + (f"-{meta['beam_width']}"
                              if meta["beam_width"] else "")
    if meta["pre_stages"]:
        what += " --pre " + "/".join(meta["pre_stages"])
    print(f"export {what}: {export_s:.2f} s, {out.stat().st_size} bytes "
          f"({meta['platforms']}, batch {meta['batch_size']}, rows "
          f"{meta['input_row_shape']}), load_exported {load_s:.2f} s [{card}]")
    if meta["platforms"] != [torch.device(device).type]:
        raise RuntimeError(f"export's platforms {meta['platforms']}")
    return exp


def trace_kernels(trace: Path) -> dict:
    """Events of the card's kernels in a Chrome trace, by K1's and K2's
    kernel name."""
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(kernels),
            "K1": sum(K1_KERNEL in n for n in kernels),
            "K2": sum(K2_KERNEL in n for n in kernels)}


def profiled_runs(root: Path, device, card: str) -> dict:
    """``run_training`` of flagship_synth.yaml (1 epoch at PROFILE_KEYS keys)
    with ``tpu.profile_steps`` and ``tpu.profile_trace`` on, K1 and K2
    counted from 0, then the same run untraced: the trace names K1's and
    K2's kernels, ``profile.json`` has the JAX keys, ``tb/events.captions``
    holds the preview images."""
    import dataclasses

    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    base = Config.load(EXPERIMENT_CONFIG)
    rates, launches = {}, {}
    for label, steps, trace in (("traced", PROFILE_STEPS, True),
                                ("untraced", 0, False)):
        cfg = dataclasses.replace(
            base, run=f"profile_{label}", log=str(root), epochs=1,
            tpu=dataclasses.replace(base.tpu, profile_steps=steps,
                                    profile_trace=trace))
        if trace:
            gather_rows.launches = fd.fused_greedy_decode.launches = 0
        t0 = time.perf_counter()
        run_path, _, bundle = experiment.run_training(
            cfg, smoke_keys=PROFILE_KEYS, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if trace:
            launches = {"K1": gather_rows.launches,
                        "K2": fd.fused_greedy_decode.launches}
            traced_path = Path(run_path)
        del bundle
        (epoch,) = [json.loads(line) for line in
                    open(Path(run_path) / "metrics.jsonl")
                    if json.loads(line)["kind"] == "epoch"]
        rates[label] = epoch["steps_per_sec"]
        print(f"run_training {label}: 1 epoch at {PROFILE_KEYS} keys in "
              f"{wall:.2f} s, {epoch['steps_per_sec']} steps/s, epoch "
              f"{epoch['epoch_time']} s [{card}]")
        release()
    (trace_file,) = (traced_path / "trace").glob("*.pt.trace.json")
    found = trace_kernels(trace_file)
    stats = json.loads((traced_path / "profile.json").read_text())
    (captions,) = (traced_path / "tb").glob("events.out.tfevents.*.captions")
    blob = captions.read_bytes()
    images = blob.count(b"\x89PNG\r\n\x1a\n")
    print(f"trace {trace_file.name}: {trace_file.stat().st_size} bytes, "
          f"{found['kernels']} kernel events, {found['K1']} of K1 "
          f"({K1_KERNEL}), {found['K2']} of K2 ({K2_KERNEL}); profile.json "
          f"{stats}; tb/events.captions {len(blob)} bytes, {images} preview "
          f"images; launches in the traced run {launches}; steps/s traced "
          f"{rates['traced']} against untraced {rates['untraced']} [{card}]")
    if not (found["K1"] and found["K2"]):
        raise RuntimeError(f"the trace lacks K1's or K2's kernels: {found}")
    if set(stats) != {"steps", "mean_s", "p50_s", "p99_s"}:
        raise RuntimeError(f"profile.json keys {sorted(stats)}")
    if images < 4 or b"captions/sample_3" not in blob:
        raise RuntimeError(f"tb/events.captions holds {images} images")
    if not (launches["K1"] and launches["K2"]):
        raise RuntimeError(f"the traced run's launches {launches}")
    return {"launches": launches, "trace_bytes": trace_file.stat().st_size,
            "steps_per_sec": rates, "profile": stats}


def analysis_functions(run_path: str, out: dict, pairs, card: str) -> dict:
    """The analysis functions that draw nothing, on the experiment's run
    directory and on ANALYSIS_ROWS full-width rows; their seconds. (The
    ``analyze`` command draws with matplotlib, which the card's machine
    lacks: it is held to the JAX one on the CPU only.)"""
    from masters_thesis_tpu_torch.evalsuite import analysis

    attn = np.load(Path(run_path) / f"attention_scores_{out['epoch']}.npy")
    refs: dict = {}
    for key, cap, *_ in pairs["test"]:
        refs.setdefault(int(key), []).append(" ".join(cap.split()[1:-1]))
    captions = dict(zip(map(int, out["keys"]), out["texts"]))
    half = {k: v for i, (k, v) in enumerate(captions.items()) if i % 2}
    betas = np.random.default_rng(SEED).standard_normal(
        (ANALYSIS_ROWS, N_VOXELS), dtype=np.float32)
    seconds = {}
    for name, fn in (
            ("caption_table", lambda: analysis.caption_table(
                out["texts"], [refs[int(k)] for k in out["keys"]],
                keys=out["keys"])),
            ("attention_by_region", lambda: analysis.attention_by_region(
                attn)),
            ("attention_over_time", lambda: analysis.attention_over_time(
                attn)),
            ("hit_rate", lambda: analysis.hit_rate(captions, half)),
            ("most_active_vertices", lambda: analysis.most_active_vertices(
                betas)),
            ("streamed_betas_stats", lambda: analysis.streamed_betas_stats(
                betas))):
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        if name == "streamed_betas_stats" and not np.allclose(
                result["mean"], betas.mean(axis=0), atol=1e-5):
            raise RuntimeError("streamed_betas_stats' mean differs")
        if name == "most_active_vertices" and not (np.diff(
                result["mean_abs"][result["indices"]]) <= 0).all():
            raise RuntimeError("most_active_vertices is not in descending "
                               "order")
    print(f"analysis on {len(out['texts'])} test captions, attention "
          f"{attn.shape} and {ANALYSIS_ROWS} x {N_VOXELS} rows, s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + " (host)")
    return seconds


def spread_copy(run_path: str, dest: Path, device) -> str:
    """A copy of the run directory whose one checkpoint holds the run's
    weights spread by ``spread_for_check``: two epochs on random captions
    leave the flagship emitting one caption for every row, and a check of
    words needs words that vary by row."""
    import shutil

    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops.fused_decode import spread_for_check
    from masters_thesis_tpu_torch.serve import Captioner
    from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
    from masters_thesis_tpu_torch.train.state import new_state

    dest.mkdir()
    for name in ("config.yaml", "tokenizer.json", "run_meta.json",
                 "layout.npz"):
        shutil.copy(Path(run_path) / name, dest / name)
    model = Captioner.from_run_dir(run_path, device=device).model
    spread_for_check(model, torch.Generator().manual_seed(SEED))
    mgr = CheckpointManager(str(dest / "model"))
    mgr.save(new_state(model, Config.load(dest / "config.yaml"), device), 0)
    mgr.close()
    return str(dest)


def check_exported(label: str, run_path: str, exp, rows: np.ndarray, device,
                   card: str, beam: bool = False) -> dict:
    """The exported program's words on ``rows`` against the live unfused
    ``Captioner``'s of the same run, bit for bit; greedy also against K2's
    ``Captioner``, apart only at near-ties. Returns the captioners."""
    from masters_thesis_tpu_torch.serve import Captioner

    live = Captioner.from_run_dir(run_path, device=device, use_fused=False,
                                  beam_width=DEPLOY_BEAM)
    words = exp.caption_ids(rows)
    decoder = "beam" if beam else "greedy"
    if not np.array_equal(words, live.caption_ids(rows, decoder)):
        raise RuntimeError(f"{label}: the exported {decoder} words differ "
                           f"from the live unfused Captioner's")
    print(f"{label}: exported {decoder} words equal the live unfused "
          f"Captioner's on {len(rows)} test rows bit for bit "
          f"({len(set(map(bytes, words)))} distinct captions) [{card}]")
    if beam:
        return {"live": live}
    k2 = Captioner.from_run_dir(run_path, device=device)
    ties = near_tie_rows(k2.model, rows, words, k2.caption_ids(rows),
                         exp.tokenizer.start_id, exp.meta["max_length"],
                         f"{label}: exported greedy against K2's Captioner",
                         card)
    return {"live": live, "k2": k2, "near_ties": ties}


def deploy(run_path: str, out: dict, rows: np.ndarray, pairs, device,
           card: str) -> dict:
    """The deploy phase on the training product's run directory: ``export``
    greedy on the card, its words against the live unfused ``Captioner``'s
    bit for bit and against K2's (near-ties counted); the same for greedy
    on a copy of the run with spread weights, whose words vary by row, and
    exported beam-5 there against live beam-5 bit for bit; captions/s of
    the exported program, the live unfused decoder and K2; three HTTP
    requests through ``serve --export``; a profiled ``run_training`` (its
    K1 and K2 launches are the phase's); ``device_memory_stats``; the
    analysis functions."""
    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.utils.monitor import device_memory_stats

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_deploy_") as tmp:
        root = Path(tmp)
        exp = export_artifact(run_path, root / "greedy.mttx", device, card)
        check_exported("trained run", run_path, exp, rows, device, card)
        spread = spread_copy(run_path, root / "spread", device)
        exp = export_artifact(spread, root / "spread.mttx", device, card)
        held = check_exported("spread copy", spread, exp, rows, device, card)
        beam = export_artifact(spread, root / "beam.mttx", device, card,
                               "--decoder", "beam", "--beam-width",
                               str(DEPLOY_BEAM))
        check_exported("spread copy", spread, beam, rows, device, card,
                       beam=True)
        rates = {name: throughput(cap, rows, card, label=f"{name}: ",
                                  windows=DEPLOY_WINDOWS,
                                  window_s=DEPLOY_WINDOW_S)
                 for name, cap in (("exported", exp),
                                   ("live unfused", held["live"]),
                                   ("K2", held["k2"]))}
        del beam
        args = cli._parser().parse_args([
            "serve", "--export", str(root / "spread.mttx"), "--port", "0",
            "--device", str(device)])
        served = serve(exp, rows, card, server=cli.make_server(args))
        if served != exp.caption(rows[:len(served)]):
            raise RuntimeError("serve --export answered other captions than "
                               "the artifact")
        print(f"serve --export: {len(served)} captions over "
              f"{len(REQUEST_ROWS)} requests equal the artifact's [{card}]")
        ties = held["near_ties"]
        del exp, held
        release()
        profiled = profiled_runs(root, device, card)
        stats = device_memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
        print(f"device_memory_stats {stats}; mem_get_info free {free}, total "
              f"{total} [{card}]")
        if stats["bytes_limit"] != total:
            raise RuntimeError("bytes_limit is not the card's total")
        seconds = analysis_functions(run_path, out, pairs, card)
    print(f"deploy: the phase in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"launches": profiled["launches"], "near_ties": ties,
            "captions_per_s": rates, "analysis_s": seconds,
            "profile": profiled}


def deploy_pre(pre: Path, run_path: str, device, card: str) -> None:
    """``export --pre`` of the ingest phase's ThinkAndTell run: the artifact
    takes raw rows, and its words are those of the host chain's replay and
    the live decode (a row apart only at a near-tie of that decode)."""
    from masters_thesis_tpu_torch.data.pack import open_pack
    from masters_thesis_tpu_torch.experiment import apply_preprocess_chain
    from masters_thesis_tpu_torch.serve import Captioner

    with tempfile.TemporaryDirectory(prefix="mtt_pre_") as tmp:
        exp = export_artifact(run_path, Path(tmp) / "pre.mttx", device,
                              card, "--pre", str(pre))
    raw = open_pack(str(pre / "betas_pack"))
    rows = raw.gather_host(raw.indices_for(raw.keys[-PRE_TRANSFORM_ROWS:]))
    replay = apply_preprocess_chain(str(pre), rows)
    live = Captioner.from_run_dir(run_path, device=device)
    near_tie_rows(live.model, replay, exp.caption_ids(rows),
                  live.caption_ids(replay), live.tokenizer.start_id,
                  live.max_length, f"export --pre: {len(rows)} raw "
                  f"{rows.shape[1]}-wide rows through the artifact against "
                  f"the chain's replay and the live decode", card)


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
    k1 = check_gather(store.device_array(), card)
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
        deploy_pre(pre, run_path, device, card)
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


# ---- the sweep phase: the USE encoder, guse, score and tune ----

USE_VOCAB = 200_000                 # tokens of the random bundle
USE_OOV_BUCKETS = 256
USE_PROBES = 64                     # the bundle's golden sentences
USE_CHECK_ROWS = 4_096              # card against CPU
USE_ATOL = 1e-5
GUSE_KEYS = 73_000                  # NSD's stimuli, 5 captions each
GUSE_CAPTIONS = 5
CAPTION_WORDS = 30_000              # the captions' word list, Zipf-drawn
GUSE_PEAK_BYTES = 8e9               # the chunked embed stays far below 80 GB
GUSE_SPLIT = (1_000, 200, 100)      # guse_nic: unique, shared, test keys
GUSE_RTOL = 1e-6                    # score's GUSE against run_metrics'
TUNE_CONFIG = "flagship_synth.yaml"
TUNE_KEYS = 384                     # of flagship_synth.yaml's 2,571
TUNE_SAMPLES, TUNE_PROCESSES, TUNE_EPOCHS = 4, 2, 2
QUEUE_TRIALS = 2
SWEEP_COUNTS_ENV = "MTT_SWEEP_COUNTS"


def counted_trial(*args, **kwargs):
    """``cli._tune_trial`` with its kernels counted, in whatever process runs
    the trial (the sweep's spawned children import this module and unpickle
    this function): K1's and K2's counts set to 0 before the trial and read
    after it, with the trial's wall s and peak device memory, written as
    one JSON file into the directory ``MTT_SWEEP_COUNTS`` names. The trial's
    return value is ``_tune_trial``'s."""
    import os
    import uuid

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    trial = getattr(counted_trial, "real", cli._tune_trial)
    cuda = torch.cuda.is_available()
    gather_rows.launches = 0
    fd.fused_greedy_decode.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        return trial(*args, **kwargs)
    finally:
        if cuda:
            torch.cuda.synchronize()
        record = {"pid": os.getpid(), "config": args[3],
                  "wall_s": time.perf_counter() - t0,
                  "gather_rows": gather_rows.launches,
                  "fused_greedy_decode": fd.fused_greedy_decode.launches,
                  "peak_bytes": (torch.cuda.max_memory_allocated() if cuda
                                 else 0)}
        path = Path(os.environ[SWEEP_COUNTS_ENV]) / f"{uuid.uuid4().hex}.json"
        path.write_text(json.dumps(record))


@contextlib.contextmanager
def counting_trials(counts: Path):
    """The tune command's trials through ``counted_trial``, their records
    in ``counts`` (also for the spawned processes, through the
    environment)."""
    import os

    from masters_thesis_tpu_torch import cli

    os.environ[SWEEP_COUNTS_ENV] = str(counts)
    counted_trial.real = cli._tune_trial
    cli._tune_trial = counted_trial
    try:
        yield
    finally:
        cli._tune_trial = counted_trial.real
        del counted_trial.real
        os.environ.pop(SWEEP_COUNTS_ENV)


def tune_worker(argv, ready) -> None:
    """A ``tune --queue DIR --worker`` process: the command in this
    process, its trials counted; ``ready`` is set once the port is imported
    and the card initialised."""
    from masters_thesis_tpu_torch import cli

    if torch.cuda.is_available():
        torch.cuda.init()
    counted_trial.real = cli._tune_trial
    cli._tune_trial = counted_trial
    ready.set()
    with_stdout(cli.main, argv)


def caption_corpus():
    """Synthetic captions for GUSE_KEYS keys: 7 to 14 words each, drawn by
    a Zipf law (p ~ 1/rank) over a CAPTION_WORDS word list; the bundle's
    vocabulary leaves out every word whose rank ends in 3 (a tenth of the
    words written), which then go through FarmHash to an OOV bucket.
    Returns (keys, captions by key, the bundle's vocabulary, the share of
    words written outside it)."""
    rng = np.random.default_rng(SEED)
    words = np.array([f"w{i:05d}" for i in range(CAPTION_WORDS)],
                     dtype=object)
    lengths = rng.integers(7, 15, GUSE_KEYS * GUSE_CAPTIONS)
    zipf = 1.0 / np.arange(1, CAPTION_WORDS + 1)
    ranks = rng.choice(CAPTION_WORDS, int(lengths.sum()),
                       p=zipf / zipf.sum())
    drawn = words[ranks]
    ends = np.cumsum(lengths)
    caps = [" ".join(drawn[e - n:e]) + "." for e, n in zip(ends, lengths)]
    keys = np.arange(1, GUSE_KEYS + 1)
    by_key = {int(k): caps[i * GUSE_CAPTIONS:(i + 1) * GUSE_CAPTIONS]
              for i, k in enumerate(keys)}
    kept = [w for i, w in enumerate(words) if i % 10 != 3]
    vocab = kept + [f"v{i:06d}" for i in range(USE_VOCAB - len(kept))]
    return keys, by_key, vocab, float(np.mean(ranks % 10 == 3))


def check_use_encoder(root: Path, vocab, sentences, device, card: str):
    """The encoder at the class's full width over a USE_VOCAB-token random
    bundle: goldens from a CPU forward of USE_PROBES sentences, the bundle
    loaded on the card through ``from_npz`` (golden check), a copy with two
    of the probes' embedding rows swapped refused, and the card's vectors
    within USE_ATOL of the CPU's on USE_CHECK_ROWS sentences. Returns the
    bundle's path."""
    from masters_thesis_tpu_torch.models.use_encoder import (
        USEEncoder,
        init_use_params,
        save_use_bundle,
    )

    t0 = time.perf_counter()
    params = init_use_params(USE_VOCAB, oov_buckets=USE_OOV_BUCKETS,
                             embed_dim=512, hidden=(512, 512, 512),
                             out_dim=512, seed=SEED)
    cpu = USEEncoder(vocab, params, USE_OOV_BUCKETS, (512, 512, 512), 512,
                     512, device="cpu")
    probes = sentences[:USE_PROBES]
    goldens = cpu.embed(probes)
    path = root / "use_dan.npz"
    save_use_bundle(str(path), vocab, params, USE_OOV_BUCKETS,
                    goldens=(probes, goldens))
    table_mb = params["embedding"].nbytes / 1e6
    print(f"USE bundle: {USE_VOCAB} tokens + {USE_OOV_BUCKETS} OOV buckets, "
          f"embed 512, hidden 512 x 3, out 512 ({table_mb:.1f} MB of table), "
          f"{USE_PROBES} goldens from the CPU forward, made in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    enc = USEEncoder.from_npz(str(path), device=device)
    load_s = time.perf_counter() - t0
    golden_err = float(np.abs(enc.embed(probes) - goldens).max())
    print(f"USE from_npz on the card: golden check passed ({golden_err:.2e} "
          f"of {1e-3:.0e} max-abs), loaded in {load_s:.2f} s [{card}]")

    a, b = sorted({i for s in probes for i in cpu.token_ids(s)
                   if i < len(vocab)})[:2]
    table = params["embedding"]
    table[[a, b]] = table[[b, a]]
    bad = root / "use_dan_swapped.npz"
    save_use_bundle(str(bad), vocab, params, USE_OOV_BUCKETS,
                    goldens=(probes, goldens))
    table[[a, b]] = table[[b, a]]
    try:
        USEEncoder.from_npz(str(bad), device=device)
    except ValueError as exc:
        if "self-verification" not in str(exc):
            raise
        print(f"USE bundle with rows {a} and {b} ({vocab[a]!r}, "
              f"{vocab[b]!r}) swapped: refused ({str(exc)[:90]}...)")
    else:
        raise RuntimeError("a USE bundle with two rows swapped loaded")
    bad.unlink()

    check = sentences[:USE_CHECK_ROWS]
    t0 = time.perf_counter()
    got = enc.embed(check)
    card_s = time.perf_counter() - t0
    err = float(np.abs(got - cpu.embed(check)).max())
    print(f"USE card vs CPU on {len(check)} sentences: {err:.2e} max-abs "
          f"(tolerance {USE_ATOL:.0e}); the card's embed {card_s:.3f} s "
          f"[{card}]")
    if err > USE_ATOL:
        raise RuntimeError(f"the card's USE vectors are {err:.2e} from the "
                           f"CPU's")
    del enc, cpu, params
    return path


def guse_nsd(root: Path, bundle: Path, by_key, device, card: str) -> dict:
    """``guse`` through the CLI on GUSE_KEYS x GUSE_CAPTIONS captions with
    the bundle, then guse_nic (``configs/guse_nic.yaml``) one epoch on the
    per-key vectors it wrote, for the GUSE_SPLIT keys (``ingest_run``: the
    val loss falls, K1 on every train and val batch, K1 against its plain
    version on the run's store). Returns K1's launches in the run, the
    check's error and K1's timing on the store."""
    from concurrent.futures import ThreadPoolExecutor

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.evalsuite import guse_sim
    from masters_thesis_tpu_torch.models.use_encoder import EMBED_CHUNK
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    t0 = time.perf_counter()
    captions = root / "captions"
    captions.mkdir()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda kv: (captions / f"KID{kv[0]}.txt").write_text(
            "\n".join(kv[1]) + "\n"), by_key.items(), chunksize=512))
    write_s = time.perf_counter() - t0
    unique, shared, test = GUSE_SPLIT
    keys = sorted(by_key)[:unique + shared]
    nsd = root / "nsd"
    write_split(nsd, keys[:unique], keys[unique:], keys[unique:][:test])
    for hemi in ("lh", "rh"):           # build_data reads an atlas always
        np.save(nsd / f"glasser_{hemi}.npy", np.zeros(4, np.int64))
    cfg = ingest_config("guse_nic.yaml", str(root / "logs"),
                        captions_path=captions, guse_path=bundle.parent,
                        nsd_dir=nsd)
    yaml = root / "guse_nic.yaml"
    cfg.save(yaml)

    # the command's parts by host clock: the encoder it makes (its
    # ``seconds``), the caption files' read and the files' writes
    from masters_thesis_tpu_torch.data import captions as captions_mod

    made, spent = [], {"read": 0.0, "write": 0.0}
    patched = {(guse_sim, "default_embedder"): guse_sim.default_embedder,
               (captions_mod, "load_captions_dir"):
                   captions_mod.load_captions_dir,
               (np, "save"): np.save}

    def timed(what, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[what] += time.perf_counter() - t
        return run

    def recording(*args, **kwargs):
        made.append(patched[guse_sim, "default_embedder"](*args, **kwargs))
        return made[-1]

    guse_sim.default_embedder = recording
    captions_mod.load_captions_dir = timed(
        "read", patched[captions_mod, "load_captions_dir"])
    np.save = timed("write", patched[np, "save"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        report = with_stdout(cli.main, ["guse", "--config", str(yaml),
                                        "--out", str(root / "guse"),
                                        "--device", str(device)])
    finally:
        for (module, name), fn in patched.items():
            setattr(module, name, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = GUSE_KEYS * GUSE_CAPTIONS
    sec = made[0].seconds
    print(f"guse: {n} sentences ({GUSE_KEYS} keys x {GUSE_CAPTIONS}; "
          f"{write_s:.2f} s to write their KID files, 8 threads) in "
          f"{wall:.2f} s: read the caption files {spent['read']:.2f} s, "
          f"embed {sec['tokenize'] + sec['device']:.2f} s "
          f"({n / (sec['tokenize'] + sec['device']):.0f} sentences/s: host "
          f"tokenization {sec['tokenize']:.2f} s, device {sec['device']:.2f}"
          f" s, the upload, forward and copy back of chunks of "
          f"{EMBED_CHUNK}), write the table and "
          f"{report['per_key_files']} per-key files {spent['write']:.2f} s; "
          f"peak device memory {peak / 1e9:.2f} GB [{card}]")
    if (report["embedder"] != "use_dan" or report["n_keys"] != GUSE_KEYS
            or report["captions_per_key"] != GUSE_CAPTIONS
            or report["per_key_files"] != GUSE_KEYS):
        raise RuntimeError(f"guse report {report}")
    if peak > GUSE_PEAK_BYTES:
        raise RuntimeError(f"guse peaked at {peak / 1e9:.2f} GB")
    table = np.load(root / "guse" / "guse_pre_processed.npy", mmap_mode="r")
    if table.shape != (GUSE_KEYS, GUSE_CAPTIONS, 512) or not np.isfinite(
            table[-100:]).all():
        raise RuntimeError(f"guse table {table.shape}")
    del made, table

    cfg.dataset.betas_path = str(root / "guse" / "guse_averaged")
    gather_rows.launches = 0
    out = ingest_run("guse_nic", cfg, device, card)
    k1 = gather_rows.launches
    del out["bundle"]
    release()
    return {"K1": k1, "errors": out["errors"],
            "k1_stores": out["k1_stores"]}


def score_phase(root: Path, bundle: Path, scored: dict, device,
                card: str) -> None:
    """``score`` through the CLI, with the bundle, against the references
    as a JSON dict, on two captions files of the training product's test
    keys: the run's own ``captions_E.txt`` and, since its model emits one
    caption for every row after 2 epochs (which makes every GUSE score 0),
    a control whose caption of each key is its first reference. Each must
    score GUSE_* (not GUSE_hash_*), within GUSE_RTOL of ``run_metrics`` on
    the same captions, and every text metric equal."""
    import os

    from masters_thesis_tpu_torch import cli, experiment
    from masters_thesis_tpu_torch.config import Config

    refs = {}
    for split_pairs in scored["pairs"].values():
        for key, cap, *_ in split_pairs:
            refs.setdefault(int(key), []).append(" ".join(cap.split()[1:-1]))
    (root / "refs.json").write_text(json.dumps(refs))
    control = [refs[int(k)][0] for k in scored["keys"]]
    runs = (("the run's captions", scored["captions"], scored["texts"]),
            ("each key's first reference", "".join(
                f"{k}\t{t}\n" for k, t in zip(scored["keys"], control)),
             control))
    os.environ["MTT_GUSE_WEIGHTS"] = str(bundle)
    try:
        for label, text, texts in runs:
            (root / "captions.txt").write_text(text)
            t0 = time.perf_counter()
            report = with_stdout(cli.main, [
                "score", "--captions", str(root / "captions.txt"),
                "--references", str(root / "refs.json"), "--device",
                str(device)])
            score_s = time.perf_counter() - t0
            want = experiment.run_metrics(
                {"cfg": Config(), "pairs": scored["pairs"]},
                {"texts": texts, "keys": scored["keys"]}, device=device)
            got = report["scores"]
            print(f"score on {label}: {report['n_scored']} of "
                  f"{report['n_candidates']} captions in {score_s:.2f} s: "
                  + ", ".join(f"{k} {got.get(k)} (run_metrics {want[k]})"
                              for k in ("GUSE_pearson_r", "GUSE_mean_corr",
                                        "Bleu_4"))
                  + f" [{card}]")
            if "GUSE_pearson_r" not in got or any(k.startswith("GUSE_hash")
                                                  for k in got):
                raise RuntimeError(f"score labelled {sorted(got)}")
            for key, value in want.items():
                if key.startswith("GUSE"):
                    if abs(got[key] - value) > GUSE_RTOL * max(1.0,
                                                               abs(value)):
                        raise RuntimeError(f"score's {key} {got[key]} "
                                           f"against run_metrics' {value}")
                elif got.get(key) != value:
                    raise RuntimeError(f"score's {key} {got.get(key)} "
                                       f"against run_metrics' {value}")
    finally:
        del os.environ["MTT_GUSE_WEIGHTS"]
    if not want["GUSE_mean_corr"]:
        raise RuntimeError("the control's GUSE scores are 0")


def trial_records(counts: Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(counts.glob("*.json"))]


def print_trials(label: str, records, wall: float, card: str) -> dict:
    """Each trial's wall s and launches, the sweep's wall s and trials an
    hour, each process's peak device memory; the launches summed."""
    for r in records:
        print(f"  {label} trial {r['config']}: {r['wall_s']:.2f} s, K1 "
              f"{r['gather_rows']}, K2 {r['fused_greedy_decode']} (process "
              f"{r['pid']})")
    peaks = {}
    for r in records:
        peaks[r["pid"]] = max(peaks.get(r["pid"], 0), r["peak_bytes"])
    sums = {k: sum(r[k] for r in records)
            for k in ("gather_rows", "fused_greedy_decode")}
    print(f"{label}: {len(records)} trials in {wall:.2f} s, "
          f"{len(records) / wall * 3600:.1f} trials/hour; peak device "
          f"memory by process (allocator) "
          + ", ".join(f"{pid}: {b / 1e9:.2f} GB" for pid, b in peaks.items())
          + f"; launches summed over them K1 {sums['gather_rows']}, K2 "
          f"{sums['fused_greedy_decode']} [{card}]")
    if not sums["gather_rows"] or any(not r["gather_rows"]
                                      for r in records):
        raise RuntimeError(f"{label}: a trial launched no K1: {records}")
    return sums


def tune_phase(root: Path, device, card: str) -> dict:
    """``tune`` through the CLI on ``configs/flagship_synth.yaml`` at
    TUNE_KEYS keys: TUNE_SAMPLES trials in TUNE_PROCESSES spawned processes
    over TUNE_EPOCHS epochs, then ``--queue`` with this process as the
    coordinator and one ``--worker`` process, QUEUE_TRIALS trials. Every
    trial must finish (ASHA may stop it), none in error, every one
    recorded; K1 and K2 are counted in the processes that ran the trials
    (``counted_trial``). Returns the launches summed."""
    import multiprocessing as mp

    from masters_thesis_tpu_torch import cli

    cfg = ingest_config(TUNE_CONFIG, str(root / "tune_logs"))
    yaml = root / "tune.yaml"
    cfg.save(yaml)
    base = ["tune", "--config", str(yaml), "--epochs", str(TUNE_EPOCHS),
            "--smoke-keys", str(TUNE_KEYS), "--device", str(device)]
    sums = {"gather_rows": 0, "fused_greedy_decode": 0}

    counts = root / "counts_processes"
    counts.mkdir()
    t0 = time.perf_counter()
    with counting_trials(counts):
        out = with_stdout(cli.main, [*base, "--num-samples",
                                     str(TUNE_SAMPLES), "--processes",
                                     str(TUNE_PROCESSES)])
    wall = time.perf_counter() - t0
    results = json.loads((root / "tune_logs" / "tune_results.json")
                         .read_text())["trials"]
    print(f"tune --processes {TUNE_PROCESSES}: {out}")
    for t in results:
        print(f"  trial {t['trial_id']}: final val_loss {t['final_metric']}, "
              f"{len(t['history'])} epochs, stopped by ASHA "
              f"{t['stopped_early']}, {t['wall_s']:.2f} s, error "
              f"{t['error']}")
    if (len(results) != TUNE_SAMPLES or out["n_trials"] != TUNE_SAMPLES
            or any(t["error"] or t["final_metric"] is None
                   or not np.isfinite(t["final_metric"]) for t in results)):
        raise RuntimeError(f"tune results {results}")
    records = trial_records(counts)
    if len(records) != TUNE_SAMPLES or len({r["pid"] for r in records}) < 2:
        raise RuntimeError(f"trial records {records}")
    for k, v in print_trials(f"tune --processes {TUNE_PROCESSES}", records,
                             wall, card).items():
        sums[k] += v
    release()

    counts = root / "counts_queue"
    counts.mkdir()
    queue = root / "queue"
    argv = [*base, "--num-samples", str(QUEUE_TRIALS), "--queue", str(queue)]
    ctx = mp.get_context("spawn")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_trials(counts):
        ready = ctx.Event()
        worker = ctx.Process(target=tune_worker,
                             args=([*argv, "--worker"], ready))
        worker.start()
        try:
            if not ready.wait(300):
                raise RuntimeError("the --worker process did not start")
            out = with_stdout(cli.main, argv)
        finally:
            worker.join(timeout=600)
            if worker.is_alive():
                worker.kill()
                worker.join()
    wall = time.perf_counter() - t0
    print(f"tune --queue (this process and one --worker): {out}; the "
          f"worker exited {worker.exitcode}")
    done = [json.loads(p.read_text())
            for p in sorted((queue / "done").glob("*.json"))]
    for r in done:
        print(f"  trial {r['trial_id']} by {r['worker']}: final val_loss "
              f"{r['final_metric']}, {len(r['history'])} epochs, "
              f"{r['wall_s']:.2f} s, error {r.get('error')}")
    if (worker.exitcode != 0 or len(done) != QUEUE_TRIALS
            or out["n_trials"] != QUEUE_TRIALS
            or any(r.get("error") or r["final_metric"] is None
                   for r in done)):
        raise RuntimeError(f"tune --queue records {done}")
    records = trial_records(counts)
    if len(records) != QUEUE_TRIALS or len({r["pid"] for r in records}) < 2:
        raise RuntimeError(f"trial records {records}: the coordinator and "
                           f"the worker must each run a trial")
    for k, v in print_trials("tune --queue", records, wall, card).items():
        sums[k] += v
    return sums


def sweep(device, card: str, scored: dict) -> dict:
    """The sweep phase: the USE encoder at full width (``check_use_encoder``),
    ``guse`` at NSD scale and guse_nic on its output (``guse_nsd``),
    ``score`` with the encoder (``score_phase``) and ``tune`` in processes
    and through a queue (``tune_phase``). Returns K1's and K2's launches
    in the phase's runs (K1's in guse_nic's epoch and the trials, K2's in
    the trials), the K1 check's error and K1's timing on guse_nic's
    store."""
    from masters_thesis_tpu_torch.models.use_encoder import clean_sentence

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_sweep_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        keys, by_key, vocab, oov_share = caption_corpus()
        sentences = [clean_sentence(c) for k in keys[:USE_CHECK_ROWS]
                     for c in by_key[int(k)]][:USE_CHECK_ROWS]
        print(f"sweep corpus: {GUSE_KEYS} keys x {GUSE_CAPTIONS} captions, "
              f"{oov_share:.1%} of the words written outside the bundle's "
              f"vocabulary, made in {time.perf_counter() - t0:.2f} s")
        (root / "use").mkdir()
        bundle = check_use_encoder(root / "use", vocab, sentences, device,
                                   card)
        release()
        guse = guse_nsd(root, bundle, by_key, device, card)
        del by_key
        score_phase(root, bundle, scored, device, card)
        release()
        tuned = tune_phase(root, device, card)
        release()
    launches = {"gather_rows": guse["K1"] + tuned["gather_rows"],
                "fused_greedy_decode": tuned["fused_greedy_decode"]}
    print(f"sweep: the phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches} (K1 {guse['K1']} of them in guse_nic's "
          f"epoch) [{card}]")
    return {"launches": launches, "errors": guse["errors"],
            "k1_stores": guse["k1_stores"]}


# ---- the parallel phase: ranks on the card, --shard, dryrun (parallel/)

PARALLEL_KEYS = 256                 # 13 train steps at batch 64
PARALLEL_PAD = 8                    # tpu.vocab_pad_multiple: 5,001 -> 5,008
PARALLEL_MESHES = ((1, 2), (2, 1))  # (data, model), 2 ranks on cuda:0
PARALLEL_LOSS_ATOL = 1e-4
PARALLEL_STORE_SHARD = 2            # K1 on rank 0's columns of a 1 x 2 mesh
DRYRUN_RANKS = 4


def parallel_config(log: str, **tpu):
    """``configs/flagship_synth.yaml`` for one epoch with its vocab padded
    to 5,008, its ``tpu:`` knobs set from ``tpu``."""
    from masters_thesis_tpu_torch.config import Config

    cfg = Config.load(EXPERIMENT_CONFIG)
    cfg.log, cfg.epochs = log, 1
    cfg.tpu.vocab_pad_multiple = PARALLEL_PAD
    for knob, value in tpu.items():
        setattr(cfg.tpu, knob, value)
    return cfg


def parallel_runs(root: Path, device, card: str) -> dict:
    """``run_training`` four ways: in this process (no mesh, then
    ``mesh_data: 0`` over a process group of one rank, NCCL), then through
    ``train --processes 2 --devices-per-process 1`` at data 1 x model 2 and
    data 2 x model 1, two ranks sharing the card under gloo. Every run's
    epoch loss within PARALLEL_LOSS_ATOL of the single-process run's, and
    K1 on every train and val batch of every rank."""
    import torch.distributed as dist

    from masters_thesis_tpu_torch import cli, experiment
    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.parallel import multiprocess as mp

    runs, batches = {}, None
    for label, tpu in (("single", {}), ("1 rank", {"mesh_data": 0})):
        cfg = parallel_config(str(root / label.replace(" ", "_")), **tpu)
        gather_rows.launches = 0
        t0 = time.perf_counter()
        run_path, logs, bundle = experiment.run_training(
            cfg, smoke_keys=PARALLEL_KEYS, device=device)
        torch.cuda.synchronize()
        report = mp._training_report(run_path, bundle, logs)
        report["wall_s"] = time.perf_counter() - t0
        if batches is None:
            batches = (len(bundle["pairs"]["train"]) // cfg.batch_size
                       + len(bundle["pairs"]["val"]) // cfg.batch_size)
        if label == "1 rank":
            report["backend"] = dist.get_backend()
            dist.destroy_process_group()
        runs[label] = report
        del bundle
        release()
    for d, m in PARALLEL_MESHES:
        label = f"{d}x{m}"
        cfg = parallel_config(str(root / label), mesh_data=d, mesh_model=m)
        path = root / f"{label}.yaml"
        cfg.save(path)
        t0 = time.perf_counter()
        report = with_stdout(cli.main, [
            "train", "--config", str(path), "--processes", str(d * m),
            "--devices-per-process", "1", "--smoke-keys",
            str(PARALLEL_KEYS), "--device", device.type])
        report["wall_s"] = time.perf_counter() - t0
        report["backend"] = "gloo"
        runs[label] = report
    want = runs["single"]["epoch_losses"]
    for label, r in runs.items():
        diff = max(abs(a - b) for a, b in zip(r["epoch_losses"], want))
        vdiff = max(abs(a - b) for a, b in zip(r["epoch_val_losses"],
                                               runs["single"]
                                               ["epoch_val_losses"]))
        k1 = r["launches_by_rank"]["gather_rows"]
        print(f"parallel {label}: mesh {r['mesh']}, "
              f"{r.get('ranks', 1)} rank(s) on the card "
              f"({r.get('backend', 'no group')}), loss "
              f"{r['epoch_losses']}, val loss {r['epoch_val_losses']}, "
              f"|loss - single| {diff:.3e} (limit {PARALLEL_LOSS_ATOL}), "
              f"|val loss - single| {vdiff:.3e}, steps/s "
              f"{r['steps_per_sec']}, param norm {r['param_norm']:.6f}, K1 "
              f"launches by rank {k1} ({batches} train and val batches), "
              f"run {r['wall_s']:.1f} s [{card}]")
        if len(r["epoch_losses"]) != 1 or diff > PARALLEL_LOSS_ATOL:
            raise RuntimeError(f"parallel {label}: epoch losses "
                               f"{r['epoch_losses']} against the single "
                               f"process's {want}")
        if min(k1) < batches:
            raise RuntimeError(f"parallel {label}: K1 launched {k1} times "
                               f"by rank, for {batches} batches a rank")
    return runs


def check_rank_restore(run_path: str, report: dict, device,
                       card: str) -> None:
    """The multi-rank run's checkpoint restored in this process, on one
    device: its whole state bit for bit (SHA-256)."""
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel.multiprocess import _state_sha256
    from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
    from masters_thesis_tpu_torch.train.state import model_for, new_state

    cfg = Config.load(Path(run_path) / "config.yaml")
    layout = GroupLayout.load(Path(run_path) / "layout.npz")
    state = new_state(model_for(cfg, layout), cfg, device)
    _, epoch = CheckpointManager(str(Path(run_path) / "model")).restore(state)
    sha = _state_sha256(state.model.state_dict())
    print(f"parallel: the data 1 x model 2 run's epoch-{epoch} checkpoint "
          f"restored on one device: SHA-256 {sha[:16]}..., the run's "
          f"{report['state_sha256'][:16]}... [{card}]")
    if sha != report["state_sha256"]:
        raise RuntimeError("the multi-rank checkpoint did not restore bit "
                           "for bit")


def check_shard_serving(run_path: str, tok, device, card: str) -> tuple:
    """K2 against its plain version at vocab 5,008; ``Captioner(shard=1)``
    on that model against K2's plain words, near-ties excepted and counted,
    its K2 launches counted; and ``caption --shard 1`` on the
    single-process run against ``caption``."""
    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    model = flagship_model(device, vocab_size=WIDTHS["vocab_size"]
                           + (-WIDTHS["vocab_size"]) % PARALLEL_PAD,
                           true_vocab=WIDTHS["vocab_size"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    k2 = check_kernel(model, rows, card, f"K2 at vocab {model.vocab_size}")
    _, reference = fd.decode_kernel(model)
    opts = fd.decode_options(model)
    inputs = fd.decode_inputs(model, rows, tok.start_id)
    want, _, margins = reference(*inputs, max_length=model.max_length,
                                 return_margins=True, **opts)
    sharded = Captioner(model, tok, WIDTHS["units"], model.max_length,
                        batch_size=BATCH, device=device, shard=1)
    fd.fused_greedy_decode.launches = 0
    got = torch.as_tensor(sharded.caption_ids(rows.cpu().numpy()))
    launches = fd.fused_greedy_decode.launches
    differ = (got != want.cpu()).any(1)
    ties = differ & (margins.cpu().min(1).values < TIE_MARGIN)
    print(f"caption --shard 1 (Captioner, {len(sharded.replicas)} replica) "
          f"vs K2's plain version at vocab {model.vocab_size}: "
          f"{int((~differ).sum())}/{BATCH} rows identical, near-tie rows "
          f"{int(ties.sum())}, K2 launches {launches} [{card}]")
    if bool((differ & ~ties).any()) or launches < 1:
        raise RuntimeError(f"--shard 1 serving: rows "
                           f"{differ.nonzero().flatten().tolist()} differ "
                           f"away from near-ties, K2 launches {launches}")
    meta = json.loads((Path(run_path) / "run_meta.json").read_text())
    with tempfile.TemporaryDirectory(prefix="mtt_shard_") as tmp:
        betas = Path(tmp) / "rows.npy"
        np.save(betas, np.random.default_rng(SEED).standard_normal(
            (BATCH, *meta["input_row_shape"]), dtype=np.float32))
        texts = {}
        for shard in ("0", "1"):
            out = Path(tmp) / f"{shard}.txt"
            with_stdout(cli.main, ["caption", "--run", run_path, "--betas",
                                   str(betas), "--shard", shard, "--out",
                                   str(out), "--device", device.type])
            texts[shard] = out.read_text()
    print(f"caption --shard 1 on the single-process run: the words of "
          f"caption, {texts['1'] == texts['0']} [{card}]")
    if texts["1"] != texts["0"]:
        raise RuntimeError("caption --shard 1 differs from caption")
    return k2, launches


def parallel(tok, device, card: str) -> dict:
    """The parallel phase: ``parallel_runs``, the 1 x 2 run's checkpoint
    restored here, K1 against its plain version (and timed beside
    ``index_select``) on a rank's store of a 1 x 2 mesh, K2 at vocab 5,008
    and ``--shard 1`` serving, then ``dryrun --devices 4`` and ``dryrun
    --flagship``. Multi-card scaling is not measured: the machine has one
    card, which the ranks share."""
    from types import SimpleNamespace

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.data.store import ArrayStore
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.parallel.sharding import shard_store_array

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_parallel_") as tmp:
        root = Path(tmp)
        runs = parallel_runs(root, device, card)
        check_rank_restore(runs["1x2"]["run_path"], runs["1x2"], device,
                           card)
        layout = GroupLayout.load(Path(runs["single"]["run_path"])
                                  / "layout.npz")
        gen = torch.Generator(device=device).manual_seed(SEED)
        raw = torch.randn(PARALLEL_KEYS, N_VOXELS, generator=gen,
                          device=device)
        rank = SimpleNamespace(m=0, model=PARALLEL_STORE_SHARD)
        store = ArrayStore(shard_store_array(raw, layout, rank),
                           range(PARALLEL_KEYS), device=device)
        del raw
        print(f"K1 on rank 0's store of a 1 x {PARALLEL_STORE_SHARD} mesh: "
              f"{tuple(store.device_array().shape)}, of the "
              f"{layout.padded_total} grouped columns")
        k1 = check_gather(store.device_array(), card)
        del store
        release()
        k2, k2_launches = check_shard_serving(runs["single"]["run_path"],
                                              tok, device, card)
        release()
    t0 = time.perf_counter()
    cli.main(["dryrun", "--devices", str(DRYRUN_RANKS), "--device",
              device.type])
    cli.main(["dryrun", "--devices", "8", "--flagship", "--device",
              device.type])
    print(f"dryrun: {time.perf_counter() - t0:.1f} s")
    k1_launches = sum(sum(r["launches_by_rank"]["gather_rows"])
                      for r in runs.values())
    print(f"parallel: the phase in {time.perf_counter() - t_phase:.1f} s; "
          f"K1 launches {k1_launches} over the four runs' ranks, K2 "
          f"{k2_launches} [{card}]")
    return {"K1": k1, "K2": k2, "launches": {"gather_rows": k1_launches,
                                             "fused_greedy_decode":
                                                 k2_launches}}


# ---- mixed precision and remat (M16 and M15) ----

PRECISION_KEYS = 256                # 13 train steps of one epoch at 64
PRECISION_RUNS = (
    ("fp32", {}),
    ("bf16", {"compute_dtype": "bfloat16"}),
    ("fp32 + remat", {"remat": True}),
    ("bf16 + remat", {"compute_dtype": "bfloat16", "remat": True}),
    # the fused route from a bf16 store, its bf16 run against its fp32 one
    # (its attention masks come from another stream than autograd's)
    ("fp32 fused_seq", {"fused_seq": True, "store_dtype": "bfloat16"}),
    ("bf16 fused_seq", {"compute_dtype": "bfloat16", "fused_seq": True,
                        "store_dtype": "bfloat16"}),
)
REMAT_TWINS = {"fp32 + remat": "fp32", "bf16 + remat": "bf16"}
BF16_TWINS = {"bf16": "fp32", "bf16 + remat": "fp32 + remat",
              "bf16 fused_seq": "fp32 fused_seq"}
REMAT_RTOL = 1e-5                   # a remat run's epoch loss vs its twin's
# |bf16 - fp32| / fp32 of the epoch loss, stated before the first bf16 run
# on the card: the same masks and data, the weights and betas rounded
BF16_LOSS_BAND = 1e-2
WIDE_MEMORY = dict(units=2048, batch_size=256)  # JAX config.py:80-84
# the bf16 K4 against its plain version, step by step on the kernel's own
# carries: fp32 sums in another order (~1e-5), and now and then a rounding
# to bf16 that the last bit of ctx flips, which moves that input by 2^-8 of
# itself and the whole row of the step's z by up to that times a weight
# (about one row in a thousand on the flagship's inputs): at most
# BF16_FLIP_ROWS of a residual's (t, b) rows may be off by more than
# BF16_STEP_ATOL, and no entry by more than BF16_SEQ_ATOL
BF16_STEP_ATOL, BF16_FLIP_ROWS, BF16_SEQ_ATOL = 1e-4, 0.02, 1e-2
# over the whole sequence the rounding of h to bf16 each step turns the
# kernel's last-bit differences into bf16 ones within a few steps: the
# kernel must stay no farther from the plain version than this share of
# the fp32 plain version's distance to it (the bf16 noise itself)
BF16_FREE_SHARE = 1.0
SEQ_TURNS = 5           # fp32 and bf16 K4 timed in alternate turns


def precision_runs(root: Path, device, card: str) -> dict:
    """``run_training`` of ``configs/flagship_synth.yaml`` (1 epoch at 256
    keys, from the device store through K1) the six ways of
    ``PRECISION_RUNS``: each run's epoch loss, steps/s, peak device memory
    and K1 and K4 launches; each remat run's loss within REMAT_RTOL of its
    twin's, each bf16 run's within BF16_LOSS_BAND of its fp32 twin's, every
    loss
    finite, K1 on every train and val batch, the chosen dtype in
    ``run_meta.json``."""
    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops import fused_seq as fs
    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.parallel import multiprocess as mp

    runs = {}
    for label, tpu in PRECISION_RUNS:
        cfg = Config.load(EXPERIMENT_CONFIG)
        cfg.log, cfg.epochs = str(root / label.replace(" ", "_")), 1
        for knob, value in tpu.items():
            setattr(cfg.tpu, knob, value)
        gather_rows.launches = 0
        fs.fused_seq_forward.launches = fs.fused_seq_forward.launches_bf16 = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_path, logs, bundle = experiment.run_training(
            cfg, smoke_keys=PRECISION_KEYS, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report = mp._training_report(run_path, bundle, logs)
        meta = json.loads((Path(run_path) / "run_meta.json").read_text())
        batches = (len(bundle["pairs"]["train"]) // cfg.batch_size
                   + len(bundle["pairs"]["val"]) // cfg.batch_size)
        runs[label] = r = {
            "loss": report["epoch_losses"][0],
            "val_loss": report["epoch_val_losses"][0],
            "steps_per_s": report["steps_per_sec"][0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "K1": gather_rows.launches,
            "K4": fs.fused_seq_forward.launches,
            "K4_bf16": fs.fused_seq_forward.launches_bf16,
            "compute_dtype": meta["compute_dtype"], "wall_s": wall}
        print(f"precision {label}: tpu {tpu or 'defaults'}, forward in "
              f"{r['compute_dtype']}, epoch loss {r['loss']:.9f}, val loss "
              f"{r['val_loss']:.9f}, steps/s {r['steps_per_s']:.2f}, peak "
              f"device memory {r['peak_gb']:.3f} GB, K1 launches {r['K1']} "
              f"({batches} train and val batches), K4 launches fp32 "
              f"{r['K4']} bf16 {r['K4_bf16']}, run {wall:.1f} s [{card}]")
        want = "bfloat16" if tpu.get("compute_dtype") else "float32"
        if not (np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])):
            raise RuntimeError(f"precision {label}: a loss is not finite")
        if r["compute_dtype"] != want or r["K1"] < batches:
            raise RuntimeError(f"precision {label}: forward in "
                               f"{r['compute_dtype']} (want {want}), K1 "
                               f"launched {r['K1']} times for {batches} "
                               f"batches")
        del bundle
        release()
    for label, r in runs.items():
        twin = REMAT_TWINS.get(label)
        if twin is not None:
            rel = abs(r["loss"] - runs[twin]["loss"]) / abs(runs[twin]["loss"])
            print(f"precision {label} vs {twin}: epoch loss rel diff "
                  f"{rel:.3e} (limit {REMAT_RTOL}), peak memory "
                  f"{r['peak_gb']:.3f} vs {runs[twin]['peak_gb']:.3f} GB")
            if rel > REMAT_RTOL:
                raise RuntimeError(f"precision {label}: epoch loss "
                                   f"{r['loss']} leaves {twin}'s")
        twin = BF16_TWINS.get(label)
        if twin is not None:
            base = runs[twin]["loss"]
            rel = abs(r["loss"] - base) / abs(base)
            print(f"precision {label} vs {twin}: epoch loss rel diff "
                  f"{rel:.3e} (band {BF16_LOSS_BAND}), steps/s "
                  f"{r['steps_per_s']:.2f} vs {runs[twin]['steps_per_s']:.2f}"
                  f", peak memory {r['peak_gb']:.3f} vs "
                  f"{runs[twin]['peak_gb']:.3f} GB")
            if rel > BF16_LOSS_BAND:
                raise RuntimeError(f"precision {label}: epoch loss "
                                   f"{r['loss']} outside the band around "
                                   f"{twin}'s {base}")
    return runs


def wide_memory(device, card: str) -> dict:
    """One train step of LcNIC at the flagship encoder and units 2,048,
    batch 256 (the JAX package's wide shape) with and without remat, in
    fp32 and bf16: peak device memory of the step and its ms."""
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import init_model

    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=SEED),
                         N_VOXELS)
    B, T = WIDE_MEMORY["batch_size"], WIDTHS["max_length"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    betas = torch.randn(B, N_VOXELS, generator=gen, device=device)
    tokens = torch.randint(1, WIDTHS["vocab_size"], (B, T), generator=gen,
                           device=device)
    target = torch.roll(tokens, -1, 1)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for remat in (False, True):
            cfg = train_config()
            cfg.units, cfg.batch_size = (WIDE_MEMORY["units"],
                                         WIDE_MEMORY["batch_size"])
            cfg.tpu.compute_dtype, cfg.tpu.remat = dtype, remat
            state = init_model(cfg, layout, device)
            step = steps.make_train_step(cfg, lc_nic_l2_rules(cfg))
            state, m = step(state, betas, tokens, target)      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: step(state, betas, tokens, target), reps=3,
                         warmup=0)
            peak = torch.cuda.max_memory_allocated()
            label = f"{dtype}{' + remat' if remat else ''}"
            out[label] = {"peak_gb": peak / 1e9,
                          "step_gb": (peak - before) / 1e9, "ms": ms}
            print(f"wide step (units {cfg.units}, batch {B}) {label}: peak "
                  f"device memory {peak / 1e9:.3f} GB, of it "
                  f"{(peak - before) / 1e9:.3f} GB above the state, "
                  f"{ms:.2f} ms a step, loss {float(m['loss']):.6f} "
                  f"[{card}]")
            if not np.isfinite(float(m["loss"])):
                raise RuntimeError(f"wide step {label}: loss not finite")
            del state, step, m
            release()
    return out


def seq_bound_bf16(inputs) -> dict:
    """``bound`` of one bf16-weight K4 forward: as ``seq_bound`` with 2
    bytes for each weight element of W2, Wx and Wh, and the multiply-adds
    at the bf16 tensor-core peak."""
    pre, features, emb, w2, b2, v, bv, wx, wh, b = inputs
    B, R, A = pre.shape
    T, E = emb.shape[1:]
    D, U = features.shape[2], w2.shape[0]
    read = sum(t.numel() * t.element_size() for t in inputs)
    written = 4 * T * B * (U + U + R + 4 * U + A)
    fma = B * T * (U * A + R * A + R * D + (D + E + U) * 4 * U)
    return bound(read + written, 2 * fma, BF16_FLOPS)


@torch.inference_mode()
def check_seq_kernel_bf16(inputs, attn_slope: float, card: str,
                          label: str) -> dict:
    """The bf16-weight K4 against its plain version on ``inputs`` (fp32;
    W2, Wx and Wh cast to bf16): each step on the kernel's own carries,
    residual by residual, within BF16_STEP_ATOL but for BF16_FLIP_ROWS of
    its rows and within BF16_SEQ_ATOL for all, and the whole sequence no
    farther from the plain version than BF16_FREE_SHARE of the fp32 plain
    version's distance to it; then the bf16 and the fp32 K4 timed in
    alternate turns, and the plain version. Returns the entry of the
    kernels line, less its launches."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    names = ("h", "c", "alpha", "z", "hw_pre")
    half = tuple(t.to(torch.bfloat16) if k in fs.BF16_ARGS else t
                 for k, t in zip(fs.SEQ_ARGS, inputs))
    got = fs.fused_seq_forward(*half, attn_slope)
    torch.cuda.synchronize()
    stepped = fs.fused_seq_forward_reference(*half, attn_slope,
                                             carries=(got[0], got[1]))
    want = fs.fused_seq_forward_reference(*half, attn_slope)
    fp32 = fs.fused_seq_forward_reference(*inputs, attn_slope)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    errs = {n: err(g, w) for n, g, w in zip(names, got, stepped)}
    flips = {n: float(((g - w).abs() > BF16_STEP_ATOL).any(-1).float()
                      .mean()) for n, g, w in zip(names, got, stepped)}
    free = {n: err(g, w) for n, g, w in zip(names, got, want)}
    control = {n: err(f, w) for n, f, w in zip(names, fp32, want)}
    B, T, R = got[2].shape
    show = lambda e: ", ".join(f"{n} {x:.3e}" for n, x in e.items())  # noqa
    print(f"{label} vs plain at B={B} T={T} R={R}, step by step on the "
          f"kernel's carries: max abs err {show(errs)} (limit "
          f"{BF16_SEQ_ATOL}), share of rows off by more than "
          f"{BF16_STEP_ATOL} {show(flips)} (limit {BF16_FLIP_ROWS}); the "
          f"whole sequence: {show(free)}, the fp32 plain version's distance "
          f"to the bf16 one {show(control)} [{card}]")
    if not all(torch.isfinite(g).all() for g in got):
        raise RuntimeError(f"{label} produced a value that is not finite")
    if max(errs.values()) > BF16_SEQ_ATOL or max(flips.values()) > (
            BF16_FLIP_ROWS) or any(free[n] > BF16_FREE_SHARE * control[n]
                                    for n in names):
        raise RuntimeError(f"{label} disagrees with its plain version: "
                           f"step by step {errs}, whole {free}, fp32 "
                           f"{control}")
    times = {"fp32": [], "bf16": []}
    for _ in range(SEQ_TURNS):
        for which, args in (("fp32", inputs), ("bf16", half)):
            times[which].append(cuda_ms(
                lambda a=args: fs.fused_seq_forward(*a, attn_slope)))
    ms, fp32_ms = (float(np.median(times[k])) for k in ("bf16", "fp32"))
    plain_ms = cuda_ms(lambda: fs.fused_seq_forward_reference(*half,
                                                              attn_slope))
    work = seq_bound_bf16(half)
    print(f"{label} forward at B={B}, T={T}: bf16 kernel {ms:.4f} ms "
          f"(turns {min(times['bf16']):.4f}-{max(times['bf16']):.4f}), fp32 "
          f"K4 {fp32_ms:.4f} ms in the same turns "
          f"({min(times['fp32']):.4f}-{max(times['fp32']):.4f}), plain "
          f"version {plain_ms:.4f} ms, bound {work['bound_ms']:.4f} ms (by "
          f"{work['bound_by']}, 3.35 TB/s and 989 TFLOP/s dense bf16) "
          f"[{card}]")
    return {"max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, **work, "library_ms": None,
            "fp32_ms": fp32_ms}


@torch.inference_mode()
def split_seq_bf16(inputs, attn_slope: float, card: str, label: str) -> dict:
    """The bf16-weight K4's tensor-core products on their own: its device
    time a step by part (h W2, attention, the cell) by ``torch.profiler``
    on ``inputs`` (fp32; W2, Wx and Wh cast to bf16), and the cell's
    TFLOP/s at its 2 B (D + E + U) 4U operations a step; None where the
    profile kept no kernel of a part. The fused-sequence phase takes it:
    late in a run the profiler has kept none of a call's kernels."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    half = tuple(t.to(torch.bfloat16) if k in fs.BF16_ARGS else t
                 for k, t in zip(fs.SEQ_ARGS, inputs))
    B, T, E = half[2].shape
    D, U = half[1].shape[2], half[3].shape[0]
    split = step_split(lambda: fs.fused_seq_forward(*half, attn_slope),
                       label, T, STEP_PARTS["seq_bf16"], card)
    cell = split["cell (mma)"]
    tflops = None if cell is None else 2 * B * (D + E + U) * 4 * U / cell / 1e6
    print(f"{label}: the cell's launches "
          + ("not measured (not in the profile)" if cell is None else
             f"{cell:.2f} us a step by torch.profiler, {tflops:.1f} TFLOP/s "
             f"of the 989 dense bf16") + f" [{card}]")
    return {"us_a_step": split, "cell_tflops": tflops}


def precision(device, card: str) -> dict:
    """The precision phase: ``precision_runs``, ``wide_memory``, the
    bf16-weight K4 against its plain version at the flagship and the wide
    shape (timed beside the fp32 K4), then, its count set to 0, the bf16
    sequence (``make_fused_sequence(backend="kernel",
    compute_dtype=bfloat16)``) forward and backward on the flagship model,
    which must launch the bf16 K4. Returns its entry of the kernels line
    and the runs."""
    from masters_thesis_tpu_torch.ops import fused_seq as fs

    t_phase = time.perf_counter()
    # checkpoint's first call imports torch's compiler stack (seconds): do
    # it before the runs, so that no run's steps/s carries it
    from torch.utils.checkpoint import checkpoint

    checkpoint(torch.square, torch.ones(1, device=device, requires_grad=True),
               use_reentrant=False)
    with tempfile.TemporaryDirectory(prefix="mtt_precision_") as tmp:
        runs = precision_runs(Path(tmp), device, card)
    memory = wide_memory(device, card)
    slope = 0.2
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = flagship_model(device)
    T, V = WIDTHS["max_length"], WIDTHS["vocab_size"]
    betas = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    tokens = torch.randint(1, V, (BATCH, T), generator=gen, device=device)
    inputs = seq_inputs(model, betas, tokens)
    k4 = check_seq_kernel_bf16(inputs, slope, card, "bf16 K4 (flagship)")
    dec = decoder_model(device, PROBE_WIDE,
                        torch.Generator().manual_seed(SEED))
    features = torch.randn(PROBE_WIDE_BATCH, N_GROUPS,
                           PROBE_WIDE["group_size"], generator=gen,
                           device=device)
    toks = torch.randint(1, PROBE_WIDE["vocab_size"],
                         (PROBE_WIDE_BATCH, PROBE_WIDE["max_length"]),
                         generator=gen, device=device)
    wide = check_seq_kernel_bf16(seq_inputs(dec, features, toks), slope,
                                 card, "bf16 K4 (the probe's wide shape)")
    k4["wide"] = {"shape": f"B {PROBE_WIDE_BATCH}, U "
                  f"{PROBE_WIDE['units']}, A {PROBE_WIDE['attn_units']}, D "
                  f"{PROBE_WIDE['group_size']}, E "
                  f"{PROBE_WIDE['embedding_text']}, R {N_GROUPS}, T "
                  f"{PROBE_WIDE['max_length']}", **wide}
    del dec, features, toks
    release()

    # the path: the bf16 sequence's forward (K4) and custom backward
    seq = fs.make_fused_sequence(slope, "kernel",
                                 compute_dtype=torch.bfloat16)
    pre, feats, emb = (t.detach().requires_grad_(True) for t in inputs[:3])
    w = {k: t.detach().requires_grad_(True)
         for k, t in zip(fs.W_KEYS, inputs[3:])}
    fs.fused_seq_forward.launches_bf16 = 0
    hseq, alphas = seq(w, pre, feats, emb)
    grads = torch.autograd.grad(hseq.square().sum() + alphas.sum(),
                                [pre, feats, emb, *w.values()])
    torch.cuda.synchronize()
    launches = fs.fused_seq_forward.launches_bf16
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"bf16 K4 launches through make_fused_sequence(backend='kernel', "
          f"compute_dtype=bfloat16), forward and custom backward: "
          f"{launches}; gradients finite and fp32: "
          f"{finite and all(g.dtype == torch.float32 for g in grads)}")
    if launches < 1 or not finite:
        raise RuntimeError("the bf16 sequence never launched the bf16 K4, "
                           "or its gradients are not finite")
    print(f"precision: the phase in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return {"K4": {"launches": launches, **k4}, "runs": runs,
            "wide_memory": memory}


# ---- the plain-route phase: tpu.use_pallas false and the scanned decoders

PLAIN_KEYS = 256                    # 13 train steps of one epoch at 64
SCANNED_GREEDY = (16, 64)           # K stacked batches of B rows
SCANNED_BEAM = (4, 64)
SCANNED_BEAM_WIDTH = 5
SCANNED_REPS = 3


def plain_route_run(root: Path, use_pallas: bool, device, card: str,
                    mesh: bool = False) -> dict:
    """``run_training`` of ``configs/flagship_synth.yaml`` (1 epoch at
    PLAIN_KEYS keys) and ``run_eval`` greedy with ``tpu.use_pallas`` as
    given (with ``mesh``, on a mesh of one rank, NCCL, and no eval): the
    epoch and val losses, steps/s, eval captions/s, the words by test key,
    and K1's, K2's and K3's launches in each part, K1's also as the rank
    report counts them."""
    import torch.distributed as dist

    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.parallel import multiprocess as mp

    kernels = {"K1": gather_rows, "K2": fd.fused_greedy_decode,
               "K3": fd.fused_greedy_decode_gru}
    label = f"use_pallas {use_pallas}" + (", a 1-rank mesh" if mesh else "")
    cfg = Config.load(EXPERIMENT_CONFIG)
    cfg.log, cfg.epochs = str(root / label.replace(" ", "_")), 1
    cfg.tpu.use_pallas = use_pallas
    if mesh:
        cfg.tpu.mesh_data = 0
    for k in kernels.values():
        k.launches = 0
    run_path, logs, bundle = experiment.run_training(
        cfg, smoke_keys=PLAIN_KEYS, device=device)
    torch.cuda.synchronize()
    train = {n: k.launches for n, k in kernels.items()}
    report = mp._training_report(run_path, bundle, logs)
    if mesh:
        dist.destroy_process_group()
        r = {"loss": report["epoch_losses"][0],
             "val_loss": report["epoch_val_losses"][0],
             "steps_per_s": report["steps_per_sec"][0], "train": train,
             "by_rank": report["launches_by_rank"]["gather_rows"]}
        print(f"plain route: {label}: mesh {report['mesh']}, epoch loss "
              f"{r['loss']!r}, val loss {r['val_loss']!r}, steps/s "
              f"{r['steps_per_s']:.2f}; launches {train}, K1 by rank "
              f"{r['by_rank']} [{card}]")
        return r
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = experiment.run_eval(bundle, run_path)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    evals = {n: k.launches for n, k in kernels.items()}
    batches = (len(bundle["pairs"]["train"]) // cfg.batch_size
               + len(bundle["pairs"]["val"]) // cfg.batch_size)
    n = len(out["texts"])
    r = {"loss": report["epoch_losses"][0],
         "val_loss": report["epoch_val_losses"][0],
         "steps_per_s": report["steps_per_sec"][0],
         "eval_captions_per_s": n / eval_s, "train": train, "eval": evals,
         "words": out["words"], "keys": out["keys"], "bundle": bundle,
         "test_batches": -(-n // min(cfg.batch_size, n)),
         "train_batches": batches}
    print(f"plain route: {label}: epoch loss {r['loss']!r}, "
          f"val loss {r['val_loss']!r}, steps/s {r['steps_per_s']:.2f}; "
          f"run_eval {n} captions in {eval_s:.3f} s, "
          f"{r['eval_captions_per_s']:.1f} captions/s (host clock); launches "
          f"in run_training {train} ({batches} train and val batches), in "
          f"run_eval {evals} ({r['test_batches']} test batches) [{card}]")
    return r


def check_plain_words(off: dict, on: dict, start_id: int, card: str) -> int:
    """The knob-off run's eval words (the step loop) against the knob-on
    run's (K2), one row a test key: equal but at near-ties of the plain
    greedy decode (top-2 margin < TIE_MARGIN), which are counted."""
    if not np.array_equal(off["keys"], on["keys"]):
        raise RuntimeError("the two routes decoded other test pairs")
    bundle = on["bundle"]
    store, model = bundle["store"], bundle["model"]
    _, first = np.unique(on["keys"], return_index=True)
    first = np.sort(first)
    idx = torch.as_tensor(store.indices_for(on["keys"][first]),
                          device=store.device)
    rows = store.device_array().index_select(0, idx.long()).float()
    was_training = model.training
    model.eval()
    try:
        return near_tie_rows(model, rows.cpu().numpy(), off["words"][first],
                             on["words"][first], start_id,
                             bundle["cfg"].max_length,
                             "plain route: use_pallas false words (step "
                             "loop) vs use_pallas true (K2), a row a test "
                             "key", card)
    finally:
        model.train(was_training)


def plain_runs(root: Path, device, card: str) -> dict:
    """The knob twice from one seed, true then false: K1 and K2 launched
    in the first run, K1, K2 and K3 never in the second; the epoch and val
    losses equal bit for bit (a gather is a copy), or, if a second true run
    shows that the card's reductions are not deterministic, the false run
    within that spread; the words equal but at near-ties. Then false on a
    mesh of one rank: no launch, K1's count by rank 0, the losses within
    PARALLEL_LOSS_ATOL of the false run's."""
    on = plain_route_run(root, True, device, card)
    off = plain_route_run(root, False, device, card)
    meshed = plain_route_run(root, False, device, card, mesh=True)
    if (on["train"]["K1"] < on["train_batches"]
            or on["eval"]["K2"] < on["test_batches"]):
        raise RuntimeError(f"use_pallas true: K1 {on['train']['K1']} for "
                           f"{on['train_batches']} batches, K2 "
                           f"{on['eval']['K2']} for {on['test_batches']}")
    if (any(off["train"].values()) or any(off["eval"].values())
            or any(meshed["train"].values()) or any(meshed["by_rank"])):
        raise RuntimeError(f"use_pallas false launched a kernel: "
                           f"{off['train']}, {off['eval']}, on the mesh "
                           f"{meshed['train']}, {meshed['by_rank']}")
    apart = max(abs(meshed[k] - off[k]) for k in ("loss", "val_loss"))
    print(f"plain route: the 1-rank mesh's losses {apart:.3e} from the "
          f"false run's (limit {PARALLEL_LOSS_ATOL}) [{card}]")
    if apart > PARALLEL_LOSS_ATOL:
        raise RuntimeError("use_pallas false on a 1-rank mesh trained "
                           "another model")
    keys = ("loss", "val_loss")
    if all(off[k] == on[k] for k in keys):
        print(f"plain route: epoch and val losses of the two routes equal "
              f"bit for bit [{card}]")
    else:
        again = plain_route_run(root, True, device, card)
        spread = max(abs(again[k] - on[k]) for k in keys)
        apart = max(abs(off[k] - on[k]) for k in keys)
        print(f"plain route: the losses differ by {apart!r}; held to the "
              f"true route's own spread over two runs, {spread!r} [{card}]")
        if spread == 0.0 or apart > spread:
            raise RuntimeError("use_pallas false trained another model")
        del again
    check_plain_words(off, on, on["bundle"]["tokenizer"].start_id, card)
    print(f"plain route: steps/s {off['steps_per_s']:.2f} (library take) vs "
          f"{on['steps_per_s']:.2f} (K1); eval captions/s "
          f"{off['eval_captions_per_s']:.1f} (step loop) vs "
          f"{on['eval_captions_per_s']:.1f} (K2) [{card}]")
    return {"twin": {n: on["train"][n] + on["eval"][n] for n in on["train"]},
            "route": {n: off["train"][n] + off["eval"][n]
                      + meshed["train"][n] for n in off["train"]}}


@torch.inference_mode()
def check_scanned(device, tok, card: str) -> None:
    """The scanned greedy and beam decoders on the flagship LcNIC (fp32,
    TF32 off): each slice of K stacked batches equals a single call of the
    unfused decoder bit for bit; captions/s of each scanned call, and of
    K2 over the same greedy rows batch by batch (CUDA events)."""
    from masters_thesis_tpu_torch.decode import (
        make_beam_decoder,
        make_greedy_decoder,
        make_scanned_beam_decoder,
        make_scanned_greedy_decoder,
    )
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    model = flagship_model(device)
    T, start, end = model.max_length, tok.start_id, tok.end_id
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rates = {}
    K, B = SCANNED_GREEDY
    betas = torch.randn(K, B, N_VOXELS, generator=gen, device=device)
    scanned = make_scanned_greedy_decoder(model, T)
    words = scanned(betas, start)
    single = make_greedy_decoder(model, T)
    same = all(torch.equal(words[k], single(betas[k], start)[0])
               for k in range(K))
    rates["greedy"] = K * B / cuda_ms(lambda: scanned(betas, start),
                                      reps=SCANNED_REPS, warmup=1) * 1e3
    fused = fd.make_whole_fused_greedy_decoder(model, T)
    rates["K2"] = K * B / cuda_ms(lambda: [fused(b, start) for b in betas],
                                  reps=SCANNED_REPS, warmup=1) * 1e3
    print(f"scanned greedy, K {K} x B {B}: each slice equals a single "
          f"unfused call bit for bit: {same}; {rates['greedy']:.1f} "
          f"captions/s, K2 batch by batch on the same rows "
          f"{rates['K2']:.1f} captions/s (CUDA events, {SCANNED_REPS} calls) "
          f"[{card}]")
    if not same:
        raise RuntimeError("a slice of the scanned greedy decoder differs "
                           "from its single call")
    if len(torch.unique(words)) < MIN_DISTINCT_WORDS:
        raise RuntimeError("the scanned greedy words are degenerate")
    del betas, words
    K, B = SCANNED_BEAM
    betas = torch.randn(K, B, N_VOXELS, generator=gen, device=device)
    scanned = make_scanned_beam_decoder(model, T,
                                        beam_width=SCANNED_BEAM_WIDTH)
    words = scanned(betas, start, end)
    single = make_beam_decoder(model, T, beam_width=SCANNED_BEAM_WIDTH)
    same = all(torch.equal(words[k], single(betas[k], start, end)[0])
               for k in range(K))
    rates[f"beam-{SCANNED_BEAM_WIDTH}"] = K * B / cuda_ms(
        lambda: scanned(betas, start, end), reps=SCANNED_REPS,
        warmup=1) * 1e3
    print(f"scanned beam-{SCANNED_BEAM_WIDTH}, K {K} x B {B}: each slice "
          f"equals a single call bit for bit: {same}; "
          f"{rates[f'beam-{SCANNED_BEAM_WIDTH}']:.1f} captions/s (CUDA "
          f"events, {SCANNED_REPS} calls) [{card}]")
    if not same:
        raise RuntimeError("a slice of the scanned beam decoder differs "
                           "from its single call")


def plain_route(device, tok, card: str) -> dict:
    """The plain-route phase: ``plain_runs``, then ``check_scanned``.
    Returns K1's, K2's and K3's launches on the true route ("twin") and on
    the false one ("route")."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtt_plain_") as tmp:
        launches = plain_runs(Path(tmp), device, card)
    release()
    check_scanned(device, tok, card)
    print(f"plain route: the phase in {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    return launches


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
    k2 = check_kernel(model, betas, card, "K2", profile=args.profile,
                      digest=K2_DIGEST)

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
    # the bf16-weight K2, feat_bf16 off (the Captioner's) and on
    k2b = check_kernel_bf16(model, betas, card, "bf16 K2",
                            profile=args.profile)
    k2b["feat_bf16"] = check_kernel_bf16(model, betas, card,
                                         "bf16 K2 (feat_bf16)",
                                         feat_bf16=True,
                                         profile=args.profile)
    k2b["max_abs_err"] = max(k2b["max_abs_err"],
                             k2b["feat_bf16"].pop("max_abs_err"))
    k2b["launches"] = serve_bf16(model, tok, rows, card, "bf16 K2")
    del model, captioner, rows, betas
    release()

    k3 = cnn_rnn(device, tok, card, args.profile)
    k3b = k3.pop("bf16")
    release()
    pix = pixel_gather(device, card)
    release()
    fold = inception_fold(device, card)
    release()

    k1, train_data = train(device, card, args.profile)
    k4 = fused_seq(train_data, device, card, args.profile)
    bf16_parts = k4.pop("bf16_parts")
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
    swept = sweep(device, card, product.pop("scored"))
    swp = swept["launches"]
    release()
    par = parallel(tok, device, card)
    release()
    prec = precision(device, card)
    prec["K4"]["wide"].update(bf16_parts["wide"])
    release()
    plain = plain_route(device, tok, card)
    release()
    k1["max_abs_err"] = max(k1["max_abs_err"], par["K1"]["max_abs_err"])
    k1["stores"] += par["K1"]["stores"]
    k2["max_abs_err"] = max(k2["max_abs_err"], par["K2"]["max_abs_err"])
    shape_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k1["rank_store"] = {k: par["K1"][k] for k in shape_keys}
    k1["pixel_store"] = {k: pix[k] for k in shape_keys}
    k2["vocab_5008"] = {k: par["K2"][k] for k in shape_keys}
    k1["max_abs_err"] = max([k1["max_abs_err"], *ingested["errors"]["K1"],
                             swept["errors"]["K1"], pix["max_abs_err"]])
    k1["stores"] += ingested["k1_stores"] + swept["k1_stores"] + pix["stores"]
    k2["max_abs_err"] = max([k2["max_abs_err"], *fam["errors"]["K2"],
                             *ingested["errors"]["K2"]])
    k3["max_abs_err"] = max([k3["max_abs_err"], *fam["errors"]["K3"],
                             *ingested["errors"]["K3"]])
    counts = fam["launches"]
    dep = product["deploy"]["launches"]
    print(json.dumps({"kernels": [{
        "name": "fused_greedy_decode", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_decode.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:211",
        "launches": launches, "launches_experiment": product["K2"],
        "launches_deploy": dep["K2"],
        "launches_families": counts["fused_greedy_decode"],
        "launches_ingest": ing["fused_greedy_decode"],
        "launches_sweep": swp["fused_greedy_decode"],
        "launches_parallel": par["launches"]["fused_greedy_decode"],
        "launches_plain_twin": plain["twin"]["K2"],
        "launches_plain_route": plain["route"]["K2"],
        **k2}, {
        "name": "fused_greedy_decode_gru", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_decode.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:276",
        "launches_families": counts["fused_greedy_decode_gru"],
        "launches_ingest": ing["fused_greedy_decode_gru"],
        "launches_plain_route": plain["route"]["K3"], **k3}, {
        "name": "fused_greedy_decode_bf16", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/decode_bf16.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:211", **k2b}, {
        "name": "fused_greedy_decode_gru_bf16", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/decode_bf16.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:276", **k3b}, {
        "name": "gather_rows", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/gather.cu",
        "replaces": "masters_thesis_tpu/ops/gather.py:49",
        "launches_experiment": product["K1"],
        "launches_deploy": dep["K1"],
        "launches_families": counts["gather_rows"],
        "launches_ingest": ing["gather_rows"],
        "launches_sweep": swp["gather_rows"],
        "launches_parallel": par["launches"]["gather_rows"],
        "launches_plain_twin": plain["twin"]["K1"],
        "launches_plain_route": plain["route"]["K1"], **k1}, {
        "name": "fused_seq_forward", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_seq.cu",
        "replaces": "masters_thesis_tpu/ops/fused_seq.py:204", **k4}, {
        "name": "fused_seq_forward_bf16", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_seq.cu",
        "replaces": "masters_thesis_tpu/ops/fused_seq.py:204",
        **prec["K4"], **bf16_parts["flagship"]},
        *probes]}))
    print(json.dumps({"inception_fold": fold}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
