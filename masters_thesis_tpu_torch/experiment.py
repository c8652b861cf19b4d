"""Experiment wiring: config -> data -> model -> trainer / eval / metrics.

Counterpart of ``masters_thesis_tpu/experiment.py`` (reference
AttemptFour/main.py, main_ms.py, main_images.py, eval.py, metric_suit.py)
for every model family of its ``build_model``: ``build_data``,
``build_model``, ``run_training`` (a ``Trainer`` with the standard
callbacks and async checkpoints), ``run_eval`` (greedy or beam decoding of
the test split), ``run_metrics`` (the metric suite; ``GUSE_*`` from the
USE encoder on the device when a weight bundle is found) and
``run_guse_precompute`` (get_guse.py: every caption's USE vector and the
per-key averages that ``guse_nic`` trains on). ``run_training``
writes the JAX package's run directory: ``config.yaml``, ``log.log``,
``tokenizer.json``, ``layout.npz`` (for the families whose encoder reads a
group layout), ``glove_table.npy`` (for a GloVe run), ``modelsummary.txt``,
``run_meta.json``, ``metrics.jsonl``, the CSV logs, ``caption_previews.txt``,
``df_grads.csv``, ``tb/`` (scalars, and the caption images of
``CaptionImagePreview`` in ``events.*.captions``), ``profile.json`` and
``trace/`` where ``tpu.profile_steps`` and ``tpu.profile_trace`` ask for them
(``utils/profiling.py``, on ``torch.profiler``), and ``model/``, whose
checkpoint files are torch's (``train/checkpoint.py``).

Every entry point runs on the card (``cuda``) unless it is given
``device="cpu"``. There, every train, val and test batch gathers its rows
from the device store through K1 (``ops.gather``), with ``tpu.scan_steps``
> 0 for ``lc_nic``/``ms_nic`` from a store permuted once into the encoder's
grouped layout ("pregathered"), and every greedy decode of a ``NIC`` runs
K2 (LSTM) or K3 (GRU) (``ops.fused_decode``). ``tpu.use_pallas: false``
takes the JAX package's plain paths instead, on the card as on the CPU:
every gather through the library take (``ops.gather.take_rows``) and every
greedy decode through the step loop (``decode.greedy``), so that K1, K2 and
K3 make no launch. The ShowTell family has no kernel, here as in the JAX
package, and decodes through the step loop; beam and sampling are plain
PyTorch on any device. On the CPU each kernel takes its plain PyTorch
version. ``layout.npz`` and ``run_meta.json``'s
``input_row_shape`` let serving (``serve.Captioner.from_run_dir``) rebuild
a model that takes raw rows.

With ``dataset.betas_path`` a directory, ``build_data`` reads real NSD
data (ROADMAP M19): the key split of ``nsd_dir``'s conditions CSVs, the
caption files, the Glasser groups of its atlas vectors, and the betas of a
pack (``data.pack``) or of per-key ``.npy`` files, host-resident, which
``run_training`` uploads to the card in row blocks (``data.store``); with
``ms2_nic``/``ms_nic`` and ``betas_path_b`` a second subject joins, its keys
offset by ``B_KEY_OFFSET``. ``run_preprocess`` makes such data from NSD
session files (``data.preprocess``): per-trial files, a pack with repeats
averaged, per-voxel statistics and the chained vc-mask -> normalize -> PCA
views, the PCA fitted and applied on the card, and ``transform.json``,
which ``apply_preprocess_chain`` replays on raw rows for serving.
Without NSD data the data is ``data.synthetic`` made from the seed, at the
sizes the JAX package uses. With ``tpu.mesh_data``/``tpu.mesh_model``
set, ``run_training`` is one rank's part of a sharded run
(``parallel/``). ``tpu.compute_dtype: bfloat16`` trains in bf16 on fp32
masters on the card and in fp32 on the CPU (``train.steps._compute_dtype``:
logged once, and recorded as ``run_meta.json``'s ``compute_dtype``);
``tpu.remat`` reaches the NIC, ImgNIC and CnnRnnNIC models
(``train.state.model_for``). ``vocab_overlap`` compares two tokenizers'
top-k vocabularies (caption_analysis.py::unique_words).
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import time

import numpy as np
import torch

from masters_thesis_tpu_torch import __version__
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.pairs import encode_pairs
from masters_thesis_tpu_torch.data.pipeline import BatchPipeline, EvalPipeline
from masters_thesis_tpu_torch.data.preprocess.glasser import select_groups
from masters_thesis_tpu_torch.data.store import (
    ArrayStore,
    RowConcat,
    permute_rows,
)
from masters_thesis_tpu_torch.data.synthetic import synthetic_dataset
from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.device import resolve_device
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu_torch.models.multisubject import DualSubjectEncoder
from masters_thesis_tpu_torch.models.nic import NIC
from masters_thesis_tpu_torch.models.showtell import showtell_l2_rules
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.ops.gather import row_gather
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
from masters_thesis_tpu_torch.train.state import (
    LAYOUT_MODELS,
    MODELS,
    model_for,
    new_state,
)
from masters_thesis_tpu_torch.utils.logging import MetricLogger, setup_run_dir

logger = logging.getLogger(__name__)

PORTED_MODELS = MODELS


# ---------------------------------------------------------------- data

def build_data(cfg: Config, smoke_keys: int = 48):
    """Returns (split, pairs, tokenizer, store, groups), ``store`` on the
    host (``run_training`` moves it to the device).

    Real-data mode when ``cfg.dataset.betas_path`` is a directory, the
    layout the offline preprocessing writes (``data.preprocess``,
    ``data.pack``), read as the JAX ``build_data`` reads it:
      betas_path/           a pack dir (meta.json) OR subj0X_KID{key}.npy files
      captions_path/        KID{key}.txt (5 captions per key)
      nsd_dir/subj0X_conditions.csv + test_conditions.csv  (key split)
      nsd_dir/glasser_lh.npy + glasser_rh.npy              (atlas labels)
    Its store is host-resident (a pack's memmap is not read here).

    Otherwise the synthetic data of the JAX ``build_data``, row for row, in
    a CPU ``ArrayStore``: ``smoke_keys`` keys, 2,048 voxels in 4-16 groups
    up to 64 keys, else the configured input width (360 Glasser-like groups
    at full width); 512-wide GUSE vectors for ``guse_nic``; (16, C) patch
    rows for ``img_nic`` and ``cnn_rnn``."""
    betas_path = cfg.dataset.betas_path
    if betas_path and os.path.isdir(betas_path):
        return _apply_group_selection(_build_real_data(cfg), cfg)
    n_voxels = min(cfg.input_dim(), 2048) if smoke_keys <= 64 else cfg.input_dim()
    if cfg.model.lower() == "guse_nic":
        n_voxels = 512  # GUSE sentence-embedding width (get_guse.py)
    n_groups = (360 if n_voxels >= 65536
                else min(16, max(4, n_voxels // 128)))
    split, pairs, tok, betas, keys, groups = synthetic_dataset(
        n_keys=smoke_keys,
        n_voxels=n_voxels,
        n_groups=n_groups,
        top_k=min(cfg.top_k, 200),
        seed=cfg.seed,
        structured=(cfg.dataset.synthetic
                    if cfg.dataset.synthetic in ("structured",
                                                 "compositional")
                    else False),
    )
    if cfg.model.lower() in ("img_nic", "cnn_rnn"):
        # image models read (patches, channels) conv features, not flat
        # vectors (VGG16 (196, 512) / InceptionV3 (64, 2048))
        rng = np.random.Generator(np.random.PCG64(cfg.seed))
        n_patches, channels = 16, max(32, min(cfg.embedding_features, 128))
        betas = rng.standard_normal(
            (len(keys), n_patches, channels)).astype(np.float32)
    store = ArrayStore(betas, keys, device="cpu")
    return _apply_group_selection((split, pairs, tok, store, groups), cfg)


def _apply_group_selection(data, cfg: Config):
    """Drop cfg.groups_to_remove from the Glasser group list before the
    encoder is built — the flagship trains on 345 of 360 regions
    (AttemptFour/main.py:115). Indices beyond the group count (e.g. the
    345-region list against a 16-group smoke dataset) are ignored, as
    ``select_groups`` filters by index."""
    if not cfg.groups_to_remove:
        return data
    split, pairs, tok, store, groups = data
    if groups is None:
        return data
    kept = select_groups(groups, list(cfg.groups_to_remove))
    logger.info("group selection: %d -> %d groups (%d removed)",
                len(groups), len(kept), len(groups) - len(kept))
    return split, pairs, tok, store, kept


# subject-B NSD keys are offset internally so two subjects' betas for the
# same stimulus can coexist in one store/pair list (NSD 73KIDs are < 10^6)
B_KEY_OFFSET = 10_000_000


def _load_beta_store(betas_path: str, keys) -> ArrayStore:
    """A host-resident store over a pack (its memmap) or over per-key
    ``{prefix}_KID{key}.npy`` files of one subject."""
    import glob

    from masters_thesis_tpu_torch.data.pack import open_pack

    if os.path.exists(os.path.join(betas_path, "meta.json")):
        return open_pack(betas_path)
    npys = glob.glob(os.path.join(betas_path, "*_KID*.npy"))
    if not npys:
        raise FileNotFoundError(
            f"betas path {betas_path!r} contains neither a packed dataset "
            "(meta.json) nor per-key *_KID*.npy beta files")
    prefixes = sorted({os.path.basename(p).split("_KID")[0] for p in npys})
    if len(prefixes) > 1:
        # glob order is filesystem-dependent: silently picking one subject
        # from a dir holding several would train on arbitrary brain data
        raise ValueError(
            f"betas path {betas_path!r} holds files for multiple subject "
            f"prefixes {prefixes}; point betas_path (and betas_path_b) at "
            "one subject's files each")
    prefix = prefixes[0]
    return ArrayStore.from_npy_dir(
        betas_path, list(keys), lambda key: f"{prefix}_KID{key}.npy")


def _build_real_data(cfg: Config):
    """NSD loading: key split, captions, beta store, Glasser groups.

    Two-subject mode (ms2_nic/ms_nic + dataset.betas_path_b, the main_ms.py
    setup): subject A loads from the first subj0*_conditions.csv +
    betas_path, subject B from the second CSV + betas_path_b; B's keys are
    offset by ``B_KEY_OFFSET`` in the combined pair list and store, whose
    rows are A's then B's, end to end on the host (``RowConcat``: no
    combined copy). Train and val pairs carry both subjects (the [A;B] batch
    layout comes from the pipeline's subject_split); the TEST split stays
    subject A's — the reference evaluates one subject at a time."""
    import glob

    from masters_thesis_tpu_torch.data.captions import load_captions_dir
    from masters_thesis_tpu_torch.data.pairs import create_pairs
    from masters_thesis_tpu_torch.data.preprocess.glasser import (
        groups_from_atlas,
    )
    from masters_thesis_tpu_torch.data.splits import get_nsd_keys
    from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

    nsd_dir = cfg.dataset.nsd_dir
    cond_csvs = sorted(glob.glob(os.path.join(nsd_dir,
                                              "subj0*_conditions.csv")))
    if not cond_csvs:
        raise FileNotFoundError(f"no subj0*_conditions.csv under {nsd_dir}")
    split = get_nsd_keys(
        cond_csvs[0], os.path.join(nsd_dir, "test_conditions.csv"),
        strict=False,  # the reference's 9000/1000/515 asserts only hold for
        #                full NSD subjects (load_avg_betas.py:221-223)
    )
    all_keys = np.concatenate([split.train, split.val, split.test])

    caps = load_captions_dir(cfg.dataset.captions_path, keys=all_keys)
    pairs = {
        name: create_pairs(getattr(split, name), caps, subject="A")
        for name in ("train", "val", "test")
    }

    # ms2_nic: two encoders, [A;B] split batches; ms_nic: ONE shared encoder
    # on the mixed pair list (main_ms_single_enc.py)
    two_subject = (cfg.model.lower() in ("ms2_nic", "ms_nic")
                   and bool(cfg.dataset.betas_path_b))
    store_b = None
    if two_subject:
        csv_b = cond_csvs[1] if len(cond_csvs) > 1 else cond_csvs[0]
        split_b = get_nsd_keys(
            csv_b, os.path.join(nsd_dir, "test_conditions.csv"), strict=False)
        keys_b = np.concatenate([split_b.train, split_b.val, split_b.test])
        caps_b_dir = cfg.dataset.captions_path_b or cfg.dataset.captions_path
        caps_b = load_captions_dir(caps_b_dir, keys=keys_b)
        for name in ("train", "val"):
            sub_pairs = create_pairs(getattr(split_b, name), caps_b,
                                     subject="B")
            pairs[name] = pairs[name] + [
                (int(k) + B_KEY_OFFSET, cap, cid, cnt, subj)
                for k, cap, cid, cnt, subj in sub_pairs
            ]
        store_b = _load_beta_store(cfg.dataset.betas_path_b, keys_b)
        logger.info(
            "two-subject data: %d + %d train pairs (B keys offset by %d)",
            sum(p[4] == "A" for p in pairs["train"]),
            sum(p[4] == "B" for p in pairs["train"]), B_KEY_OFFSET)

    tok_path = os.path.join(nsd_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        tok = Tokenizer.load(tok_path)
    else:
        tok = Tokenizer(num_words=cfg.top_k)
        tok.fit_on_texts([p[1] for p in pairs["train"] + pairs["val"]])
        tok.install_pad()

    store = _load_beta_store(cfg.dataset.betas_path, all_keys)
    if store_b is not None:
        store = ArrayStore(
            RowConcat([store.data, store_b.data]),
            [int(k) for k in store.keys]
            + [int(k) + B_KEY_OFFSET for k in store_b.keys],
            device_resident=False)

    lh = np.load(os.path.join(nsd_dir, "glasser_lh.npy"))
    rh = np.load(os.path.join(nsd_dir, "glasser_rh.npy"))
    groups = groups_from_atlas(lh, rh)
    return split, pairs, tok, store, groups


# ---------------------------------------------------------------- model

def resolve_glove_table(cfg: Config, tokenizer):
    """cfg.glove_path -> (vocab_size, E) float32 table, or None.

    The glove_NIC variant (AttemptFour/Model/glove_NIC.py) swaps the learned
    text embedding for pretrained GloVe vectors. A ``.npy`` path loads a
    prebuilt table; anything else parses as GloVe text, filtered to the run
    tokenizer's vocab (``data.captions.build_glove_table``)."""
    if not cfg.glove_path:
        return None
    if cfg.glove_path.endswith(".npy"):
        table = np.load(cfg.glove_path).astype(np.float32)
    else:
        from masters_thesis_tpu_torch.data.captions import build_glove_table

        table = build_glove_table(cfg.glove_path, tokenizer,
                                  dim=cfg.embedding_text)
    if table.ndim != 2 or table.shape[0] != cfg.vocab_size:
        raise ValueError(
            f"glove table {cfg.glove_path!r} has shape {table.shape}; "
            f"expected ({cfg.vocab_size}, E) for top_k={cfg.top_k}")
    return table


def build_model(cfg: Config, groups, n_voxels: int,
                pregathered: bool = False, embedding_table=None,
                row_shape=None):
    """The model family of ``cfg.model`` (``train.state.model_for``, with
    the JAX ``build_model``'s refusals): (model on the CPU, l2_rules,
    masked). ``row_shape`` is one input row's shape, by default
    (n_voxels,): (P, C) for the image families. ``pregathered``
    (``lc_nic``/``ms_nic``) builds the encoder for rows already in the
    grouped padded layout (a permuted device store), with the same
    parameters; ``embedding_table`` is a resolved GloVe table."""
    name = cfg.model.lower()
    layout = GroupLayout(groups, n_voxels) if name in LAYOUT_MODELS else None
    model = model_for(cfg, layout, pregathered=pregathered,
                      row_shape=row_shape or (n_voxels,),
                      embedding_table=embedding_table)
    if name in ("showtell", "thinkandtell", "guse_nic"):
        return model, showtell_l2_rules(cfg), True
    return model, lc_nic_l2_rules(cfg), name == "cnn_rnn"


def _greedy_decoder(model, cfg: Config):
    """decode(betas, start_id) -> (words, ..., alphas): for a ``NIC``, K2 or
    K3 on the card and its plain version on the CPU; the step loop for the
    ShowTell family, which has no kernel, and for every model under
    ``tpu.use_pallas: false``. (The JAX ``_greedy_decoder``, behind the val
    caption metrics and the previews, is always the step loop; its
    ``run_eval`` takes the kernel on the TPU: ROADMAP §3.)"""
    if cfg.tpu.use_pallas and isinstance(model, NIC):
        return make_whole_fused_greedy_decoder(model, cfg.max_length)
    return make_greedy_decoder(model, cfg.max_length)


def _git_revision() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=5,
        ).stdout.strip() or None
    except Exception:
        return None


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


# ---------------------------------------------------------------- train

def run_training(cfg: Config, epochs: int | None = None, smoke_keys: int = 48,
                 resume: bool = False, extra_callbacks=(), device=None):
    """Full training run on ``device`` (default ``cuda``); returns
    (run_path, final logs, bundle).

    ``resume=True`` restores the run dir's latest checkpoint and continues
    from the next epoch (the batch order of an epoch is a function of
    (seed, epoch), the dropout masks of a step of (seed, step), so a
    resumed run takes the uninterrupted run's steps). ``extra_callbacks``
    follow the standard ones. The bundle holds what ``run_eval`` and
    ``run_metrics`` read: model, state, tokenizer, store, split, pairs,
    cfg, manager.

    With ``tpu.mesh_data``/``tpu.mesh_model`` other than 1 the run is one
    rank's part of a ('data', 'model') mesh (``parallel/``; a process group
    of one rank when no launcher started one): the same seeded state and
    batches on every rank, the state sharded (``parallel.sharding``), a
    voxel-sharded encoder's store holding the rank's columns, each batch
    cut to the rank's rows, the sharded steps; the batch is rounded down to
    the data axis (and to lcm(data, 2) for ms2_nic). The primary rank
    writes the run directory, saves are collective, and with more than one
    rank the preview, caption-metric and grad-stat callbacks are off, as
    the JAX package turns them off with more than one process. The bundle
    of a rank holds its shards."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.callbacks import (
        BatchLoss,
        CaptionMetrics,
        Checkpointing,
        ErrorLog,
        LossHistory,
        TensorBoardScalars,
    )
    from masters_thesis_tpu_torch.train.checkpoint import (
        CheckpointManager,
        warm_start_from_run,
    )
    from masters_thesis_tpu_torch.train.loop import Trainer
    from masters_thesis_tpu_torch.transplant import to_flax
    from masters_thesis_tpu_torch.utils.summary import model_summary

    device = resolve_device(device)
    compute_dtype = steps._compute_dtype(cfg, device)
    logger.info("training forward in %s (tpu.compute_dtype %s on %s)",
                str(compute_dtype).removeprefix("torch."),
                cfg.tpu.compute_dtype, device.type)
    name = cfg.model.lower()
    if name not in PORTED_MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    mesh = None
    if cfg.tpu.mesh_data != 1 or cfg.tpu.mesh_model != 1:
        from masters_thesis_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(cfg.tpu.mesh_data, cfg.tpu.mesh_model, device)
        device = mesh.device
    ranks = mesh.world if mesh is not None else 1
    is_primary = mesh is None or mesh.rank == 0
    run_path = setup_run_dir(cfg.log, cfg.run, cfg if is_primary else None,
                             file_log=is_primary)
    split, pairs, tok, host_store, groups = build_data(cfg, smoke_keys)
    if is_primary:
        tok.save(os.path.join(run_path, "tokenizer.json"))
    # glove_NIC: resolve the table once and keep it in the run directory,
    # which serving rebuilds from (a frozen table is no checkpoint entry);
    # on resume the kept table is authoritative, whatever glove_path holds
    glove_table = None
    if cfg.glove_path:
        persisted = os.path.join(run_path, "glove_table.npy")
        if resume and os.path.exists(persisted):
            glove_table = np.load(persisted)
        else:
            glove_table = resolve_glove_table(cfg, tok)
            if is_primary:
                np.save(persisted, glove_table)

    row_shape = host_store.row_shape
    n_voxels = row_shape[0]
    input_row_shape = [int(d) for d in row_shape]
    # on the card with the scanned trainer, permute the store into the
    # LcNIC encoder's grouped padded layout once at upload: the encoder then
    # skips its own voxel -> group gather (the JAX package does the same on
    # the TPU); parameters and checkpoints are the same either way
    pregathered = (cfg.tpu.scan_steps > 0 and device.type == "cuda"
                   and name in ("lc_nic", "ms_nic"))
    model, l2_rules, masked = build_model(cfg, groups, n_voxels,
                                          pregathered=pregathered,
                                          embedding_table=glove_table,
                                          row_shape=row_shape)
    layout = None
    if name in LAYOUT_MODELS:
        layout = GroupLayout(groups, n_voxels)
        if is_primary:
            layout.save(os.path.join(run_path, "layout.npz"))
    state = new_state(model, cfg, device)
    model = state.model
    if cfg.warm_start:
        ws = warm_start_from_run(model, cfg.warm_start)
        logger.info(
            "warm start from %s (epoch %s): %d loaded, %d shape-skipped, "
            "%d missing", cfg.warm_start, ws.get("source_epoch"),
            len(ws["loaded"]), len(ws["skipped_shape"]), len(ws["missing"]))
    if is_primary:
        variables = to_flax(model.state_dict())
        with open(os.path.join(run_path, "modelsummary.txt"), "w") as f:
            f.write(model_summary(variables["params"],
                                  variables.get("batch_stats"),
                                  name=cfg.model))
        del variables
    voxel_sharded = False
    if mesh is not None:
        from masters_thesis_tpu_torch.parallel.sharding import (
            encoder_voxel_sharded,
            shard_params,
            shard_store_array,
        )

        # the same seeded initial state on every rank, each keeping its
        # shards; a voxel-sharded encoder reads the rank's store columns
        state = shard_params(state, mesh)
        voxel_sharded = encoder_voxel_sharded(model, state.shards)

    # the store on the device (a host-resident one in row blocks through a
    # pinned buffer); the host rows go as soon as it is there
    keys = host_store.keys
    t_up = time.perf_counter()
    data = host_store.upload(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.info("store: %d x %d %s rows on %s in %.2f s", *data.shape,
                data.dtype, device, time.perf_counter() - t_up)
    data = data.view(len(keys), *row_shape)
    del host_store
    if voxel_sharded:
        data = shard_store_array(data, layout, mesh)
    elif pregathered:
        data = permute_rows(data, layout)
    store = ArrayStore(data, keys, device=device, dtype=cfg.tpu.store_dtype,
                       kernel=cfg.tpu.use_pallas)
    del data

    train_enc = encode_pairs(pairs["train"], tok, cfg.max_length)
    val_enc = encode_pairs(pairs["val"], tok, cfg.max_length)
    bs = min(cfg.batch_size, max(2, len(train_enc) // 2))
    if mesh is not None:
        # the global batch's rows split evenly over the data axis (a mean
        # of the ranks' means is the global mean only then), and ms2_nic's
        # [A-half ; B-half] also needs an even batch: both at once
        d = mesh.data
        mult = math.lcm(d, 2) if name == "ms2_nic" else d
        new_bs = max(mult, (bs // mult) * mult)
        if new_bs != bs:
            logger.warning(
                "batch size %d not divisible by data axis %d%s; using %d",
                bs, d, " x subject-split 2" if mult != d else "", new_bs)
            bs = new_bs
    # ms2_NIC's two encoders need every batch laid out [A-half ; B-half]
    # (main_ms.py's generator contract)
    subject_split = name == "ms2_nic"
    if subject_split:
        for enc in (train_enc, val_enc):
            if len(np.unique(enc.subjects)) < 2:
                # a single-subject pair list (the synthetic data):
                # alternating pseudo-subject ids keep the batch layout, and
                # both encoders see one distribution
                logger.warning(
                    "ms2_nic with a single-subject pair list: assigning "
                    "alternating pseudo-subject ids (real two-subject runs "
                    "need per-subject pair lists / subject_ids)")
                enc.subjects = np.arange(len(enc), dtype=np.int32) % 2
        bs -= bs % 2
    # ThinkAndTell (ShowTell align="self") supervises unshifted targets
    pipe_kw = dict(subject_split=subject_split,
                   self_target=name == "thinkandtell")
    train_pipe = BatchPipeline(train_enc, store, bs, seed=cfg.seed, **pipe_kw)
    val_pipe = BatchPipeline(val_enc, store, bs, seed=cfg.seed, shuffle=False,
                             **pipe_kw)
    # the GradStats batch, with the training objective's targets and layout
    batch = next(iter(BatchPipeline(train_enc, store, bs, seed=0,
                                    prefetch=0, **pipe_kw).epoch()))

    meta_path = os.path.join(run_path, "run_meta.json")
    if is_primary:
        with open(meta_path, "w") as f:
            json.dump({
                "framework_version": __version__,
                "git_revision": _git_revision(),
                "model": cfg.model,
                "backend": _backend(device),
                "n_devices": (torch.cuda.device_count()
                              if device.type == "cuda" else 1),
                # one process a rank
                "n_processes": ranks,
                "mesh": mesh.shape if mesh is not None else None,
                "input_row_shape": input_row_shape,
                # torch's generators draw every mask whatever the value
                "prng_impl": cfg.tpu.prng_impl,
                # the training forward's dtype (bf16 only on the card)
                "compute_dtype": str(compute_dtype).removeprefix("torch."),
            }, f, indent=1)

    # decoded caption metrics on the val split: one row per unique val key,
    # the references rebuilt from the raw pairs
    caption_metrics_cb = None
    if cfg.caption_metrics_every > 0 and pairs["val"] and ranks == 1:
        seen: set = set()
        unique_val = []
        refs_by_key: dict = {}
        for key, cap, cid, count, subj in pairs["val"]:
            refs_by_key.setdefault(int(key), []).append(
                " ".join(cap.split()[1:-1]))  # strip <start>/<end>
            if int(key) not in seen:
                seen.add(int(key))
                unique_val.append((key, cap, cid, count, subj))
        cm_enc = encode_pairs(unique_val, tok, cfg.max_length)
        cm_pipe = EvalPipeline(cm_enc, store, min(bs, len(cm_enc)))
        caption_metrics_cb = CaptionMetrics(
            _greedy_decoder(model, cfg), cm_pipe, tok, refs_by_key,
            every=cfg.caption_metrics_every)

    mgr = CheckpointManager(os.path.join(run_path, "model"),
                            primary=is_primary)
    start_epoch = 0
    if resume:
        state, restored_epoch = mgr.restore(state)
        if restored_epoch is not None:
            start_epoch = restored_epoch + 1
            logger.info("resumed from epoch %d", restored_epoch)

    placer = None
    if mesh is not None:
        from masters_thesis_tpu_torch.parallel import sharding

        placer = sharding.MeshInputPlacer(
            mesh, bs, state, layout, pregathered_reference=pregathered)
        train_step = sharding.make_sharded_train_step(
            cfg, l2_rules, state, placer, masked=masked)
        eval_step = sharding.make_sharded_eval_step(
            cfg, l2_rules, state, placer, masked=masked)
    else:
        train_step = steps.make_train_step(cfg, l2_rules, masked=masked)
        eval_step = steps.make_eval_step(cfg, l2_rules, masked=masked)
    if ranks > 1:
        # the preview, caption-metric and grad-stat callbacks decode or
        # differentiate outside the symmetric train loop: off with more
        # than one rank, as the JAX package turns them off with more than
        # one process; the primary rank writes the run directory's logs
        callbacks = [
            *([ErrorLog(run_path), LossHistory(run_path),
               BatchLoss(run_path)] if is_primary else []),
            Checkpointing(mgr, every=cfg.tpu.ckpt_every),
            *([TensorBoardScalars(os.path.join(run_path, "tb"))]
              if is_primary else []),
            *extra_callbacks,
        ]
    else:
        callbacks = _single_rank_callbacks(
            cfg, run_path, mgr, caption_metrics_cb, train_pipe, val_pipe,
            val_enc, bs, batch, tok, model, l2_rules, masked,
            extra_callbacks)
    trainer = Trainer(
        cfg, train_step, eval_step, state, train_pipe, val_pipe,
        callbacks=callbacks, store=store,
        metric_logger=(MetricLogger(os.path.join(run_path, "metrics.jsonl"))
                       if is_primary else None),
        input_placer=placer)
    if cfg.tpu.scan_steps > 0:
        # K steps a call from the device tables, and the validation pass in
        # one call
        if mesh is not None:
            trainer.use_scanned_steps(
                sharding.make_sharded_scanned_train_steps_from_tables(
                    cfg, l2_rules, state, placer, masked=masked), tables=True)
            trainer.use_scanned_eval(
                sharding.make_sharded_scanned_eval_steps_from_tables(
                    cfg, l2_rules, state, placer, masked=masked))
        else:
            trainer.use_scanned_steps(
                steps.make_scanned_train_steps_from_tables(cfg, l2_rules,
                                                           masked=masked),
                tables=True)
            trainer.use_scanned_eval(
                steps.make_scanned_eval_steps_from_tables(cfg, l2_rules,
                                                          masked=masked))
    t_fit = time.perf_counter()
    logs = trainer.fit(epochs=epochs, start_epoch=start_epoch)
    train_wall = time.perf_counter() - t_fit
    bundle = {
        "model": model, "state": trainer.state, "tokenizer": tok,
        "store": store, "split": split, "pairs": pairs, "cfg": cfg,
        "manager": mgr,
    }
    if not is_primary:
        return run_path, logs, bundle

    with open(meta_path) as f:
        meta = json.load(f)
    meta["train_wall_s"] = round(train_wall, 2)
    meta["steps_per_sec_final_epoch"] = round(
        float(logs.get("steps_per_sec", 0.0)), 2)
    sps = trainer.epoch_steps_per_sec
    if len(sps) > 1:
        # epoch 0 carries the first launches' set-up: the median of the
        # rest is the steady-state number
        meta["steps_per_sec_median"] = round(float(np.median(sps[1:])), 2)
    meta["epochs_ran"] = len(sps)
    meta["epochs_target"] = epochs if epochs is not None else cfg.epochs
    if caption_metrics_cb is not None and caption_metrics_cb.history:
        meta["caption_metrics"] = caption_metrics_cb.history
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return run_path, logs, bundle


def _single_rank_callbacks(cfg, run_path, mgr, caption_metrics_cb,
                           train_pipe, val_pipe, val_enc, bs, batch, tok,
                           model, l2_rules, masked, extra_callbacks):
    """The standard callbacks of a run of one rank."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.callbacks import (
        BatchLoss,
        CaptionImagePreview,
        Checkpointing,
        ErrorLog,
        GradStats,
        LossHistory,
        PredictPreview,
        StepProfiling,
        TensorBoardScalars,
        TraceCapture,
        load_stimulus_images,
    )

    preview_batch = (next(iter(val_pipe.epoch())) if len(val_enc) >= bs
                     else next(iter(train_pipe.epoch())))
    # one decoder, shared by both preview callbacks
    preview_decoder = _greedy_decoder(model, cfg)
    return [
        ErrorLog(run_path),
        LossHistory(run_path),
        BatchLoss(run_path),
        Checkpointing(mgr, every=cfg.tpu.ckpt_every),
        # before TensorBoardScalars: CaptionMetrics adds val_bleu*/val_cider
        # to the epoch's logs
        *([caption_metrics_cb] if caption_metrics_cb else []),
        TensorBoardScalars(os.path.join(run_path, "tb")),
        PredictPreview(run_path, preview_decoder, preview_batch, tok,
                       every=5),
        CaptionImagePreview(
            os.path.join(run_path, "tb"), preview_decoder, preview_batch, tok,
            # the caption drawn over the stimulus picture when the run has
            # one on disk (soloist TensorBoardCaption semantics)
            images=load_stimulus_images(cfg.dataset.images_path,
                                        preview_batch.get("keys", [])),
            every=5),
        GradStats(run_path,
                  steps.make_grad_stats_fn(cfg, l2_rules, masked=masked),
                  batch, every=5),
        *([StepProfiling(run_path, cfg.tpu.profile_steps)]
          if cfg.tpu.profile_steps > 0 else []),
        *([TraceCapture(run_path)] if cfg.tpu.profile_trace else []),
        *extra_callbacks,
    ]


# ---------------------------------------------------------------- eval

def run_eval(bundle, run_path: str, epoch: int | None = None,
             decoder: str = "greedy", beam_width: int = 5,
             ms2_subject: str = "a"):
    """Test-set decoding (reference eval.py:147-193): the words of every
    test pair (val when there is no test split), written as
    ``output_captions_{e}.npy``, ``attention_scores_{e}.npy`` and
    ``captions_{e}.txt``. ``decoder`` "greedy" runs K2 or K3 for a ``NIC``
    (the step loop for the ShowTell family, and for every model under
    ``tpu.use_pallas: false``, whose rows come through the library take);
    "beam" the fixed-lattice beam of ``beam_width``, whose attention file
    holds the winning hypothesis' own trail. ``ms2_subject`` picks the
    encoder that decodes an ms2_nic run (the split layout is a training
    batch contract; the reference evaluates one subject at a time).
    Returns {"words", "keys", "texts", "epoch"}."""
    if decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}: expected 'greedy' "
                         f"or 'beam'")
    cfg, model, tok = bundle["cfg"], bundle["model"], bundle["tokenizer"]
    store = bundle["store"]
    pairs = bundle["pairs"]["test"] or bundle["pairs"]["val"]
    enc = encode_pairs(pairs, tok, cfg.max_length)
    bs = min(cfg.batch_size, len(enc))
    pipe = EvalPipeline(enc, store, bs)
    gather = row_gather(cfg.tpu.use_pallas)
    if decoder == "greedy":
        dec = _greedy_decoder(model, cfg)
    else:
        beam = make_beam_decoder(model, cfg.max_length, beam_width=beam_width)

        def dec(betas, start_id):
            words, _, alphas, _, _ = beam(betas, start_id, tok.end_id)
            return words, alphas

    all_words, all_attn, all_keys = [], [], []
    was_training = model.training
    encoder = getattr(model, "encoder", None)
    dual = isinstance(encoder, DualSubjectEncoder) and encoder.mode == "split"
    model.eval()
    try:
        if dual:
            logger.info("ms2 eval: decoding through encoder_%s", ms2_subject)
            encoder.mode = ms2_subject
        for batch in pipe.epoch():
            betas = gather(
                store.device_array(),
                torch.as_tensor(batch["idx"], device=store.device))
            out = dec(betas, tok.start_id)
            valid = batch["valid"]
            all_words.append(out[0].cpu().numpy()[valid])
            all_attn.append(out[-1].cpu().numpy()[valid])
            all_keys.append(batch["keys"][valid])
    finally:
        if dual:
            encoder.mode = "split"
        model.train(was_training)

    words = np.concatenate(all_words)
    attn = np.concatenate(all_attn)
    keys = np.concatenate(all_keys)
    e = epoch if epoch is not None else bundle["manager"].latest_epoch() or 0
    np.save(os.path.join(run_path, f"output_captions_{e}.npy"), words)
    np.save(os.path.join(run_path, f"attention_scores_{e}.npy"), attn)
    texts = [ids_to_caption(row, tok) for row in words]
    with open(os.path.join(run_path, f"captions_{e}.txt"), "w") as f:
        for key, text in zip(keys, texts):
            f.write(f"{key}\t{text}\n")
    return {"words": words, "keys": keys, "texts": texts, "epoch": e}


def run_guse_precompute(cfg: Config, out_dir: str, per_key: bool = True,
                        device=None) -> dict:
    """The reference's GUSE precompute (AttemptFour/get_guse.py
    __main__): embed every caption of every key, save the flat
    (N, C, 512) brick plus the per-key averaged vectors that the guse_NIC
    data path trains on (get_guse.py:104-140: guse_pre_processed.npy and
    guse_averaged/guse_embedding_KID{key}.npy, the ``*_KID*.npy`` files
    ``build_data`` reads as ``dataset.betas_path``).

    The embedder resolves exactly like run_metrics: the real USE-DAN on
    ``device`` (default ``cuda``) when a weight bundle is present, otherwise
    the hash fallback on the host — and meta.json records which one
    produced the files so hash output can never be mistaken for GUSE."""
    from masters_thesis_tpu_torch.data.captions import load_captions_dir
    from masters_thesis_tpu_torch.evalsuite.guse_sim import (
        default_embedder,
        embed_caption_table,
    )

    caps = load_captions_dir(cfg.dataset.captions_path)
    if not caps:
        raise FileNotFoundError(
            f"no KID*.txt caption files under {cfg.dataset.captions_path!r}")
    guse_dir = cfg.dataset.guse_path
    bundle_path = os.path.join(guse_dir, "use_dan.npz") if guse_dir else None
    embedder = default_embedder(
        bundle_path if bundle_path and os.path.exists(bundle_path) else None,
        device)
    keys, table = embed_caption_table(caps, embedder=embedder)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "guse_pre_processed.npy"), table)
    np.save(os.path.join(out_dir, "keys.npy"), keys)
    n_per_key = 0
    if per_key and len(keys):
        avg_dir = os.path.join(out_dir, "guse_averaged")
        os.makedirs(avg_dir, exist_ok=True)
        averaged = table.mean(axis=1)  # (N, 512), get_guse.py:94
        for key, vec in zip(keys, averaged):
            np.save(os.path.join(
                avg_dir, f"guse_embedding_KID{int(key)}.npy"), vec)
        n_per_key = len(keys)
    name = getattr(embedder, "name", type(embedder).__name__)
    meta = {
        "embedder": name,
        "is_real_guse": name == "use_dan",
        "n_keys": int(len(keys)),
        "captions_per_key": int(table.shape[1]) if table.ndim == 3 else 0,
        "dim": int(table.shape[-1]) if table.size else embedder.dim,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info("GUSE precompute: %d keys x %d captions -> %s (embedder=%s)",
                meta["n_keys"], meta["captions_per_key"], out_dir, name)
    return {**meta, "out": out_dir, "per_key_files": n_per_key}


def run_metrics(bundle, eval_out, captions_by_key=None, device=None) -> dict:
    """The metric suite (reference metric_suit.py + guse_sim.py) on the
    eval output.

    GUSE scores are labelled ``GUSE_*`` only when produced by the real
    USE-DAN encoder (models/use_encoder.py, weights resolved via
    MTT_GUSE_WEIGHTS or <guse_path>/use_dan.npz), which runs on ``device``,
    by default the device of the bundle's store (``cuda`` without one); the
    offline hash fallback reports as ``GUSE_hash_*`` so a word-overlap proxy
    can never be mistaken for the reference metric (get_guse.py:49-63)."""
    from masters_thesis_tpu_torch.evalsuite.guse_sim import (
        labelled_guse_scores,
    )
    from masters_thesis_tpu_torch.evalsuite.metric_suite import (
        evaluate_captions,
    )

    if captions_by_key is None:
        captions_by_key = {}
        for split_pairs in bundle["pairs"].values():
            for key, cap, cid, count, subj in split_pairs:
                captions_by_key.setdefault(int(key), []).append(
                    " ".join(cap.split()[1:-1]))  # strip <start>/<end>
    refs = [captions_by_key[int(k)] for k in eval_out["keys"]]
    scores = evaluate_captions(eval_out["texts"], refs)

    guse_dir = bundle["cfg"].dataset.guse_path
    bundle_path = os.path.join(guse_dir, "use_dan.npz") if guse_dir else None
    if device is None and bundle.get("store") is not None:
        device = bundle["store"].device
    scores.update(labelled_guse_scores(
        eval_out["texts"], refs,
        weights_path=(bundle_path if bundle_path
                      and os.path.exists(bundle_path) else None),
        device=device))
    return scores


# ---------------------------------------------------------------- preprocess

def apply_preprocess_chain(pre_dir: str, rows: np.ndarray) -> np.ndarray:
    """Replay a preprocess run's derived-view chain (transform.json:
    vc_mask -> normalize -> pca, whichever stages ran) on arbitrary (N, V)
    rows, on the host in numpy as the JAX package replays it — serving
    requests and new sessions must go through the SAME transforms the
    training pack did (``transform``)."""
    from masters_thesis_tpu_torch.data.preprocess.pca import PCAModel

    with open(os.path.join(pre_dir, "transform.json")) as f:
        meta = json.load(f)
    x = np.asarray(rows, np.float32)
    raw_shape = meta.get("input_row_shape")
    if raw_shape and list(x.shape[1:]) != list(raw_shape):
        # a vc-mask gather would silently accept any rows wide enough for
        # its max index — wrong vertices, garbage captions, no error
        raise ValueError(
            f"chain {pre_dir!r} was recorded on rows of shape {raw_shape}; "
            f"got {list(x.shape[1:])}")
    for st in meta["stages"]:
        path = os.path.join(pre_dir, st["file"])
        if st["stage"] == "vc_mask":
            x = x[:, np.load(path)]
        elif st["stage"] == "normalize":
            d = np.load(path)
            x = (x - d["mean"]) / d["std"]
        elif st["stage"] == "pca":
            x = PCAModel.load(path).transform(x).astype(np.float32)
        else:
            raise ValueError(f"unknown transform stage {st['stage']!r}")
    expect = meta.get("final_row_shape")
    if expect and list(x.shape[1:]) != list(expect):
        raise ValueError(
            f"replayed chain produced rows of shape {x.shape[1:]}, "
            f"expected {expect}")
    return x


def _train_split_indices(view, nsd_dir):
    """Pack-row indices of the unique-train keys, or (None, 'all_rows').

    Picks the conditions CSV whose train split covers the most pack keys —
    an nsd_dir can hold several subjects' CSVs, and blindly taking the
    alphabetically first would fit statistics on the WRONG subject's split
    (near-zero key overlap, a degenerate fit with no error)."""
    if not (nsd_dir and os.path.isdir(nsd_dir)):
        return None, "all_rows"
    import glob as _glob

    from masters_thesis_tpu_torch.data.splits import get_nsd_keys

    test_csv = os.path.join(nsd_dir, "test_conditions.csv")
    conds = sorted(_glob.glob(os.path.join(nsd_dir, "subj0*_conditions.csv")))
    if not conds or not os.path.exists(test_csv):
        return None, "all_rows"
    key_to_row = {int(k): i for i, k in enumerate(view.keys.tolist())}
    best_idx, best_cond = [], None
    for cond in conds:
        split = get_nsd_keys(cond, test_csv, strict=False)
        idx = [key_to_row[k] for k in split.train.tolist() if k in key_to_row]
        if len(idx) > len(best_idx):
            best_idx, best_cond = idx, cond
    if not best_idx:
        return None, "all_rows"
    if len(conds) > 1:
        logger.info(
            "preprocess: train split from %s (best pack-key coverage: %d)",
            os.path.basename(best_cond), len(best_idx))
    return np.asarray(best_idx), f"train_split:{len(best_idx)}"


def _parse_visual_parcels(spec: str) -> list[int]:
    """``--vc-parcels``: a comma-separated label list, or a CSV file like
    the reference's VISUAL_MASK table (ThinkAndTell/train.py:91-92 reads it
    with pandas index_col=0 and flattens the values).

    File parsing is structural, not guess-per-row: a first line with any
    non-numeric NON-EMPTY field is the header (trailing commas alone never
    make one — a '1,2,3,' value list keeps its first row). With a header,
    the first COLUMN is dropped when it is pandas' index — either unnamed
    (empty first header field, the reference's ',0' layout) or a named
    serial index (the data rows' first fields count 0..N-1 or 1..N), so a
    'idx,parcel' export can't leak row numbers (incl. parcel 0, the
    unlabelled region) into the mask. A fully-numeric file is a plain
    value list — every field counts."""
    if not os.path.exists(spec):
        return [int(p) for p in spec.split(",") if p.strip()]
    with open(spec) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"no parcel labels parsed from {spec!r}")

    def fields(line):
        # trailing empty fields are CSV artifacts (trailing commas), not
        # structure — strip them before any header/index decision
        out = [p.strip() for p in line.split(",")]
        while out and out[-1] == "":
            out.pop()
        return out

    def numeric(vals):
        try:
            return [int(float(p)) for p in vals]
        except ValueError:
            return None

    first = fields(lines[0])
    drop_index = False
    if numeric([p for p in first if p]) is None or (first and first[0] == ""):
        # header row (pandas writes an unnamed index as an empty first name)
        data = [fields(ln) for ln in lines[1:]]
        if first and first[0] == "":
            drop_index = True
        else:
            # named index column: detect a serial 0..N-1 / 1..N first column
            col0 = numeric([row[0] for row in data if row])
            n = len(data)
            drop_index = (
                len(first) > 1 and col0 is not None
                and (col0 == list(range(n)) or col0 == list(range(1, n + 1)))
            )
        lines = lines[1:]
    parcels: list[int] = []
    for line in lines:
        vals = fields(line)
        if drop_index:
            vals = vals[1:]
        nums = numeric([p for p in vals if p])
        if nums is None:
            raise ValueError(
                f"non-numeric parcel field in {spec!r}: {line!r}")
        parcels.extend(nums)
    if not parcels:
        raise ValueError(f"no parcel labels parsed from {spec!r}")
    return parcels


# rows a derived view streams off its source pack at a time
VIEW_BLOCK_ROWS = 512


def run_preprocess(
    cfg: Config,
    out_dir: str,
    pca_components: int = 0,
    from_sessions: str | None = None,
    behavior: str | None = None,
    captions_json: str | None = None,
    n_sessions: int = 40,
    vc_parcels: str | None = None,
    normalize: bool = False,
    device=None,
) -> dict:
    """Offline preprocessing driver (the reference's ian_code/nsd_get_data +
    data_mean + SVD/svd.py stage), the JAX ``run_preprocess``'s files and
    report: [optionally session files -> per-trial npy (my_get_betas,
    nsd_get_data.py:174-281), then] per-key npy betas -> pack (repeats
    averaged, nsd_get_data.py:527); per-voxel mean/std; the chained views
    (vc mask -> normalize -> PCA) and ``transform.json``; the tokenizer from
    the captions dir. The PCA is fitted (``fit_pca``) and applied to every
    row on ``device`` (by default ``cuda``); everything else runs on the
    host in numpy, as in the JAX package. The report's ``seconds`` gives
    each stage's wall time."""
    from masters_thesis_tpu_torch.data.captions import load_captions_dir
    from masters_thesis_tpu_torch.data.pack import open_pack, write_pack
    from masters_thesis_tpu_torch.data.pairs import clean_caption
    from masters_thesis_tpu_torch.data.preprocess.pca import (
        fit_pca,
        projector,
    )
    from masters_thesis_tpu_torch.data.preprocess.sessions import (
        averaged_rows,
        ingest_sessions,
    )
    from masters_thesis_tpu_torch.data.preprocess.zscore import (
        voxelwise_stats,
    )
    from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

    os.makedirs(out_dir, exist_ok=True)
    report: dict = {}
    seconds: dict = {}
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    betas_path = cfg.dataset.betas_path
    captions_path = cfg.dataset.captions_path
    if from_sessions:
        if not behavior:
            raise ValueError("--from-sessions needs --behavior (CSV/TSV or "
                             "dir)")
        ingest = ingest_sessions(
            from_sessions, behavior, os.path.join(out_dir, "ingest"),
            n_sessions=n_sessions, captions_json=captions_json,
        )
        report["ingest"] = {k: v for k, v in ingest.items() if k != "subjects"}
        subjects = ingest["subjects"]
        if len(subjects) != 1:
            raise ValueError(
                f"session ingest found subjects {sorted(subjects)}; run one "
                "subject's sessions per preprocess invocation (reference "
                "loops my_get_betas per subject)")
        (_, paths), = subjects.items()
        betas_path = paths["betas"]
        if captions_json:
            captions_path = paths["captions"]
        lap("ingest")

    pack_dir = os.path.join(out_dir, "betas_pack")
    meta = write_pack(pack_dir, None, averaged_rows(betas_path))
    report["pack"] = meta
    lap("pack")

    store = open_pack(pack_dir)
    # keep the memmap: voxelwise_stats streams chunked passes over it
    mean, std = voxelwise_stats(store.data)
    np.savez(os.path.join(out_dir, "voxel_stats.npz"), mean=mean, std=std)
    report["voxel_stats"] = {"n_voxels": int(mean.shape[0])}
    lap("stats")

    # ---- derived input views, CHAINED in the reference's order:
    # raw -> vc-mask -> per-voxel normalize -> pca. Each enabled stage
    # consumes the previous stage's pack; transform.json records the chain
    # so `transform` / apply_preprocess_chain can replay it on raw rows
    chain: list[dict] = []
    view = store  # the current stage input

    def _write_view(name, row_fn, row_shape_note):
        pack_path = os.path.join(out_dir, name)

        def rows():
            data, keys = view.data, view.keys.tolist()
            for i in range(0, len(keys), VIEW_BLOCK_ROWS):
                block = row_fn(np.asarray(data[i:i + VIEW_BLOCK_ROWS],
                                          np.float32))
                for j, key in enumerate(keys[i:i + VIEW_BLOCK_ROWS]):
                    yield key, block[j]

        meta_ = write_pack(pack_path, None, rows())
        logger.info("preprocess: wrote %s (%s rows, %s)", name,
                    meta_["n_rows"], row_shape_note)
        return pack_path, meta_

    if vc_parcels:
        # the visual-cortex stage (ThinkAndTell/train.py:78-113 +
        # create_betas_dataset.py): mask the full-cortex rows down to the
        # visual parcels — the pack input_kind: vc configs train on
        from masters_thesis_tpu_torch.data.preprocess.glasser import (
            load_atlas_vector,
            visual_cortex_mask,
        )

        nsd_dir = cfg.dataset.nsd_dir
        if not (nsd_dir and os.path.isdir(nsd_dir)):
            raise ValueError(
                "--vc-parcels needs dataset.nsd_dir with glasser_lh/rh "
                "atlas label vectors to build the vertex mask"
            )
        lh = load_atlas_vector(os.path.join(nsd_dir, "glasser_lh.npy"))
        rh = load_atlas_vector(os.path.join(nsd_dir, "glasser_rh.npy"))
        parcels = _parse_visual_parcels(vc_parcels)
        mask = visual_cortex_mask(lh, rh, parcels)
        width = view.row_shape[0]
        if len(lh) + len(rh) != width:
            raise ValueError(
                f"atlas covers {len(lh) + len(rh)} vertices but the pack "
                f"rows are {width}-wide — wrong atlas for this data"
            )
        if mask.size == 0:
            raise ValueError(
                f"visual parcels {parcels} match no atlas vertex")
        np.save(os.path.join(out_dir, "vc_mask.npy"), mask)
        vc_pack, vc_meta = _write_view(
            "betas_pack_vc", lambda b: b[:, mask],
            f"{mask.size} visual-cortex vertices")
        report["vc"] = {"n_vertices": int(mask.size), "pack": vc_pack,
                        "n_rows": vc_meta["n_rows"],
                        "parcels": sorted(set(parcels))}
        chain.append({"stage": "vc_mask", "file": "vc_mask.npy"})
        view = open_pack(vc_pack)
        lap("vc")

    if normalize:
        # per-voxel (x - mean)/std over the CURRENT view, the reference's
        # load-time normalization (load_dataset.py:8-22; stats from
        # data_mean.py), with statistics from the TRAIN rows when the split
        # is resolvable (no val/test leak); std floors at 1e-8 (a dead
        # voxel would NaN the row)
        idx, stats_from = _train_split_indices(view, cfg.dataset.nsd_dir)
        stat_rows = view.data if idx is None else view.data[idx]
        v_mean, v_std = voxelwise_stats(stat_rows)
        del stat_rows
        v_std = np.maximum(v_std, 1e-8)
        np.savez(os.path.join(out_dir, "norm_stats.npz"),
                 mean=v_mean, std=v_std)
        norm_pack, norm_meta = _write_view(
            "betas_pack_norm", lambda b: (b - v_mean) / v_std,
            "per-voxel normalized")
        report["normalize"] = {"pack": norm_pack,
                               "n_rows": norm_meta["n_rows"],
                               "n_voxels": int(v_mean.shape[0]),
                               "stats_from": stats_from}
        chain.append({"stage": "normalize", "file": "norm_stats.npz"})
        view = open_pack(norm_pack)
        lap("normalize")

    if pca_components > 0:
        # fit on the unique-train rows when the key split is resolvable
        # (the reference fits on the 27k unique split then transforms both
        # splits, SVD/svd.py:64-93 — fitting on val/test leaks them into
        # the subspace); otherwise fit on every row and say so
        idx, fit_on = _train_split_indices(view, cfg.dataset.nsd_dir)
        fit_rows = view.data if idx is None else view.data[idx]
        model = fit_pca(fit_rows, pca_components, device=device)
        del fit_rows
        model.save(os.path.join(out_dir, "pca_model.npz"))
        lap("pca_fit")
        # transform EVERY row, on the device, into the reduced pack the pca
        # configs train on (input_kind: pca points dataset.betas_path here)
        pca_pack, pca_meta = _write_view(
            "betas_pack_pca", projector(model, device),
            f"{model.components.shape[0]} components")
        report["pca"] = {"components": int(model.components.shape[0]),
                         "fit_on": fit_on, "pack": pca_pack,
                         "n_rows": pca_meta["n_rows"]}
        chain.append({"stage": "pca", "file": "pca_model.npz"})
        view = open_pack(pca_pack)
        lap("pca_transform")

    with open(os.path.join(out_dir, "transform.json"), "w") as f:
        json.dump({"stages": chain,
                   "input_row_shape": list(store.row_shape),
                   "final_row_shape": list(view.row_shape)}, f, indent=1)
    report["transform"] = {"stages": [c["stage"] for c in chain]}

    if captions_path and os.path.isdir(captions_path):
        caps = load_captions_dir(captions_path)
        texts = [clean_caption(line) for lines in caps.values()
                 for line in lines]
        tok = Tokenizer(num_words=cfg.top_k)
        tok.fit_on_texts(texts)
        tok.install_pad()
        tok.save(os.path.join(out_dir, "tokenizer.json"))
        report["tokenizer"] = corpus_stats(texts)
        lap("tokenizer")
    report["seconds"] = seconds
    return report


def corpus_stats(texts: list[str]) -> dict:
    """Word/vocab counts (CNN_RNN/count_words.py) plus caption-length
    statistics (caption_analysis.py::statistics — min/max/mean and the
    .25/.5/.75/.9/.99 percentiles its describe() prints)."""
    words = [w for t in texts for w in t.split()]
    lengths = np.asarray([len(t.split()) for t in texts], np.int64)
    stats = {
        "n_captions": len(texts),
        "n_words": len(words),
        "n_unique": len(set(words)),
    }
    if len(lengths):
        stats["caption_length"] = {
            "min": int(lengths.min()),
            "max": int(lengths.max()),
            "mean": float(lengths.mean()),
            **{f"p{int(q * 100)}": float(np.percentile(lengths, q * 100))
               for q in (0.25, 0.5, 0.75, 0.9, 0.99)},
        }
    return stats


def vocab_overlap(tok_a, tok_b, top_k: int = 5000) -> dict:
    """Fraction of tokenizer A's top-k vocabulary present in tokenizer B's
    top-k (caption_analysis.py::unique_words: 73k-corpus vocab vs one
    subject's vocab). Words rank by count, most first, ties in the order
    of ``word_counts`` (a stable sort, as the JAX function's)."""
    def top_words(tok):
        pairs = sorted(tok.word_counts.items(), key=lambda x: x[1],
                       reverse=True)
        return [w for w, _ in pairs[:top_k]]

    a, b = top_words(tok_a), set(top_words(tok_b))
    overlap = sum(1 for w in a if w in b)
    return {
        "overlap": overlap,
        "total": len(a),
        "fraction": overlap / len(a) if a else 0.0,
    }
