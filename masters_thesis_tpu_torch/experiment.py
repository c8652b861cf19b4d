"""Experiment wiring: config -> data -> model -> trainer / eval / metrics.

Counterpart of ``masters_thesis_tpu/experiment.py`` (reference
AttemptFour/main.py, main_ms.py, main_images.py, eval.py, metric_suit.py)
for every model family of its ``build_model``: ``build_data``,
``build_model``, ``run_training`` (a ``Trainer`` with the standard
callbacks and async checkpoints), ``run_eval`` (greedy or beam decoding of
the test split) and ``run_metrics`` (the metric suite). ``run_training``
writes the JAX package's run directory: ``config.yaml``, ``log.log``,
``tokenizer.json``, ``layout.npz`` (for the families whose encoder reads a
group layout), ``glove_table.npy`` (for a GloVe run), ``modelsummary.txt``,
``run_meta.json``, ``metrics.jsonl``, the CSV logs, ``caption_previews.txt``,
``df_grads.csv``, ``tb/`` and ``model/``, whose checkpoint files are
torch's (``train/checkpoint.py``).

Every entry point runs on the card (``cuda``) unless it is given
``device="cpu"``. There, every train and val batch gathers its rows from
the device store through K1 (``ops.gather``), with ``tpu.scan_steps`` > 0
for ``lc_nic``/``ms_nic`` from a store permuted once into the encoder's
grouped layout ("pregathered"), and every greedy decode of a ``NIC`` runs
K2 (LSTM) or K3 (GRU) (``ops.fused_decode``). The ShowTell family has no
kernel, here as in the JAX package, and decodes through the step loop; beam
and sampling are plain PyTorch on any device. On the CPU each kernel takes
its plain PyTorch version. ``layout.npz`` and ``run_meta.json``'s
``input_row_shape`` let serving (``serve.Captioner.from_run_dir``) rebuild
a model that takes raw rows.

Without NSD data the data is ``data.synthetic`` made from the seed, at the
sizes the JAX package uses. What waits raises ``NotImplementedError``
naming its ROADMAP item: real data (M19) and the ``tpu:`` knobs of
``config.unsupported_knobs``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time

import numpy as np
import torch

from masters_thesis_tpu_torch import __version__
from masters_thesis_tpu_torch.config import Config, unsupported_knobs
from masters_thesis_tpu_torch.data.pairs import encode_pairs
from masters_thesis_tpu_torch.data.pipeline import BatchPipeline, EvalPipeline
from masters_thesis_tpu_torch.data.store import ArrayStore, permute_rows
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
from masters_thesis_tpu_torch.ops.gather import gather_rows
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
    """Returns (split, pairs, tokenizer, store, groups), ``store`` a CPU
    ``ArrayStore`` over the host rows (``run_training`` moves it to the
    device). The synthetic data of the JAX ``build_data``, row for row:
    ``smoke_keys`` keys, 2,048 voxels in 4-16 groups up to 64 keys, else the
    configured input width (360 Glasser-like groups at full width); 512-wide
    GUSE vectors for ``guse_nic``; (16, C) patch rows for ``img_nic`` and
    ``cnn_rnn``."""
    if cfg.dataset.betas_path and os.path.isdir(cfg.dataset.betas_path):
        raise NotImplementedError(
            f"real NSD data ({cfg.dataset.betas_path}) needs data/pack.py, "
            "ported with data ingestion (ROADMAP M19)")
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
    if cfg.groups_to_remove:
        # the flagship trains on 345 of 360 regions (main.py:115); indices
        # past the group count are ignored, as select_groups ignores them
        rm = set(cfg.groups_to_remove)
        kept = [g for i, g in enumerate(groups) if i not in rm]
        logger.info("group selection: %d -> %d groups (%d removed)",
                    len(groups), len(kept), len(groups) - len(kept))
        groups = kept
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
    ShowTell family, which has no kernel."""
    if isinstance(model, NIC):
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
    cfg, manager."""
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.callbacks import (
        BatchLoss,
        CaptionMetrics,
        Checkpointing,
        ErrorLog,
        GradStats,
        LossHistory,
        PredictPreview,
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
    unsupported_knobs(cfg, device)
    name = cfg.model.lower()
    if name not in PORTED_MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    run_path = setup_run_dir(cfg.log, cfg.run, cfg)
    split, pairs, tok, host_store, groups = build_data(cfg, smoke_keys)
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
    if name in LAYOUT_MODELS:
        layout = GroupLayout(groups, n_voxels)
        layout.save(os.path.join(run_path, "layout.npz"))

    # the store on the device; the host rows go as soon as it is there
    keys = host_store.keys
    data = host_store.data.to(device).view(len(keys), *row_shape)
    del host_store
    if pregathered:
        data = permute_rows(data, layout)
    store = ArrayStore(data, keys, device=device, dtype=cfg.tpu.store_dtype)
    del data

    train_enc = encode_pairs(pairs["train"], tok, cfg.max_length)
    val_enc = encode_pairs(pairs["val"], tok, cfg.max_length)
    bs = min(cfg.batch_size, max(2, len(train_enc) // 2))
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

    state = new_state(model, cfg, device)
    model = state.model
    if cfg.warm_start:
        ws = warm_start_from_run(model, cfg.warm_start)
        logger.info(
            "warm start from %s (epoch %s): %d loaded, %d shape-skipped, "
            "%d missing", cfg.warm_start, ws.get("source_epoch"),
            len(ws["loaded"]), len(ws["skipped_shape"]), len(ws["missing"]))

    variables = to_flax(model.state_dict())
    with open(os.path.join(run_path, "modelsummary.txt"), "w") as f:
        f.write(model_summary(variables["params"],
                              variables.get("batch_stats"), name=cfg.model))
    del variables

    meta_path = os.path.join(run_path, "run_meta.json")
    with open(meta_path, "w") as f:
        json.dump({
            "framework_version": __version__,
            "git_revision": _git_revision(),
            "model": cfg.model,
            "backend": _backend(device),
            "n_devices": (torch.cuda.device_count()
                          if device.type == "cuda" else 1),
            "n_processes": 1,
            "mesh": None,
            "input_row_shape": input_row_shape,
            # torch's generators draw every mask whatever the value
            "prng_impl": cfg.tpu.prng_impl,
        }, f, indent=1)

    # decoded caption metrics on the val split: one row per unique val key,
    # the references rebuilt from the raw pairs
    caption_metrics_cb = None
    if cfg.caption_metrics_every > 0 and pairs["val"]:
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

    mgr = CheckpointManager(os.path.join(run_path, "model"))
    start_epoch = 0
    if resume:
        state, restored_epoch = mgr.restore(state)
        if restored_epoch is not None:
            start_epoch = restored_epoch + 1
            logger.info("resumed from epoch %d", restored_epoch)

    train_step = steps.make_train_step(cfg, l2_rules, masked=masked)
    eval_step = steps.make_eval_step(cfg, l2_rules, masked=masked)
    preview_batch = (next(iter(val_pipe.epoch())) if len(val_enc) >= bs
                     else next(iter(train_pipe.epoch())))
    callbacks = [
        ErrorLog(run_path),
        LossHistory(run_path),
        BatchLoss(run_path),
        Checkpointing(mgr, every=cfg.tpu.ckpt_every),
        # before TensorBoardScalars: CaptionMetrics adds val_bleu*/val_cider
        # to the epoch's logs
        *([caption_metrics_cb] if caption_metrics_cb else []),
        TensorBoardScalars(os.path.join(run_path, "tb")),
        PredictPreview(run_path, _greedy_decoder(model, cfg), preview_batch,
                       tok, every=5),
        GradStats(run_path,
                  steps.make_grad_stats_fn(cfg, l2_rules, masked=masked),
                  batch, every=5),
        *extra_callbacks,
    ]
    trainer = Trainer(
        cfg, train_step, eval_step, state, train_pipe, val_pipe,
        callbacks=callbacks, store=store,
        metric_logger=MetricLogger(os.path.join(run_path, "metrics.jsonl")))
    if cfg.tpu.scan_steps > 0:
        # K steps a call from the device tables, and the validation pass in
        # one call
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
    bundle = {
        "model": model, "state": trainer.state, "tokenizer": tok,
        "store": store, "split": split, "pairs": pairs, "cfg": cfg,
        "manager": mgr,
    }
    return run_path, logs, bundle


# ---------------------------------------------------------------- eval

def run_eval(bundle, run_path: str, epoch: int | None = None,
             decoder: str = "greedy", beam_width: int = 5,
             ms2_subject: str = "a"):
    """Test-set decoding (reference eval.py:147-193): the words of every
    test pair (val when there is no test split), written as
    ``output_captions_{e}.npy``, ``attention_scores_{e}.npy`` and
    ``captions_{e}.txt``. ``decoder`` "greedy" runs K2 or K3 for a ``NIC``
    (the step loop for the ShowTell family); "beam" the fixed-lattice beam
    of ``beam_width``, whose attention file holds the winning hypothesis'
    own trail. ``ms2_subject`` picks the encoder that decodes an ms2_nic
    run (the split layout is a training batch contract; the reference
    evaluates one subject at a time). Returns {"words", "keys", "texts",
    "epoch"}."""
    if decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}: expected 'greedy' "
                         f"or 'beam'")
    cfg, model, tok = bundle["cfg"], bundle["model"], bundle["tokenizer"]
    store = bundle["store"]
    pairs = bundle["pairs"]["test"] or bundle["pairs"]["val"]
    enc = encode_pairs(pairs, tok, cfg.max_length)
    bs = min(cfg.batch_size, len(enc))
    pipe = EvalPipeline(enc, store, bs)
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
            betas = gather_rows(
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


def run_metrics(bundle, eval_out, captions_by_key=None) -> dict:
    """The metric suite (reference metric_suit.py + guse_sim.py) on the
    eval output. GUSE scores carry ``GUSE_hash_*``: the USE encoder waits
    (ROADMAP M12), and a USE weight bundle in the config's guse dir
    raises."""
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
    scores.update(labelled_guse_scores(
        eval_out["texts"], refs,
        weights_path=(bundle_path if bundle_path
                      and os.path.exists(bundle_path) else None)))
    return scores
