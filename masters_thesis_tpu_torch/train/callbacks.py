"""Training callbacks: CSV logs, checkpoints, caption previews and metrics,
gradient statistics, TensorBoard scalars, early stopping.

Counterpart of ``masters_thesis_tpu/train/callbacks.py`` (reference
AttemptFour/Callbacks/: EpochLoss.py, BatchLoss.py, Predict.py), with the
same names, files and columns. The differences come from the state: the
port's model is one module that the step updates in place, where the JAX
callbacks take variables. So a decoder here is bound to the model
(``decode(betas, start_id) -> (words, ...)``, as
``ops.fused_decode.make_whole_fused_greedy_decoder`` makes it: K2 on the
card), and a decoding callback switches the model to ``eval()`` for the
decode and puts back the mode it had (``_decode_words``). Per-step rows
reach ``on_batch_end`` from the Trainer's one fetch at the epoch's end, so
no callback reads the device per step.

``CaptionImagePreview`` draws with the port's own bitmap font
(``utils.tensorboard.render_caption_image``); ``StepProfiling`` and
``TraceCapture`` run on ``torch.profiler`` (``utils.profiling``).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import traceback

import numpy as np

from masters_thesis_tpu_torch.evalsuite.bleu import corpus_bleu
from masters_thesis_tpu_torch.evalsuite.cider import CiderScorer
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption
from masters_thesis_tpu_torch.train.loop import Callback
from masters_thesis_tpu_torch.utils.logging import CSVLogger
from masters_thesis_tpu_torch.utils.profiling import StepProfiler, start_trace
from masters_thesis_tpu_torch.utils.tensorboard import (
    EventWriter,
    render_caption_image,
)

logger = logging.getLogger("masters_thesis_tpu_torch")

class ErrorLog(Callback):
    """On an unhandled training exception: the traceback to <run>/error.log
    and a failure notification (CNN_RNN/train.py:527-531)."""

    def __init__(self, run_path: str, notifier=None):
        self.path = os.path.join(run_path, "error.log")
        self.notifier = notifier

    def on_error(self, trainer, exc):
        with open(self.path, "a") as f:
            f.write(traceback.format_exc())
        if self.notifier is not None:
            try:
                self.notifier.send(f"training failed: {exc!r}")
            except Exception:
                pass  # a dead notifier must never mask the real error


class LossHistory(Callback):
    """Per-epoch CSV (loss_history.csv), EpochLoss.LossHistory."""

    FIELDS = ["epoch", "loss", "accuracy", "L2", "val_loss", "val_accuracy"]

    def __init__(self, run_path: str):
        self.csv = CSVLogger(os.path.join(run_path, "loss_history.csv"),
                             self.FIELDS)

    def on_epoch_end(self, trainer, epoch, logs):
        row = {"epoch": epoch}
        row.update({k: f"{float(v):.6f}" for k, v in logs.items()
                    if k in self.FIELDS})
        self.csv.write(row)


class BatchLoss(Callback):
    """Per-batch CSV (batch_training_log.csv), BatchLoss.py; the grad_norm
    column stands for the reference's df_grads.csv dump."""

    FIELDS = ["step", "loss", "accuracy", "L2", "grad_norm"]

    def __init__(self, run_path: str, every: int = 1):
        self.csv = CSVLogger(
            os.path.join(run_path, "batch_training_log.csv"), self.FIELDS)
        self.every = every
        self._pending: list = []

    def on_batch_end(self, trainer, step, logs):
        if step % self.every == 0:
            self._pending.append(
                (step, {k: v for k, v in logs.items() if k in self.FIELDS}))

    def _flush(self):
        for step, logs in self._pending:
            row = {"step": step}
            row.update({k: f"{float(v):.6f}" for k, v in logs.items()})
            self.csv.write(row)
        self._pending.clear()

    def on_epoch_end(self, trainer, epoch, logs):
        self._flush()

    def on_train_end(self, trainer):
        # the trainer's finally: no rows are lost on error or interrupt
        self._flush()


def _preview_betas(trainer, batch):
    """A stored batch's rows on the device, gathered as the trainer
    gathers them (K1)."""
    return trainer._batch_arrays(batch)[0]


def _decode_words(trainer, decoder, betas, start_id: int) -> np.ndarray:
    """Greedy words of ``betas`` with the model in eval mode, then the mode
    it had put back: the rest of the run must train with dropout on."""
    model = trainer.state.model
    was_training = model.training
    model.eval()
    try:
        words = decoder(betas, start_id)[0]
    finally:
        model.train(was_training)
    return words.cpu().numpy()


class PredictPreview(Callback):
    """Epoch-end greedy captions on a fixed validation batch (Predict.py)."""

    def __init__(self, run_path: str, decoder, batch, tokenizer,
                 every: int = 1):
        self.path = os.path.join(run_path, "caption_previews.txt")
        self.decoder = decoder
        self.batch = batch
        self.tokenizer = tokenizer
        self.every = every

    def on_epoch_end(self, trainer, epoch, logs):
        if epoch % self.every:
            return
        words = _decode_words(trainer, self.decoder,
                              _preview_betas(trainer, self.batch),
                              self.tokenizer.start_id)
        texts = self.tokenizer.sequences_to_texts(list(words))
        with open(self.path, "a") as f:
            f.write(f"=== epoch {epoch} ===\n")
            for t in texts[:8]:
                f.write(t + "\n")


class CaptionMetrics(Callback):
    """Decoded caption metrics on the val split during training: every
    ``every`` epochs and on the final one, greedy-decode one row per val
    key, score corpus BLEU-1/BLEU-4 and CIDEr against the key's references,
    log them to metrics.jsonl (kind ``caption_metrics``) and keep the curve
    in ``history`` for run_meta.json."""

    def __init__(self, decoder, pipe, tokenizer, refs_by_key,
                 every: int = 5):
        self.decoder = decoder
        self.pipe = pipe          # EvalPipeline over unique-key val pairs
        self.tokenizer = tokenizer
        self.refs = refs_by_key   # key -> [plain reference texts]
        self.every = max(1, every)
        self.history: list = []

    def on_epoch_end(self, trainer, epoch, logs):
        last = (trainer._target_epochs or 0) - 1
        if epoch % self.every and epoch != last:
            return
        texts, keys = [], []
        for batch in self.pipe.epoch():
            words = _decode_words(trainer, self.decoder,
                                  _preview_betas(trainer, batch),
                                  self.tokenizer.start_id)
            valid = batch["valid"]
            for row in words[valid]:
                texts.append(ids_to_caption(row, self.tokenizer))
            keys.extend(int(k) for k in batch["keys"][valid])
        refs = [[r.split() for r in self.refs[k]] for k in keys]
        hyps = [t.split() for t in texts]
        bleu = corpus_bleu(refs, hyps, max_n=4)
        cider, _ = CiderScorer().compute(refs, hyps)
        row = {
            "epoch": epoch,
            "val_bleu1": round(float(bleu[0]), 5),
            "val_bleu4": round(float(bleu[3]), 5),
            "val_cider": round(float(cider), 5),
            "n_captions": len(texts),
        }
        self.history.append(row)
        logs.update({k: v for k, v in row.items() if k.startswith("val_")})
        if trainer.metric_logger is not None:
            trainer.metric_logger.log("caption_metrics", **row)
        logger.info(
            "caption_metrics epoch %d: BLEU-4=%.4f CIDEr=%.4f (%d captions)",
            epoch, row["val_bleu4"], row["val_cider"], len(texts))


def load_stimulus_images(images_path: str, keys, max_images: int = 4):
    """Best-effort load of stimulus pictures ``KID{key}.(png|jpg|jpeg|npy)``
    for a preview batch (soloist TensorBoardCaption.py:38 loads a pics dir).

    Returns a list aligned with ``keys[:max_images]`` — ``None`` where no
    file exists — or ``None`` when the dir is unset/missing or nothing was
    found (the preview then renders text-only banners). A file that cannot
    be read counts as no picture; PNG and JPEG files need PIL."""
    if not images_path or not os.path.isdir(images_path):
        return None
    out, found = [], False
    for key in list(keys)[:max_images]:
        img = None
        for ext in ("png", "jpg", "jpeg", "npy"):
            p = os.path.join(images_path, f"KID{int(key)}.{ext}")
            if not os.path.exists(p):
                continue
            try:
                if ext == "npy":
                    img = np.load(p)
                else:
                    from PIL import Image

                    img = np.asarray(Image.open(p).convert("RGB"))
                found = True
                break
            except Exception:
                # unreadable file -> try the key's next format (a corrupt
                # .png used to mask a perfectly loadable .npy)
                img = None
        out.append(img)
    return out if found else None


class CaptionImagePreview(Callback):
    """Epoch-end captions rendered onto their stimulus images as TensorBoard
    image summaries (soloist TensorBoardCaption.py:49-99) in
    ``<logdir>/events.out.tfevents.*.captions``. ``images`` aligns with the
    preview batch rows; None entries render a text-only banner (betas
    models have no stimulus pixels at train time)."""

    def __init__(self, logdir: str, decoder, batch, tokenizer,
                 images=None, every: int = 1, max_images: int = 4):
        self.writer = EventWriter(logdir, filename_suffix=".captions")
        self.decoder = decoder
        self.batch = batch
        self.tokenizer = tokenizer
        self.images = images
        self.every = every
        self.max_images = max_images

    def on_epoch_end(self, trainer, epoch, logs):
        if epoch % self.every:
            return
        words = _decode_words(trainer, self.decoder,
                              _preview_betas(trainer, self.batch),
                              self.tokenizer.start_id)
        texts = self.tokenizer.sequences_to_texts(list(words))
        for i, text in enumerate(texts[: self.max_images]):
            img = None if self.images is None else self.images[i]
            png, h, w = render_caption_image(img, text)
            self.writer.image(f"captions/sample_{i}", png, h, w, epoch)

    def on_train_end(self, trainer):
        self.writer.close()


class StepProfiling(Callback):
    """Wall-time stats over a step window -> <run>/profile.json
    (profile_batch semantics, main.py:210), written only when the window
    saw steps. The time is the host's between two ``on_batch_end`` calls,
    with no synchronise (one would slow the steps it measures): in scanned
    mode the batch callbacks arrive at the epoch's end, so the window
    measures the host's stepping through them, as in the JAX package."""

    def __init__(self, run_path: str, n_steps: int, start_step: int = 10):
        self.path = os.path.join(run_path, "profile.json")
        self.profiler = StepProfiler(start_step, start_step + n_steps)

    def on_batch_end(self, trainer, step, logs):
        self.profiler.maybe_tick(step)

    def on_train_end(self, trainer):
        stats = self.profiler.summary()
        if stats:
            with open(self.path, "w") as f:
                json.dump(stats, f, indent=1)


class TraceCapture(Callback):
    """A ``torch.profiler`` trace of the first epoch -> <run>/trace/
    (``*.pt.trace.json``, which TensorBoard's profile tab and Perfetto
    read; ``tpu.profile_trace``): CPU activity, and the card's kernels when
    the trainer runs on CUDA. It stops at the first epoch's end (traces
    grow fast) or at the train end, whichever comes first."""

    def __init__(self, run_path: str):
        self.logdir = os.path.join(run_path, "trace")
        self._prof = None

    def on_train_begin(self, trainer):
        self._prof = start_trace(self.logdir, trainer.device)

    def _stop(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def on_epoch_end(self, trainer, epoch, logs):
        self._stop()  # first epoch only

    def on_train_end(self, trainer):
        self._stop()  # safety net for 0-epoch/interrupted runs


class Checkpointing(Callback):
    """Epoch-end checkpoint saves. ``save`` copies the state to the host
    before it returns and writes on a thread behind the next epoch; train
    end, error and interrupt flush the write in flight."""

    def __init__(self, manager, every: int = 1):
        self.manager = manager
        self._saved_step = None
        # cfg.tpu.ckpt_every: every N epochs plus the run's final epoch;
        # with N > 1 best-by-val-loss is tracked among SAVED epochs only
        self.every = max(1, int(every))
        self._last_val = None
        self._errored = False

    def on_train_begin(self, trainer):
        # the train-end safety net then also covers an early stop before
        # the first cadence save
        self._saved_step = int(trainer.state.step)

    def on_epoch_end(self, trainer, epoch, logs):
        self._last_val = logs.get("val_loss")
        target = trainer._target_epochs
        is_last = target is not None and epoch >= target - 1
        if not ((epoch + 1) % self.every == 0 or is_last
                or trainer.stop_training):
            return
        self.manager.save(trainer.state, epoch, val_loss=logs.get("val_loss"))
        self._saved_step = int(trainer.state.step)

    def on_interrupt(self, trainer, epoch):
        # save the partial epoch as the latest checkpoint, unless no step
        # ran since the last save (main.py:365-372)
        if self._saved_step != int(trainer.state.step):
            self.manager.save(trainer.state, epoch, val_loss=None)
            self._saved_step = int(trainer.state.step)
        self.manager.close()

    def on_train_end(self, trainer):
        # cadence safety net: never end training with unsaved steps, except
        # after an error (the reference saves nothing on failure)
        if (not self._errored and self._saved_step is not None
                and self._saved_step != int(trainer.state.step)):
            self.manager.save(trainer.state, trainer._epoch,
                              val_loss=self._last_val)
            self._saved_step = int(trainer.state.step)
        self.manager.close()

    def on_error(self, trainer, exc):
        # commit the write in flight; a failing write must not mask the
        # training exception
        self._errored = True
        try:
            self.manager.close()
        except Exception:
            logger.exception("checkpoint flush failed during error teardown")


class GradStats(Callback):
    """Per-parameter gradient norms, mean and max magnitudes ->
    df_grads.csv (main.py:359-361), every ``every`` epochs, from
    ``train.steps.make_grad_stats_fn``."""

    def __init__(self, run_path: str, stats_fn, batch, every: int = 1):
        self.path = os.path.join(run_path, "df_grads.csv")
        self.stats_fn = stats_fn
        self.batch = batch
        self.every = every

    def on_epoch_end(self, trainer, epoch, logs):
        if epoch % self.every:
            return
        betas, tokens, target = trainer._batch_arrays(self.batch)
        stats = self.stats_fn(trainer.state, betas, tokens, target)
        # the header only for a new file: a resumed run appends
        write_header = not os.path.exists(self.path)
        with open(self.path, "a", newline="") as f:
            w = csv.writer(f)
            if write_header:
                w.writerow(["epoch", "param", "grad_norm", "grad_mean_abs",
                            "grad_max_abs"])
            for name, (norm, mean_abs, max_abs) in sorted(stats.items()):
                w.writerow([epoch, name, f"{norm:.6e}", f"{mean_abs:.6e}",
                            f"{max_abs:.6e}"])


class TensorBoardScalars(Callback):
    """Per-batch and per-epoch scalar summaries (main.py:202-211) through
    the dependency-free event writer."""

    def __init__(self, logdir: str, batch_every: int = 10):
        self.writer = EventWriter(logdir)
        self.batch_every = batch_every
        self._pending: list = []

    def on_batch_end(self, trainer, step, logs):
        if step % self.batch_every == 0:
            self._pending.append((step, {
                k: logs[k] for k in ("loss", "accuracy", "L2", "grad_norm")
                if k in logs
            }))

    def _flush(self):
        for step, vals in self._pending:
            self.writer.scalars({k: float(v) for k, v in vals.items()},
                                step, prefix="batch/")
        self._pending = []

    def on_epoch_end(self, trainer, epoch, logs):
        self._flush()
        vals = {k: float(v) for k, v in logs.items()
                if isinstance(v, (int, float))}
        self.writer.scalars(vals, epoch, prefix="epoch/")

    def on_train_end(self, trainer):
        self._flush()
        self.writer.close()


class EarlyStopping(Callback):
    """EarlyStoppingByLossVal (soloist callbacks.py:5-77)."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 1e-3,
                 patience: int = 5):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.best = None
        self.bad = 0

    def on_epoch_end(self, trainer, epoch, logs):
        val = logs.get(self.monitor)
        if val is None:
            return
        val = float(val)
        if self.best is None or val < self.best - self.min_delta:
            self.best = val
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                trainer.stop_training = True
