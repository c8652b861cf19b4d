"""The port's training callbacks against the JAX package's: driven by the
same epochs of logs, through the same hooks of a stand-in trainer, they
write the same CSV lines, TensorBoard records, caption previews, caption
metrics, gradient statistics and checkpoint saves, and stop at the same
epoch. Then the port's decoding callbacks in a real ``Trainer``: the
losses are those of a run without them, and the model is back in training
mode after every decode."""

import dataclasses
import json
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from masters_thesis_tpu.train import callbacks as jcb
from masters_thesis_tpu.utils import logging as jlogging
from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.pairs import encode_pairs
from masters_thesis_tpu_torch.data.pipeline import BatchPipeline, EvalPipeline
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.train import callbacks as pcb
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.loop import Callback, Trainer
from masters_thesis_tpu_torch.train.state import new_state
from masters_thesis_tpu_torch.utils import logging as plogging

from torch_threads import one_thread  # noqa: F401

EPOCHS = 4
KEYS = [3, 5, 7, 9, 11]


def _logs(epoch):
    rng = np.random.default_rng(epoch)
    return {"loss": float(rng.random()), "L2": 0.5, "attention": 0.25,
            "accuracy": float(rng.random()), "total": 1.5,
            "grad_norm": float(rng.random()),
            "val_loss": [2.0, 1.0, 1.5, 1.2][epoch % 4],
            "val_accuracy": 0.5, "epoch_time": 1.0, "steps_per_sec": 2.0}


def _tokenizer():
    tok = Tokenizer(num_words=None)
    tok.fit_on_texts(["<start> a dog runs in the park <end>",
                      "<start> the cat sits on a mat <end>"])
    tok.install_pad()
    return tok


class _Manager:
    """Records the saves and flushes a Checkpointing callback makes."""

    def __init__(self):
        self.calls = []

    def save(self, state, epoch, val_loss=None):
        self.calls.append(("save", int(state.step), epoch, val_loss))

    def close(self):
        self.calls.append(("close",))


def _words(tok, epoch):
    """Decoded words of a batch of 5: a caption per row, with <end>."""
    ids = [tok.word_index[w] for w in "a dog runs in the park".split()]
    rows = [([tok.start_id] + ids[i + epoch % 2:] + [tok.end_id] * 9)[:8]
            for i in range(5)]
    return np.asarray(rows, np.int32)


class _Trainer(SimpleNamespace):
    """The hooks a callback reads, for either package."""


def _drive(cb_module, run_path, metric_logger, jax_side, interrupt_at=None):
    """One run of every callback over EPOCHS epochs of fixed logs; the
    decoders and the gradient statistics answer the same for both."""
    tok = _tokenizer()
    batch = {"idx": np.arange(5, dtype=np.int32),
             "tokens": np.ones((5, 4), np.int32),
             "target": np.ones((5, 4), np.int32),
             "keys": np.asarray(KEYS), "valid": np.ones(5, bool)}
    if jax_side:
        batch["betas"] = np.zeros((5, 3), np.float32)
    epoch_box = [0]

    def decoder(*args):
        words = _words(tok, epoch_box[0])
        return (words, None, None) if jax_side else (torch.from_numpy(words),
                                                     None)

    def stats_fn(state, betas, tokens, target):
        e = epoch_box[0]
        return {"b/kernel": (1.0 + e, 0.5, 2.0), "a/bias": (0.25, e, 1e-7)}

    pipe = SimpleNamespace(epoch=lambda: iter([batch]))
    refs = {k: ["a dog runs in the park", "a cat"] for k in KEYS}
    manager = _Manager()
    callbacks = [
        cb_module.ErrorLog(run_path),
        cb_module.LossHistory(run_path),
        cb_module.BatchLoss(run_path, every=2),
        cb_module.Checkpointing(manager, every=2),
        cb_module.CaptionMetrics(decoder, pipe, tok, refs, every=3),
        cb_module.TensorBoardScalars(os.path.join(run_path, "tb"),
                                     batch_every=3),
        cb_module.PredictPreview(run_path, decoder, batch, tok, every=2),
        cb_module.GradStats(run_path, stats_fn, batch, every=2),
        cb_module.EarlyStopping(min_delta=0.1, patience=2),
    ]
    model = torch.nn.Linear(1, 1)
    state = SimpleNamespace(step=0, model=model, params={}, batch_stats={})
    trainer = _Trainer(state=state, stop_training=False, _target_epochs=EPOCHS,
                       _epoch=0, metric_logger=metric_logger, store=None,
                       _batch_arrays=lambda b: (torch.zeros(5, 3),
                                                torch.ones(5, 4),
                                                torch.ones(5, 4)))
    for cb in callbacks:
        cb.on_train_begin(trainer)
    stopped = None
    try:
        for epoch in range(EPOCHS):
            epoch_box[0] = trainer._epoch = epoch
            if epoch == interrupt_at:
                state.step += 1
                raise KeyboardInterrupt
            for _ in range(3):
                state.step += 1
                for cb in callbacks:
                    cb.on_batch_end(trainer, state.step,
                                    {**_logs(state.step), "extra": 9.0})
            logs = _logs(epoch)
            for cb in callbacks:
                cb.on_epoch_end(trainer, epoch, logs)
            if trainer.stop_training:
                stopped = epoch
                break
    except KeyboardInterrupt:
        for cb in callbacks:
            cb.on_interrupt(trainer, trainer._epoch)
    finally:
        for cb in callbacks:
            cb.on_train_end(trainer)
    return manager.calls, stopped, callbacks[4].history, model.training


def _event_payloads(run_path, wrapped: bool):
    """The records of the run's event file, wall time cut off; the port's
    (``wrapped``) with each summary value taken out of its ``value``
    wrapper, the layout the JAX writer writes (ROADMAP F8)."""
    from test_torch_copies import _unwrapped

    (path,) = [os.path.join(run_path, "tb", f)
               for f in os.listdir(os.path.join(run_path, "tb"))]
    data = open(path, "rb").read()
    out, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + n]
        out.append(_unwrapped(payload) if wrapped else payload[9:])
        i += 16 + n
    return out


@pytest.mark.parametrize("interrupt_at", [None, 1])
def test_callbacks_write_what_the_jax_callbacks_write(tmp_path,
                                                      interrupt_at):
    out = {}
    for name, module, logging_module, jax_side in (
            ("port", pcb, plogging, False), ("jax", jcb, jlogging, True)):
        run = tmp_path / name
        run.mkdir()
        log = logging_module.MetricLogger(str(run / "metrics.jsonl"))
        out[name] = _drive(module, str(run), log, jax_side, interrupt_at)
        log.close()
    calls, stopped, history, _ = out["port"]
    assert out["port"][:3] == out["jax"][:3]
    if interrupt_at is None:
        assert stopped == 3 and len(history) == 2   # epochs 0 and 3
    else:
        # the partial epoch saved on the interrupt, flushed there and at
        # the train end
        assert calls[-3:] == [("save", 4, 1, None), ("close",), ("close",)]
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    for name in ("loss_history.csv", "batch_training_log.csv",
                 "caption_previews.txt", "df_grads.csv"):
        assert (port / name).read_text() == (jax_ / name).read_text(), name
    rows = [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(port / "metrics.jsonl")]
    jrows = [{k: v for k, v in json.loads(line).items() if k != "ts"}
             for line in open(jax_ / "metrics.jsonl")]
    assert rows == jrows
    assert _event_payloads(port, True) == _event_payloads(jax_, False)


def test_decoding_callbacks_put_the_models_mode_back(tmp_path):
    """In training mode before, in training mode after; in eval mode
    before, in eval mode after (the decode itself runs in eval mode)."""
    tok = _tokenizer()
    seen = []
    model = torch.nn.Linear(1, 1)

    def decoder(betas, start_id):
        seen.append(model.training)
        return torch.from_numpy(_words(tok, 0)), None

    trainer = _Trainer(state=SimpleNamespace(model=model),
                       _batch_arrays=lambda b: (torch.zeros(5, 3),))
    preview = pcb.PredictPreview(str(tmp_path), decoder, {}, tok)
    for mode in (True, False):
        model.train(mode)
        preview.on_epoch_end(trainer, 0, {})
        assert model.training is mode
    assert seen == [False, False]


def test_decoding_callbacks_leave_training_as_it_was(tmp_path):
    """PredictPreview and CaptionMetrics at every=1 in a real Trainer with
    dropout on: the same per-step losses as a run without them, the model
    back in training mode after each epoch's decodes, and a preview and
    caption metrics every epoch."""
    cfg = dataclasses.replace(Config.load(
        os.path.join(os.path.dirname(__file__), "..", "configs",
                     "smoke.yaml")), log=str(tmp_path))
    assert cfg.dropout_lstm == 0.2

    class Rows(Callback):
        def __init__(self):
            self.rows, self.modes = [], []

        def on_batch_end(self, trainer, step, logs):
            self.rows.append(logs["loss"])

        def on_epoch_end(self, trainer, epoch, logs):
            self.modes.append(trainer.state.model.training)

    def fit(with_decoders):
        _, pairs, tok, store, groups = experiment.build_data(cfg, 24)
        model, rules, _ = experiment.build_model(cfg, groups,
                                                 store.row_shape[0])
        state = new_state(model, cfg, "cpu")
        enc = encode_pairs(pairs["train"], tok, cfg.max_length)
        val = encode_pairs(pairs["val"], tok, cfg.max_length)
        train_pipe = BatchPipeline(enc, store, 8, seed=cfg.seed)
        val_pipe = BatchPipeline(val, store, 8, seed=cfg.seed, shuffle=False)
        rows = Rows()
        decoders = []
        if with_decoders:
            dec = experiment._greedy_decoder(state.model, cfg)
            refs = {int(k): ["a dog"] for k in val.keys}
            decoders = [
                pcb.PredictPreview(str(tmp_path), dec,
                                   next(iter(val_pipe.epoch())), tok,
                                   every=1),
                pcb.CaptionMetrics(dec, EvalPipeline(val, store, 8), tok,
                                   refs, every=1)]
        trainer = Trainer(cfg, steps.make_train_step(cfg, rules),
                          steps.make_eval_step(cfg, rules), state,
                          train_pipe, val_pipe,
                          callbacks=[*decoders, rows], store=store)
        trainer.fit(epochs=2)
        return rows, decoders

    plain, _ = fit(False)
    with_dec, (_, metrics) = fit(True)
    assert plain.rows == with_dec.rows and len(plain.rows) > 2
    assert with_dec.modes == [True, True]
    assert [h["epoch"] for h in metrics.history] == [0, 1]
    previews = (tmp_path / "caption_previews.txt").read_text()
    assert previews.count("=== epoch") == 2
