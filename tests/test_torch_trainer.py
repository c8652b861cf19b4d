"""The ported slice as a whole: one epoch of the port's ``Trainer`` against
the JAX package's ``Trainer``, each over its own instance of the shared
``BatchPipeline`` with the same seed, scanned in chunks with a ragged tail,
plus the scanned validation pass; every dropout rate 0, fp32 on the CPU,
per-step losses within 2e-5 (ROADMAP M5). Also the port Trainer's own
paths: per-step training, batch callbacks in step order, and the SIGTERM
partial stop."""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.pairs import encode_pairs
from masters_thesis_tpu.data.pipeline import BatchPipeline
from masters_thesis_tpu.data.synthetic import synthetic_dataset
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu.train.callbacks import Callback as JCallback
from masters_thesis_tpu.train.loop import Trainer as JTrainer
from masters_thesis_tpu.train.losses import lc_nic_l2_rules as jrules_of
from masters_thesis_tpu.train.optim import make_optimizer as jmake_optimizer
from masters_thesis_tpu.train.state import TrainState as JTrainState
from masters_thesis_tpu.train.state import init_model as jinit_model
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.loop import Callback, Trainer
from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
from masters_thesis_tpu_torch.train.state import init_model
from masters_thesis_tpu_torch.transplant import from_flax

from torch_threads import one_thread  # noqa: F401

TRAJ = dict(rtol=2e-5, atol=2e-5)
N_VOXELS = 64
CFG = dict(top_k=30, batch_size=4, max_length=5, units=12, attn_units=6,
           group_size=4, embedding_text=8, epochs=1, alpha=1e-3,
           dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
           dropout_lstm=0.0, dropout_out=0.0)


class Recorder(Callback):
    def __init__(self):
        self.rows, self.events = [], []

    def on_train_begin(self, trainer):
        self.events.append("begin")

    def on_batch_end(self, trainer, step, logs):
        self.rows.append((step, logs))

    def on_epoch_end(self, trainer, epoch, logs):
        self.events.append(("epoch", epoch))

    def on_interrupt(self, trainer, epoch):
        self.events.append(("interrupt", epoch))

    def on_train_end(self, trainer):
        self.events.append("end")


class JRecorder(JCallback):
    def __init__(self):
        self.rows = []

    def on_batch_end(self, trainer, step, logs):
        self.rows.append((step, {k: float(v) for k, v in logs.items()}))


def _data():
    _, pairs, tok, jstore, groups = synthetic_dataset(
        n_keys=16, n_voxels=N_VOXELS, n_groups=3, top_k=CFG["top_k"],
        device_resident=True)
    enc = encode_pairs(pairs["train"], tok, CFG["max_length"])
    val = encode_pairs(pairs["val"], tok, CFG["max_length"])
    return jstore, enc, val, GroupLayout(groups, N_VOXELS)


def _port_trainer(cfg, jstore, enc, val, layout, callbacks, variables=None,
                  train_step=None):
    store = ArrayStore(np.asarray(jstore.device_array()), jstore.keys,
                       device="cpu")
    state = init_model(cfg, layout, "cpu")
    if variables is not None:
        state.model.load_state_dict(from_flax(variables))
    rules = lc_nic_l2_rules(cfg)
    trainer = Trainer(
        cfg, train_step or steps.make_train_step(cfg, rules),
        steps.make_eval_step(cfg, rules), state,
        BatchPipeline(enc, store, cfg.batch_size, seed=0),
        BatchPipeline(val, store, cfg.batch_size, seed=0, shuffle=False),
        callbacks=callbacks, store=store)
    return trainer, rules


def test_one_epoch_matches_the_jax_trainer():
    jcfg, cfg = JConfig(**CFG), Config(**CFG)
    jcfg.tpu.scan_steps = cfg.tpu.scan_steps = 3
    jstore, enc, val, layout = _data()
    jmodel = JLcNIC(layout=layout, units=cfg.units, group_size=cfg.group_size,
                    embedding_text=cfg.embedding_text,
                    attn_units=cfg.attn_units, vocab_size=cfg.vocab_size,
                    max_length=cfg.max_length, dropout_features=0.0,
                    dropout_text=0.0, dropout_attn=0.0, dropout_lstm=0.0,
                    dropout_out=0.0)
    pipe = BatchPipeline(enc, jstore, cfg.batch_size, seed=0)
    batch = next(iter(pipe.epoch(0)))
    params, bstats, rng = jinit_model(
        jmodel, jcfg, np.asarray(jstore.device_gather(batch["idx"])),
        batch["tokens"])
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": bstats})
    jrules = jrules_of(jcfg)
    jrec = JRecorder()
    jtrainer = JTrainer(
        jcfg, jsteps.make_train_step(jmodel, jcfg, jrules, donate=False),
        jsteps.make_eval_step(jmodel, jcfg, jrules),
        JTrainState.create(params=params, batch_stats=bstats,
                           tx=jmake_optimizer(jcfg), rng=rng),
        pipe, BatchPipeline(val, jstore, cfg.batch_size, seed=0,
                            shuffle=False),
        callbacks=[jrec], store=jstore)
    jtrainer.use_scanned_steps(jsteps.make_scanned_train_steps_from_tables(
        jmodel, jcfg, jrules), tables=True)
    jtrainer.use_scanned_eval(jsteps.make_scanned_eval_steps_from_tables(
        jmodel, jcfg, jrules))
    jlogs = jtrainer.fit()

    rec = Recorder()
    trainer, rules = _port_trainer(cfg, jstore, enc, val, layout, [rec],
                                   variables)
    trainer.use_scanned_steps(
        steps.make_scanned_train_steps_from_tables(cfg, rules), tables=True)
    trainer.use_scanned_eval(
        steps.make_scanned_eval_steps_from_tables(cfg, rules))
    logs = trainer.fit()

    n = len(trainer.train_pipe)
    assert n % 3 and n > 3                 # full chunks and a ragged tail
    assert [s for s, _ in rec.rows] == [s for s, _ in jrec.rows] == list(
        range(1, n + 1))
    for key in ("loss", "total", "grad_norm", "accuracy"):
        np.testing.assert_allclose([r[key] for _, r in rec.rows],
                                   [r[key] for _, r in jrec.rows],
                                   err_msg=key, **TRAJ)
    for key in ("loss", "val_loss", "val_accuracy", "val_L2"):
        np.testing.assert_allclose(logs[key], jlogs[key], err_msg=key,
                                   **TRAJ)
    assert trainer.state.step == int(jtrainer.state.step) == n
    assert rec.events == ["begin", ("epoch", 0), "end"]


def test_per_step_path_equals_the_scanned_path():
    """``scan_steps`` 0 runs every step through the per-step path, with the
    per-batch validation loop; same numbers as the scanned path."""
    jstore, enc, val, layout = _data()
    logs = []
    for scan in (0, 3):
        cfg = Config(**CFG)
        cfg.tpu.scan_steps = scan
        rec = Recorder()
        trainer, rules = _port_trainer(cfg, jstore, enc, val, layout, [rec])
        if scan:
            trainer.use_scanned_steps(
                steps.make_scanned_train_steps_from_tables(cfg, rules))
            trainer.use_scanned_eval(
                steps.make_scanned_eval_steps_from_tables(cfg, rules))
        logs.append((trainer.fit(), [r["loss"] for _, r in rec.rows]))
    (a, la), (b, lb) = logs
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for key in ("loss", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, err_msg=key)
    assert a["steps_per_sec"] > 0 and a["epoch_time"] > 0


def test_sigterm_stops_at_a_safe_point_and_keeps_the_rows():
    """SIGTERM during a step sets a flag; the trainer raises at the next
    safe point, hands the finished steps' metrics to the batch hook, calls
    ``on_interrupt`` and restores the previous handler."""
    cfg = Config(**CFG)
    jstore, enc, val, layout = _data()
    rules = lc_nic_l2_rules(cfg)
    inner = steps.make_train_step(cfg, rules)

    def step(state, *batch):
        state, metrics = inner(state, *batch)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, metrics

    rec = Recorder()
    trainer, _ = _port_trainer(cfg, jstore, enc, val, layout, [rec],
                               train_step=step)
    before = signal.getsignal(signal.SIGTERM)
    trainer.fit(epochs=3)
    assert [s for s, _ in rec.rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for _, r in rec.rows)
    assert rec.events == ["begin", ("interrupt", 0), "end"]
    assert trainer.state.step == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_only_the_tables_scanned_trainer_is_ported():
    cfg = Config(**CFG)
    jstore, enc, val, layout = _data()
    trainer, rules = _port_trainer(cfg, jstore, enc, val, layout, [])
    with pytest.raises(NotImplementedError, match="tables"):
        trainer.use_scanned_steps(
            steps.make_scanned_train_steps_from_tables(cfg, rules),
            tables=False)


def test_dropout_on_trains_and_the_loss_falls():
    """The default dropouts (0.2): two epochs on the CPU, finite metrics,
    and a lower mean loss in the second epoch than in the first."""
    cfg = Config(**{**CFG, "dropout_features": 0.2, "dropout_text": 0.2,
                    "dropout_attn": 0.2, "dropout_lstm": 0.2,
                    "dropout_out": 0.2, "alpha": 3e-3})
    cfg.tpu.scan_steps = 4
    jstore, enc, val, layout = _data()
    rec = Recorder()
    trainer, rules = _port_trainer(cfg, jstore, enc, val, layout, [rec])
    trainer.use_scanned_steps(
        steps.make_scanned_train_steps_from_tables(cfg, rules))
    trainer.fit(epochs=2)
    losses = np.array([r["loss"] for _, r in rec.rows])
    n = len(trainer.train_pipe)
    assert np.isfinite(losses).all() and len(losses) == 2 * n
    assert losses[n:].mean() < losses[:n].mean()
    assert torch.isfinite(trainer.state.model.encoder.input_bn.var).all()
