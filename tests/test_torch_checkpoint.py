"""The port's checkpoint manager: a save/restore round trip is bit for bit
(parameters, BatchNorm statistics, Adam's mu, nu and count or SGD's trace,
step and seed); a save is a host copy, so in-place updates after ``save``
returns never reach the file; the JAX manager's async cases
(``tests/test_checkpoint_async.py``) hold for the port's manager; and
``warm_start_from_run`` loads by name, skips other shapes and refuses a run
without a checkpoint."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch import nn

from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.train import checkpoint as ckpt
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.checkpoint import (
    CheckpointManager,
    warm_start_from_run,
)
from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
from masters_thesis_tpu_torch.train.optim import Optimizer
from masters_thesis_tpu_torch.train.state import TrainState, init_model

from torch_threads import one_thread  # noqa: F401

CFG = dict(units=16, attn_units=4, group_size=4, embedding_text=8,
           max_length=5, top_k=29, batch_size=6, seed=3)
N_VOXELS, B = 96, 6


def _trained_state(seed=3, n_steps=2, **kw):
    """A small LcNIC state after ``n_steps`` training steps (dropout on),
    so that every slot of the checkpoint holds something non-trivial."""
    cfg = Config(**{**CFG, "seed": seed, **kw})
    layout = GroupLayout(synthetic_groups(N_VOXELS, 4, seed=0), N_VOXELS)
    state = init_model(cfg, layout, device="cpu")
    rng = np.random.default_rng(seed)
    step = steps.make_train_step(cfg, lc_nic_l2_rules(cfg))
    for _ in range(n_steps):
        betas = torch.from_numpy(
            rng.standard_normal((B, N_VOXELS)).astype(np.float32))
        tokens = torch.from_numpy(rng.integers(1, 30, (B, 5)).astype(
            np.int32))
        state, _ = step(state, betas, tokens, torch.roll(tokens, -1, 1))
    return cfg, layout, state


def _tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for slot in ("mu", "nu", "trace"):
        for i, t in enumerate(getattr(state.tx, slot, [])):
            out[f"{slot}.{i}"] = t
    return out


def _assert_same_state(got, want):
    a, b = _tensors(got), _tensors(want)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert (got.tx.count, got.step, got.seed) == (want.tx.count, want.step,
                                                  want.seed)


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_round_trip_is_bit_for_bit(tmp_path, optimizer):
    _, _, state = _trained_state(optimizer=optimizer)
    assert state.step == 2 and state.tx.count == 2
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(state, epoch=0, val_loss=1.5)
    mgr.close()
    _, _, fresh = _trained_state(seed=9, n_steps=1, optimizer=optimizer)
    restored, epoch = CheckpointManager(str(tmp_path)).restore(fresh)
    assert epoch == 0 and restored is fresh
    _assert_same_state(fresh, state)
    saved = mgr.read(0)
    assert set(saved) == {"params", "batch_stats", "opt_state", "step",
                          "seed"}
    assert torch.equal(saved["batch_stats"]["encoder"]["input_bn"]["var"],
                       state.model.encoder.input_bn.var)
    assert set(saved["opt_state"]) == (
        {"name", "count", "mu", "nu"} if optimizer == "Adam"
        else {"name", "count", "trace"})
    (timing,) = mgr.timings
    assert timing["bytes"] == ckpt.nbytes(saved) > 0
    assert 0 < timing["blocked_ms"] <= timing["commit_ms"]


def test_in_place_updates_after_save_do_not_reach_the_file(tmp_path,
                                                          monkeypatch):
    """The write is held back until the parameters, the BatchNorm
    statistics and Adam's state have been changed in place; the file still
    holds the state ``save`` was given."""
    _, _, state = _trained_state()
    want = {k: v.clone() for k, v in _tensors(state).items()}
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert release.wait(30)
        real_save(obj, path)

    monkeypatch.setattr(ckpt.torch, "save", held_save)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, epoch=0, val_loss=1.0)
    with torch.no_grad():
        for t in _tensors(state).values():
            t.add_(1.0)
    state.tx.count += 5
    state.step += 5
    release.set()
    mgr.close()
    monkeypatch.setattr(ckpt.torch, "save", real_save)
    _, _, fresh = _trained_state(seed=8, n_steps=1)
    CheckpointManager(str(tmp_path)).restore(fresh)
    got = _tensors(fresh)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert (fresh.tx.count, fresh.step) == (2, 2)


class _Toy(nn.Module):
    def __init__(self, x: float):
        super().__init__()
        self.dense = nn.Module()
        self.dense.kernel = nn.Parameter(torch.full((4, 4), x))


def _state(x: float) -> TrainState:
    model = _Toy(x)
    state = TrainState(model=model, tx=Optimizer(model.parameters(), 1e-3),
                       generator=torch.Generator(), seed=0, step=int(x))
    state.tx.count = int(x)
    return state


def test_async_save_visible_after_read(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(_state(1.0), epoch=0, val_loss=2.0)
    # read paths flush the pending write
    assert mgr.latest_epoch() == 0
    assert mgr.best_epoch() == 0
    restored = mgr.read(0)
    assert restored["params"]["dense"]["kernel"][0, 0] == 1.0


def test_meta_deferred_until_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(_state(1.0), epoch=0, val_loss=2.0)
    mgr.save(_state(2.0), epoch=1, val_loss=1.0)  # finalizes epoch 0 first
    # epoch 1 may still be in flight: meta on disk reflects only epoch 0
    with open(os.path.join(str(tmp_path), "meta.json")) as f:
        meta = json.load(f)
    assert meta["latest"] == 0
    mgr.close()
    with open(os.path.join(str(tmp_path), "meta.json")) as f:
        meta = json.load(f)
    assert meta["latest"] == 1
    assert meta["best_epoch"] == 1  # val 1.0 < 2.0


def test_prune_and_best_across_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(_state(0.0), epoch=0, val_loss=0.5)  # stays: best
    for e in range(1, 5):
        mgr.save(_state(float(e)), epoch=e, val_loss=1.0 + e)
    mgr.close()
    kept = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("ep"))
    assert kept == ["ep000", "ep003", "ep004"]  # best + last 2
    assert mgr.best_epoch() == 0
    state, epoch = mgr.restore(_state(9.0), best=True)
    assert epoch == 0
    assert state.model.dense.kernel[0, 0] == 0.0
    assert (state.step, state.tx.count) == (0, 0)


def test_failed_write_raises_at_the_next_read(tmp_path, monkeypatch):
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), epoch=0, val_loss=1.0)
    with pytest.raises(RuntimeError, match="epoch 0") as err:
        mgr.latest_epoch()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.meta["epochs"] == []


def test_restore_of_an_empty_directory_returns_none(tmp_path):
    state = _state(3.0)
    assert CheckpointManager(str(tmp_path)).restore(state) == (state, None)


def test_warm_start_loads_matching_names_and_skips_other_shapes(tmp_path):
    """A source run with wider attention: every parameter of the same shape
    loads, the attention's W1 and W2 (other shapes) keep their own
    values."""
    _, _, source = _trained_state()
    mgr = CheckpointManager(str(tmp_path / "src" / "model"))
    mgr.save(source, epoch=0, val_loss=1.0)
    mgr.close()
    _, _, wide = _trained_state(seed=5, n_steps=0, attn_units=6)
    before = {k: v.clone() for k, v in wide.model.named_parameters()}
    report = warm_start_from_run(wide.model, str(tmp_path / "src"))
    src = dict(source.model.named_parameters())
    assert report["source_epoch"] == 0 and not report["missing"]
    assert sorted(s.split(":")[0] for s in report["skipped_shape"]) == [
        "attention/V/kernel", "attention/W1/bias", "attention/W1/kernel",
        "attention/W2/bias", "attention/W2/kernel"]
    for name, p in wide.model.named_parameters():
        path = name.replace(".", "/")
        if path in report["loaded"]:
            assert torch.equal(p, src[name]), name
        else:
            assert torch.equal(p, before[name]), name
    assert len(report["loaded"]) == len(src) - 5


def test_warm_start_refuses_a_run_without_checkpoints(tmp_path):
    _, _, state = _trained_state(n_steps=0)
    with pytest.raises(FileNotFoundError, match="no model/"):
        warm_start_from_run(state.model, str(tmp_path / "typo"))
    assert not (tmp_path / "typo").exists()
    os.makedirs(tmp_path / "empty" / "model")
    with pytest.raises(FileNotFoundError, match="no saved checkpoint"):
        warm_start_from_run(state.model, str(tmp_path / "empty"))
