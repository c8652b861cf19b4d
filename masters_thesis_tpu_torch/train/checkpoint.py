"""Checkpoint manager: best-by-val-loss + latest, with resume, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/checkpoint.py`` (reference
main.py:167-190, CNN_RNN/train.py:272-287, main.py:150-163), with its
directory contract and ``torch.save`` in place of orbax:

- ``<dir>/ep{NNN}/state.pt`` per saved epoch;
- ``<dir>/meta.json``, written atomically, with ``best_val_loss``,
  ``best_epoch``, ``epochs`` and ``latest``;
- pruning to the last ``max_to_keep`` epochs, the best one always kept.

A checkpoint holds the parameters and BatchNorm statistics under their flax
names (``transplant.to_flax``), the optimizer state (Adam's ``mu``, ``nu``
and ``count``, or SGD's ``trace`` and ``count``, as flax-named trees), and
``step`` and ``seed``: all that a resumed run needs to take the steps the
uninterrupted run would have taken, bit for bit (the dropout masks of step
s depend on (seed, s) alone, ``train/state.py``).

Saves are asynchronous, as in the JAX manager, but the port's train step
updates the model and the optimizer IN PLACE, so ``save`` first copies
every tensor to the host and returns only then: later steps cannot reach
the file. Only the file write runs on a thread, behind the next epoch, and
the meta/prune bookkeeping of a save is deferred until its write commits;
every read flushes the write in flight first. ``timings`` records, per
save, the ms that ``save`` blocked, the ms to the commit and the bytes.

Under a mesh a save is collective: every rank gathers the whole state
(``parallel.sharding.gather_state_dict``), and the primary rank's manager
(``primary=True``) writes it in the same format, so a checkpoint does not
depend on the topology that wrote it; a restore on any topology slices the
whole state to each rank's shards, as orbax restores the JAX package's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import torch

from masters_thesis_tpu_torch.transplant import from_flax, to_flax

_FILE = "state.pt"


def _torch_tree(tree: dict) -> dict:
    """A nested dict of numpy arrays as the same dict of torch tensors,
    sharing their memory."""
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _flat(tree: dict, prefix: str = "") -> dict:
    """The flax-nested tree -> {'a.b.kernel': leaf}."""
    out = {}
    for name, value in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(value, dict):
            out.update(_flat(value, key))
        else:
            out[key] = value
    return out


def _slots(tx) -> tuple[str, ...]:
    return ("mu", "nu") if tx.name == "adam" else ("trace",)


def snapshot(state) -> dict:
    """What a checkpoint holds, as host copies (``to_flax`` copies every
    tensor): {"params", "batch_stats", "opt_state", "step", "seed"}, the
    trees flax-named."""
    from masters_thesis_tpu_torch.parallel.sharding import (
        gather_slots,
        gather_state_dict,
    )

    model, tx = state.model, state.tx
    whole = bool(state.shards)
    variables = to_flax(gather_state_dict(state) if whole
                        else model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    slots = (gather_slots(state) if whole
             else {slot: getattr(tx, slot) for slot in _slots(tx)})
    opt = {"name": tx.name, "count": int(tx.count)}
    for slot in _slots(tx):
        opt[slot] = _torch_tree(to_flax(dict(zip(names, slots[slot])))
                                ["params"])
    return {"params": _torch_tree(variables.get("params", {})),
            "batch_stats": _torch_tree(variables.get("batch_stats", {})),
            "opt_state": opt, "step": int(state.step),
            "seed": int(state.seed)}


def nbytes(target: dict) -> int:
    """The bytes of every tensor in a snapshot."""
    if isinstance(target, dict):
        return sum(nbytes(v) for v in target.values())
    return (target.numel() * target.element_size()
            if isinstance(target, torch.Tensor) else 0)


def load_into(state, target: dict) -> None:
    """Put a snapshot back into ``state``, in place: the model's parameters
    and BatchNorm statistics, the optimizer, step and seed; each sharded
    leaf's slice of this rank under a mesh."""
    from masters_thesis_tpu_torch.parallel.sharding import local_slice

    model, tx = state.model, state.tx
    whole = from_flax(
        {c: target[c] for c in ("params", "batch_stats") if target[c]})
    model.load_state_dict({k: local_slice(k, v, state)
                           for k, v in whole.items()})
    opt = target["opt_state"]
    if opt["name"] != tx.name:
        raise ValueError(f"checkpoint optimizer {opt['name']!r} != the "
                         f"run's {tx.name!r}")
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for slot in _slots(tx):
            saved = _flat(opt[slot])
            for name, t in zip(names, getattr(tx, slot)):
                t.copy_(local_slice(name, saved[name], state))
    tx.count = int(opt["count"])
    state.step = int(target["step"])
    state.seed = int(target["seed"])


class CheckpointManager:
    """``primary``: this rank writes. Under a mesh every rank's manager
    takes part in a save (the gather is collective) and only the primary's
    writes files and ``meta.json``; every rank restores from the files."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 primary: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.primary = primary
        self._pending: tuple[int, float | None] | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.timings: list[dict] = []
        self._meta_path = os.path.join(self.directory, "meta.json")
        self.meta = self._load_meta()

    def _load_meta(self) -> dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {"best_val_loss": None, "best_epoch": None, "epochs": []}

    def _save_meta(self) -> None:
        # atomic: meta.json must never be seen half-written
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ep{epoch:03d}")

    # ---- save ----
    def save(self, state, epoch: int, val_loss: float | None = None) -> None:
        """Copy the state to the host, then write it on a thread; the
        best/latest/prune bookkeeping follows once the write commits."""
        self._finalize_pending()
        t0 = time.perf_counter()
        target = snapshot(state)
        if not self.primary:
            return
        path = self._epoch_dir(epoch)
        if os.path.exists(path):
            shutil.rmtree(path)
        timing = {"epoch": epoch, "bytes": nbytes(target),
                  "blocked_ms": None, "commit_ms": None}

        def write():
            try:
                tmp = path + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                torch.save(target, os.path.join(tmp, _FILE))
                os.replace(tmp, path)
                timing["commit_ms"] = (time.perf_counter() - t0) * 1e3
            except BaseException as exc:  # noqa: BLE001 — re-raised at flush
                self._error = exc

        timing["blocked_ms"] = (time.perf_counter() - t0) * 1e3
        self.timings.append(timing)
        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-ep{epoch:03d}")
        self._thread.start()
        self._pending = (epoch, val_loss)

    def _finalize_pending(self) -> None:
        """Wait for the write in flight to commit, then apply its
        best/latest/prune bookkeeping."""
        if self._pending is None:
            return
        self._thread.join()
        self._thread = None
        epoch, val_loss = self._pending
        self._pending = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(f"checkpoint write of epoch {epoch} "
                               f"failed") from exc
        if epoch not in self.meta["epochs"]:
            self.meta["epochs"].append(epoch)
        self.meta["latest"] = epoch
        if val_loss is not None and (
            self.meta["best_val_loss"] is None
            or val_loss < self.meta["best_val_loss"]
        ):
            self.meta["best_val_loss"] = float(val_loss)
            self.meta["best_epoch"] = epoch
        keep = set(self.meta["epochs"][-self.max_to_keep:])
        if self.meta["best_epoch"] is not None:
            keep.add(self.meta["best_epoch"])
        for e in list(self.meta["epochs"]):
            if e not in keep and os.path.exists(self._epoch_dir(e)):
                shutil.rmtree(self._epoch_dir(e))
        self.meta["epochs"] = [e for e in self.meta["epochs"] if e in keep]
        self._save_meta()

    def close(self) -> None:
        """Flush the write in flight (train end, error, interrupt)."""
        self._finalize_pending()

    # ---- restore ----
    def latest_epoch(self) -> int | None:
        self._finalize_pending()
        return self.meta.get("latest")

    def best_epoch(self) -> int | None:
        self._finalize_pending()
        return self.meta.get("best_epoch")

    def _pick(self, epoch: int | None, best: bool) -> int | None:
        if epoch is None:
            epoch = self.best_epoch() if best else self.latest_epoch()
        return epoch

    def read(self, epoch: int) -> dict:
        """The saved snapshot of ``epoch`` (host tensors)."""
        self._finalize_pending()
        return torch.load(os.path.join(self._epoch_dir(epoch), _FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, state, epoch: int | None = None, best: bool = False):
        """Restore into ``state`` in place; returns (state, epoch), epoch
        None when there is nothing to restore."""
        epoch = self._pick(epoch, best)
        if epoch is None:
            return state, None
        load_into(state, self.read(epoch))
        return state, epoch

    def restore_params_only(self, epoch: int | None = None,
                            best: bool = True):
        """(the flax-named parameter tree, epoch), or (None, None)."""
        epoch = self._pick(epoch, best)
        if epoch is None:
            return None, None
        return self.read(epoch)["params"], epoch


def merge_by_name(model, source: dict) -> dict:
    """Keras ``load_weights(by_name=True, skip_mismatch=True)``
    (main.py:150-163): copy into ``model`` every parameter whose flax path
    is in ``source`` with the same shape; keep the model's own elsewhere.
    Returns the report of '/'-joined paths: loaded, skipped_shape,
    missing."""
    report = {"loaded": [], "skipped_shape": [], "missing": []}
    saved = _flat(source)
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = name.replace(".", "/")
            s = saved.get(name)
            if s is None:
                report["missing"].append(path)
            elif tuple(s.shape) == tuple(p.shape):
                p.copy_(s)
                report["loaded"].append(path)
            else:
                report["skipped_shape"].append(
                    f"{path}: {tuple(s.shape)} vs {tuple(p.shape)}")
    return report


def warm_start_from_run(model, run_dir: str) -> dict:
    """Preload matching parameters from another run's best (else latest)
    checkpoint (``cfg.warm_start``), in place. A run dir without a
    ``model/`` directory or without a saved epoch raises."""
    model_dir = os.path.join(run_dir, "model")
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(
            f"warm_start run dir {run_dir!r} has no model/ checkpoint "
            "directory — check the path")
    mgr = CheckpointManager(model_dir)
    source, epoch = mgr.restore_params_only(best=True)
    if epoch is None:
        source, epoch = mgr.restore_params_only(best=False)
    if epoch is None:
        raise FileNotFoundError(
            f"warm_start run dir {run_dir!r} contains no saved checkpoint "
            "epochs — nothing to warm-start from")
    report = merge_by_name(model, source)
    report["source_epoch"] = epoch
    return report
