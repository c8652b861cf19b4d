"""Trainer: the epoch loop over the shared input pipeline, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/loop.py`` (reference
AttemptFour/main.py:269-372): epochs of train steps from a
``BatchPipeline`` (shared with the JAX package) over a device-resident
``data.store.ArrayStore``, a validation pass, the callback hooks, and the
SIGTERM -> KeyboardInterrupt -> ``on_interrupt`` partial-stop path.

Metrics stay on the device for the whole epoch and come to the host in one
copy at its end (or when it is cut short), where the batch callbacks then
fire in step order: a host read per step would hold the host behind the
card. The hooks the callbacks of ``train/callbacks.py`` read are the JAX
Trainer's: ``metric_logger`` (one ``epoch`` record per epoch in
``metrics.jsonl``), ``_target_epochs`` and ``epoch_steps_per_sec``.

Under a mesh (``parallel/``) every rank runs this loop over the same
seed-determined global batches, and ``input_placer``
(``parallel.sharding.MeshInputPlacer``) cuts each batch, and each block of
scanned pair ids, to the rank's rows before K1 gathers them from the
rank's store.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

import numpy as np
import torch

from masters_thesis_tpu_torch.ops.gather import row_gather

logger = logging.getLogger(__name__)


class Callback:
    """The hooks the Trainer calls; each does nothing here."""

    def on_train_begin(self, trainer) -> None:
        pass

    def on_batch_end(self, trainer, step: int, logs: dict) -> None:
        pass

    def on_epoch_end(self, trainer, epoch: int, logs: dict) -> None:
        pass

    def on_interrupt(self, trainer, epoch: int) -> None:
        pass

    def on_error(self, trainer, exc: BaseException) -> None:
        pass

    def on_train_end(self, trainer) -> None:
        pass


def _to_host(pending: list[tuple[int, dict]]) -> list[dict]:
    """[(k, metrics stacked (k,) or 0-dim)] on the device -> one dict of
    floats per step, through a single device-to-host copy."""
    if not pending:
        return []
    keys = list(pending[0][1])
    flat = torch.cat([torch.stack([m[key].reshape(-1) for key in keys])
                      for _, m in pending], dim=1).cpu().numpy()
    return [dict(zip(keys, map(float, col))) for col in flat.T]


def _mean_metrics(rows: list[dict]) -> dict:
    if not rows:
        return {}
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


class Trainer:
    def __init__(self, cfg, train_step, eval_step, state, train_pipe,
                 val_pipe=None, callbacks=(), store=None, metric_logger=None,
                 input_placer=None):
        self.cfg = cfg
        self.input_placer = input_placer
        self.metric_logger = metric_logger
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.train_pipe = train_pipe
        self.val_pipe = val_pipe
        self.callbacks = list(callbacks)
        self.store = store
        self.stop_training = False
        self.scanned_step = None       # set by use_scanned_steps()
        self._scan_tables = None
        self.scanned_eval = None       # set by use_scanned_eval()
        self._val_scan_args = None
        # advances by 1 (per step) or K (scanned) per call, so bookkeeping
        # never reads the state's counter behind the device's back
        self._host_step = int(state.step)
        self._epoch = 0
        self._target_epochs = None
        self._preempted = False
        self.epoch_steps_per_sec: list[float] = []

    @property
    def device(self) -> torch.device:
        return self.store.device

    def _tables(self, pipe) -> tuple:
        """The pipe's store-row, token and target tables on the device."""
        return tuple(torch.as_tensor(t, device=self.device) for t in
                     (pipe.store_idx.astype(np.int32), pipe.pairs.tokens,
                      pipe.targets))

    def use_scanned_steps(self, scanned_step, tables: bool = True) -> None:
        """K steps per call (``cfg.tpu.scan_steps`` > 0), with the signature
        of ``train.steps.make_scanned_train_steps_from_tables``: the tables
        go to the device once and each call ships the (K, B) pair ids. The
        stacked-batch variant of the JAX package is not ported."""
        if not tables:
            raise NotImplementedError(
                "only the from-tables scanned trainer is ported")
        self.scanned_step = scanned_step
        self._scan_tables = None

    def use_scanned_eval(self, scanned_eval) -> None:
        """The whole validation pass in one call
        (``train.steps.make_scanned_eval_steps_from_tables``), over a store
        shared with the val pipeline."""
        self.scanned_eval = scanned_eval

    def _batch_arrays(self, batch):
        """The batch on the device, its rows gathered from the store through
        K1, or the library take under ``tpu.use_pallas: false`` (this
        rank's rows under a mesh)."""
        if self.input_placer is not None:
            batch = self.input_placer.batch(batch)
        idx = torch.as_tensor(batch["idx"], device=self.device)
        return (row_gather(self.cfg.tpu.use_pallas)(
                    self.store.device_array(), idx),
                torch.as_tensor(batch["tokens"], device=self.device),
                torch.as_tensor(batch["target"], device=self.device))

    def _sel(self, sel: np.ndarray) -> torch.Tensor:
        """A (K, B) block of pair ids on the device, this rank's columns
        of it under a mesh."""
        sel = torch.as_tensor(sel, device=self.device)
        if self.input_placer is not None:
            sel = self.input_placer.sel(sel)
        return sel

    def _run_epoch_steps(self, epoch: int) -> list[dict]:
        """One epoch: chunks of ``scan_steps`` through the scanned step when
        it is set, the ragged tail and every step otherwise through the
        per-step path; one host fetch of the metrics at the end."""
        scan_k = self.cfg.tpu.scan_steps if self.scanned_step else 0
        if scan_k and self._scan_tables is None:
            self._scan_tables = self._tables(self.train_pipe)
        pending: list[tuple[int, dict]] = []
        chunk: list[dict] = []

        def flush(chunk):
            sel = self._sel(np.stack([b["sel"] for b in chunk]))
            self.state, metrics = self.scanned_step(
                self.state, self.store.device_array(), *self._scan_tables,
                sel)
            self._host_step += len(chunk)
            pending.append((len(chunk), metrics))

        rows: list[dict] = []
        try:
            for batch in self.train_pipe.epoch(epoch):
                if not scan_k:
                    self.state, metrics = self.train_step(
                        self.state, *self._batch_arrays(batch))
                    self._host_step += 1
                    pending.append((1, metrics))
                    self._check_preempted()
                    continue
                chunk.append(batch)
                if len(chunk) == scan_k:
                    flush(chunk)
                    chunk = []
                    self._check_preempted()
            for batch in chunk:                 # the ragged tail
                self.state, metrics = self.train_step(
                    self.state, *self._batch_arrays(batch))
                self._host_step += 1
                pending.append((1, metrics))
        finally:
            # on an interrupt too: the finished steps' rows must reach the
            # callbacks before the partial-stop path runs
            rows = _to_host(pending)
            first = self._host_step - len(rows) + 1
            for i, row in enumerate(rows):
                for cb in self.callbacks:
                    cb.on_batch_end(self, first + i, row)
        return rows

    def fit(self, epochs: int | None = None, start_epoch: int = 0) -> dict:
        epochs = self.cfg.epochs if epochs is None else epochs
        self._target_epochs = epochs    # the callbacks' final-epoch checks
        for cb in self.callbacks:
            cb.on_train_begin(self)
        logs: dict = {}
        # SIGTERM (preemption) only sets a flag; the stop is raised at the
        # next safe point, between steps or after an epoch. Handlers
        # install from the main thread only.
        prev_term, installed = None, False
        self._preempted = False
        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                self._preempted = True

            prev_term = signal.signal(signal.SIGTERM, _on_term)
            installed = True
        try:
            for epoch in range(start_epoch, epochs):
                self._epoch = epoch
                logs = self._run_epoch(epoch)
                for cb in self.callbacks:
                    cb.on_epoch_end(self, epoch, logs)
                self._check_preempted()
                if self.stop_training:
                    logger.info("early stopping at epoch %d", epoch)
                    break
        except KeyboardInterrupt:
            logger.warning("KeyboardInterrupt: stopping after the steps done")
            for cb in self.callbacks:
                cb.on_interrupt(self, self._epoch)
        except Exception as exc:
            for cb in self.callbacks:
                cb.on_error(self, exc)
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_term if prev_term
                              is not None else signal.SIG_DFL)
            for cb in self.callbacks:
                cb.on_train_end(self)
        return logs

    def _check_preempted(self) -> None:
        """Raise at a safe point if SIGTERM arrived since the last check."""
        if self._preempted:
            self._preempted = False
            raise KeyboardInterrupt("SIGTERM (preemption)")

    def _run_validation(self) -> dict:
        """One validation pass -> mean metrics: one call over the unshuffled
        pair ids when a scanned eval is set and the val pipe shares the
        store, else the per-batch loop."""
        p = self.val_pipe
        if (self.scanned_eval is not None and p.store is self.store
                and p.steps_per_epoch > 0 and not p.shuffle
                # a ceil-batched pipe pads its tail: padded rows must not
                # be averaged, and its pairs do not fill steps x batch
                and len(p.pairs) >= p.steps_per_epoch * p.batch_size):
            if self._val_scan_args is None:
                n = p.steps_per_epoch * p.batch_size
                sel = p._order()[:n].reshape(p.steps_per_epoch, p.batch_size)
                self._val_scan_args = (*self._tables(p),
                                       self._sel(sel.astype(np.int32)))
            stacked = self.scanned_eval(self.state, self.store.device_array(),
                                        *self._val_scan_args)
            self._check_preempted()
            return _mean_metrics(_to_host([(p.steps_per_epoch, stacked)]))
        pending = []
        for batch in p.epoch():
            pending.append((1, self.eval_step(self.state,
                                              *self._batch_arrays(batch))))
            self._check_preempted()
        return _mean_metrics(_to_host(pending))

    def _run_epoch(self, epoch: int) -> dict:
        t0 = time.perf_counter()
        rows = self._run_epoch_steps(epoch)
        logs = _mean_metrics(rows)
        # the host fetch above waited for every step, so this clock closes
        # the train phase: pipeline, host work, launches and device time
        t_train = time.perf_counter() - t0
        if self.val_pipe is not None:
            logs.update({f"val_{k}": v
                         for k, v in self._run_validation().items()})
        logs["epoch_time"] = time.perf_counter() - t0
        logs["steps_per_sec"] = len(rows) / t_train if rows else 0.0
        self.epoch_steps_per_sec.append(logs["steps_per_sec"])
        if self.metric_logger is not None:
            self.metric_logger.log("epoch", epoch=epoch, **logs)
        logger.info("epoch %d: loss=%.4f val_loss=%s (%.1fs, %.2f steps/s)",
                    epoch, logs.get("loss", float("nan")),
                    f"{logs['val_loss']:.4f}" if "val_loss" in logs else "n/a",
                    logs["epoch_time"], logs["steps_per_sec"])
        return logs
