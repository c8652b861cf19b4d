"""Run-dir setup and metric sinks.

Reference observability surface (SURVEY.md §5): python logging to
``Log/{run}/log.log`` (main.py:52), per-epoch ``loss_history.csv``
(Callbacks/EpochLoss.py:21-52), per-batch CSV (Callbacks/BatchLoss.py), config
snapshot copied into the run dir (main.py:36-50). We reproduce that layout and
add a JSONL metrics stream (one line per step/epoch) for machine consumption.

The port's own copy of ``masters_thesis_tpu/utils/logging.py``, with the
same names and meaning (``tests/test_torch_copies.py`` holds the two
together).
"""

from __future__ import annotations

import json
import logging
import os
import time


def setup_run_dir(log_root: str, run: str, config=None,
                  file_log: bool = True) -> str:
    """Create Log/{run}/, snapshot the config, attach a file logger.

    ``file_log=False`` skips the log.log handler — multi-process training
    gates it to the primary so P processes don't interleave records into
    one shared file."""
    run_path = os.path.join(log_root, run)
    os.makedirs(run_path, exist_ok=True)
    if config is not None:
        config.save(os.path.join(run_path, "config.yaml"))
    if not file_log:
        return run_path
    log_path = os.path.join(run_path, "log.log")
    root = logging.getLogger()
    # one live run-dir file handler at a time: in-process tune sweeps call
    # run_training per trial, and stacking handlers would duplicate every
    # later trial's records into all earlier trials' log files (and leak
    # the file handles)
    for h in list(root.handlers):
        if getattr(h, "_mtt_run_handler", False):
            root.removeHandler(h)
            h.close()
    handler = logging.FileHandler(log_path)
    handler._mtt_run_handler = True
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    root.addHandler(handler)
    # the root logger defaults to WARNING, which silently drops the
    # framework's info-level run records (resume, warm start, early stop)
    if root.level > logging.INFO:
        root.setLevel(logging.INFO)
    return run_path


class CSVLogger:
    """Append-only CSV with a fixed header, flushed per row (cf. EpochLoss.py)."""

    def __init__(self, path: str, fieldnames: list[str]):
        self.path = path
        self.fieldnames = fieldnames
        exists = os.path.exists(path)
        self._f = open(path, "a")
        if not exists:
            self._f.write(",".join(fieldnames) + "\n")
            self._f.flush()

    def write(self, row: dict) -> None:
        self._f.write(",".join(str(row.get(k, "")) for k in self.fieldnames) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricLogger:
    """JSONL metric stream: one record per event with wall time."""

    def __init__(self, path: str):
        self._f = open(path, "a")

    def log(self, kind: str, **metrics) -> None:
        rec = {"kind": kind, "ts": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
