"""The port's profiling (``utils/profiling.py`` on ``torch.profiler``,
the ``StepProfiling`` and ``TraceCapture`` callbacks) against the JAX
package's, on the CPU.

``StepProfiler`` is a copy: on the same sequence of steps and clock ticks
it records the original's times and summary. The callbacks keep the JAX
semantics: the window starts at step 10, ``profile.json`` is written only
when the window saw steps, and the trace covers the first epoch only (or
stops at the train end). A ``run_training`` with both knobs on writes
``profile.json`` with the JAX keys and step count (the JAX run of the same
config beside it) and a Chrome trace under ``trace/`` that names the train
step's operators."""

import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.utils import profiling as jprofiling
from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.train.callbacks import (
    StepProfiling,
    TraceCapture,
)
from masters_thesis_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _ticks(module, start, end, steps, monkeypatch):
    clock = iter([0.5 * i + 0.01 * i * i for i in range(len(steps))])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    prof = module.StepProfiler(start, end)
    for step in steps:
        prof.maybe_tick(step)
    return prof.times, prof.summary()


@pytest.mark.parametrize("start,end,steps", [
    (10, 15, list(range(1, 30))),
    (0, 0, [0, 1, 2]),
    (3, 8, [1, 4, 5, 9, 6, 7, 2, 8]),
    (2, 200, list(range(300))),
    (10, 15, [1, 2, 3]),
])
def test_step_profiler_matches_original(start, end, steps, monkeypatch):
    got = _ticks(profiling, start, end, steps, monkeypatch)
    want = _ticks(jprofiling, start, end, steps, monkeypatch)
    assert got == want


def _trainer():
    return SimpleNamespace(device=torch.device("cpu"))


def test_step_profiling_writes_nothing_before_its_window(tmp_path):
    cb = StepProfiling(str(tmp_path), n_steps=5)
    for step in range(1, 10):
        cb.on_batch_end(_trainer(), step, {})
    cb.on_train_end(_trainer())
    assert not (tmp_path / "profile.json").exists()
    for step in range(10, 20):
        cb.on_batch_end(_trainer(), step, {})
    cb.on_train_end(_trainer())
    stats = json.loads((tmp_path / "profile.json").read_text())
    assert stats["steps"] == 5


def _traces(run_path):
    return sorted((Path(run_path) / "trace").glob("*.pt.trace.json"))


def test_trace_covers_the_first_epoch_only(tmp_path):
    cb, trainer = TraceCapture(str(tmp_path)), _trainer()
    cb.on_train_begin(trainer)
    torch.ones(4) @ torch.ones(4)
    cb.on_epoch_end(trainer, 0, {})
    (first,) = _traces(tmp_path)
    cb.on_epoch_end(trainer, 1, {})
    cb.on_train_end(trainer)
    assert _traces(tmp_path) == [first]
    names = {e.get("name") for e in json.loads(first.read_text())[
        "traceEvents"]}
    assert "aten::dot" in names


def test_trace_stops_at_the_train_end_without_an_epoch(tmp_path):
    cb, trainer = TraceCapture(str(tmp_path)), _trainer()
    cb.on_train_begin(trainer)
    cb.on_train_end(trainer)
    assert len(_traces(tmp_path)) == 1
    # a second profiler may start once the first has stopped
    with profiling.profile_trace(str(tmp_path / "again")):
        torch.zeros(2).sum()
    assert len(list((tmp_path / "again").glob("*.pt.trace.json"))) == 1


def _smoke(tmp_path, cls):
    cfg = cls.load(ROOT / "configs" / "smoke.yaml")
    return dataclasses.replace(
        cfg, log=str(tmp_path), tpu=dataclasses.replace(
            cfg.tpu, profile_steps=3, profile_trace=cls is Config))


def test_run_training_with_both_knobs_on(tmp_path):
    """2 epochs of configs/smoke.yaml at 48 keys: the window (steps
    10..13) sees 3 steps, as in the JAX run of the same config."""
    run_path, _, _ = experiment.run_training(
        _smoke(tmp_path / "port", Config), epochs=2, smoke_keys=48,
        device="cpu")
    jrun, _, _ = jexp.run_training(_smoke(tmp_path / "jax", JConfig),
                                   epochs=2, smoke_keys=48)
    stats = json.loads((Path(run_path) / "profile.json").read_text())
    jstats = json.loads((Path(jrun) / "profile.json").read_text())
    assert stats.keys() == jstats.keys() == {"steps", "mean_s", "p50_s",
                                              "p99_s"}
    assert stats["steps"] == jstats["steps"] == 3
    assert 0 < stats["p50_s"] <= stats["p99_s"]
    (trace,) = _traces(run_path)
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"aten::mm", "aten::addmm"} & names
