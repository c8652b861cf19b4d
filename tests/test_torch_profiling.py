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


# ---- spans of the program's work (``profiling.span``) ----------------------

SPANS = ("span:gather", "span:decode.inputs", "span:decode.kernel")
T_SPAN, START = 6, 1


def _lcnic():
    from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
    from masters_thesis_tpu_torch.models.nic import LcNIC
    from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

    gen = torch.Generator().manual_seed(0)
    layout = GroupLayout(synthetic_groups(256, 6, seed=0), 256)
    model = LcNIC(layout, units=16, group_size=4, embedding_text=8,
                  attn_units=8, vocab_size=40, max_length=T_SPAN,
                  generator=gen)
    return model, torch.randn(12, 256, generator=gen)


def _cnnrnn():
    from masters_thesis_tpu_torch.models.nic import CnnRnnNIC

    gen = torch.Generator().manual_seed(0)
    model = CnnRnnNIC(embed_dim=8, units=16, vocab_size=40,
                      max_length=T_SPAN, n_patches=5, in_channels=12,
                      gru_zero_state=True, generator=gen)
    return model, torch.randn(12, 5 * 12, generator=gen)


MODELS = {"lcnic": _lcnic, "cnn_rnn": _cnnrnn}


def _decode_rows(name, gather, weights_bf16=False):
    """A tiny model's greedy decode of store rows 3, 0, 7, 11, 5 gathered by
    ``gather``, the rows of the CnnRnn's store its patches laid flat."""
    from masters_thesis_tpu_torch.ops import fused_decode

    model, store = MODELS[name]()
    model.eval()
    fused_decode.spread_for_check(model, torch.Generator().manual_seed(1))
    decode = fused_decode.make_whole_fused_greedy_decoder(
        model, T_SPAN, weights_bf16=weights_bf16)
    ids = torch.tensor([3, 0, 7, 11, 5])

    def run():
        rows = gather(store, ids)
        if name == "cnn_rnn":
            rows = rows.view(len(ids), 5, 12)
        return decode(rows, START)

    return run


def _gathers():
    from masters_thesis_tpu_torch.ops.gather import gather_rows, take_rows

    return {"gather_rows": gather_rows, "take_rows": take_rows}


def test_span_off_enters_no_range_and_records_no_device_span(monkeypatch):
    """With no profiler the spans of a gather and a decode open no
    ``record_function`` and record no event pair."""
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    def refuse(*args, **kwargs):
        raise AssertionError("record_function on the hot path")

    before = profiling.device_spans()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("decode.kernel", torch.zeros(2)) as inside:
        assert inside is None
    words, _ = _decode_rows("lcnic", gather_rows)()
    assert words.shape == (5, T_SPAN)
    assert profiling.device_spans() == before


@pytest.mark.parametrize("gather", ["gather_rows", "take_rows"])
@pytest.mark.parametrize("name", list(MODELS))
def test_spans_nest_once_a_call_inside_the_caller(name, gather):
    """Under a CPU profiler one gather and one decode emit each program span
    once, inside the caller's range, in order and apart; CPU tensors
    record no event pair."""
    run = _decode_rows(name, _gathers()[gather])
    run()                                   # the first call's set-up
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("span:enqueue"):
            run()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))
    (outer,) = ranges["span:enqueue"]
    got = []
    for key in SPANS:
        (r,) = ranges[key]
        assert outer[0] <= r[0] <= r[1] <= outer[1], key
        got.append(r)
    assert got[0][1] <= got[1][0] and got[1][1] <= got[2][0]
    assert not [s for s in profiling.device_spans() if s[0] in
                ("gather", "decode.inputs", "decode.kernel")]


def test_bf16_casts_lie_in_the_one_inputs_span():
    """With bf16 weights the casts are part of ``decode.inputs``: still one
    span of each name a call."""
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    run = _decode_rows("lcnic", gather_rows, weights_bf16=True)
    run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = [e.name for e in prof.events()]
    assert [names.count(k) for k in SPANS] == [1, 1, 1]
    inputs = next(e for e in prof.events() if e.name == SPANS[1])
    casts = [e for e in prof.events() if e.name == "aten::to"
             and inputs.time_range.start <= e.time_range.start
             <= inputs.time_range.end]
    assert casts


@pytest.mark.parametrize("name", list(MODELS))
def test_words_and_alphas_do_not_change_under_the_profiler(name):
    from masters_thesis_tpu_torch.ops.gather import gather_rows

    run = _decode_rows(name, gather_rows)
    words, alphas = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced_words, traced_alphas = run()
    assert torch.equal(words, traced_words)
    assert torch.equal(alphas, traced_alphas)
    assert len(torch.unique(words)) > 1


def test_start_trace_clears_the_device_spans(tmp_path):
    profiling._DEVICE_SPANS.append(("decode.kernel", None, None))
    assert profiling.device_spans()[-1] == ("decode.kernel", None, None)
    prof = profiling.start_trace(str(tmp_path))
    assert profiling.device_spans() == []
    prof.stop()
