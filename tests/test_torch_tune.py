"""The port's ``tune/`` against the JAX package's: the search spaces draw
the same configs and ASHA makes the same decisions; ``run_experiment``
(in this process and in 2 spawned processes) records the same trials,
``wall_s`` aside; every case of ``tests/test_tune_dispatch.py`` runs
against both queues (the original's module and the port's copy); the
port's ``FileLock`` repairs the original's three heartbeat faults, each
with a test that the original's behaviour fails; and the ``tune``
command, in this process and through ``--queue``, runs the JAX CLI's
trial configs to its final metrics within 2e-5 (dropout off, both packages
warm-started from the same parameters)."""

import contextlib
import dataclasses
import importlib
import io
import json
import multiprocessing as mp
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from masters_thesis_tpu.tune import asha as jasha
from masters_thesis_tpu.tune import runner as jrunner
from masters_thesis_tpu.tune import search as jsearch
from masters_thesis_tpu_torch.tune import asha, dispatch, runner, search

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
QUEUES = {"jax": "masters_thesis_tpu.tune.dispatch",
          "port": "masters_thesis_tpu_torch.tune.dispatch"}


@pytest.fixture(params=sorted(QUEUES))
def d(request):
    """The dispatch module under test: the original or the port's copy."""
    return importlib.import_module(QUEUES[request.param])


# ---------------------------------------------------------------- search, ASHA

def _space(mod):
    return {"lr": mod.LogUniform(1e-5, 1e-2), "dropout": mod.Uniform(0, .5),
            "units": mod.Choice([128, 256, 512]), "fixed": 42}


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_search_spaces_draw_the_original_configs(seed):
    assert (list(search.RandomSearch(_space(search), 20, seed=seed))
            == list(jsearch.RandomSearch(_space(jsearch), 20, seed=seed)))
    grid = {"a": [1, 2], "b": ["x", "y", "z"], "c": 7}
    assert list(search.GridSearch(grid)) == list(jsearch.GridSearch(grid))


@pytest.mark.parametrize("mode,rf", [("min", 2), ("min", 4), ("max", 3)])
def test_asha_makes_the_original_decisions(mode, rf):
    ours = asha.ASHAScheduler(mode=mode, max_t=40, grace_period=2,
                              reduction_factor=rf)
    theirs = jasha.ASHAScheduler(mode=mode, max_t=40, grace_period=2,
                                 reduction_factor=rf)
    assert ours.rungs == theirs.rungs
    rng = np.random.default_rng(rf)
    shared, jshared, lock = {}, {}, threading.Lock()
    for trial in range(60):
        t = int(rng.choice([1, 2, 4, 6, 8, 18, 32, 40]))
        m = {"val_loss": float(rng.standard_normal())}
        assert (ours.on_result(trial, t, m)
                == theirs.on_result(trial, t, m))
        assert (ours.on_result_shared(t, m, shared, lock)
                == theirs.on_result_shared(t, m, jshared, lock))
    assert shared == jshared


def _bowl_trial(config, report):
    """Module-level (spawned workers import it): a loss that falls to a
    config-dependent floor, honouring 'stop'; x == 1 crashes."""
    if config["x"] == 1.0:
        raise RuntimeError("nan loss")
    loss = None
    for t in range(1, 9):
        loss = (config["x"] - 0.3) ** 2 + 1.0 / t
        if report(t, {"val_loss": loss}) == "stop":
            break
    return loss


def _records(res):
    return [{k: v for k, v in t.items() if k != "wall_s"}
            for t in res.trials]


@pytest.mark.parametrize("processes", [1, 2])
def test_run_experiment_records_the_original_trials(processes, tmp_path):
    """The same records as the original's run_experiment, ``wall_s``
    aside; a crashing trial is recorded and the sweep goes on. In 2
    processes ASHA's rung order depends on arrival, so the schedulers
    compare in one process and both runners in two without one."""
    configs = [{"x": x} for x in (0.9, 0.1, 1.0, 0.35, 0.6, 0.2)]
    sched = (lambda m: m.ASHAScheduler(max_t=8, grace_period=2,
                                       reduction_factor=2)
             if processes == 1 else None)
    got = runner.run_experiment(_bowl_trial, configs, sched(asha),
                                processes=processes,
                                log_dir=str(tmp_path / "port"))
    want = jrunner.run_experiment(_bowl_trial, configs, sched(jasha),
                                  processes=processes,
                                  log_dir=str(tmp_path / "jax"))
    assert _records(got) == _records(want)
    assert got.best()["config"] == want.best()["config"] == {"x": 0.35}
    errored = [t for t in got.trials if t["error"]]
    assert len(errored) == 1 and "nan loss" in errored[0]["error"]
    if processes == 1:
        assert any(t["stopped_early"] for t in got.trials)
    with open(tmp_path / "port" / "tune_results.json") as f:
        saved = json.load(f)
    assert len(saved["trials"]) == len(configs)


def _flat_trial(config, report):
    loss = float(config["x"])
    for t in range(1, 11):
        if report(t, {"val_loss": loss}) == "stop":
            break
    return loss


def test_parallel_asha_prunes_across_workers():
    configs = [{"x": float(v)} for v in range(1, 9)]
    sched = asha.ASHAScheduler(max_t=20, grace_period=1, reduction_factor=2)
    res = runner.run_experiment(_flat_trial, configs, sched, processes=2)
    assert len(res.trials) == 8 and res.best()["final_metric"] == 1.0
    stopped = [t for t in res.trials if t["stopped_early"]]
    assert stopped and all(len(t["history"]) < 10 for t in stopped)


# ---------------------------------------------------------------- dispatch:
# every case of tests/test_tune_dispatch.py, against both queues

def _trial(cfg, report):
    if cfg["v"] == "boom":
        raise RuntimeError("synthetic failure")
    report(1, {"val_loss": cfg["v"]})
    return cfg["v"]


def test_enqueue_claim_exactly_once(d, tmp_path):
    q = str(tmp_path / "q")
    assert d.enqueue_trials(q, [{"x": i} for i in range(5)]) == 5
    seen = []
    while (spec := d.claim_next(q, "w0")) is not None:
        seen.append(spec["trial_id"])
    assert sorted(seen) == [0, 1, 2, 3, 4]
    assert d.claim_next(q, "w0") is None


def test_file_rungs_roundtrip_and_lock(d, tmp_path):
    rungs = d.FileRungs(str(tmp_path / "rungs.json"))
    assert rungs.get(2) is None
    rungs[2] = [1.0, 3.0]
    assert rungs.get(2) == [1.0, 3.0]
    lock = d.FileLock(str(tmp_path / "l.lock"))
    with lock:
        assert os.path.exists(lock.path)
    assert not os.path.exists(lock.path)


def test_worker_runs_trials_and_records(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}, {"v": 2.0}, {"v": "boom"}])
    assert d.run_worker(q, _trial, scheduler=None, max_idle_s=0.1) == 3
    records = d.collect_results(q, 3, timeout_s=5)
    ok = [r for r in records if r.get("final_metric") is not None]
    bad = [r for r in records if r.get("final_metric") is None]
    assert len(ok) == 2 and len(bad) == 1
    assert "RuntimeError" in bad[0]["error"]
    assert ok[0]["history"] == [{"t": 1, "val_loss": 1.0}]


def _worker_proc(module, q, wid):
    d = importlib.import_module(module)
    sched_mod = importlib.import_module(module.replace("dispatch", "asha"))

    def trial(cfg, report):
        for t in range(1, 5):
            if report(t, {"val_loss": cfg["v"]}) == "stop":
                return cfg["v"]
        return cfg["v"]

    sched = sched_mod.ASHAScheduler(max_t=10, grace_period=2,
                                    reduction_factor=2)
    d.run_worker(q, trial, sched, worker_id=wid, max_idle_s=1.0)


def test_two_worker_processes_share_asha_rungs(d, tmp_path):
    q = str(tmp_path / "q")
    vals = [0.1, 0.2, 0.3, 0.4, 10.0, 20.0, 30.0, 40.0]
    d.enqueue_trials(q, [{"v": v} for v in vals])
    ctx = mp.get_context("spawn")
    ps = [ctx.Process(target=_worker_proc, args=(d.__name__, q, f"w{i}"))
          for i in range(2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(timeout=120)
        assert p.exitcode == 0
    records = d.collect_results(q, 8, timeout_s=5)
    stopped = {r["config"]["v"] for r in records if r["stopped_early"]}
    survived = {r["config"]["v"] for r in records if not r["stopped_early"]}
    assert 40.0 in stopped or 30.0 in stopped
    assert 0.1 in survived
    assert {r["worker"] for r in records} <= {"w0", "w1"}
    with open(os.path.join(q, "rungs.json")) as f:
        assert len(json.load(f)["2"]) == 8


def test_coordinator_flow(d, tmp_path):
    q = str(tmp_path / "q")
    res = d.run_distributed_experiment(
        _trial, [{"v": 3.0}, {"v": 1.0}, {"v": 2.0}], scheduler=None,
        queue_dir=q, timeout_s=10)
    assert len(res.trials) == 3
    assert res.best()["config"] == {"v": 1.0}
    assert os.path.exists(os.path.join(q, "STOP"))
    assert d.run_worker(q, _trial, max_idle_s=5.0) == 0


def test_stale_lock_is_broken(d, tmp_path):
    path = str(tmp_path / "x.lock")
    with open(path, "w") as f:
        f.write("999999")
    os.utime(path, (0, 0))
    with d.FileLock(path, stale_s=1.0):
        pass


def test_dead_worker_claim_requeued_and_rerun(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 7.0}])
    dead = d.claim_next(q, "dead-host")
    os.utime(dead["_claimed"], (0, 0))
    d.stop_queue(q)
    assert d.run_worker(q, _trial, stale_claim_s=0.5, max_idle_s=2.0) == 1
    [rec] = d.collect_results(q, 1, timeout_s=5)
    assert rec["final_metric"] == 7.0 and rec["requeues"] == 1
    assert not os.listdir(os.path.join(q, "running"))


def test_live_claim_not_requeued_and_heartbeat_refreshes(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}])
    spec = d.claim_next(q, "w0")
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0
    os.utime(spec["_claimed"], (0, 0))
    hb = d._Heartbeat(spec["_claimed"], every_s=0.05)
    try:
        deadline = time.time() + 5.0
        while (os.path.getmtime(spec["_claimed"]) == 0
               and time.time() < deadline):
            time.sleep(0.02)
        assert os.path.getmtime(spec["_claimed"]) > 0
    finally:
        hb.stop()
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0


def test_aged_pending_spec_claim_is_not_stale(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}])
    os.utime(os.path.join(q, "pending", "trial_0000.json"), (0, 0))
    spec = d.claim_next(q, "w0")
    assert spec is not None
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0
    assert os.path.exists(spec["_claimed"])
    assert os.listdir(os.path.join(q, "pending")) == []


def test_orphaned_requeue_tempfile_is_swept(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 5.0}])
    orphan = os.path.join(q, "pending", "trial_0000.json.requeue.12345")
    os.rename(os.path.join(q, "pending", "trial_0000.json"), orphan)
    assert d.claim_next(q, "w0") is None
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0
    os.utime(orphan, (0, 0))
    assert d.requeue_stale(q, stale_claim_s=60.0) == 1
    spec = d.claim_next(q, "w0")
    assert spec is not None and spec["trial_id"] == 0


def test_requeue_intermediate_is_not_born_stale(d, tmp_path, monkeypatch):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 3.0}])
    dead = d.claim_next(q, "dead-host")
    os.utime(dead["_claimed"], (0, 0))
    real_rename = os.rename

    def failing_final_rename(src, dst):
        if ".requeue." in str(src) and str(dst).endswith(".json"):
            raise OSError("simulated transient fs error")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", failing_final_rename)
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0
    monkeypatch.undo()
    pending = os.path.join(q, "pending")
    orphans = [n for n in os.listdir(pending) if ".requeue." in n]
    assert len(orphans) == 1
    assert d.requeue_stale(q, stale_claim_s=60.0) == 0
    assert [n for n in os.listdir(pending) if ".requeue." in n] == orphans
    os.utime(os.path.join(pending, orphans[0]), (0, 0))
    assert d.requeue_stale(q, stale_claim_s=60.0) == 1
    spec = d.claim_next(q, "w0")
    assert spec is not None and spec["trial_id"] == 0


def test_claim_survives_concurrent_steal(d, tmp_path, monkeypatch):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}, {"v": 2.0}])
    real_utime = os.utime
    stolen = {}

    def stealing_utime(path, *a, **k):
        if "running" in str(path) and "trial_0000" in str(path) and not stolen:
            stolen["done"] = True
            os.rename(path, os.path.join(q, "pending", "trial_0000.json"))
            raise OSError("simulated: spec stolen before the utime landed")
        return real_utime(path, *a, **k)

    monkeypatch.setattr(os, "utime", stealing_utime)
    spec = d.claim_next(q, "w0")
    assert spec is not None and spec["trial_id"] == 1
    assert os.path.exists(os.path.join(q, "pending", "trial_0000.json"))


def test_broken_holders_exit_does_not_delete_new_lock(d, tmp_path):
    path = str(tmp_path / "x.lock")
    a = d.FileLock(path, stale_s=30.0)
    a.__enter__()
    os.unlink(path)
    b = d.FileLock(path, stale_s=30.0)
    b.__enter__()
    a.__exit__(None, None, None)
    assert os.path.exists(path)
    b.__exit__(None, None, None)
    assert not os.path.exists(path)


def test_fresh_queue_refusal_preserves_asha_state(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}])
    rungs_path = os.path.join(q, "rungs.json")
    with open(rungs_path, "w") as f:
        f.write('{"1": [0.5]}')
    with pytest.raises(RuntimeError, match="resume-queue"):
        d._require_fresh_queue(q)
    assert os.path.exists(rungs_path)


def test_resume_refuses_out_of_range_trial_ids(d, tmp_path):
    q = str(tmp_path / "q")
    space = [{"v": 3.0}, {"v": 1.0}, {"v": 2.0}]
    d.run_distributed_experiment(_trial, space, queue_dir=q, timeout_s=10)
    with pytest.raises(RuntimeError, match="search space has only"):
        d.run_distributed_experiment(_trial, space[:2], queue_dir=q,
                                     timeout_s=10, resume=True)


def test_coordinator_collect_requeues_stale(d, tmp_path):
    q = str(tmp_path / "q")
    d.enqueue_trials(q, [{"v": 1.0}])
    dead = d.claim_next(q, "dead-host")
    os.utime(dead["_claimed"], (0, 0))
    with pytest.raises(TimeoutError):
        d.collect_results(q, 1, poll_s=0.05, timeout_s=0.3,
                          stale_claim_s=0.1)
    assert os.listdir(os.path.join(q, "pending")) == [
        os.path.basename(dead["_claimed"])]


def test_resume_queue_continues_interrupted_run(d, tmp_path):
    q = str(tmp_path / "q")
    space = [{"v": 3.0}, {"v": 1.0}, {"v": 2.0}]
    d.enqueue_trials(q, space)
    os.unlink(os.path.join(q, "pending", "trial_0001.json"))
    dead = d.claim_next(q, "dead-host")
    assert dead["trial_id"] == 0
    d.run_worker(q, _trial, max_idle_s=0.1, stale_claim_s=3600)
    os.utime(dead["_claimed"], (0, 0))
    d.stop_queue(q)
    assert len(os.listdir(os.path.join(q, "done"))) == 1
    with pytest.raises(RuntimeError, match="resume"):
        d.run_distributed_experiment(_trial, space, queue_dir=q,
                                     timeout_s=10)
    with pytest.raises(RuntimeError, match="identical"):
        d.run_distributed_experiment(_trial, [{"v": 99.0}] * 3, queue_dir=q,
                                     timeout_s=10, resume=True)
    res = d.run_distributed_experiment(_trial, space, queue_dir=q,
                                       timeout_s=30, resume=True,
                                       stale_claim_s=0.2)
    assert sorted(r["trial_id"] for r in res.trials) == [0, 1, 2]
    assert res.best()["config"] == {"v": 1.0}
    rec0 = [r for r in res.trials if r["trial_id"] == 0][0]
    assert rec0["final_metric"] == 3.0 and rec0.get("requeues", 0) >= 1


# ---------------------------------------------------------------- F1: the
# original FileLock's heartbeat faults, repaired in the port's copy

def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_stalled_live_lock_holder_keeps_lock_fresh(tmp_path):
    """A live holder stalled past stale_s keeps its lock fresh: with the
    mtime aged to 0, the beat (every stale_s/3 = 0.05 s) brings it back to
    now, and the file still holds the holder's token (event-driven, no
    fixed sleep against a wall-clock bound)."""
    path = str(tmp_path / "x.lock")
    with dispatch.FileLock(path, stale_s=0.15) as lock:
        os.utime(path, (0, 0))
        assert _wait_for(lambda: os.path.getmtime(path) > 0)
        with open(path, "rb") as f:
            assert f.read() == lock._token
        assert dispatch._server_now(path) - os.path.getmtime(path) < 60.0
    assert not os.path.exists(path)


def test_heartbeat_survives_a_transient_oserror(tmp_path, monkeypatch):
    """F1 (1): one OSError in a beat's touch no longer ends the heartbeat
    (the original's beat returns on it, and the lock then goes stale)."""
    path = str(tmp_path / "x.lock")
    real_utime = os.utime
    calls = {"failed": 0, "ok": 0}

    def flaky_utime(target, *a, **k):
        if not calls["failed"]:
            calls["failed"] += 1
            raise OSError("simulated NFS hiccup")
        calls["ok"] += 1
        return real_utime(target, *a, **k)

    monkeypatch.setattr(os, "utime", flaky_utime)
    with dispatch.FileLock(path, stale_s=0.15):
        assert _wait_for(lambda: calls["ok"] >= 2, timeout=5.0), calls
    assert calls["failed"] == 1


def test_zombie_beat_does_not_refresh_the_next_holders_lock(tmp_path):
    """F1 (2): a holder whose lock was broken and re-taken by another
    process must not keep the new holder's lock fresh: its beat reads the
    file's token, stops, and leaves the new lock's mtime alone (the
    original's beat touches whatever file holds the path)."""
    path = str(tmp_path / "x.lock")
    a = dispatch.FileLock(path, stale_s=0.15)
    a.__enter__()
    beat = a._beat_thread
    os.unlink(path)                       # broken by a contender ...
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.write(fd, b"another-host:1:token")  # ... which now holds it
    os.close(fd)
    os.utime(path, (0, 0))                # and has stalled itself
    beat.join(timeout=5.0)
    assert not beat.is_alive()
    assert os.path.getmtime(path) == 0
    a.__exit__(None, None, None)
    assert os.path.exists(path)           # not ours: left in place


def test_exit_keeps_the_beat_threads_event_alive(tmp_path, monkeypatch):
    """F1 (3): when ``__exit__``'s join times out on a beat stuck in a slow
    filesystem call, and the next holder takes the lock meanwhile, the
    resumed beat leaves the new lock alone and ends cleanly on its own stop
    event (the original set ``_beat_stop`` to None under it: its resumed
    beat touched the new lock by path, then died on ``None.wait``)."""
    path = str(tmp_path / "x.lock")
    stuck, release = threading.Event(), threading.Event()
    real_utime = os.utime
    errors = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: errors.append(args.exc_value))
    lock = dispatch.FileLock(path, stale_s=0.15)
    lock.join_s = 0.05
    lock.__enter__()
    beat = lock._beat_thread

    def slow_utime(target, *a, **k):
        if threading.current_thread() is beat and not stuck.is_set():
            stuck.set()
            release.wait(10.0)
        return real_utime(target, *a, **k)

    monkeypatch.setattr(os, "utime", slow_utime)
    assert stuck.wait(5.0)
    lock.__exit__(None, None, None)       # the join times out
    assert beat.is_alive() and lock._beat_stop is None
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.write(fd, b"next-holder:1:token")  # the next holder's lock
    os.close(fd)
    real_utime(path, (0, 0))
    release.set()
    beat.join(timeout=5.0)
    assert not beat.is_alive()
    assert errors == []
    assert os.path.getmtime(path) == 0


# ---------------------------------------------------------------- the command

DROPOUTS = ("dropout_features", "dropout_text", "dropout_lstm",
            "dropout_attn", "dropout_out")


@pytest.fixture(scope="module")
def tune_config(tmp_path_factory):
    """configs/smoke.yaml with dropout off, warm-started in both packages
    from the same parameters: the port's seeded LcNIC, as a port
    checkpoint, and on the JAX side through its ``warm_start_from_run``
    (patched in the test to merge these parameters by name)."""
    from masters_thesis_tpu_torch import experiment
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
    from masters_thesis_tpu_torch.train.state import new_state
    from masters_thesis_tpu_torch.transplant import to_flax

    tmp = tmp_path_factory.mktemp("tune")
    text = ((ROOT / "configs" / "smoke.yaml").read_text()
            + "".join(f"{k}: 0.0\n" for k in DROPOUTS))
    base = tmp / "base.yaml"
    base.write_text(text)
    cfg = Config.load(base)
    _, _, _, store, groups = experiment.build_data(cfg, 12)
    model, _, _ = experiment.build_model(cfg, groups, store.row_shape[0])
    start = tmp / "start"
    mgr = CheckpointManager(str(start / "model"))
    mgr.save(new_state(model, cfg, "cpu"), 0)
    mgr.close()
    params = to_flax(model.state_dict())["params"]
    out = {"params": params}
    for name in ("jax", "port"):        # each package its own run dirs
        out[name] = tmp / f"{name}.yaml"
        out[name].write_text(text.replace(
            "log: /tmp/mtt_logs/", f"log: {tmp / name}/")
            + f"warm_start: {start}\n")
        out[f"{name}_log"] = tmp / name
    return out


def _jax_warm_start(monkeypatch, params):
    from masters_thesis_tpu.train import checkpoint as jcheckpoint

    def warm_start_from_run(template, run_dir):
        merged, report = jcheckpoint.merge_by_name(template, params)
        assert not report["missing"] and not report["skipped_shape"]
        return merged, {**report, "source_epoch": 0}

    monkeypatch.setattr(jcheckpoint, "warm_start_from_run",
                        warm_start_from_run)


def _cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _trials(path):
    with open(path) as f:
        return json.load(f)["trials"]


def test_tune_smoke_test_runs_the_jax_trials(tune_config, monkeypatch):
    """``tune --smoke-test``: the JAX CLI's 2 trial configs, each trained
    by the port's run_training to the JAX trial's final val_loss within
    2e-5 (relative), with the same per-epoch history and ASHA flags, and
    the JAX CLI's JSON."""
    from masters_thesis_tpu.cli import main as jmain
    from masters_thesis_tpu_torch.cli import main

    _jax_warm_start(monkeypatch, tune_config["params"])
    argv = ["tune", "--smoke-test", "--epochs", "2", "--smoke-keys", "12",
            "--config"]
    want = _cli(jmain, [*argv, str(tune_config["jax"])])
    jtrials = _trials(tune_config["jax_log"] / "tune_results.json")
    got = _cli(main, [*argv, str(tune_config["port"]), "--device", "cpu"])
    trials = _trials(tune_config["port_log"] / "tune_results.json")
    assert got.keys() == want.keys()
    assert got["best"] == want["best"] and got["n_trials"] == 2
    assert got["best_metric"] == pytest.approx(want["best_metric"],
                                               rel=2e-5)
    assert len(trials) == len(jtrials) == 2
    for t, j in zip(trials, jtrials):
        assert t["config"] == j["config"]
        assert t["error"] is None and j["error"] is None
        assert t["stopped_early"] == j["stopped_early"]
        assert [h["t"] for h in t["history"]] == [h["t"]
                                                  for h in j["history"]]
        np.testing.assert_allclose(
            [h["val_loss"] for h in t["history"]],
            [h["val_loss"] for h in j["history"]], rtol=2e-5)
        assert t["final_metric"] == pytest.approx(j["final_metric"],
                                                  rel=2e-5)


def test_tune_queue_coordinator_and_worker(tune_config, tmp_path):
    """``tune --queue`` on the CPU: a ``--worker`` process (spawned through
    the command) and the coordinator work the queue together; every trial
    is done, none in error, and the coordinator prints the JSON."""
    from masters_thesis_tpu_torch.cli import main

    q = str(tmp_path / "queue")
    argv = ["tune", "--config", str(tune_config["port"]), "--smoke-test",
            "--epochs", "1", "--smoke-keys", "12", "--device", "cpu",
            "--queue", q]
    ctx = mp.get_context("spawn")
    worker = ctx.Process(target=_tune_worker, args=(argv + ["--worker"],))
    worker.start()
    try:
        out = _cli(main, argv)
    finally:
        worker.join(timeout=120)
    assert worker.exitcode == 0
    assert out["n_trials"] == 2 and out["best_metric"] is not None
    done = sorted(os.listdir(os.path.join(q, "done")))
    assert done == ["trial_0000.json", "trial_0001.json"]
    for name in done:
        with open(os.path.join(q, "done", name)) as f:
            assert json.load(f).get("error") is None
    assert os.path.exists(os.path.join(q, "STOP"))


def _tune_worker(argv):
    from masters_thesis_tpu_torch.cli import main

    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0


def test_tune_trial_is_picklable_for_spawned_processes(tune_config):
    import functools
    import pickle

    from masters_thesis_tpu_torch import cli
    from masters_thesis_tpu_torch.config import Config

    trial = functools.partial(cli._tune_trial,
                              Config.load(tune_config["port"]), 1, 12,
                              device="cpu")
    again = pickle.loads(pickle.dumps(trial))
    assert again.func is cli._tune_trial
    assert dataclasses.asdict(again.args[0]) == dataclasses.asdict(
        trial.args[0])
