"""Trial runner: the multi-trial orchestration layer.

Reference: ``tune.run(train_NIC, num_samples=200, AsyncHyperBandScheduler,
resources_per_trial={cpu:2, gpu:0.33})`` (AttemptFour/tune.py:166-205) — Ray
workers each running a full training. Here trials run either sequentially
in-process or as spawned subprocesses (``processes > 1``; on one card, N
CUDA contexts share it); each trial reports per-epoch metrics through a
callback and ASHA decides continue/stop (the TuneReportCallback flow,
tune.py:146-153).

``trial_fn(config, report) -> float`` runs one trial, calling
``report(t, metrics)`` each epoch and honouring its 'stop' return.

The port's own copy of ``masters_thesis_tpu/tune/runner.py``, with the same
names and meaning (``tests/test_torch_tune.py`` holds the two together).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field


@dataclass
class TuneResult:
    trials: list = field(default_factory=list)
    metric: str = "val_loss"
    mode: str = "min"

    def best(self) -> dict:
        ok = [t for t in self.trials if t.get("final_metric") is not None]
        key = lambda tr: tr["final_metric"]
        return min(ok, key=key) if self.mode == "min" else max(ok, key=key)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"metric": self.metric, "trials": self.trials}, f, indent=1)


def _run_one(args):
    """Worker-process trial body. ``shared``/``lock`` are Manager proxies of
    the cross-process ASHA rung state; the scheduler object itself is
    stateless config here, so every worker makes identical decisions against
    the shared rungs (matching Ray's async scheduler across workers)."""
    trial_fn, trial_id, config, metric, scheduler, shared, lock = args
    history = []
    stopped_early = False

    def report(t, metrics):
        nonlocal stopped_early
        history.append({"t": t, **{k: float(v) for k, v in metrics.items()}})
        if scheduler is not None and shared is not None:
            decision = scheduler.on_result_shared(t, metrics, shared, lock)
            if decision == "stop":
                stopped_early = True
            # 'complete' (budget exhausted) halts training like 'stop' but
            # is NOT recorded as ASHA-culled
            return "stop" if decision == "complete" else decision
        return "continue"

    t0 = time.time()
    try:
        final = trial_fn(config, report)
    except Exception as exc:  # one bad config must not sink the sweep
        return (trial_id, config, history, None, stopped_early,
                time.time() - t0, f"{type(exc).__name__}: {exc}")
    return (trial_id, config, history, float(final), stopped_early,
            time.time() - t0, None)


def run_experiment(
    trial_fn,
    search,
    scheduler=None,
    metric: str = "val_loss",
    mode: str = "min",
    processes: int = 1,
    log_dir: str | None = None,
) -> TuneResult:
    result = TuneResult(metric=metric, mode=mode)

    if processes > 1:
        # trials in worker processes WITH ASHA coupling: rung results live in
        # a Manager dict that every worker reports into, so the scheduler can
        # stop poor trials at rung boundaries across processes — Ray's
        # AsyncHyperBand-with-parallel-workers behavior (tune.py:166-205)
        import multiprocessing as mp

        # spawn, not fork: CUDA cannot be used in a child forked after the
        # parent initialised it, and fork() under the parent's threads can
        # deadlock
        ctx = mp.get_context("spawn")
        with ctx.Manager() as man:
            shared = man.dict() if scheduler is not None else None
            lock = man.Lock() if scheduler is not None else None
            jobs = [
                (trial_fn, i, cfg, metric, scheduler, shared, lock)
                for i, cfg in enumerate(search)
            ]
            with ProcessPoolExecutor(max_workers=processes,
                                     mp_context=ctx) as pool:
                for (trial_id, cfg, history, final, stopped_early,
                     wall_s, error) in pool.map(_run_one, jobs):
                    result.trials.append(
                        {
                            "trial_id": trial_id,
                            "config": cfg,
                            "history": history,
                            "final_metric": final,
                            "stopped_early": stopped_early,
                            "wall_s": wall_s,
                            "error": error,
                        }
                    )
    else:
        for trial_id, config in enumerate(search):
            history = []
            stopped_early = False

            def report(t, metrics):
                nonlocal stopped_early
                history.append(
                    {"t": t, **{k: float(v) for k, v in metrics.items()}}
                )
                if scheduler is not None:
                    decision = scheduler.on_result(trial_id, t, metrics)
                    if decision == "stop":
                        stopped_early = True
                    return "stop" if decision == "complete" else decision
                return "continue"

            t0 = time.time()
            try:
                final = float(trial_fn(config, report))
                error = None
            except Exception as exc:
                # a crashing trial is RECORDED, the rest of the sweep runs
                # (Ray marks trials errored and continues; dispatch.py's
                # run_worker already does the same)
                final, error = None, f"{type(exc).__name__}: {exc}"
            result.trials.append(
                {
                    "trial_id": trial_id,
                    "config": config,
                    "history": history,
                    "final_metric": final,
                    "stopped_early": stopped_early,
                    "wall_s": time.time() - t0,
                    "error": error,
                }
            )

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        result.save(os.path.join(log_dir, "tune_results.json"))
    return result
