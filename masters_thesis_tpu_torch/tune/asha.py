"""ASHA — asynchronous successive halving (Li et al. 2018).

The reference's Ray Tune setup uses AsyncHyperBandScheduler with
max_t=100, grace_period=8 (AttemptFour/tune.py:168-176). Same semantics:
rungs at grace_period * reduction_factor^k; when a trial reaches a rung it
continues only if its metric is in the top 1/reduction_factor of results seen
at that rung so far (asynchronous — no waiting for full brackets).

The port's own copy of ``masters_thesis_tpu/tune/asha.py``, with the same
names and meaning (``tests/test_torch_tune.py`` holds the two together).
"""

from __future__ import annotations

from collections import defaultdict


class ASHAScheduler:
    def __init__(
        self,
        metric: str = "val_loss",
        mode: str = "min",
        max_t: int = 100,
        grace_period: int = 8,
        reduction_factor: int = 4,
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: list[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self._results: dict[int, list[float]] = defaultdict(list)

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def on_result(self, trial_id, t: int, metrics: dict) -> str:
        """Returns 'continue' or 'stop'. Call once per epoch (t = 1-based)."""
        return self._decide(t, metrics, self._results, None)

    def on_result_shared(self, t: int, metrics: dict, shared, lock) -> str:
        """Same decision against cross-process rung state: ``shared`` is a
        multiprocessing.Manager dict (rung t -> list of metric values) and
        ``lock`` serialises the read-modify-write. This is what makes ASHA
        work across parallel trial workers (Ray's async scheduler flow,
        AttemptFour/tune.py:166-205)."""
        return self._decide(t, metrics, shared, lock)

    def _decide(self, t: int, metrics: dict, results, lock) -> str:
        if t >= self.max_t:
            # the trial ran its full budget: halt it, but as COMPLETED —
            # reporters must not record it as ASHA-culled
            return "complete"
        if t not in self.rungs:
            return "continue"
        value = float(metrics[self.metric])
        if lock is not None:
            with lock:
                vals = list(results.get(t, []))
                vals.append(value)
                results[t] = vals  # reassign: Manager dicts don't see mutation
            rung = vals
        else:
            results[t].append(value)
            rung = results[t]
        ranked = sorted(rung, reverse=(self.mode == "max"))
        cutoff_idx = max(len(ranked) // self.rf, 1) - 1
        cutoff = ranked[cutoff_idx]
        keep = value <= cutoff if self.mode == "min" else value >= cutoff
        return "continue" if keep else "stop"
