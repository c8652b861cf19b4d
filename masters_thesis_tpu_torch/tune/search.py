"""Hyperparameter search spaces and samplers.

Reference surfaces: Ray Tune with ``tune.loguniform`` L2 search
(AttemptFour/tune.py:194-197, num_samples=200), kerastuner RandomSearch
(ThinkAndTell/gridsearch_train.py:318) and grid search hooks
(ThinkAndTell/train.py:522-535). Deterministic given a seed.

The port's own copy of ``masters_thesis_tpu/tune/search.py``, with the same
names and meaning (``tests/test_torch_tune.py`` holds the two together).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np


@dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.low, self.high))


@dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(
            math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        )


@dataclass(frozen=True)
class Choice:
    options: Sequence[Any]

    def sample(self, rng: np.random.Generator):
        return self.options[int(rng.integers(len(self.options)))]


class RandomSearch:
    """num_samples draws from a {name: space-or-constant} dict."""

    def __init__(self, space: dict, num_samples: int, seed: int = 0):
        self.space = space
        self.num_samples = num_samples
        self.seed = seed

    def __iter__(self):
        rng = np.random.Generator(np.random.PCG64(self.seed))
        for _ in range(self.num_samples):
            yield {
                k: v.sample(rng) if hasattr(v, "sample") else v
                for k, v in self.space.items()
            }


class GridSearch:
    """Cartesian product over {name: list} (constants pass through)."""

    def __init__(self, space: dict):
        self.space = space

    def __iter__(self):
        keys = list(self.space)
        grids = [
            v if isinstance(v, (list, tuple)) else [v] for v in self.space.values()
        ]
        for combo in itertools.product(*grids):
            yield dict(zip(keys, combo))
