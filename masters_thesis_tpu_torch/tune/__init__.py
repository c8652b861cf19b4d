"""Hyper-parameter sweeps: search spaces, ASHA, the trial runner and the
shared-filesystem queue (``dispatch``). The port's own copy of
``masters_thesis_tpu/tune/``; a trial is the port's ``run_training``
(``cli.py``'s ``tune`` command)."""

from masters_thesis_tpu_torch.tune.search import (
    Choice,
    GridSearch,
    LogUniform,
    RandomSearch,
    Uniform,
)
from masters_thesis_tpu_torch.tune.asha import ASHAScheduler
from masters_thesis_tpu_torch.tune.runner import TuneResult, run_experiment

__all__ = [
    "Choice",
    "GridSearch",
    "LogUniform",
    "RandomSearch",
    "Uniform",
    "ASHAScheduler",
    "TuneResult",
    "run_experiment",
]
