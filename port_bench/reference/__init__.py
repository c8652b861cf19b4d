"""The plain reference of each model family, one module a family named by
the configuration's ``model`` (``lc_nic.py``, ``cnn_rnn.py``): its
weights and raw rows drawn from the seed, its teacher-forced forward and
its FLOP count. Imports nothing of the program."""

import importlib


def family(cfg: dict):
    """The reference module of the configuration's model family."""
    return importlib.import_module(f"{__name__}.{cfg['model']}")
