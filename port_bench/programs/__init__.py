"""The program under test, built for each model family from the
benchmark's weights: one module a family named by the configuration's
``model`` (``lc_nic.py``, ``cnn_rnn.py``)."""

import importlib


def family(cfg: dict):
    """The program module of the configuration's model family."""
    return importlib.import_module(f"{__name__}.{cfg['model']}")
