"""Training over a ('data', 'model') mesh of ranks, in PyTorch.

Counterpart of ``masters_thesis_tpu/parallel/``: ``mesh`` (the grid of
ranks and the process group), ``collectives`` (the layers' collectives and
the placement a sharded step tells them), ``sharding`` (the rules, the
sharded state, input placement, the sharded steps), ``multiprocess`` (one
process a rank: ``train --processes``) and ``dryrun``. The modules are
imported by name: the models import ``collectives``, and ``sharding``
builds on ``train.steps``.
"""
