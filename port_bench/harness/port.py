"""The program under test, set up from the benchmark's inputs: its model
with the benchmark's weights and its device store, for any model family
(``programs/<model>.py``).

Everything here calls the program (``masters_thesis_tpu_torch``); the
reference never imports this file.
"""

from __future__ import annotations

import torch

from port_bench import programs
from port_bench.harness import traffic


def model(cfg: dict, weights: dict, device):
    """The program's model of the configuration's family at its widths,
    holding ``weights``."""
    family = programs.family(cfg)
    m = family.build(cfg, device)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name in family.LEAVES:
                p.copy_(weights[family.LEAVES[name]].view(p.shape))
        family.load_encoder(m, weights)
    return m


def store(cfg: dict, seed: int, device, m):
    """The program's device store of every key of the configuration, block
    by block, each row as the family stores it (``to_store``)."""
    from masters_thesis_tpu_torch.data.store import ArrayStore

    family = programs.family(cfg)
    n = cfg["store"]["keys"]
    data = torch.empty(n, family.store_width(cfg, m), device=device)
    for block in range(traffic.n_blocks(cfg)):
        rows = family.to_store(m, traffic.raw_rows(cfg, seed, block, device))
        lo = block * traffic.ROW_BLOCK
        data[lo:lo + len(rows)] = rows
        del rows
    return ArrayStore(data, list(range(n)), device=device)
