"""The benchmark's weights are made from the seed on the device, in a few
large draws, as one dict of named tensors (the plain reference's own
names), then widened by a rule frozen in each family's reference module
(``weights``) so that greedy argmax margins are not all near-ties and
every bias and statistic is live.

The rule is the benchmark's, not the program's: the same dict is loaded
into the program's model (``programs/<model>.py``) and handed to the
reference.
"""

from __future__ import annotations

import math

import torch


def draw(shapes: dict, generator, device, uniform: set) -> dict:
    """One normal draw for every leaf not in ``uniform`` and one uniform
    draw on [0, 1) for those in it, cut into the leaves."""
    out = {}
    for kind, names in (("normal", [n for n in shapes if n not in uniform]),
                        ("uniform", [n for n in shapes if n in uniform])):
        sizes = [math.prod(shapes[n]) for n in names]
        if not sizes:
            continue
        make = torch.randn if kind == "normal" else torch.rand
        flat = make(sum(sizes), generator=generator, device=device)
        for n, part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(shapes[n])
    return out
