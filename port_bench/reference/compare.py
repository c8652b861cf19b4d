"""The numbers that decide ``correct``: what the program produced against
the plain reference, each held to a limit of its own (the cell's file under
``port_bench/limits/``, set from readings as ``PERF.md`` records).
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is moved by round-off alone under Adam (a key's bias under softmax): its
# change is left out
ROUND_OFF_SHARE = 1e-3


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, the larger."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            if k in prog else math.inf for k in keys}


def norm_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keys).values())


def train_readings(prog: dict, ref: dict) -> dict:
    """``loss``: the worst step's relative gap of the cross-entropy;
    ``grad``: the first step's gradient as Adam gets it; ``change``: the
    parameters' change after the last step, leaves moved by round-off
    alone left out."""
    loss = (max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
            if len(prog["loss"]) == len(ref["loss"]) else math.inf)
    raw = ref["raw_grad"]
    floor = ROUND_OFF_SHARE * statistics.median(raw.values())
    moved = [k for k in ref["change"] if raw[k] >= floor]
    return {"loss": loss,
            "grad": norm_gap(prog["grad"], ref["grad"], ref["grad"]),
            "change": norm_gap(prog["change"], ref["change"], moved)}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves with the widest gaps of ``grad`` and ``change``,
    for the record of what a reading is made of."""
    out = {}
    for name in ("grad", "change"):
        gaps = leaf_gaps(prog[name], ref[name], ref[name])
        out[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def served_gap(logits: torch.Tensor, words: torch.Tensor) -> float:
    """The widest gap by which a served word's reference logit lies under
    the reference's best at its position."""
    got = logits.gather(-1, words.long()[..., None])[..., 0]
    return float((logits.amax(dim=-1) - got).amax())


def decode_readings(logits, alphas_ref, words, alphas) -> dict:
    """``logit_gap`` of the served words, ``alpha_err`` the largest
    absolute gap of the served alphas from the reference's."""
    if not torch.isfinite(alphas).all():
        return {"logit_gap": math.inf, "alpha_err": math.inf}
    return {"logit_gap": served_gap(logits, words),
            "alpha_err": float((alphas - alphas_ref).abs().amax())}


def verdict(readings: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, value, limit)])."""
    rows = [(name, float(readings[name]), float(limits[name]))
            for name in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


@contextlib.contextmanager
def lower_precision():
    """The control's precision: float32 products in TF32, the nearest
    precision under the float32 the configurations state."""
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept
