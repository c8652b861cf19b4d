"""The LcNIC of "Think and Tell" in plain PyTorch: the benchmark's reference
of the ``lc_nic`` family, with the family's raw rows and weights drawn
from the seed and its model FLOPs.

Written from the model's description (AttemptFour/Model/lc_NIC.py and
layers.py), not from the program: 360 parallel Dense(32) layers, one per
Glasser group, each on its own voxels, with LeakyReLU(0.2), then BatchNorm
(Keras' epsilon 1e-3) and dropout; Bahdanau attention whose W1 and W2
carry the LeakyReLU inside, dropout on the scores; a Keras LSTM cell
([i|f|c|o]) stepped over the teacher-forced tokens; a LeakyReLU Dense(256)
and a Dense(vocab) head. Training: the unmasked mean cross-entropy over
(B, T) plus the Keras L2 terms, Keras clipnorm tensor by tensor (a
group's kernel is a row block of ``enc.w``: the groups of one bucket width
share one tensor, as the program's configuration states), and Adam with
its epsilon outside the square root.

Dropout masks: step s draws from a generator on the rows' device seeded
with (seed * 0x9E3779B97F4A7C15 + s) mod 2**64, one ``torch.rand`` a site
in the order of the forward (the encoder's output, the embedded tokens,
then each time step's scores and cell output, then the head's hidden
layer), keeping where the draw is under 1 - rate. That is the
configuration's rule for its masks, worked out here again.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.atlas import (group_bounds, group_sizes,
                                        group_widths)
from port_bench.reference.flops import decode_step_flops
from port_bench.reference.weights import draw

SLOPE = 0.2
BN_EPS = 1e-3
GOLDEN = 0x9E3779B97F4A7C15


def row_width(cfg: dict) -> int:
    """Values in one raw store row: a beta a voxel."""
    return cfg["n_voxels"]


def draw_rows(cfg: dict, n: int, generator, device) -> torch.Tensor:
    """``n`` raw store rows: z-scored betas, N(0, 1)."""
    return torch.randn(n, row_width(cfg), generator=generator, device=device)


def regions(cfg: dict) -> int:
    """What the attention weighs: the groups."""
    return cfg["n_groups"]


def weights(cfg: dict, seed: int, device) -> dict:
    """The LcNIC's leaves. ``enc.w`` is (n_voxels, group_size): voxel v's
    row of its group's dense; ``enc.b`` (n_groups, group_size)."""
    Vx, G, D = cfg["n_voxels"], cfg["n_groups"], cfg["group_size"]
    A, U, E, H, V = (cfg["attn_units"], cfg["units"], cfg["embedding_text"],
                     cfg["head_dim"], cfg["vocab_size"])
    shapes = {"enc.w": (Vx, D), "enc.b": (G, D), "bn.scale": (D,),
              "bn.bias": (D,), "bn.mean": (D,), "bn.var": (D,),
              "att.w1": (D, A), "att.b1": (A,), "att.w2": (U, A),
              "att.b2": (A,), "att.v": (A, 1), "att.bv": (1,),
              "cell.wx": (D + E, 4 * U), "cell.wh": (U, 4 * U),
              "cell.b": (4 * U,), "emb": (V, E), "head.wi": (U, H),
              "head.bi": (H,), "head.wo": (H, V), "head.bo": (V,)}
    gen = torch.Generator(device=device).manual_seed(seed)
    r = draw(shapes, gen, device, {"bn.var", "emb"})
    per_group = torch.as_tensor(group_sizes(cfg), device=device)
    sizes = torch.repeat_interleave(per_group, per_group).float()
    w = {
        # he normal with the group's own fan-in
        "enc.w": r["enc.w"] * torch.sqrt(2.0 / sizes)[:, None],
        "enc.b": 0.1 * r["enc.b"],
        "bn.scale": 1.0 + 0.1 * r["bn.scale"],
        "bn.bias": 0.1 * r["bn.bias"],
        "bn.mean": 0.5 * r["bn.mean"],
        "bn.var": 0.5 + 1.5 * r["bn.var"],
        "att.w1": r["att.w1"] * math.sqrt(2.0 / D),
        "att.b1": 0.5 * r["att.b1"],
        "att.w2": r["att.w2"] * 2.0 * math.sqrt(2.0 / U),
        "att.b2": 0.5 * r["att.b2"],
        "att.v": r["att.v"] * 5.0 / math.sqrt(A),
        "att.bv": r["att.bv"],
        "cell.wx": r["cell.wx"] * math.sqrt(2.0 / (D + E + 4 * U)),
        "cell.wh": r["cell.wh"] / math.sqrt(U),
        "cell.b": 0.5 * r["cell.b"],
        "emb": 1.6 * (2.0 * r["emb"] - 1.0),
        "head.wi": r["head.wi"] * 4.0 / math.sqrt(U),
        "head.bi": 0.5 * r["head.bi"],
        "head.wo": r["head.wo"] * 4.0 / math.sqrt(H),
        "head.bo": 0.2 * r["head.bo"],
    }
    w["cell.wx"][:D] *= 5.0          # the context's rows of the cell
    w["cell.b"][U:2 * U] += 1.0      # Keras' unit forget bias
    return w


def leaky(x):
    return torch.where(x >= 0, x, SLOPE * x)


def dropout_key(seed: int, step: int) -> int:
    return (seed * GOLDEN + step) % 2**64


def drop(x, rate: float, gen):
    """One dropout site: x / (1 - rate) where the draw keeps it, else 0."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, 0.0)


def encode(w: dict, cfg: dict, x: torch.Tensor, train_stats: bool):
    """(B, n_voxels) raw rows -> (B, n_groups, group_size), before the
    dropout. ``train_stats``: BatchNorm on the batch's biased statistics
    over (B, groups), else on the running ones."""
    bounds = group_bounds(cfg)
    outs = [x[:, a:b] @ w["enc.w"][a:b] for a, b in zip(bounds[:-1],
                                                        bounds[1:])]
    y = leaky(torch.stack(outs, dim=1) + w["enc.b"])
    if train_stats:
        var, mean = torch.var_mean(y, dim=(0, 1), correction=0)
    else:
        var, mean = w["bn.var"], w["bn.mean"]
    return (y - mean) * (w["bn.scale"] * torch.rsqrt(var + BN_EPS)) \
        + w["bn.bias"]


def attend(w: dict, features, h, rate: float = 0.0, gen=None):
    """context (B, D), alpha (B, R)."""
    s = torch.tanh(leaky(features @ w["att.w1"] + w["att.b1"])
                   + leaky(h @ w["att.w2"] + w["att.b2"])[:, None])
    if gen is not None:
        s = drop(s, rate, gen)
    alpha = torch.softmax((s @ w["att.v"])[..., 0] + w["att.bv"], dim=1)
    return (alpha[..., None] * features).sum(dim=1), alpha


def lstm(w: dict, x, h, c):
    z = x @ w["cell.wx"] + h @ w["cell.wh"] + w["cell.b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def head(w: dict, h, rate: float = 0.0, gen=None):
    x = leaky(h @ w["head.wi"] + w["head.bi"])
    if gen is not None:
        x = drop(x, rate, gen)
    return x @ w["head.wo"] + w["head.bo"]


def teacher_forced(w: dict, cfg: dict, x, tokens, gen=None):
    """Logits (B, T, V) and alphas (B, T, R) of the rows ``x`` on the
    input ``tokens`` (B, T): in training, with the masks of ``gen``; with
    ``gen`` None in inference (running statistics, no dropout)."""
    train = gen is not None
    r = cfg["dropout"]
    feats = encode(w, cfg, x, train)
    emb = w["emb"][tokens.long()]
    if train:
        feats = drop(feats, r["features"], gen)
        emb = drop(emb, r["text"], gen)
    h = torch.zeros(x.shape[0], cfg["units"], device=x.device)
    c = torch.zeros_like(h)
    outs, alphas = [], []
    for t in range(tokens.shape[1]):
        ctx, alpha = attend(w, feats, h, r["attn"], gen)
        h, c = lstm(w, torch.cat([ctx, emb[:, t]], dim=-1), h, c)
        outs.append(drop(h, r["lstm"], gen) if train else h)
        alphas.append(alpha)
    logits = head(w, torch.stack(outs, dim=1), r["out"], gen)
    return logits, torch.stack(alphas, dim=1)


# ---- training ----

L2_LEAVES = {"enc.w": "input_reg", "att.w1": "attn_reg", "att.w2": "attn_reg",
             "cell.wx": "lstm_reg", "head.wi": "output_reg",
             "head.wo": "output_reg"}
TRAINED = ("enc.w", "enc.b", "bn.scale", "bn.bias", "att.w1", "att.b1",
           "att.w2", "att.b2", "att.v", "att.bv", "cell.wx", "cell.wh",
           "cell.b", "emb", "head.wi", "head.bi", "head.wo", "head.bo")


def loss(w: dict, cfg: dict, x, tokens, target, gen):
    """(total, the cross-entropy) of one training forward."""
    logits, _ = teacher_forced(w, cfg, x, tokens, gen)
    nll = -F.log_softmax(logits, dim=-1).gather(
        -1, target.long()[..., None])[..., 0]
    cce = nll.mean()
    l2 = sum(cfg["l2"][rule] * torch.sum(torch.square(w[name]))
             for name, rule in L2_LEAVES.items())
    return cce + l2, cce


def clip_units(cfg: dict, device) -> dict:
    """For ``enc.w`` and ``enc.b``, each row's clipped tensor: the index of
    its group's bucket width."""
    widths = group_widths(cfg)
    unit = np.unique(widths, return_inverse=True)[1]
    sizes = np.diff(group_bounds(cfg))
    return {"enc.b": torch.as_tensor(unit, device=device),
            "enc.w": torch.as_tensor(np.repeat(unit, sizes), device=device),
            "widths": np.unique(widths)}


def tensor_norms(name: str, g: torch.Tensor, units: dict) -> torch.Tensor:
    """The norm of each clipped tensor of leaf ``name``: one for most,
    one a bucket width for the encoder's kernel and bias."""
    if name not in ("enc.w", "enc.b"):
        return torch.linalg.vector_norm(g)[None]
    idx = units[name]
    sq = torch.zeros(len(units["widths"]), device=g.device,
                     dtype=g.dtype).index_add_(0, idx, g.square().sum(1))
    return sq.sqrt()


def clip(name: str, g: torch.Tensor, units: dict, max_norm: float):
    norms = tensor_norms(name, g, units)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-12), 1.0)
    if name in ("enc.w", "enc.b"):
        return g * scale[units[name]][:, None]
    return g * scale[0]


def train_steps(w0: dict, cfg: dict, batches, seed: int) -> dict:
    """Follow ``batches`` (x, tokens, target) from the weights ``w0`` with
    Adam, from step 0. Returns each step's cross-entropy, each clipped
    tensor's norm of the first step's gradient as Adam gets it (clipped)
    and as the loss gives it, and each clipped tensor's change after the
    last step, keyed as ``leaf_keys`` gives them."""
    opt = cfg["optimizer"]
    b1, b2, eps, lr = opt["beta_1"], opt["beta_2"], opt["epsilon"], \
        opt["alpha"]
    dev = next(iter(w0.values())).device
    units = clip_units(cfg, dev)
    w = {k: v.clone().requires_grad_(k in TRAINED) for k, v in w0.items()}
    mu = {k: torch.zeros_like(w[k]) for k in TRAINED}
    nu = {k: torch.zeros_like(w[k]) for k in TRAINED}
    out = {"loss": []}
    for step, (x, tokens, target) in enumerate(batches):
        gen = torch.Generator(device=dev).manual_seed(dropout_key(seed,
                                                                  step))
        total, cce = loss(w, cfg, x, tokens, target, gen)
        grads = torch.autograd.grad(total, [w[k] for k in TRAINED])
        out["loss"].append(float(cce.detach()))
        count = step + 1
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        with torch.no_grad():
            clipped = {k: clip(k, g, units, opt["clipnorm"])
                       for k, g in zip(TRAINED, grads)}
            if step == 0:
                out["grad"] = leaf_norms(clipped, units)
                out["raw_grad"] = leaf_norms(dict(zip(TRAINED, grads)),
                                             units)
            for k in TRAINED:
                g = clipped[k]
                mu[k].mul_(b1).add_((1 - b1) * g)
                nu[k].mul_(b2).add_((1 - b2) * torch.square(g))
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                w[k].add_(upd * -lr)
    with torch.no_grad():
        out["change"] = leaf_norms({k: w[k] - w0[k] for k in TRAINED},
                                   units)
    return out


def leaf_norms(tensors: dict, units: dict) -> dict:
    """{leaf key: norm} for every clipped tensor: ``enc.w@<width>`` and
    ``enc.b@<width>`` for the encoder's buckets, the leaf's name else."""
    out = {}
    for name, t in tensors.items():
        norms = tensor_norms(name, t.float(), units).tolist()
        if name in ("enc.w", "enc.b"):
            for width, n in zip(units["widths"], norms):
                out[f"{name}@{int(width)}"] = n
        else:
            out[name] = norms[0]
    return out


# ---- model FLOPs (``reference/flops.py``'s rules)

def step_flops(cfg: dict) -> float:
    """One teacher-forced step of one sample, forward: the attention (W1 on
    every region, W2, the scores, the context), the LSTM's gates and the
    head."""
    R, D, A = cfg["n_groups"], cfg["group_size"], cfg["attn_units"]
    U, E, H, V = cfg["units"], cfg["embedding_text"], cfg["head_dim"], \
        cfg["vocab_size"]
    attn = 2 * R * D * A + 2 * U * A + 2 * R * A + 2 * R * D
    lstm = 2 * (D + E + U) * 4 * U
    head = 2 * U * H + 2 * H * V
    return float(attn + lstm + head)


def train_flops_per_sample(cfg: dict) -> float:
    """``bench.py::flagship_flops_per_step`` over one sample: the encoder
    (every voxel enters one group's dense to ``group_size``) and
    ``max_length`` steps, forward and backward (3x the forward)."""
    enc = 2 * cfg["n_voxels"] * cfg["group_size"]
    return 3.0 * (enc + cfg["max_length"] * step_flops(cfg))


def caption_flops(cfg: dict) -> float:
    """One greedy caption: the encoder, ``pre`` once, and ``max_length``
    decode steps."""
    R, D, A = cfg["n_groups"], cfg["group_size"], cfg["attn_units"]
    enc = 2 * cfg["n_voxels"] * D
    steps = cfg["max_length"] * decode_step_flops(
        "lstm", regions=R, feat_dim=D, attn_units=A, units=cfg["units"],
        emb_dim=cfg["embedding_text"], head_dim=cfg["head_dim"],
        vocab=cfg["vocab_size"])
    return float(enc + 2 * R * D * A + steps)
