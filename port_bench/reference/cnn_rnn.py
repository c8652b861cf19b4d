"""The CNN_RNN captioner (Show, Attend and Tell; Xu et al. 2015,
arXiv:1502.03044, as the thesis' CNN_RNN/model.py builds it) in plain
PyTorch: the benchmark's reference of the ``cnn_rnn`` family, in
inference, with the family's raw rows and weights drawn from the seed and
its model FLOPs.

A shared relu Dense over the InceptionV3 patches; Bahdanau attention with
no inner activation; a Keras GRU cell (reset_after: [z|r|h], input and
recurrent biases apart) called without an initial state, so each step's
recurrence starts from zeros and the carried h feeds only the next
attention; a linear Dense(units) and a Dense(vocab) head.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.flops import decode_step_flops
from port_bench.reference.weights import draw


def row_width(cfg: dict) -> int:
    """Values in one raw store row: a patch's channels, patch by patch."""
    return cfg["n_patches"] * cfg["in_channels"]


def draw_rows(cfg: dict, n: int, generator, device) -> torch.Tensor:
    """``n`` raw store rows: post-ReLU feature maps, max(N(0, 1), 0)."""
    rows = torch.randn(n, row_width(cfg), generator=generator, device=device)
    return rows.clamp_(min=0.0)


def regions(cfg: dict) -> int:
    """What the attention weighs: the patches."""
    return cfg["n_patches"]


def weights(cfg: dict, seed: int, device) -> dict:
    """The CnnRnn's leaves: the patch projection ``enc.w`` (C, D), the
    linear attention, the GRU (``cell.b`` rows: input, recurrent bias) and
    the linear head."""
    C, D, U, V = (cfg["in_channels"], cfg["embed_dim"], cfg["units"],
                  cfg["vocab_size"])
    shapes = {"enc.w": (C, D), "enc.b": (D,), "att.w1": (D, U),
              "att.b1": (U,), "att.w2": (U, U), "att.b2": (U,),
              "att.v": (U, 1), "att.bv": (1,), "cell.wx": (2 * D, 3 * U),
              "cell.wh": (U, 3 * U), "cell.b": (2, 3 * U), "emb": (V, D),
              "head.wi": (U, U), "head.bi": (U,), "head.wo": (U, V),
              "head.bo": (V,)}
    gen = torch.Generator(device=device).manual_seed(seed)
    r = draw(shapes, gen, device, {"emb"})
    w = {
        "enc.w": r["enc.w"] * math.sqrt(2.0 / C),
        "enc.b": 0.1 * r["enc.b"],
        "att.w1": r["att.w1"] * math.sqrt(1.0 / D),
        "att.b1": 0.5 * r["att.b1"],
        "att.w2": r["att.w2"] * 2.0 * math.sqrt(1.0 / U),
        "att.b2": 0.5 * r["att.b2"],
        # a linear inner activation keeps the scores' tanh near saturation:
        # x2, not x5, keeps the attention soft
        "att.v": r["att.v"] * 2.0 / math.sqrt(U),
        "att.bv": r["att.bv"],
        "cell.wx": r["cell.wx"] * math.sqrt(2.0 / (2 * D + 3 * U)),
        "cell.wh": r["cell.wh"] / math.sqrt(U),
        "cell.b": 0.5 * r["cell.b"],
        "emb": 1.6 * (2.0 * r["emb"] - 1.0),
        "head.wi": r["head.wi"] * 4.0 / math.sqrt(U),
        "head.bi": 0.5 * r["head.bi"],
        "head.wo": r["head.wo"] * 4.0 / math.sqrt(U),
        "head.bo": 0.2 * r["head.bo"],
    }
    w["cell.wx"][:D] *= 5.0
    return w


def encode(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, P * C) rows -> (B, P, D)."""
    x = x.view(x.shape[0], cfg["n_patches"], cfg["in_channels"])
    return torch.relu(x @ w["enc.w"] + w["enc.b"])


def attend(w: dict, features, h):
    s = torch.tanh(features @ w["att.w1"] + w["att.b1"]
                   + (h @ w["att.w2"] + w["att.b2"])[:, None])
    alpha = torch.softmax((s @ w["att.v"])[..., 0] + w["att.bv"], dim=1)
    return (alpha[..., None] * features).sum(dim=1), alpha


def gru_from_zero(w: dict, x):
    xz = x @ w["cell.wx"] + w["cell.b"][0]
    hz = w["cell.b"][1]                  # zeros @ the recurrent kernel
    xz_z, xz_r, xz_h = torch.chunk(xz, 3, dim=-1)
    hz_z, hz_r, hz_h = torch.chunk(hz, 3, dim=-1)
    z = torch.sigmoid(xz_z + hz_z)
    r = torch.sigmoid(xz_r + hz_r)
    return (1 - z) * torch.tanh(xz_h + r * hz_h)


def teacher_forced(w: dict, cfg: dict, x, tokens):
    """Logits (B, T, V) and alphas (B, T, P) of the rows ``x`` on the
    input ``tokens`` (B, T)."""
    feats = encode(w, cfg, x)
    emb = w["emb"][tokens.long()]
    h = torch.zeros(x.shape[0], cfg["units"], device=x.device)
    hs, alphas = [], []
    for t in range(tokens.shape[1]):
        ctx, alpha = attend(w, feats, h)
        h = gru_from_zero(w, torch.cat([ctx, emb[:, t]], dim=-1))
        hs.append(h)
        alphas.append(alpha)
    hs = torch.stack(hs, dim=1)
    logits = (hs @ w["head.wi"] + w["head.bi"]) @ w["head.wo"] + w["head.bo"]
    return logits, torch.stack(alphas, dim=1)


def caption_flops(cfg: dict) -> float:
    """One greedy caption (``reference/flops.py``'s rules): the patch
    projection, ``pre`` once, and ``max_length`` decode steps of the
    zero-state GRU."""
    P, C, D, U = cfg["n_patches"], cfg["in_channels"], cfg["embed_dim"], \
        cfg["units"]
    enc = 2 * P * C * D
    steps = cfg["max_length"] * decode_step_flops(
        "gru", regions=P, feat_dim=D, attn_units=U, units=U, emb_dim=D,
        head_dim=U, vocab=cfg["vocab_size"], zero_state=True)
    return float(enc + 2 * P * D * U + steps)
