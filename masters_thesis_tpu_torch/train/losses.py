"""Loss terms of the train step, in PyTorch.

Counterpart of ``masters_thesis_tpu/train/losses.py`` (reference
AttemptFour/Model/lc_NIC.py:328-408):

  total = caption CCE, the UNMASKED mean over (B, T)        (:370-375)
        + Keras L2 activity terms by parameter name          (:379)
        (+ attention sum-to-one MSE, off as in the reference (:384))

The CCE is taken from logits with ``log_softmax`` and target ids; the masked
variant of the older generations multiplies by the mask and still divides by
B x T, not by the mask count (ThinkAndTell/model.py:319-334).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch.parallel.collectives import (
    global_sums,
    is_sharded,
    reduce_from_model,
)


def caption_loss(logits, target_ids, mask=None) -> torch.Tensor:
    """Mean cross-entropy over (B, T); ``mask`` (B, T) zeroes masked steps
    without changing the divisor."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target_ids.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    return (nll * mask.to(nll.dtype)).mean()


def accuracy(logits, target_ids, mask=None) -> torch.Tensor:
    """Categorical accuracy (lc_NIC.py:469-486): argmax match rate; the
    masked rate's sums are over the global batch inside a sharded step."""
    hit = (logits.argmax(dim=-1) == target_ids).float()
    if mask is None:
        return hit.mean()
    mask = mask.to(hit.dtype)
    hits, count = global_sums((hit * mask).sum(), mask.sum())
    return hits / count.clamp(min=1.0)


def attention_loss(alphas) -> torch.Tensor:
    """Doubly-stochastic attention regulariser: MSE(sum_t alpha_t, 1)."""
    total = alphas.sum(dim=1)                                 # (B, R)
    return torch.square(total - 1.0).mean()


# ---- L2 regularisation ----

def lc_nic_l2_rules(cfg) -> list[tuple[tuple[str, ...], float]]:
    """Which kernels carry which L2 coefficient in the flagship model
    (lc_NIC.py:84-159): encoder kernels input_reg, attention W1/W2 attn_reg,
    the LSTM input kernel lstm_reg, both head kernels output_reg; V, the
    embedding, biases and BatchNorm carry none."""
    return [
        (("encoder", "kernel"), cfg.input_reg),
        (("attention", "W1", "kernel"), cfg.attn_reg),
        (("attention", "W2", "kernel"), cfg.attn_reg),
        (("lstm", "kernel"), cfg.lstm_reg),
        (("dense_inter", "kernel"), cfg.output_reg),
        (("dense_out", "kernel"), cfg.output_reg),
    ]


def _matches(names: tuple[str, ...], pattern: tuple[str, ...]) -> bool:
    """Ordered subsequence match with prefix tolerance on each name (so
    ("encoder", "kernel") matches encoder.kernel_0, kernel_1, ...)."""
    i = 0
    for pat in pattern:
        while i < len(names) and not names[i].startswith(pat):
            i += 1
        if i == len(names):
            return False
        i += 1
    return True


def l2_loss(model, rules) -> torch.Tensor:
    """Keras-style L2: sum_i coeff_i * sum(w_i**2) over the parameters whose
    dotted names (flax's paths, ``named_parameters()``) match a rule; the
    first matching rule wins. Inside a sharded step, the term of a shard
    that its layer computes with is summed over the model group."""
    total = None
    for name, param in model.named_parameters():
        names = tuple(name.split("."))
        for pattern, coeff in rules:
            if coeff and _matches(names, pattern):
                term = coeff * torch.sum(torch.square(param))
                if is_sharded(name):
                    term = reduce_from_model(term)
                total = term if total is None else total + term
                break
    if total is None:
        return torch.zeros((), device=next(model.parameters()).device)
    return total
