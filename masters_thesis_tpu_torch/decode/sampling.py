"""Stochastic (categorical) decoding, in PyTorch.

Counterpart of ``masters_thesis_tpu/decode/sampling.py`` (reference
``sample_choice``, lc_NIC.py:571-575, and the stochastic decode of
CNN_RNN/train.py:343-369): each step draws the next word from the softmax of
the logits over a temperature, optionally kept to the top k.

``filter_logits`` is the JAX package's filter as written there: the k-th
largest logit is the threshold and every logit below it goes to -inf, so
ties at the k-th logit are kept and more than k words may survive. The draw
is the Gumbel-max trick, as ``jax.random.categorical`` draws, from the
caller's ``torch.Generator`` on the decode's device; the two frameworks draw
different words from one seed. Plain PyTorch on the card as on the CPU: the
JAX package has no kernel for it either.
"""

from __future__ import annotations

import torch


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: int) -> torch.Tensor:
    """(B, V) logits over ``temperature``; with ``top_k`` > 0, -inf below
    the k-th largest of each row (ties at it kept)."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1)[0][:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return logits


def make_sampling_decoder(model, max_length: int, temperature: float = 1.0,
                          top_k: int = 0):
    """decode(betas (B, ...), start_id, generator) -> words (B, T) int32,
    each step's word drawn with ``generator`` (a ``torch.Generator`` on the
    betas' device). Raises the JAX package's ``ValueError`` for a
    temperature of 0 or less (logits/0 is NaN in the draw; a temperature of
    0 means greedy) and for a ``top_k`` outside [0, vocab]."""
    if temperature <= 0:
        raise ValueError(
            f"sampling temperature must be > 0, got {temperature} "
            "(for deterministic decoding use the greedy decoder)")
    vocab = getattr(model, "vocab_size", None)
    if top_k < 0 or (vocab and top_k > vocab):
        raise ValueError(
            f"sampling top_k must be in [0, vocab={vocab}], got {top_k} "
            "(0 samples the full vocabulary)")

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int,
               generator: torch.Generator):
        features = model.encode(betas)
        h, c = model.init_carry(features)
        tok = torch.full((betas.shape[0],), start_id, dtype=torch.long,
                         device=betas.device)
        words = []
        for _ in range(max_length):
            h, c, logits, _ = model.decode_step(h, c, features, tok)
            logits = filter_logits(logits, temperature, top_k)
            u = torch.rand(logits.shape, generator=generator,
                           dtype=logits.dtype, device=logits.device)
            gumbel = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(logits.dtype).tiny)))
            tok = torch.argmax(logits + gumbel, dim=-1)
            words.append(tok)
        return torch.stack(words, 1).to(torch.int32)

    return decode
