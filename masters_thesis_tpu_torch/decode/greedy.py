"""Greedy caption decoding, the unfused step loop, in PyTorch.

Counterpart of ``masters_thesis_tpu/decode/greedy.py::make_greedy_decoder``:
encode once, then ``max_length`` steps of ``decode_step`` and argmax, for
either cell of ``NIC`` (a GRU carries ``c`` through unchanged) and for
``ShowTell``. Like the reference it always runs every step (no stop at
``<end>``). It is the oracle for the whole-decode kernel, the path behind
``Captioner(use_fused=False)``, of ``tpu.use_pallas: false`` and of the
ShowTell family, which has no kernel in the JAX package either.
``make_scanned_greedy_decoder`` decodes K stacked batches in one call,
each as a single call would.
"""

from __future__ import annotations

import torch


def make_greedy_decoder(model, max_length: int):
    """decode(betas (B, N), start_id) -> (words (B, T) int32,
    logits (B, T, V), alphas (B, T, R))."""

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int):
        features = model.encode(betas)
        h, c = model.init_carry(features)
        tok = torch.full((betas.shape[0],), start_id, dtype=torch.long,
                         device=betas.device)
        words, logits, alphas = [], [], []
        for _ in range(max_length):
            h, c, step_logits, alpha = model.decode_step(h, c, features, tok)
            tok = torch.argmax(step_logits, dim=-1)
            words.append(tok)
            logits.append(step_logits)
            alphas.append(alpha)
        return (torch.stack(words, 1).to(torch.int32),
                torch.stack(logits, 1), torch.stack(alphas, 1))

    return decode


def make_scanned_greedy_decoder(model, max_length: int,
                                return_logits: bool = False):
    """decode(betas (K, B, N), start_id) -> words (K, B, T) int32, or
    (words, logits (K, B, T, V)) with ``return_logits``.

    Counterpart of the JAX ``make_scanned_greedy_decoder``, the serving
    decoder of K stacked batches a call. It walks the batches one by one,
    as the JAX ``lax.scan`` does, so that each slice is a single call's
    words bit for bit: K·B rows in one product would sum in another order
    and could move near-ties."""
    inner = make_greedy_decoder(model, max_length)

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int):
        outs = [inner(b, start_id) for b in betas]
        words = torch.stack([o[0] for o in outs])
        if return_logits:
            return words, torch.stack([o[1] for o in outs])
        return words

    return decode
