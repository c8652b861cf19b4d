"""Batched beam search on a fixed (B, W) lattice, in PyTorch.

Counterpart of ``masters_thesis_tpu/decode/beam.py::make_beam_decoder``,
operation for operation. Semantics follow the reference's only complete beam
search (soloist/Modified-Show-And-Tell-Keras/evaluate.py:103-189): log-
probabilities accumulate, the W best of the W·V candidates survive each
step, a beam that emits ``<end>`` is finished, and hypotheses rank by
``score / max(len, 1)^alpha`` with alpha 0.7.

The lattice keeps the reference's shrinking frontier without dynamic
shapes:

- a finished beam may only continue with ``<pad>``, at zero cost, and that
  continuation's selection key gets a rank-only bonus (``BONUS``,
  2·|``NEG_INF``|), so a finished hypothesis is never displaced by live
  candidates; the exact scores are read from the candidates, not from the
  keys minus the bonus, whose fp32 spacing near 2e9 (256) would wipe out
  the log-probabilities;
- the seed step is unchecked: ``<end>`` finishes a beam only from the
  second step on;
- a finish on the first loop step (the reference's -inf route) is kept as a
  frozen dead end whose normalised score is ``NEG_INF``;
- the length counts emitted non-``<end>`` tokens.

Token and attention histories are reordered with the beams; a finished
beam's attention is zero. The W best keys are taken in an order defined for
ties, the lower flat index first, as ``jax.lax.top_k`` takes them
(``torch.topk`` promises no order among equal keys): a stable descending
sort. Near ±1e9 the fp32 spacing is 64, so ``NEG_INF + logp`` collapses for
the dead slots; every operation keeps the JAX package's order and dtype, so
that the same candidates win.

It runs any model with the decode API (``encode``, ``init_carry``,
``decode_step``): a GRU carries ``c`` through unchanged, and ShowTell's
(B·W, 1) placeholder alphas ride along. It is plain PyTorch on the card as
on the CPU: the JAX package runs it in XLA, with no kernel (a whole-beam
kernel was measured slower there and deleted). ``make_scanned_beam_decoder``
decodes K stacked batches in one call, each as a single call would.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e9
# rank-only bonus on a finished beam's <pad> continuation: it must dominate
# |NEG_INF| so that no live or dead-slot candidate outranks a frozen beam
BONUS = -2.0 * NEG_INF


def top_w(keys: torch.Tensor, w: int):
    """(indices, values) of the ``w + 1`` largest entries of each row of
    ``keys`` (fewer where the row is shorter), largest first and, among
    equal keys, the lower index first; the first ``w`` are the selection."""
    values, indices = torch.sort(keys, dim=1, descending=True, stable=True)
    return indices[:, :w + 1], values[:, :w + 1]


def make_scanned_beam_decoder(model, max_length: int, beam_width: int = 5):
    """decode(betas (K, B, N), start_id, end_id) -> words (K, B, T) int32:
    the JAX ``make_scanned_beam_decoder``, K stacked batches a call, walked
    one by one as the JAX scan walks them (see
    ``greedy.make_scanned_greedy_decoder``)."""
    inner = make_beam_decoder(model, max_length, beam_width=beam_width)

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int, end_id: int):
        return torch.stack([inner(b, start_id, end_id)[0] for b in betas])

    return decode


def make_beam_decoder(model, max_length: int, beam_width: int = 5,
                      alpha: float = 0.7, pad_id: int = 0,
                      return_margins: bool = False):
    """decode(betas (B, ...), start_id, end_id) -> (best_tokens (B, T)
    int32, best_scores (B,), best_alphas (B, T, R), hist (B, W, T) int32,
    norm (B, W)).

    With ``return_margins`` also each row's deciding margin (B,): the
    smallest gap, over the steps, between the last selected key and the
    first one left out, and between the two best normalised scores. Below
    a few ulps of the scores, a decode that sums in another order may take
    other words there; a check tells such a near-tie from a fault by it."""
    W = beam_width

    @torch.inference_mode()
    def decode(betas: torch.Tensor, start_id: int, end_id: int):
        features = model.encode(betas)
        B, device, dtype = features.shape[0], features.device, features.dtype
        T = max_length

        feat_t = features.repeat_interleave(W, dim=0)        # (B*W, ...)
        h, c = model.init_carry(feat_t)
        tok = torch.full((B * W,), start_id, dtype=torch.long, device=device)
        # all beams start identical: only beam 0 is live at t = 0
        scores = torch.tensor([0.0] + [NEG_INF] * (W - 1), dtype=dtype,
                              device=device).repeat(B, 1)
        finished = torch.zeros(B, W, dtype=torch.bool, device=device)
        deadend = torch.zeros_like(finished)  # finished on the first loop step
        lengths = torch.zeros(B, W, dtype=torch.int32, device=device)
        hist = torch.full((B, W, T), pad_id, dtype=torch.int32,
                          device=device)
        ahist = None                          # (B, W, T, R) once R is known
        rows = torch.arange(B, device=device)
        margins = torch.full((B,), float("inf"), dtype=dtype, device=device)

        for t in range(T):
            h2, c2, logits, attn = model.decode_step(h, c, feat_t, tok)
            logp = torch.log_softmax(logits, dim=-1)
            V = logp.shape[-1]
            logp = logp.view(B, W, V)
            # finished beams may only emit <pad>, at zero cost
            pad_row = torch.full((V,), NEG_INF, dtype=logp.dtype,
                                 device=device)
            pad_row[pad_id] = 0.0
            logp = torch.where(finished[..., None], pad_row, logp)

            cand = scores[..., None] + logp                   # (B, W, V)
            bonus_row = torch.zeros(V, dtype=cand.dtype, device=device)
            bonus_row[pad_id] = BONUS
            keys = cand + finished[..., None].to(cand.dtype) * bonus_row
            top_idx, top_keys = top_w(keys.reshape(B, W * V), W)
            if top_idx.shape[1] > W:
                margins = torch.minimum(margins,
                                        top_keys[:, W - 1] - top_keys[:, W])
            top_idx = top_idx[:, :W]
            top_scores = cand.reshape(B, W * V).gather(1, top_idx)
            beam_src = top_idx // V                           # (B, W)
            new_tok = top_idx % V

            def pick(x):  # reorder per-beam state along the chosen sources
                x = x.reshape(B, W, -1)
                return x.gather(1, beam_src[..., None].expand(-1, -1,
                                                               x.shape[-1]))

            h = pick(h2).reshape(B * W, -1)
            c = pick(c2).reshape(B * W, -1)
            fin_src = finished.gather(1, beam_src)
            dead_src = deadend.gather(1, beam_src)
            len_src = lengths.gather(1, beam_src)
            # the reference's seed step never tests for <end>
            is_end = (new_tok == end_id) & (t > 0)
            finished = fin_src | is_end
            # a first-loop-step finish is recorded with score -inf
            deadend = dead_src | (is_end & ~fin_src & (t == 1))
            # the route length counts emitted non-<end> tokens
            lengths = len_src + (~fin_src & ~is_end).to(torch.int32)
            hist = hist.gather(1, beam_src[..., None].expand(-1, -1, T))
            hist[:, :, t] = torch.where(fin_src, pad_id, new_tok).to(
                torch.int32)
            # attn belongs to the pre-reorder beams: take the sources',
            # zero once a beam has finished
            R = attn.shape[-1]
            if ahist is None:
                ahist = torch.zeros(B, W, T, R, dtype=dtype, device=device)
            attn_b = attn.reshape(B, W, R).gather(
                1, beam_src[..., None].expand(-1, -1, R))
            ahist = ahist.gather(
                1, beam_src[:, :, None, None].expand(-1, -1, T, R))
            ahist[:, :, t, :] = torch.where(fin_src[..., None], 0.0, attn_b)
            tok = new_tok.reshape(-1)
            scores = top_scores

        norm = scores / torch.pow(lengths.clamp(min=1).to(scores.dtype),
                                  alpha)
        norm = torch.where(deadend, NEG_INF, norm)
        best = torch.argmax(norm, dim=1)
        out = (hist[rows, best], norm[rows, best], ahist[rows, best], hist,
               norm)
        if not return_margins:
            return out
        if W > 1:
            top2 = torch.topk(norm, 2, dim=1).values
            margins = torch.minimum(margins, top2[:, 0] - top2[:, 1])
        return out + (margins,)

    return decode
