"""BLEU: sentence-level (NLTK semantics incl. smoothing method2) and
corpus-level (pycocoevalcap-style).

The reference scores BLEU three ways (SURVEY.md §2): NLTK ``sentence_bleu``
with 8 weight sets (AttemptFour/evaluate.py:178-226), the Cython batch kernel
(CNN_RNN/cython/cython_functions.pyx:24-50, NLTK method2 smoothing), and
pycocoevalcap corpus BLEU (metric_suit.py:88-109). All three are implemented
here from their published definitions (Papineni et al. 2002; Chen & Cherry
2014 smoothing).

The port's own copy of ``masters_thesis_tpu/evalsuite/bleu.py``, with the
same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

import math
from collections import Counter

# the 8 weight sets of evaluate.py: individual 1..4-gram + cumulative 1..4
WEIGHT_SETS = {
    "BLEU-1": (1.0, 0.0, 0.0, 0.0),
    "BLEU-2": (0.0, 1.0, 0.0, 0.0),
    "BLEU-3": (0.0, 0.0, 1.0, 0.0),
    "BLEU-4": (0.0, 0.0, 0.0, 1.0),
    "Cumulative-1": (1.0, 0.0, 0.0, 0.0),
    "Cumulative-2": (0.5, 0.5, 0.0, 0.0),
    "Cumulative-3": (1 / 3, 1 / 3, 1 / 3, 0.0),
    "Cumulative-4": (0.25, 0.25, 0.25, 0.25),
}


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def modified_precision(references, hypothesis, n):
    """(clipped matches, total hyp ngrams) for order n."""
    hyp_counts = _ngrams(hypothesis, n)
    if not hyp_counts:
        return 0, 0
    max_ref = Counter()
    for ref in references:
        for ng, cnt in _ngrams(ref, n).items():
            if cnt > max_ref[ng]:
                max_ref[ng] = cnt
    clipped = sum(min(cnt, max_ref[ng]) for ng, cnt in hyp_counts.items())
    return clipped, sum(hyp_counts.values())


def closest_ref_length(references, hyp_len):
    return min(
        (len(r) for r in references),
        key=lambda rl: (abs(rl - hyp_len), rl),
    )


def brevity_penalty(ref_len, hyp_len):
    if hyp_len > ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - ref_len / hyp_len)


def sentence_bleu(references, hypothesis, weights=(0.25,) * 4,
                  smoothing: str = "none"):
    """NLTK-compatible sentence BLEU.

    smoothing: 'none' (raw, 0 on any zero precision), 'method1' (epsilon on
    zero numerators), 'method2' (add 1 to num and denom for n>1 — what the
    Cython kernel used).
    """
    references = [list(r) for r in references]
    hypothesis = list(hypothesis)
    hyp_len = len(hypothesis)
    ref_len = closest_ref_length(references, hyp_len) if references else 0
    bp = brevity_penalty(ref_len, hyp_len)

    s = 0.0
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        num, den = modified_precision(references, hypothesis, i + 1)
        den = max(den, 1)  # NLTK clamps the denominator before smoothing
        if smoothing == "method2" and i > 0:
            num, den = num + 1, den + 1
        if num == 0:
            if smoothing == "method1":
                num = 0.1
            else:
                return 0.0
        s += w * math.log(num / den)
    return bp * math.exp(s)


def corpus_bleu(references_list, hypotheses, max_n: int = 4):
    """Corpus BLEU-1..N (pycocoevalcap semantics: pooled clipped counts,
    closest-ref brevity penalty, 'tiny' smoothing on the ratio).

    Returns list [BLEU_1, ..., BLEU_N].
    """
    tiny, small = 1e-15, 1e-9
    nums = [0] * max_n
    dens = [0] * max_n
    hyp_total, ref_total = 0, 0
    for refs, hyp in zip(references_list, hypotheses):
        refs = [list(r) for r in refs]
        hyp = list(hyp)
        hyp_total += len(hyp)
        ref_total += closest_ref_length(refs, len(hyp)) if refs else 0
        for n in range(max_n):
            num, den = modified_precision(refs, hyp, n + 1)
            nums[n] += num
            dens[n] += den

    ratio = hyp_total / (ref_total + tiny)
    bp = 1.0 if ratio > 1.0 else math.exp(1 - 1 / (ratio + tiny))
    scores = []
    acc = 1.0
    for n in range(max_n):
        p = (nums[n] + tiny) / (dens[n] + small)
        acc *= p
        scores.append(acc ** (1.0 / (n + 1)) * bp)
    return scores


def batch_sentence_bleu(references_list, hypotheses, weights=(0.25,) * 4,
                        smoothing: str = "method2") -> float:
    """Mean sentence BLEU over a batch — python fallback for the native
    kernel (see native/textmetrics.cpp)."""
    if not hypotheses:
        return 0.0
    total = sum(
        sentence_bleu(refs, hyp, weights, smoothing)
        for refs, hyp in zip(references_list, hypotheses)
    )
    return total / len(hypotheses)
