"""ROUGE-L (LCS F-measure, beta=1.2), pycocoevalcap semantics:
per candidate take the max precision and max recall over references, then
F = ((1+b^2)PR)/(R+b^2P). (Used by the reference's metric_suit.py via
pycocoevalcap; reimplemented from the Lin 2004 definition.)

The port's own copy of ``masters_thesis_tpu/evalsuite/rouge.py``. It keeps
the pure-Python LCS only, and sums the corpus score in candidate order, one
addition at a time, as the JAX package's native helper (host code) does:
Python's ``sum`` of floats compensates its rounding since 3.12, which moves
the last bit.
"""

from __future__ import annotations


def _lcs_len(a, b) -> int:
    if not a or not b:
        return 0
    # O(len(a)*len(b)) DP with two rows
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(references, hypothesis, beta: float = 1.2) -> float:
    hyp = list(hypothesis)
    prec, rec = [], []
    for ref in references:
        ref = list(ref)
        lcs = _lcs_len(ref, hyp)
        prec.append(lcs / len(hyp) if hyp else 0.0)
        rec.append(lcs / len(ref) if ref else 0.0)
    p, r = max(prec, default=0.0), max(rec, default=0.0)
    if p == 0 or r == 0:
        return 0.0
    return ((1 + beta**2) * p * r) / (r + beta**2 * p)


def corpus_rouge_l(references_list, hypotheses, beta: float = 1.2) -> float:
    if not hypotheses:
        return 0.0
    total = 0.0
    for refs, hyp in zip(references_list, hypotheses):
        total += rouge_l(refs, hyp, beta)
    return total / len(hypotheses)

