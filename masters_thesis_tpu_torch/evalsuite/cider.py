"""CIDEr (Vedantam et al. 2015), pycocoevalcap semantics.

TF-IDF weighted n-gram (1..4) cosine similarity between candidate and each
reference, averaged over refs and n, with a length gaussian penalty
(sigma=6) and a x10 scale. Document frequencies come from the reference
corpus of the eval set itself (CIDEr-D style clipping of candidate counts).
Used by the reference through pycocoevalcap in metric_suit.py:88-109.

The port's own copy of ``masters_thesis_tpu/evalsuite/cider.py``, with the
same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

import math
from collections import defaultdict

from masters_thesis_tpu_torch.evalsuite.bleu import _ngrams


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def _counts(self, tokens):
        return [_ngrams(tokens, k + 1) for k in range(self.n)]

    def compute(self, references_list, hypotheses) -> tuple[float, list[float]]:
        """Returns (corpus score, per-sentence scores)."""
        assert len(references_list) == len(hypotheses)
        # document frequency over reference sets
        df = [defaultdict(float) for _ in range(self.n)]
        n_docs = len(references_list)
        ref_counts_all = []
        for refs in references_list:
            counts = [self._counts(list(r)) for r in refs]
            ref_counts_all.append(counts)
            seen = [set() for _ in range(self.n)]
            for c in counts:
                for k in range(self.n):
                    seen[k].update(c[k].keys())
            for k in range(self.n):
                for ng in seen[k]:
                    df[k][ng] += 1.0

        log_ndocs = math.log(max(n_docs, 1))

        def vec(counts):
            """tf-idf vector + norm per n."""
            vecs, norms = [], []
            for k in range(self.n):
                v = {}
                norm = 0.0
                for ng, tf in counts[k].items():
                    idf = log_ndocs - math.log(max(df[k][ng], 1.0))
                    w = tf * idf
                    v[ng] = w
                    norm += w * w
                vecs.append(v)
                norms.append(math.sqrt(norm))
            return vecs, norms

        scores = []
        for refs, hyp, ref_counts in zip(
            references_list, hypotheses, ref_counts_all
        ):
            hyp = list(hyp)
            hvec, hnorm = vec(self._counts(hyp))
            score_n = [0.0] * self.n
            for ref, rcounts in zip(refs, ref_counts):
                ref = list(ref)
                rvec, rnorm = vec(rcounts)
                delta = len(hyp) - len(ref)
                len_pen = math.exp(-(delta**2) / (2 * self.sigma**2))
                for k in range(self.n):
                    # CIDEr-D: clip candidate tf-idf by reference tf-idf
                    dot = sum(
                        min(w, rvec[k].get(ng, 0.0)) * rvec[k].get(ng, 0.0)
                        for ng, w in hvec[k].items()
                    )
                    if hnorm[k] > 0 and rnorm[k] > 0:
                        score_n[k] += dot / (hnorm[k] * rnorm[k]) * len_pen
            n_refs = max(len(refs), 1)
            s = sum(score_n) / self.n / n_refs * 10.0
            scores.append(s)
        corpus = sum(scores) / len(scores) if scores else 0.0
        return corpus, scores
