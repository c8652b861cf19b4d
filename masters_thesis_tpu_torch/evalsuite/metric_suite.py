"""Metric suite: the reference's pycocoevalcap surface in one call.

Reference flow (AttemptFour/metric_suit.py:60-109): decode token arrays to
text, collect the 5 ground-truth captions per key, run
BLEU-1..4 / METEOR / ROUGE_L / CIDEr / SPICE and return a score dict
(METEOR uses exact+stem stages, SPICE the rule-based chunker in spice.py —
the Java jars the reference shells out to are unavailable offline). Also exposes the
NLTK-style 8-weight BLEU table of evaluate.py:178-226.

The port's own copy of ``masters_thesis_tpu/evalsuite/metric_suite.py``, with
the same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

import numpy as np

from masters_thesis_tpu_torch.evalsuite.bleu import (
    WEIGHT_SETS,
    corpus_bleu,
    sentence_bleu,
)
from masters_thesis_tpu_torch.evalsuite.cider import CiderScorer
from masters_thesis_tpu_torch.evalsuite.meteor import corpus_meteor
from masters_thesis_tpu_torch.evalsuite.rouge import corpus_rouge_l
from masters_thesis_tpu_torch.evalsuite.spice import corpus_spice
from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption, postprocess_text


def evaluate_captions(candidates: list[str], references_list: list[list[str]],
                      meteor_synonyms=None, meteor_paraphrases=None) -> dict:
    """COCOEvalCap-style score dict from plain text captions.

    METEOR runs the jar's 1.5 parameterisation (exact+stem+synonym stages,
    micro-aggregated, plus the paraphrase stage when a phrase table is
    available) when a WordNet synonym table is present — pass a
    ``SynonymTable`` or point ``MTT_METEOR_SYNONYMS`` at the JSON produced by
    ``scripts/convert_wordnet_synonyms.py`` (paraphrases:
    ``MTT_METEOR_PARAPHRASES`` / ``scripts/convert_meteor_paraphrases.py``).
    Without one it falls back to exact+stem METEOR-2005, keyed
    ``METEOR_lite`` so jar-comparable and approximate numbers are never
    conflated.
    """
    from masters_thesis_tpu_torch.evalsuite.meteor import (
        ParaphraseTable,
        SynonymTable,
    )

    cand_tok = [c.split() for c in candidates]
    refs_tok = [[r.split() for r in refs] for refs in references_list]

    if meteor_synonyms is None:
        meteor_synonyms = SynonymTable.from_env()
    if meteor_paraphrases is None:
        meteor_paraphrases = ParaphraseTable.from_env()
    if meteor_synonyms is not None:
        meteor_key = "METEOR"
        meteor = corpus_meteor(refs_tok, cand_tok, synonyms=meteor_synonyms,
                               params="1.5", paraphrases=meteor_paraphrases)
    else:
        meteor_key = "METEOR_lite"
        meteor = corpus_meteor(refs_tok, cand_tok)

    bleu = corpus_bleu(refs_tok, cand_tok, max_n=4)
    cider, _ = CiderScorer().compute(refs_tok, cand_tok)
    return {
        "Bleu_1": bleu[0],
        "Bleu_2": bleu[1],
        "Bleu_3": bleu[2],
        "Bleu_4": bleu[3],
        meteor_key: meteor,
        "ROUGE_L": corpus_rouge_l(refs_tok, cand_tok),
        "CIDEr": cider,
        # Java SPICE (scene-graph F1) is approximated by the rule-based
        # chunker in spice.py; keyed distinctly so nobody mistakes it for
        # the jar's numbers. Tuple slots match on synset overlap (the Java
        # scorer's similarTo semantics): with a real WordNet table when one
        # is configured, else the bundled curated caption-domain table
        # (irregular plurals + common COCO pairs — reproduces the
        # hand-derived golden set exactly, tests/test_spice_goldens.py).
        "SPICE_lite": corpus_spice(
            refs_tok, cand_tok,
            synonyms=(meteor_synonyms if meteor_synonyms is not None
                      else SynonymTable.default_caption_table())),
    }


def evaluate_token_outputs(
    output_ids: np.ndarray,
    keys,
    captions_by_key: dict,
    tokenizer,
) -> dict:
    """From decoder token output + NSD keys to the score dict
    (metric_suit.py main path)."""
    candidates = [ids_to_caption(row, tokenizer) for row in np.asarray(output_ids)]
    references = [clean_references(captions_by_key[int(k)]) for k in keys]
    return evaluate_captions(candidates, references)


def clean_references(refs: list[str]) -> list[str]:
    """Reference-text normalisation shared by EVERY scoring path: raw COCO
    captions ('A dog runs fast.') never match lowercased punctuation-free
    tokenizer output, so scores computed against uncleaned references are
    systematically depressed and non-comparable."""
    return [postprocess_text(_clean(c)) for c in refs]


def _clean(line: str) -> str:
    from masters_thesis_tpu_torch.data.pairs import clean_caption

    # strip <start>/<end> wrapping for reference texts
    return " ".join(clean_caption(line).split()[1:-1])


def bleu_table(candidates: list[str], references_list: list[list[str]]) -> dict:
    """The 8 BLEU variants of evaluate.py:178-226 (sentence-level means)."""
    cand_tok = [c.split() for c in candidates]
    refs_tok = [[r.split() for r in refs] for refs in references_list]
    out = {}
    for name, weights in WEIGHT_SETS.items():
        vals = [
            sentence_bleu(refs, hyp, weights, smoothing="method1")
            for refs, hyp in zip(refs_tok, cand_tok)
        ]
        out[name] = float(np.mean(vals)) if vals else 0.0
    return out
