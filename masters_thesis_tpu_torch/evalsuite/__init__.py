"""Caption metrics: the port's own copy of ``masters_thesis_tpu/evalsuite``
(BLEU, METEOR, ROUGE-L, CIDEr, SPICE-lite, the metric suite and GUSE
similarity), framework-free, with ``coco_adapter`` (COCO-format results and
annotations) and ``analysis`` (the post-hoc analyses behind ``analyze``)."""

from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption, postprocess_text
from masters_thesis_tpu_torch.evalsuite.bleu import corpus_bleu, sentence_bleu
from masters_thesis_tpu_torch.evalsuite.rouge import rouge_l
from masters_thesis_tpu_torch.evalsuite.cider import CiderScorer
from masters_thesis_tpu_torch.evalsuite.meteor import meteor_lite
from masters_thesis_tpu_torch.evalsuite.metric_suite import evaluate_captions

__all__ = [
    "ids_to_caption",
    "postprocess_text",
    "corpus_bleu",
    "sentence_bleu",
    "rouge_l",
    "CiderScorer",
    "meteor_lite",
    "evaluate_captions",
]
