"""Token-id → caption text post-processing.

The port's own copy of ``ids_to_caption`` from
``masters_thesis_tpu/evalsuite/tokens.py``, with the same meaning: truncate
at the first ``<end>`` (soloist/evaluate.py:89-98; CNN_RNN cython kernel
zeroes everything past ``<end>``, cython_functions.pyx:40-43) and drop
``<pad>``/``<start>``.
"""

from __future__ import annotations

import numpy as np

from masters_thesis_tpu_torch.data.tokenizer import END, PAD, START, Tokenizer


def ids_to_caption(ids, tokenizer: Tokenizer) -> str:
    """Decode one id sequence to text, truncated at <end>."""
    words = []
    for i in np.asarray(ids).reshape(-1).tolist():
        w = tokenizer.index_word.get(int(i))
        if w is None:
            continue
        if w == END:
            break
        if w in (PAD, START):
            continue
        words.append(w)
    return " ".join(words)
