"""(key, caption) pair construction and caption-side encoding.

Mirrors the reference's pair builder (AttemptFour/DataLoaders/load_avg_betas.py:236-270)
and the per-batch tokenise/pad/shift done by its generator
(AttemptFour/DataLoaders/data_generator_guse.py:156-163) — except that here
captions are tokenised ONCE up front into dense int32 arrays (the reference
re-tokenises every batch on the host, a major input-pipeline cost).

The port's own copy of ``masters_thesis_tpu/data/pairs.py``, with the same
names and meaning (``tests/test_torch_copies.py`` holds the two together).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from masters_thesis_tpu_torch.data.tokenizer import (
    END,
    START,
    Tokenizer,
    pad_sequences,
)


def clean_caption(line: str) -> str:
    """Reference caption cleanup: '.'/',' → space, strip, lower, wrap with
    <start>/<end> (load_avg_betas.py:260-264)."""
    cap = line.replace(".", " ").replace(",", " ").strip().split(" ")
    cap = [w.lower() for w in cap]
    return " ".join([START] + cap + [END])


def create_pairs(keys, captions_by_key, subject: str = "2", single: bool = False):
    """Build (key, caption, cid, count, subject) tuples.

    ``captions_by_key`` maps key -> list of raw caption strings (typically 5,
    as written by the offline preprocessing; see ian_code/nsd_get_data.py:262-278).
    Mirrors load_avg_betas.create_pairs (:236-270).
    """
    pairs = []
    for count, key in enumerate(keys):
        for cid, line in enumerate(captions_by_key[key]):
            pairs.append((key, clean_caption(line), cid, count, subject))
            if single:
                break
    return pairs


@dataclass
class EncodedPairs:
    """Device-friendly encoding of a pair list.

    keys:      (N,) int64 NSD keys
    tokens:    (N, max_len) int32 — padded input token ids
    subjects:  (N,) int32 — subject index (for multi-subject batching)
    """

    keys: np.ndarray
    tokens: np.ndarray
    subjects: np.ndarray

    def __len__(self) -> int:
        return len(self.keys)


def encode_pairs(
    pairs, tokenizer: Tokenizer, max_len: int, subject_ids: dict[str, int] | None = None
) -> EncodedPairs:
    """Tokenise + pad all captions once (vs per-batch in the reference)."""
    caps = [p[1] for p in pairs]
    seqs = tokenizer.texts_to_sequences(caps)
    tokens = pad_sequences(seqs, maxlen=max_len)
    keys = np.asarray([int(p[0]) for p in pairs], dtype=np.int64)
    if subject_ids is None:
        # auto-map the distinct subject labels carried on the pair tuples
        # (sorted -> 0..n-1; a single-subject list stays all-zero as before)
        distinct = sorted({str(p[4]) for p in pairs})
        subject_ids = {s: i for i, s in enumerate(distinct)}
    subjects = np.asarray([subject_ids[str(p[4])] for p in pairs], dtype=np.int32)
    return EncodedPairs(keys=keys, tokens=tokens, subjects=subjects)


def shift_target(tokens: np.ndarray) -> np.ndarray:
    """target[:, :-1] = tokens[:, 1:]; last column 0
    (data_generator_guse.py:161-162). Returned as int ids — the one-hot of the
    reference (:163) is fused into the loss on device instead."""
    target = np.zeros_like(tokens)
    target[:, :-1] = tokens[:, 1:]
    return target
