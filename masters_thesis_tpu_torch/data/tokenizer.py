"""Word tokenizer with exact Keras ``preprocessing.text.Tokenizer`` semantics.

The port's own copy of ``masters_thesis_tpu/data/tokenizer.py``, with the
same names and meaning (``tests/test_torch_copies.py`` holds the two
together), less what no part of the port calls yet: the Keras-json
persistence and ``sequences_to_texts`` come with ``from_run_dir`` (ROADMAP
M10).

The reference builds its vocabulary with
``tf.keras.preprocessing.text.Tokenizer(num_words=5000, oov_token='<unk>',
filters='!"#$%&()*+.,-/:;=?@[\\]^_`{|}~\\t\\n ')`` and then manually installs
``word_index['<pad>'] = 0`` (reference: AttemptFour/DataLoaders/load_avg_betas.py:187-191).
This module reimplements that behaviour bit-for-bit, so vocabularies built
here from the same corpus match the reference's ids.

Key Keras behaviours replicated:
- lowercasing, filter chars translated to the split char, empty tokens dropped;
- word ids assigned by descending count with stable (first-seen) tie order,
  ids starting at 1, oov token always id 1;
- ``texts_to_sequences`` maps ids ``>= num_words`` to the oov id.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

KERAS_FILTERS = '!"#$%&()*+.,-/:;=?@[\\]^_`{|}~\t\n '
PAD = "<pad>"
UNK = "<unk>"
START = "<start>"
END = "<end>"


def text_to_word_sequence(
    text: str, filters: str = KERAS_FILTERS, lower: bool = True, split: str = " "
) -> list[str]:
    if lower:
        text = text.lower()
    table = str.maketrans({c: split for c in filters})
    return [w for w in text.translate(table).split(split) if w]


class Tokenizer:
    """Keras-compatible word tokenizer."""

    def __init__(
        self,
        num_words: int | None = None,
        oov_token: str | None = UNK,
        filters: str = KERAS_FILTERS,
        lower: bool = True,
        split: str = " ",
    ):
        self.num_words = num_words
        self.oov_token = oov_token
        self.filters = filters
        self.lower = lower
        self.split = split
        self.word_counts: OrderedDict[str, int] = OrderedDict()
        self.word_index: dict[str, int] = {}
        self.index_word: dict[int, str] = {}

    # ---- fitting ----
    def fit_on_texts(self, texts) -> None:
        for text in texts:
            for w in text_to_word_sequence(text, self.filters, self.lower, self.split):
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        wcounts = sorted(self.word_counts.items(), key=lambda x: x[1], reverse=True)
        sorted_voc = [] if self.oov_token is None else [self.oov_token]
        sorted_voc.extend(w for w, _ in wcounts)
        self.word_index = dict(zip(sorted_voc, range(1, len(sorted_voc) + 1)))
        self.index_word = {i: w for w, i in self.word_index.items()}

    def install_pad(self) -> None:
        """word_index['<pad>'] = 0 as done in load_avg_betas.py:189-190."""
        self.word_index[PAD] = 0
        self.index_word[0] = PAD

    # ---- encoding / decoding ----
    def texts_to_sequences(self, texts) -> list[list[int]]:
        oov_i = self.word_index.get(self.oov_token) if self.oov_token else None
        out = []
        for text in texts:
            vect = []
            for w in text_to_word_sequence(text, self.filters, self.lower, self.split):
                i = self.word_index.get(w)
                if i is not None:
                    if self.num_words and i >= self.num_words:
                        if oov_i is not None:
                            vect.append(oov_i)
                    else:
                        vect.append(i)
                elif oov_i is not None:
                    vect.append(oov_i)
            out.append(vect)
        return out

    # ---- special ids ----
    @property
    def start_id(self) -> int:
        return self.word_index[START]

    @property
    def end_id(self) -> int:
        return self.word_index[END]


def pad_sequences(
    sequences,
    maxlen: int,
    dtype=np.int32,
    padding: str = "post",
    truncating: str = "post",
    value: int = 0,
) -> np.ndarray:
    """Keras ``pad_sequences`` with post pad/truncate defaults used by the
    reference (data_generator_guse.py:158)."""
    n = len(sequences)
    out = np.full((n, maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if not seq:
            continue
        if len(seq) > maxlen:
            seq = seq[:maxlen] if truncating == "post" else seq[-maxlen:]
        if padding == "post":
            out[i, : len(seq)] = seq
        else:
            out[i, -len(seq) :] = seq
    return out
