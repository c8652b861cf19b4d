"""Caption stores and pretrained word-embedding tables.

The port's own copy of ``masters_thesis_tpu/data/captions.py``, with the
same names and meaning (``tests/test_torch_copies.py`` holds the two
together). Reference surfaces:
- per-key caption txt files ``KID{key}.txt`` with 5 lines, written by the
  offline pipeline (ian_code/nsd_get_data.py:262-278) and read by
  create_pairs (load_avg_betas.py:256);
- the shared annotations JSON ``modified_annotations_dictionary.json``
  (utils.py:35-95: image-id -> list of caption strings);
- GloVe embedding loading for the glove_NIC variant
  (DataLoaders/data_generator_guse.py:73-110: word->vec txt, synthetic
  one-hot-ish vectors for <start>/<end>, zeros for unknown).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from masters_thesis_tpu_torch.data.tokenizer import END, START, Tokenizer

_KID_RE = re.compile(r"KID(\d+)")


def load_captions_dir(captions_path: str, keys=None) -> dict[int, list[str]]:
    """Read KID{key}.txt files into {key: [caption, ...]}.

    Lines may be plain captions (load_avg_betas.py:259-264 layout) or the
    Flickr8k-style ``{beta_path}#{i}\\t{caption}`` lines that the session
    ingest stage writes (nsd_get_data.py:262-268); the path prefix is
    stripped so both feed the same tokenizer/pairs pipeline.
    """
    wanted = None if keys is None else {int(k) for k in keys}
    out: dict[int, list[str]] = {}
    # .txt regular files only, in sorted order: a bare KID substring match
    # read editor backups / stray binaries as caption files (or raised on a
    # KID-named subdirectory), with scandir order deciding which file won a
    # duplicated key
    for entry in sorted(os.scandir(captions_path), key=lambda e: e.name):
        if not entry.name.endswith(".txt") or not entry.is_file():
            continue
        m = _KID_RE.search(entry.name)
        if not m:
            continue
        key = int(m.group(1))
        if wanted is not None and key not in wanted:
            continue
        with open(entry.path) as f:
            out[key] = [
                line.rsplit("\t", 1)[-1]
                for line in f.read().splitlines()
                if line.strip()
            ]
    return out


def save_annotations_json(path: str, captions_by_key: dict[int, list[str]]) -> None:
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in captions_by_key.items()}, f)


def load_annotations_json(path: str) -> dict[int, list[str]]:
    with open(path) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


def build_glove_table(
    glove_txt: str, tokenizer: Tokenizer, dim: int, seed: int = 0
) -> np.ndarray:
    """(vocab_size, dim) table from a GloVe txt for the tokenizer's vocab.

    Words not in GloVe get zeros; <start>/<end> get the reference's synthetic
    basis vectors (first/last dim = 1, data_generator_guse.py:89-100).
    """
    vocab_size = (tokenizer.num_words or len(tokenizer.word_index)) + 1
    table = np.zeros((vocab_size, dim), np.float32)
    # stream-filter to the tokenizer vocab: glove.840B holds ~2.2M vectors
    # (~2.5 GB parsed) of which a 5k-vocab run needs ~5k
    wanted = set(tokenizer.word_index)
    vectors: dict[str, np.ndarray] = {}
    file_dim = None
    with open(glove_txt) as f:
        for line in f:
            word, _, rest = line.rstrip().partition(" ")
            parts = rest.split(" ")
            if file_dim is None and rest:
                file_dim = len(parts)
            if word not in wanted:
                continue
            if len(parts) != dim:
                continue
            vectors[word] = np.asarray(parts, np.float32)
    if not vectors:
        # an all-zeros table trains to completion with meaningless text
        # embeddings and no other symptom — refuse loudly. The usual cause
        # is a dimension mismatch (e.g. a 300-d glove.840B file against
        # embedding_text: 512), which skips every line above.
        raise ValueError(
            f"no tokenizer vocabulary word matched a {dim}-d vector in "
            f"{glove_txt!r}"
            + (f" (the file's vectors are {file_dim}-d — set embedding_text"
               f" to {file_dim} or convert the table)"
               if file_dim not in (None, dim) else "")
        )
    for word, idx in tokenizer.word_index.items():
        if idx >= vocab_size:
            continue
        if word == START:
            v = np.zeros(dim, np.float32)
            v[0] = 1.0
        elif word == END:
            v = np.zeros(dim, np.float32)
            v[-1] = 1.0
        else:
            v = vectors.get(word)
        if v is not None:
            table[idx] = v
    return table
