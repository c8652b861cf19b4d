"""The benchmark's inputs, made from ``--seed``: the store's rows, the
captions, and the order in which the window asks for them.

One general generator for every cell: what differs between traffic mixes
is the data file under ``port_bench/traffic/``, what differs between
models is the configuration file. Sizes never depend on the seed (the
number of keys, the batch, the caption width); the seed picks values and
orders only, so every seed asks the program for the same amount of work.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from port_bench import reference

ROW_BLOCK = 256       # store rows a draw: one generator each, from the seed


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    text = repr((int(seed),) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def raw_rows(cfg: dict, seed: int, block: int, device) -> torch.Tensor:
    """The raw rows of store block ``block``, as the family draws them
    (``reference/<model>.py::draw_rows``)."""
    n = cfg["store"]["keys"]
    lo, hi = block * ROW_BLOCK, min(n, (block + 1) * ROW_BLOCK)
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, "rows", block))
    return reference.family(cfg).draw_rows(cfg, hi - lo, gen, device)


def n_blocks(cfg: dict) -> int:
    return -(-cfg["store"]["keys"] // ROW_BLOCK)


def rows_for(cfg: dict, seed: int, keys, device) -> torch.Tensor:
    """The raw rows of store rows ``keys``, drawn again block by block."""
    keys = np.asarray(keys, dtype=np.int64)
    width = reference.family(cfg).row_width(cfg)
    out = torch.empty(len(keys), width, device=device)
    for block in np.unique(keys // ROW_BLOCK):
        rows = raw_rows(cfg, seed, int(block), device)
        at = np.nonzero(keys // ROW_BLOCK == block)[0]
        out[torch.as_tensor(at, device=device)] = rows.index_select(
            0, torch.as_tensor(keys[at] - block * ROW_BLOCK, device=device))
    return out


def split(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(train keys, test keys) as store rows: the first ``train_keys`` rows
    train, the last ``test_keys`` are the shared test images."""
    s = cfg["store"]
    n = s["keys"]
    return np.arange(s["train_keys"]), np.arange(n - s["test_keys"], n)


def captions(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """(train keys x captions a key, T) int32 token ids: ``<start>``, a
    caption of ``caption_words`` words drawn from a Zipf law over the
    vocabulary's other ids, ``<end>``, then 0s. Caption c of train key k
    is row k * captions_per_key + c."""
    tok, T, V = cfg["tokens"], cfg["max_length"], cfg["vocab_size"]
    n = cfg["store"]["train_keys"] * cfg["store"]["captions_per_key"]
    rng = np.random.Generator(np.random.PCG64(subseed(seed, "captions")))
    lo, hi = traffic["caption_words"]
    first = max(tok.values()) + 1
    ranks = np.arange(1, V - first + 1, dtype=np.float64)
    p = ranks ** -traffic["zipf_s"]
    words = first + rng.choice(len(ranks), size=(n, hi), p=p / p.sum())
    lengths = rng.integers(lo, hi + 1, size=n)
    out = np.zeros((n, T), dtype=np.int32)
    out[:, 0] = tok["start"]
    cols = np.arange(hi)[None, :]
    out[:, 1:hi + 1] = np.where(cols < lengths[:, None], words, 0)
    out[np.arange(n), lengths + 1] = tok["end"]
    return out


def targets(tokens: np.ndarray) -> np.ndarray:
    """Next-token targets: tokens shifted left, the last column 0."""
    out = np.zeros_like(tokens)
    out[:, :-1] = tokens[:, 1:]
    return out


def check_batches(cfg: dict, batch: int, steps: int, seed: int) -> np.ndarray:
    """(steps, batch) caption rows of the first steps: in each step every
    row of a distinct train key, one of its captions, so no two rows of a
    batch repeat."""
    s = cfg["store"]
    rng = np.random.Generator(np.random.PCG64(subseed(seed, "check")))
    keys = np.stack([rng.permutation(s["train_keys"])[:batch]
                     for _ in range(steps)])
    cap = rng.integers(0, s["captions_per_key"], size=keys.shape)
    return keys * s["captions_per_key"] + cap


def epoch_batches(n_pairs: int, batch: int, n_steps: int, seed: int,
                  device) -> torch.Tensor:
    """(n_steps, batch) caption rows: epochs of a seeded permutation of
    all ``n_pairs``, cut into batches, the last partial batch dropped, as
    the trainer's pipeline draws them."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "epochs"))
    per_epoch = n_pairs // batch
    epochs = -(-n_steps // per_epoch)
    rows = [torch.randperm(n_pairs, generator=gen, device=device)
            [:per_epoch * batch].view(per_epoch, batch)
            for _ in range(epochs)]
    return torch.cat(rows)[:n_steps]


def request_batches(pool: np.ndarray, batch: int, n_batches: int, seed: int,
                    device) -> torch.Tensor:
    """(n_batches, batch) int64 store rows: each request ``batch`` distinct
    keys of ``pool``, drawn by the seed."""
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, "requests"))
    picks = torch.rand(n_batches, len(pool), generator=gen,
                       device=device).argsort(dim=1)[:, :batch]
    return torch.as_tensor(pool, device=device)[picks]
