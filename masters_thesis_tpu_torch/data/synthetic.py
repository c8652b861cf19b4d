"""Synthetic fixtures: fake betas with known Glasser-like group structure, a
tiny caption corpus, and key splits.

The port's own copy of the functions of ``masters_thesis_tpu/data/synthetic.py``
that the port uses, with the same names and meaning
(``tests/test_torch_copies.py`` holds them together), the structured and
compositional modes included. One difference: ``synthetic_dataset``
returns the betas as a host array with their keys, and the caller builds
the port's ``data.store.ArrayStore`` on the device it wants.
"""

from __future__ import annotations

import numpy as np

from masters_thesis_tpu_torch.data.pairs import create_pairs
from masters_thesis_tpu_torch.data.splits import KeySplit
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

_WORDS = (
    "a the man woman dog cat ball red blue small large sitting standing "
    "running holding on in near table chair park beach street food plate "
    "group person people tree sky water grass playing eating walking looking"
).split()


def synthetic_groups(n_voxels: int = 512, n_groups: int = 8, seed: int = 0):
    """Random contiguous-ish voxel index groups with ragged sizes (the Glasser
    atlas yields 360 ragged groups; load_avg_betas.py:59-94)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    cuts = np.sort(rng.choice(np.arange(1, n_voxels), size=n_groups - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n_voxels]])
    return [np.arange(bounds[i], bounds[i + 1]) for i in range(n_groups)]


def synthetic_captions(keys, n_caps: int = 5, seed: int = 0):
    rng = np.random.Generator(np.random.PCG64(seed))
    caps = {}
    for key in keys:
        lines = []
        for _ in range(n_caps):
            n = int(rng.integers(4, 10))
            lines.append(" ".join(rng.choice(_WORDS, size=n)) + ".")
        caps[int(key)] = lines
    return caps


# ---- structured mode: betas ENCODE the caption content -------------------
# The random mode above has no betas->caption mapping, so decoded caption
# metrics on held-out keys cannot rise above the corpus prior — fine for
# plumbing tests, useless as convergence evidence. Structured mode draws
# latent factors (entity, attribute, verb, place) per key, renders the five
# captions from factor-sharing templates (references agree on content words
# like real COCO captions do), and emits betas as the sum of per-factor
# voxel patterns plus noise — a generalising betas->semantics mapping the
# model can actually learn, which is the real task's shape (NSD betas carry
# the image semantics; SURVEY.md §0).

_ENTITIES = "man woman dog cat bird boy girl horse".split()
_ATTRS = "red blue small large young old black white".split()
_VERBS = ("sitting standing running walking playing eating sleeping "
          "jumping").split()
_PLACES = "park beach street field kitchen table grass water".split()
_FACTOR_SLOTS = (_ENTITIES, _ATTRS, _VERBS, _PLACES)

_TEMPLATES = (
    "a {a} {e} {v} in the {p}.",
    "the {a} {e} is {v} in the {p}.",
    "a {e} {v} in the {p}.",
    "the {e} {v} near the {p}.",
    "a {a} {e} in the {p}.",
)


def combo_held_out(factors: np.ndarray) -> np.ndarray:
    """Deterministic partition of the factor-combination space: ~1/4 of all
    entity x attribute x verb x place tuples are 'held out'. (n, 4) -> (n,)
    bool."""
    f = np.asarray(factors)
    return (f[:, 0] * 7 + f[:, 1] * 5 + f[:, 2] * 3 + f[:, 3]) % 4 == 0


def synthetic_factors(keys, seed: int = 0, holdout: str | None = None):
    """(n_keys, 4) int factor indices: entity, attribute, verb, place.

    ``holdout`` (round-5 compositional split — VERDICT r4 item 4: the
    fully-solvable structured task saturates val BLEU-4 at 1.0 by epoch 20,
    so the curve can't discriminate models):
      None      — iid combinations (the original structured mode)
      'seen'    — rejection-sample combinations from the ~3/4 'seen' region
      'unseen'  — combinations ONLY from the held-out ~1/4: every
                  (e, a, v, p) tuple is novel, so a decoder must compose
                  factor patterns it never saw together — the ceiling sits
                  genuinely below 1.0
    """
    rng = np.random.Generator(np.random.PCG64(seed + 101))
    draws = np.stack(
        [rng.integers(0, len(slot), size=len(keys))
         for slot in _FACTOR_SLOTS], axis=1)
    if holdout is None:
        return draws
    assert holdout in ("seen", "unseen")
    want_held = holdout == "unseen"
    for row in range(len(draws)):
        while combo_held_out(draws[row:row + 1])[0] != want_held:
            draws[row] = [rng.integers(0, len(slot))
                          for slot in _FACTOR_SLOTS]
    return draws


def structured_captions(keys, factors, n_caps: int = 5):
    if n_caps > len(_TEMPLATES):
        # the random mode honors any n_caps; silently capping here would
        # hand reference-count-sensitive metrics (CIDEr consensus, BLEU
        # closest-ref) different denominators between the two modes
        raise ValueError(
            f"structured synthetic data renders at most {len(_TEMPLATES)} "
            f"captions per key (template variants); got n_caps={n_caps}")
    caps = {}
    for row, key in enumerate(keys):
        e, a, v, p = (slot[factors[row, i]]
                      for i, slot in enumerate(_FACTOR_SLOTS))
        lines = [t.format(e=e, a=a, v=v, p=p) for t in _TEMPLATES[:n_caps]]
        caps[int(key)] = lines
    return caps


def structured_betas(factors, n_voxels: int, seed: int = 0,
                     noise: float = 0.5, ambiguity: float = 0.0):
    """betas = sum of the key's per-factor voxel patterns + N(0, noise).

    ``ambiguity`` (compositional-benchmark mode, round 5): with this
    probability per (key, factor), a DISTRACTOR value's pattern is added at
    EQUAL amplitude — the betas then carry two equally-strong candidates
    for that factor and the caption is genuinely underdetermined, like a
    noisy single-trial scan. Independent per-voxel noise alone cannot cap
    decodability (it averages out over 327k voxels: the first compositional
    run saturated val BLEU-4 at 1.0); equal-amplitude ambiguity caps the
    ceiling DETERMINISTICALLY below 1.0 — an ideal decoder resolves a coin
    flip on ambiguous slots — while still ranking models by how many
    unambiguous slots they decode."""
    rng = np.random.Generator(np.random.PCG64(seed + 202))
    patterns = [
        rng.standard_normal((len(slot), n_voxels)).astype(np.float32)
        for slot in _FACTOR_SLOTS
    ]
    clean = sum(
        patterns[i][factors[:, i]] for i in range(len(_FACTOR_SLOTS))
    )
    if ambiguity > 0.0:
        arng = np.random.Generator(np.random.PCG64(seed + 303))
        for i, slot in enumerate(_FACTOR_SLOTS):
            hit = arng.random(len(factors)) < ambiguity
            # distractor uniformly among the OTHER values of this factor
            shift = arng.integers(1, len(slot), size=len(factors))
            distract = (factors[:, i] + shift) % len(slot)
            clean = clean + (hit[:, None].astype(np.float32)
                             * patterns[i][distract])
    out = clean / np.sqrt(len(_FACTOR_SLOTS))
    out += noise * rng.standard_normal(out.shape).astype(np.float32)
    return out.astype(np.float32)


def synthetic_dataset(
    n_keys: int = 32,
    n_voxels: int = 512,
    n_groups: int = 8,
    n_caps: int = 5,
    top_k: int = 60,
    seed: int = 0,
    structured: bool | str = False,
):
    """Returns (split, pairs_by_split, tokenizer, betas, keys, groups):
    ``betas`` (n_keys, n_voxels) float32 on the host, row i of key
    ``keys[i]``; the other items as the JAX package's ``synthetic_dataset``
    returns them, whose store holds the same rows under the same keys.

    ``structured=True`` (or ``"structured"``): betas encode the captions'
    latent factors (see the structured-mode block above) so held-out
    caption metrics can genuinely improve with training;
    ``"compositional"`` also holds the val/test keys' factor combinations
    out of training; False keeps the independent-noise fixtures."""
    rng = np.random.Generator(np.random.PCG64(seed))
    keys = np.arange(1, n_keys + 1, dtype=np.int64)
    n_tr = int(0.7 * n_keys)
    n_va = int(0.15 * n_keys) or 1
    split = KeySplit(
        train=keys[:n_tr], val=keys[n_tr : n_tr + n_va], test=keys[n_tr + n_va :]
    )
    if structured:
        if structured == "compositional":
            # held-out-composition split: train keys draw from the 'seen'
            # 3/4 of factor space, val/test keys ONLY from the held-out
            # 1/4 — unseen (entity, attribute, verb, place) combinations,
            # so val caption metrics measure compositional generalisation
            # and plateau below the 1.0 ceiling (keys order is
            # train ++ val ++ test, matching the split above)
            n_rest = len(keys) - n_tr
            factors = np.concatenate([
                synthetic_factors(keys[:n_tr], seed=seed, holdout="seen"),
                synthetic_factors(keys[n_tr:], seed=seed + 1,
                                  holdout="unseen"),
            ]) if n_rest else synthetic_factors(keys, seed=seed,
                                                holdout="seen")
        else:
            factors = synthetic_factors(keys, seed=seed)
        caps = structured_captions(keys, factors, n_caps=n_caps)
        betas = structured_betas(
            factors, n_voxels, seed=seed,
            # compositional benchmark: half the (key, factor) slots carry an
            # equal-amplitude distractor — sub-1.0 ceiling (see
            # structured_betas)
            ambiguity=0.5 if structured == "compositional" else 0.0)
    else:
        caps = synthetic_captions(keys, n_caps=n_caps, seed=seed)
        betas = rng.standard_normal((n_keys, n_voxels)).astype(np.float32)
    pairs = {
        name: create_pairs(getattr(split, name), caps)
        for name in ("train", "val", "test")
    }

    tok = Tokenizer(num_words=top_k)
    tok.fit_on_texts([p[1] for p in pairs["train"] + pairs["val"]])
    tok.install_pad()

    groups = synthetic_groups(n_voxels, n_groups, seed=seed)
    return split, pairs, tok, betas, keys, groups
