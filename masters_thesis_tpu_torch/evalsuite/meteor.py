"""METEOR with exact + stem + WordNet-synonym stages, 2005 or 1.5 scoring.

The reference scores captions with pycocoevalcap's METEOR-1.5 jar
(AttemptFour/metric_suit.py:88-109), which aligns unigrams in four stages
(exact, stem, synonym, paraphrase) and scores with the tuned English
parameters. This module implements:

- exact + Porter-stem stages natively (``stem.py``);
- the WordNet synonym stage from a bundled synonym table (two words match
  when their synset-id sets intersect). The table is a JSON mapping
  ``word -> [synset ids]`` produced offline by
  ``scripts/convert_wordnet_synonyms.py`` (WordNet data is not in this
  zero-egress image); point ``MTT_METEOR_SYNONYMS`` at it or pass a
  ``SynonymTable``;
- both scoring parameterisations:
  * ``params="2005"`` (Banerjee & Lavie): F = 10PR/(R+9P),
    penalty = 0.5*(chunks/m)^3 — the original formula, equal stage weights;
  * ``params="1.5"`` (Denkowski & Lavie 2014, the jar's English defaults):
    alpha=0.85 beta=0.2 gamma=0.6 delta=0.75, stage weights
    exact 1.0 / stem 0.6 / synonym 0.8, content/function word weighting,
    and corpus scores micro-aggregated over segment statistics like the
    jar's final EVAL line (not a mean of segment scores).

- the paraphrase stage from a bundled phrase table (``ParaphraseTable``,
  built offline from the jar's paraphrase-en.gz by
  ``scripts/convert_meteor_paraphrases.py``; point ``MTT_METEOR_PARAPHRASES``
  at the JSON). Unmatched word spans match when the table holds the phrase
  pair in either direction, weighted 0.6 like the jar.

Alignment search matches each parameterisation's published system:

- ``params="2005"`` aligns greedy-in-order (first available reference
  occurrence per hypothesis word, stage by stage) — this reproduces the
  Banerjee & Lavie 2005 worked examples exactly (pinned in
  tests/test_meteor_goldens.py against the published numbers and the
  independent NLTK implementation);
- ``params="1.5"`` uses the jar's alignment search: collect ALL candidate
  matches across stages, then beam-search (width 40, the jar's default) for
  the one-to-one alignment that maximises total matched words, breaking
  ties by fewest chunks, then smallest total start-position distance
  (Aligner.resolve in the Meteor 1.5 source; Denkowski & Lavie 2014 §2).

- the function-word list for 1.5's delta weighting is a DATA FILE
  (``meteor_function_words_en.txt`` bundled next to this module; override
  with ``MTT_METEOR_FUNCTION_WORDS``, e.g. the jar's own
  ``function/en.words`` extracted by
  ``scripts/convert_meteor_function_words.py`` for bit-exact membership —
  the same offline-data pattern as the synonym/paraphrase tables). Every
  scoring entry point also accepts an explicit ``function_words`` set;
  the delta-weighting math itself is pinned by hand-derived goldens in
  tests/test_meteor_goldens.py.

The port's own copy of ``masters_thesis_tpu/evalsuite/meteor.py``, with the
same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

import json
import os

from masters_thesis_tpu_torch.evalsuite.stem import porter_stem

_FUNCTION_WORDS_ENV = "MTT_METEOR_FUNCTION_WORDS"


def _function_words_path() -> str:
    """$MTT_METEOR_FUNCTION_WORDS, else the bundled list — the ONE place
    the default resolves (load_function_words and the lazy cache share it)."""
    return os.environ.get(_FUNCTION_WORDS_ENV) or os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "meteor_function_words_en.txt",
    )


def load_function_words(path: str | None = None) -> frozenset:
    """Function words for METEOR-1.5's delta weighting, one per line,
    '#' comments ignored. Default: $MTT_METEOR_FUNCTION_WORDS, else the
    bundled closed-class English inventory (see the data file's header
    for the derivation and the jar-extraction route)."""
    if path is None:
        path = _function_words_path()
    words = []
    with open(path) as f:
        for line in f:
            w = line.strip()
            if w and not w.startswith("#"):
                words.append(w.lower())
    return frozenset(words)


# lazy, cached per resolved path: importing the evalsuite must not fail on
# a bad MTT_METEOR_FUNCTION_WORDS (the list only matters to 1.5 delta
# weighting), and re-pointing the env var between scoring calls is honored
_function_words_cache: dict[str, frozenset] = {}


def default_function_words() -> frozenset:
    path = _function_words_path()
    if path not in _function_words_cache:
        _function_words_cache[path] = load_function_words(path)
    return _function_words_cache[path]

_DEFAULT_TABLE_ENV = "MTT_METEOR_SYNONYMS"
_PARAPHRASE_TABLE_ENV = "MTT_METEOR_PARAPHRASES"


class SynonymTable:
    """word -> frozenset of WordNet synset ids; words match when the sets
    intersect (the jar's synonymy module semantics)."""

    def __init__(self, groups: dict[str, list]):
        self._sets = {w: frozenset(ids) for w, ids in groups.items()}

    def synsets(self, word: str) -> frozenset:
        return self._sets.get(word, frozenset())

    def __len__(self) -> int:
        return len(self._sets)

    @classmethod
    def load(cls, path: str) -> "SynonymTable":
        with open(path) as f:
            groups = json.load(f)
        # "__provenance__"-style metadata keys are not vocabulary
        return cls({w: ids for w, ids in groups.items()
                    if not w.startswith("__")})

    @classmethod
    def from_env(cls) -> "SynonymTable | None":
        path = os.environ.get(_DEFAULT_TABLE_ENV)
        if path and os.path.exists(path):
            return cls.load(path)
        return None

    _default_caption: "SynonymTable | None" = None

    @classmethod
    def default_caption_table(cls) -> "SynonymTable":
        """The bundled curated caption-domain table
        (``caption_synonyms_en.json``: irregular plurals + common COCO
        same-object pairs; see the file's provenance header). Used by the
        SPICE_lite slot matcher when no real WordNet table is configured —
        NOT by METEOR, whose 1.5 parameters are tuned against full-WordNet
        synonym coverage (a partial table would shift its stage statistics
        unpredictably, so METEOR's synonym stage stays opt-in via
        ``MTT_METEOR_SYNONYMS``)."""
        if cls._default_caption is None:
            cls._default_caption = cls.load(os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "caption_synonyms_en.json"))
        return cls._default_caption


class ParaphraseTable:
    """phrase -> set of paraphrase phrases; spans match when either
    direction holds (the jar's paraphrase module looks the pair up in a
    symmetric phrase DB built from paraphrase-en.gz)."""

    def __init__(self, mapping: dict[str, list]):
        self._map = {p: frozenset(alts) for p, alts in mapping.items()}
        self.max_words = max(
            (len(p.split()) for p in self._map), default=1)
        for alts in self._map.values():
            for a in alts:
                self.max_words = max(self.max_words, len(a.split()))

    def matches(self, a: str, b: str) -> bool:
        return b in self._map.get(a, ()) or a in self._map.get(b, ())

    def __len__(self) -> int:
        return len(self._map)

    @classmethod
    def load(cls, path: str) -> "ParaphraseTable":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_env(cls) -> "ParaphraseTable | None":
        path = os.environ.get(_PARAPHRASE_TABLE_ENV)
        if path and os.path.exists(path):
            return cls.load(path)
        return None


def _align_stage(ref_keys, hyp_keys, ref_used, hyp_used):
    """Greedy in-order alignment on one match stage; mutates used sets and
    returns (hyp_idx, ref_idx) pairs for words unmatched so far."""
    ref_positions: dict = {}
    for i, w in enumerate(ref_keys):
        if i not in ref_used:
            ref_positions.setdefault(w, []).append(i)
    pairs = []
    for j, w in enumerate(hyp_keys):
        if j in hyp_used:
            continue
        for i in ref_positions.get(w, []):
            if i not in ref_used:
                ref_used.add(i)
                hyp_used.add(j)
                pairs.append((j, i))
                break
    return pairs


def _align_synonym_stage(ref, hyp, table: SynonymTable, ref_used, hyp_used):
    """Match unmatched word pairs whose synset-id sets intersect."""
    pairs = []
    for j, hw in enumerate(hyp):
        if j in hyp_used:
            continue
        h_sets = table.synsets(hw)
        if not h_sets:
            continue
        for i, rw in enumerate(ref):
            if i in ref_used:
                continue
            if h_sets & table.synsets(rw):
                ref_used.add(i)
                hyp_used.add(j)
                pairs.append((j, i))
                break
    return pairs


def _align_paraphrase_stage(ref, hyp, table: ParaphraseTable,
                            ref_used, hyp_used):
    """Match still-unmatched word spans the phrase table pairs up
    (longest-hypothesis-span-first greedy). Spans may differ in length;
    returns (hyp_idxs, ref_idxs, anchor_pairs) where anchors pair up the
    overlapping prefix for chunk counting."""
    max_n = table.max_words   # span enumeration covers every table entry
    hyp_idxs: list = []
    ref_idxs: list = []
    anchors: list = []
    H, R = len(hyp), len(ref)
    # reference span strings are invariant across the (j, n) loops — build
    # the R x max_n table once instead of re-joining inside the inner loop
    ref_spans = [
        [" ".join(ref[i:i + k]) for k in range(min(max_n, R - i) + 1)]
        for i in range(R)
    ]
    j = 0
    while j < H:
        if j in hyp_used:
            j += 1
            continue
        advanced = False
        for n in range(min(max_n, H - j), 0, -1):
            if any((j + t) in hyp_used for t in range(n)):
                continue
            h_phrase = " ".join(hyp[j:j + n])
            for i in range(R):
                hit_len = 0
                for k in range(min(max_n, R - i), 0, -1):
                    if any((i + t) in ref_used for t in range(k)):
                        continue
                    if table.matches(h_phrase, ref_spans[i][k]):
                        hit_len = k
                        break
                if hit_len:
                    hs = range(j, j + n)
                    rs = range(i, i + hit_len)
                    hyp_used.update(hs)
                    ref_used.update(rs)
                    hyp_idxs += list(hs)
                    ref_idxs += list(rs)
                    anchors += [(j + t, i + t)
                                for t in range(min(n, hit_len))]
                    advanced = True
                    break
            if advanced:
                j += n
                break
        if not advanced:
            j += 1
    return hyp_idxs, ref_idxs, anchors


# ---- the jar's alignment search (params="1.5") ----

_BEAM_WIDTH = 40  # Meteor 1.5 Aligner default


def _candidate_matches(ref, hyp, stemmer, synonyms, paraphrases):
    """Every possible match across the four stages, as the jar's matchers
    produce them before resolution: (j, i, nh, nr, stage) with hyp span
    [j, j+nh) and ref span [i, i+nr). A word pair matching at several
    stages keeps the highest-precedence (lowest-index) stage."""
    best: dict = {}
    ref_stems = [stemmer(w) for w in ref] if stemmer else None
    hyp_stems = [stemmer(w) for w in hyp] if stemmer else None
    for j, hw in enumerate(hyp):
        h_syn = synonyms.synsets(hw) if synonyms else None
        for i, rw in enumerate(ref):
            if hw == rw:
                stage = 0
            elif ref_stems is not None and hyp_stems[j] == ref_stems[i]:
                stage = 1
            elif h_syn and (h_syn & synonyms.synsets(rw)):
                stage = 2
            else:
                continue
            key = (j, i, 1, 1)
            if key not in best or stage < best[key]:
                best[key] = stage
    if paraphrases is not None:
        H, R = len(hyp), len(ref)
        max_n = paraphrases.max_words
        ref_spans = [
            [" ".join(ref[i:i + k]) for k in range(min(max_n, R - i) + 1)]
            for i in range(R)
        ]
        for j in range(H):
            for n in range(1, min(max_n, H - j) + 1):
                h_phrase = " ".join(hyp[j:j + n])
                for i in range(R):
                    for k in range(1, min(max_n, R - i) + 1):
                        if paraphrases.matches(h_phrase, ref_spans[i][k]):
                            best.setdefault((j, i, n, k), 3)
    return [(j, i, nh, nr, st) for (j, i, nh, nr), st in best.items()]


def _beam_align(cands, n_hyp: int, beam: int = _BEAM_WIDTH):
    """Resolve candidate matches to a one-to-one alignment the jar's way
    (Aligner.resolve, Denkowski & Lavie 2014 §2): walk hypothesis positions
    left to right, at each either take one candidate match starting there or
    leave the word unmatched; prune partials to the beam by (total matched
    words DESC, chunks ASC, sum |j - i| ASC). Returns the winning matches."""
    from collections import defaultdict

    by_start = defaultdict(list)
    for c in cands:
        by_start[c[0]].append(c)
    # state: (covered, chunks, dist, hyp_mask, ref_mask, chunk_end, matches)
    states = [(0, 0, 0, 0, 0, None, ())]
    for j in range(n_hyp):
        nxt = list(states)  # every partial may leave position j unmatched
        for covered, chunks, dist, hmask, rmask, last, ms in states:
            if (hmask >> j) & 1:
                continue  # consumed by a span started earlier
            for (_, i, nh, nr, stage) in by_start.get(j, ()):
                hbits = ((1 << nh) - 1) << j
                rbits = ((1 << nr) - 1) << i
                if (hmask & hbits) or (rmask & rbits):
                    continue
                adjacent = last == (j, i)  # contiguous on BOTH sides
                nxt.append((
                    covered + nh + nr,
                    chunks + (0 if adjacent else 1),
                    dist + abs(j - i),
                    hmask | hbits, rmask | rbits,
                    (j + nh, i + nr),
                    ms + ((j, i, nh, nr, stage),),
                ))
        nxt.sort(key=lambda s: (-s[0], s[1], s[2]))
        states = nxt[:beam]
    return list(states[0][6])


def _align_beam(ref, hyp, stemmer=porter_stem,
                synonyms: SynonymTable | None = None,
                paraphrases: ParaphraseTable | None = None):
    """Jar-search alignment with the same return contract as ``_align``."""
    cands = _candidate_matches(ref, hyp, stemmer, synonyms, paraphrases)
    matches = sorted(_beam_align(cands, len(hyp)))
    stage_sides = [([], []) for _ in range(4)]
    chunks, last = 0, None
    for (j, i, nh, nr, stage) in matches:
        stage_sides[stage][0].extend(range(j, j + nh))
        stage_sides[stage][1].extend(range(i, i + nr))
        if last != (j, i):
            chunks += 1
        last = (j + nh, i + nr)
    m_h = sum(len(h) for h, _ in stage_sides)
    m_r = sum(len(r) for _, r in stage_sides)
    return stage_sides, chunks, (m_h + m_r) / 2.0


def _align(ref, hyp, stemmer=porter_stem, synonyms: SynonymTable | None = None,
           paraphrases: ParaphraseTable | None = None):
    """Staged alignment. Returns (stage_sides, chunks, m): stage_sides is a
    per-stage [exact, stem, synonym, paraphrase] list of
    (hyp_idxs, ref_idxs); chunks counts contiguous runs over ALL matched
    anchor pairs (hyp order); m is the average matched-word count of the
    two sides (they differ only for unequal paraphrase spans)."""
    ref_used: set = set()
    hyp_used: set = set()
    exact = _align_stage(ref, hyp, ref_used, hyp_used)
    stemmed = []
    if stemmer is not None:
        ref_stems = [stemmer(w) for w in ref]
        hyp_stems = [stemmer(w) for w in hyp]
        stemmed = _align_stage(ref_stems, hyp_stems, ref_used, hyp_used)
    syn = []
    if synonyms is not None:
        syn = _align_synonym_stage(ref, hyp, synonyms, ref_used, hyp_used)
    para_h, para_r, para_anchors = [], [], []
    if paraphrases is not None:
        para_h, para_r, para_anchors = _align_paraphrase_stage(
            ref, hyp, paraphrases, ref_used, hyp_used)
    stage_sides = [
        ([j for j, _ in ps], [i for _, i in ps])
        for ps in (exact, stemmed, syn)
    ] + [(para_h, para_r)]
    m_h = sum(len(h) for h, _ in stage_sides)
    m_r = sum(len(r) for _, r in stage_sides)
    m = (m_h + m_r) / 2.0
    pairs = sorted(exact + stemmed + syn + para_anchors)
    if not pairs:
        return stage_sides, 0, m
    chunks = 1
    for (j0, i0), (j1, i1) in zip(pairs, pairs[1:]):
        if not (j1 == j0 + 1 and i1 == i0 + 1):
            chunks += 1
    return stage_sides, chunks, m


# stage weights: exact, stem, synonym, paraphrase (meteor-1.5 English
# defaults; 2005 predates staged weighting — equal weights). ``search``
# selects each system's published alignment procedure (module docstring).
_PARAMS = {
    "2005": dict(alpha=0.9, beta=3.0, gamma=0.5, delta=None,
                 weights=(1.0, 1.0, 1.0, 1.0), search="greedy"),
    "1.5": dict(alpha=0.85, beta=0.2, gamma=0.6, delta=0.75,
                weights=(1.0, 0.6, 0.8, 0.6), search="beam"),
}


def _weighted_count(words, idxs, delta, function_words):
    """delta-weighted count of the indexed words (content delta,
    function 1-delta); unweighted when delta is None."""
    if delta is None:
        return float(len(idxs))
    return sum(delta if words[k] not in function_words else 1.0 - delta
               for k in idxs)


def _segment_stats(ref, hyp, stemmer, synonyms, p, paraphrases=None,
                   function_words=None):
    """METEOR sufficient statistics for one (ref, hyp) pair:
    (weighted hyp matches, weighted ref matches, weighted |hyp|,
    weighted |ref|, chunks, raw matches)."""
    align = _align_beam if p.get("search") == "beam" else _align
    stage_sides, chunks, m = align(ref, hyp, stemmer, synonyms, paraphrases)
    delta = p["delta"]
    fw = default_function_words() if function_words is None else function_words
    wm_h = wm_r = 0.0
    for w, (h_idxs, r_idxs) in zip(p["weights"], stage_sides):
        wm_h += w * _weighted_count(hyp, h_idxs, delta, fw)
        wm_r += w * _weighted_count(ref, r_idxs, delta, fw)
    len_h = _weighted_count(hyp, range(len(hyp)), delta, fw)
    len_r = _weighted_count(ref, range(len(ref)), delta, fw)
    return wm_h, wm_r, len_h, len_r, chunks, m


def _score_from_stats(wm_h, wm_r, len_h, len_r, chunks, m, p) -> float:
    if m == 0 or wm_h == 0 or wm_r == 0:
        return 0.0
    prec = wm_h / len_h
    rec = wm_r / len_r
    f = prec * rec / (p["alpha"] * prec + (1 - p["alpha"]) * rec)
    frag = chunks / m
    return f * (1.0 - p["gamma"] * frag ** p["beta"])


def meteor_lite(references, hypothesis, use_stem: bool = True,
                synonyms: SynonymTable | None = None,
                params: str = "2005",
                paraphrases: ParaphraseTable | None = None,
                function_words: frozenset | None = None) -> float:
    """Segment METEOR: max over references (metric_suit.py scores per image
    against all 5 ground-truth captions)."""
    hyp = list(hypothesis)
    if not hyp:
        return 0.0
    p = _PARAMS[params]
    stemmer = porter_stem if use_stem else None
    best = 0.0
    for ref in references:
        stats = _segment_stats(list(ref), hyp, stemmer, synonyms, p,
                               paraphrases, function_words)
        best = max(best, _score_from_stats(*stats, p))
    return best


def corpus_meteor(references_list, hypotheses, use_stem: bool = True,
                  synonyms: SynonymTable | None = None,
                  params: str = "2005",
                  paraphrases: ParaphraseTable | None = None,
                  function_words: frozenset | None = None) -> float:
    """Corpus METEOR. ``params="2005"`` averages segment scores (the original
    paper's system score); ``params="1.5"`` micro-aggregates each segment's
    best-reference statistics and scores the aggregate, matching the jar's
    final EVAL computation."""
    if not hypotheses:
        return 0.0
    p = _PARAMS[params]
    stemmer = porter_stem if use_stem else None
    if params == "2005":
        return sum(
            meteor_lite(refs, hyp, use_stem, synonyms, params, paraphrases,
                        function_words)
            for refs, hyp in zip(references_list, hypotheses)
        ) / len(hypotheses)

    agg = [0.0, 0.0, 0.0, 0.0, 0, 0]
    for refs, hyp in zip(references_list, hypotheses):
        hyp = list(hyp)
        # materialise once THEN filter: `list(r) for r in refs if list(r)`
        # drains generator references in the filter, leaving empty lists
        refs = [r for r in (list(r) for r in refs) if r]
        if not refs:
            continue
        if not hyp:
            # an empty hypothesis still contributes its reference length to
            # the aggregate recall denominator (the jar's EVAL aggregation;
            # skipping the segment would inflate the corpus score)
            stats = _segment_stats(refs[0], [], stemmer, synonyms, p,
                                   paraphrases, function_words)
            for k in range(6):
                agg[k] += stats[k]
            continue
        best_stats, best_score = None, -1.0
        for ref in refs:
            stats = _segment_stats(list(ref), hyp, stemmer, synonyms, p,
                                   paraphrases, function_words)
            score = _score_from_stats(*stats, p)
            if score > best_score:
                best_stats, best_score = stats, score
        if best_stats is not None:
            for k in range(6):
                agg[k] += best_stats[k]
    return _score_from_stats(*agg, p)
