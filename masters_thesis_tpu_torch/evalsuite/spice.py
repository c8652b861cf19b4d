"""SPICE-lite: semantic-proposition F1 for caption evaluation.

The reference reports SPICE through pycocoevalcap's Java scene-graph
pipeline (AttemptFour/metric_suit.py:88-109: dependency parse → scene graph
→ tuple F1). That stack (Stanford parser jars) is unavailable here, so this
module implements the same *scoring model* — F1 over semantic tuples
(objects, attribute-object pairs, subject-relation-object triples) —
with a lightweight caption-grammar chunker in place of the dependency
parser. COCO-style captions are syntactically simple ("a man riding a bike
down the street"), which is what makes the rule-based extraction workable.

The tuple semantics follow the SPICE scene-graph construction (Anderson et
al. 2016, building on the Schuster et al. 2015 rules) rather than a naive
chunking:

- every noun-phrase modifier — adjective, compound-noun modifier, or count
  word — becomes an attribute of the NP head ("a tennis court" →
  (court, tennis), "two women" → (women, two));
- a verb that links two NPs directly is the relation ("man riding bike" →
  (man, riding, bike)); when the relation rides a preposition, the verb
  becomes an attribute of its subject and the preposition is the relation
  ("girl standing on top of court" → (girl, standing) +
  (girl, on top of, court) — multiword prepositions are collapsed first);
- a trailing verb with no object is an attribute ("a dog running" →
  (dog, running));
- coordinated NPs share their links ("a man and a woman sitting on a
  bench" relates both subjects to the bench);
- a bare copula links its predicate head as an attribute
  ("the table is white" → (table, white)).

Tuple matching uses exact-or-Porter-stem equality, upgraded to the Java
pipeline's WordNet-synset semantics (two slot words match when their synset
id sets intersect) when a synonym table is supplied — a real WordNet table
via ``MTT_METEOR_SYNONYMS`` / ``scripts/convert_wordnet_synonyms.py``, or
(the metric-suite default when none is configured) the bundled curated
caption-domain table ``caption_synonyms_en.json`` (irregular plurals +
common COCO same-object pairs; provenance in the file header). Reported as
"SPICE_lite" either way.

Numeric pinning (round 4, tests/test_spice_goldens.py): the Anderson et
al. 2016 worked example parses to exactly the published scene graph, and
on a 14-case golden set whose F1 scores were hand-derived by applying the
published procedure on paper, spice_lite WITH synset matching — whether
from a WordNet-equivalent table or the bundled curated default — reproduces
every score exactly; with stem-only matching (``synonyms=None``) the
measured Spearman rank correlation against those published-procedure
scores is rho = 0.74, the divergent cases being precisely the
synonym-stage matches (woman~women, bike~bicycle) that the bundled table
now covers in-image.

The port's own copy of ``masters_thesis_tpu/evalsuite/spice.py``, with the
same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

from masters_thesis_tpu_torch.evalsuite.stem import porter_stem

# closed-class words for the caption grammar
_DETERMINERS = frozenset(
    "a an the this that these those his her its their some any each no "
    "every another".split())
_PREPOSITIONS = frozenset(
    "in on at by with near under over above behind beside between through "
    "across around against along inside outside onto into up down off "
    "of from to atop beneath below next".split())
_COPULAS = frozenset("is are was were be being been".split())
_CONJ = frozenset("and or while as".split())

# multiword prepositions collapsed to one link token before chunking (the
# dependency pipeline's case-marker collapsing produces the same single
# relation label, e.g. (girl, on top of, court))
_MULTIWORD_PREPS = (
    ("on", "top", "of"),
    ("in", "front", "of"),
    ("next", "to"),
    ("close", "to"),
    ("on", "side", "of"),
)

# adjective lexicon — no longer needed to decide attribute attachment
# (every NP modifier is an attribute, as in the scene-graph rules) but
# still the word-class tagger for the POS analysis (analysis.pos_tag_word)
_COMMON_ADJ = frozenset(
    "red blue green yellow black white brown orange purple pink gray grey "
    "small large big little young old tall short long wide high low open "
    "closed empty full wet dry hot cold dark bright clear blurry "
    "wooden plastic metal glass striped spotted furry".split())
_ADJ_SUFFIXES = ("ful", "ous", "ish", "ive", "able", "ible", "al", "ed",
                 "less", "y")


def _is_adjective(word: str) -> bool:
    if word in _COMMON_ADJ:
        return True
    return len(word) > 4 and word.endswith(_ADJ_SUFFIXES)


# -ing words that are (in caption usage) nouns, not present participles:
# without this list "a tall building" would close the NP at "tall" and
# lose the actual object head
_ING_NOUNS = frozenset(
    "building painting drawing clothing ceiling railing awning "
    "lightning frosting icing stuffing seasoning topping bedding "
    "fencing siding evening morning wedding string spring wing ring "
    "king thing something nothing anything everything duckling "
    "sibling dumpling lining netting paneling plumbing roofing".split())

# frequent caption verbs whose simple forms ("rides", "sit", "stood") the
# -ing heuristic can't see — stand-ins for the Java pipeline's POS tagger.
# Stored stemmed so "rides", "ride" and "riding" all resolve through one
# entry.
_VERB_STEMS = frozenset(
    porter_stem(w) for w in
    "sit stand ride hold walk look play eat fly jump lay lie hang "
    "park wear carry drive sleep swim surf throw catch kick pull push "
    "reach climb lean graze perch stroll gallop soar kneel crouch pose "
    "smile wave feed cross travel".split())
# lexicon entries that are also frequent caption NOUNS ("the park", "a
# wave", "a smile"): a determiner immediately before one marks it as a
# noun, so "sitting on a bench in the park" keeps park as an object
# instead of silently dropping it as a link verb (advisor round-3 finding)
_NOUN_WHEN_DETERMINED = frozenset(
    porter_stem(w) for w in
    "park wave smile walk play cross catch look surf feed pose".split())
_IRREGULAR_VERBS = frozenset(
    "sat stood rode held ran lay hung wore ate flew threw caught slept "
    "drove knelt".split())


def _is_verb(word: str) -> bool:
    # caption relations are present participles ("riding", "sitting on"),
    # simple forms ("rides", "sit"), or common irregular pasts ("sat")
    if len(word) > 4 and word.endswith("ing") and word not in _ING_NOUNS:
        return True
    return word in _IRREGULAR_VERBS or porter_stem(word) in _VERB_STEMS


def _is_link(word: str) -> bool:
    return (word in _PREPOSITIONS or word in _COPULAS or " " in word
            or _is_verb(word))


class SceneTuples:
    """objects: {noun}; attributes: {(noun, adj)}; relations: {(s, r, o)}."""

    def __init__(self):
        self.objects: set = set()
        self.attributes: set = set()
        self.relations: set = set()

    def all_tuples(self) -> set:
        # multiword relation labels stem word-wise ("on top of" →
        # "on top of", "standing near" → "stand near")
        def stem_words(s):
            return " ".join(porter_stem(w) for w in s.split())

        return ({("o", porter_stem(o)) for o in self.objects}
                | {("a", porter_stem(n), porter_stem(a))
                   for n, a in self.attributes}
                | {("r", porter_stem(s), stem_words(r), porter_stem(o))
                   for s, r, o in self.relations})

    def raw_map(self) -> dict:
        """stem -> a surface form that produced it; the synonym table is
        keyed on vocabulary words, not stems."""
        out: dict = {}
        for o in self.objects:
            out.setdefault(porter_stem(o), o)
        for n, a in self.attributes:
            out.setdefault(porter_stem(n), n)
            out.setdefault(porter_stem(a), a)
        for s, r, o in self.relations:
            for w in (s, o, *r.split()):
                out.setdefault(porter_stem(w), w)
        return out


def _collapse_multiword_preps(toks: list, flags: list) -> tuple:
    """Collapse multiword prepositions to one link token. Runs on
    determiner-stripped tokens (so "on the side of" matches "on side of");
    ``flags`` is the parallel after-determiner list, carried from the first
    word of a collapsed sequence."""
    out: list = []
    out_flags: list = []
    i = 0
    while i < len(toks):
        for seq in _MULTIWORD_PREPS:
            if tuple(toks[i:i + len(seq)]) == seq:
                out.append(" ".join(seq))
                out_flags.append(flags[i])
                i += len(seq)
                break
        else:
            out.append(toks[i])
            out_flags.append(flags[i])
            i += 1
    return out, out_flags


def parse_caption(tokens) -> SceneTuples:
    """Chunk a caption into coordinated noun-phrase groups linked by
    verb/preposition spans, then emit SPICE-style tuples (module
    docstring). The last word of an NP is its head; every preceding
    modifier attaches as an attribute tuple.
    """
    out = SceneTuples()
    raw = [t.lower() for t in tokens
           if t and t not in ("<start>", "<end>", "<pad>", "<unk>")]
    # drop determiners BEFORE collapsing multiword preps (so "on the side
    # of" collapses like "on side of") but keep the determiner context as a
    # per-token flag: a determiner-preceded lexicon verb is a noun
    toks: list = []
    after_det: list = []
    prev_det = False
    for w in raw:
        if w in _DETERMINERS:
            prev_det = True
            continue
        toks.append(w)
        after_det.append(prev_det)
        prev_det = False
    toks, after_det = _collapse_multiword_preps(toks, after_det)

    # segment into NP groups (coordinated NPs share a group) and the link
    # spans between consecutive groups; links[i] connects groups[i] ->
    # groups[i+1]; a trailing span (len(links) == len(groups)) has no object
    groups: list = []   # list[list[list[str]]]
    links: list = []    # list[list[str]]
    cur_np: list = []
    cur_group: list = []
    cur_link: list = []
    for w, det in zip(toks, after_det):
        if w in _CONJ:
            if cur_np:
                cur_group.append(cur_np)
                cur_np = []
            continue
        # "the park" / "a wave" / "a smile": determiner context overrides
        # the verb lexicon (but never -ing participles or true preps)
        forced_noun = (det and " " not in w
                       and w not in _PREPOSITIONS and w not in _COPULAS
                       and not (len(w) > 4 and w.endswith("ing"))
                       and porter_stem(w) in _NOUN_WHEN_DETERMINED)
        if not forced_noun and _is_link(w):
            if cur_np:
                cur_group.append(cur_np)
                cur_np = []
            if cur_group:
                groups.append(cur_group)
                cur_group = []
                cur_link = []
                links.append(cur_link)
            if not groups:
                continue  # leading link words have no subject
            if w not in _COPULAS:
                cur_link.append(w)
        else:
            cur_np.append(w)
    if cur_np:
        cur_group.append(cur_np)
    if cur_group:
        groups.append(cur_group)

    # per-NP objects and modifier attributes. A group reached only through
    # a bare copula (empty link span) is an adjectival predicate when its
    # head is an adjective — "the table is white" attaches (table, white)
    # below but must NOT also emit object 'white' (Java SPICE creates no
    # object node for an adjectival predicate).
    heads: list = []  # list[list[str]] — the head nouns of each group
    for gi, group in enumerate(groups):
        copula_pred = gi >= 1 and gi - 1 < len(links) and not links[gi - 1]
        group_heads = []
        for np_words in group:
            head = np_words[-1]
            if not (copula_pred and _is_adjective(head)):
                out.objects.add(head)
            for w in np_words[:-1]:
                out.attributes.add((head, w))
            group_heads.append(head)
        heads.append(group_heads)

    # relations between consecutive groups
    for i, link in enumerate(links):
        if i + 1 >= len(heads):
            # trailing span: verbs become subject attributes
            for v in link:
                if _is_verb(v):
                    for s in heads[i]:
                        out.attributes.add((s, v))
            continue
        verbs = [w for w in link if _is_verb(w)]
        preps = [w for w in link
                 if w in _PREPOSITIONS or " " in w]
        if preps:
            # "standing on top of court": verb -> subject attribute,
            # preposition chain -> the relation
            rel = " ".join(preps)
            for s in heads[i]:
                for v in verbs:
                    out.attributes.add((s, v))
                for o in heads[i + 1]:
                    out.relations.add((s, rel, o))
        elif verbs:
            rel = " ".join(verbs)
            for s in heads[i]:
                for o in heads[i + 1]:
                    out.relations.add((s, rel, o))
        else:
            # bare copula: predicate heads attach as attributes
            # ("the table is white")
            for s in heads[i]:
                for o in heads[i + 1]:
                    out.attributes.add((s, o))
    return out


def _slot_match(hs: str, rs: str, synonyms, hyp_raw: dict,
                ref_raw: dict) -> bool:
    """SPICE's per-word match on STEM slots: stem equality OR WordNet
    synset overlap of the underlying surface forms (SpiceScorer's
    similarTo — lemma match via intersecting synsets). Multiword relation
    labels match exactly only."""
    if hs == rs:
        return True
    if " " in hs or " " in rs:
        return False
    sa = synonyms.synsets(hyp_raw.get(hs, hs))
    return bool(sa) and not sa.isdisjoint(
        synonyms.synsets(ref_raw.get(rs, rs)))


def _match_count(hyp_t: set, ref_t: set, synonyms, hyp_raw: dict,
                 ref_raw: dict) -> int:
    """Exact stemmed intersection plus greedy bipartite synonym matching
    over the remainder (sorted iteration — deterministic across interpreter
    runs); each reference tuple is consumed at most once."""
    exact = hyp_t & ref_t
    matched = len(exact)
    used: set = set(exact)
    for h in sorted(hyp_t - exact):
        for r in sorted(ref_t):
            if r in used or len(r) != len(h) or r[0] != h[0]:
                continue  # r[0] is the category tag ("o"/"a"/"r")
            if all(_slot_match(hw, rw, synonyms, hyp_raw, ref_raw)
                   for hw, rw in zip(h[1:], r[1:])):
                used.add(r)
                matched += 1
                break
    return matched


def spice_lite(references, hypothesis, synonyms=None) -> float:
    """Tuple F1 of the hypothesis against the union of reference tuples.

    ``synonyms``: optional ``meteor.SynonymTable``; when given, slots match
    on WordNet synset overlap as in Java SPICE, not just stem equality.
    """
    hyp = parse_caption(hypothesis)
    hyp_t = hyp.all_tuples()
    ref_t: set = set()
    parsed_refs = [parse_caption(ref) for ref in references]
    for pr in parsed_refs:
        ref_t |= pr.all_tuples()
    if not hyp_t or not ref_t:
        return 0.0
    if synonyms is None:
        matched = len(hyp_t & ref_t)
    else:
        # same stemmed tuple sets (identical P/R denominators with or
        # without a table — the table can only ADD matches); the raw maps
        # recover surface forms for synset lookups
        ref_raw: dict = {}
        for pr in parsed_refs:
            for k, v in pr.raw_map().items():
                ref_raw.setdefault(k, v)
        matched = _match_count(hyp_t, ref_t, synonyms, hyp.raw_map(),
                               ref_raw)
    p = matched / len(hyp_t)
    r = matched / len(ref_t)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def corpus_spice(references_list, hypotheses, synonyms=None) -> float:
    if not hypotheses:
        return 0.0
    return sum(
        spice_lite(refs, hyp, synonyms=synonyms)
        for refs, hyp in zip(references_list, hypotheses)
    ) / len(hypotheses)
