"""Porter stemmer (Porter 1980) — pure Python, no dependencies.

True METEOR (the pycocoevalcap jar the reference calls in metric_suit.py)
matches unigrams in stages: exact, then Porter-stemmed, then WordNet
synonyms. This supplies the stem stage for our METEOR (WordNet is the one
stage that stays external in a zero-egress image). Implements the original
1980 algorithm; parity-tested against NLTK's ORIGINAL_ALGORITHM mode.

The port's own copy of ``masters_thesis_tpu/evalsuite/stem.py``, with the
same names and meaning (``tests/test_torch_evalsuite.py`` holds the two
together).
"""

from __future__ import annotations

import functools

_VOWELS = frozenset("aeiou")


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel->consonant transitions."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    i = len(word) - 1
    return (_is_cons(word, i) and not _is_cons(word, i - 1)
            and _is_cons(word, i - 2) and word[i] not in "wxy")


def _replace(word: str, suffix: str, repl: str, m_min: int):
    """If word ends with suffix and measure(stem) > m_min, swap the suffix.
    Returns (new_word, matched_suffix)."""
    if suffix and word.endswith(suffix):
        stem = word[: len(word) - len(suffix)]
        if _measure(stem) > m_min:
            return stem + repl, True
        return word, True
    return word, False


_STEP2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
          ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
          ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
          ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
          ("biliti", "ble"))

_STEP3 = (("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
          ("ical", "ic"), ("ful", ""), ("ness", ""))

_STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
          "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
          "ize")


@functools.lru_cache(maxsize=65536)
def porter_stem(word: str) -> str:
    # pure word->word: the cache removes the bulk of the stemming work in
    # corpus METEOR, which re-stems every hypothesis once per reference
    w = word.lower()
    if len(w) <= 2:
        return w

    # step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b: -eed / -ed / -ing
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # step 1c: y -> i
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2 (longest match on the penultimate letter, paper convention)
    for suffix, repl in _STEP2:
        done, matched = _replace(w, suffix, repl, 0)
        if matched:
            w = done
            break

    # step 3
    for suffix, repl in _STEP3:
        done, matched = _replace(w, suffix, repl, 0)
        if matched:
            w = done
            break

    # step 4: drop the suffix when m(stem) > 1
    for suffix in _STEP4:
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if suffix == "ion":
                if stem.endswith(("s", "t")) and _measure(stem) > 1:
                    w = stem
            elif _measure(stem) > 1:
                w = stem
            break

    # step 5a: drop trailing e
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # step 5b: -ll -> -l when m > 1
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
