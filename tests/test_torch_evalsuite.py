"""The port's copy of the caption metric suite against the JAX package's
``evalsuite``, exactly (``==``): the whole suite on seeded caption sets
(random synthetic captions, the structured templates, the captions of the
METEOR and SPICE goldens), with and without a synonym table; each metric
function alone; GUSE with the hash embedder."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from masters_thesis_tpu.data import synthetic as jsynthetic
from masters_thesis_tpu.evalsuite import bleu as jbleu
from masters_thesis_tpu.evalsuite import cider as jcider
from masters_thesis_tpu.evalsuite import guse_sim as jguse
from masters_thesis_tpu.evalsuite import meteor as jmeteor
from masters_thesis_tpu.evalsuite import metric_suite as jsuite
from masters_thesis_tpu.evalsuite import rouge as jrouge
from masters_thesis_tpu.evalsuite import spice as jspice
from masters_thesis_tpu.evalsuite import stem as jstem
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.evalsuite import (
    bleu,
    cider,
    guse_sim,
    meteor,
    metric_suite,
    rouge,
    spice,
    stem,
)

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent


def _golden_module(name):
    spec = importlib.util.spec_from_file_location(f"_golden_{name}",
                                                  TESTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _strip(cap):
    return " ".join(cap.rstrip(".").split())


def _random_sets(seed):
    """Candidates drawn from other keys' references (some overlap, some
    not), five references a key."""
    caps = jsynthetic.synthetic_captions(range(30), seed=seed)
    refs = [[_strip(c).lower() for c in caps[k]] for k in range(30)]
    rng = np.random.default_rng(seed)
    cands = [refs[int(rng.integers(0, 30))][int(rng.integers(0, 5))]
             for _ in range(30)]
    cands[3] = ""                                     # an empty caption
    return cands, refs


def _structured_sets(seed):
    keys = np.arange(24)
    factors = jsynthetic.synthetic_factors(keys, seed=seed)
    caps = jsynthetic.structured_captions(keys, factors)
    refs = [[_strip(c) for c in caps[int(k)]] for k in keys]
    shuffled = jsynthetic.synthetic_factors(keys, seed=seed + 7)
    other = jsynthetic.structured_captions(keys, shuffled)
    cands = [_strip(other[int(k)][int(k) % 5]) if k % 3 else refs[k][0]
             for k in keys]
    return cands, refs


def _golden_sets():
    spice_cases = _golden_module("test_spice_goldens").GOLDEN_CASES
    meteor_ref = "the cat sat on the mat"
    meteor_hyps = ["the cat sat on the mat", "on the mat sat the cat",
                   "the cat was sat on the mat", "john loves mary",
                   "a cat sat on a mat", "nyc city"]
    cands = [h for _, h, _ in spice_cases] + meteor_hyps
    refs = ([[r] for r, _, _ in spice_cases]
            + [[meteor_ref, "new york city"]] * len(meteor_hyps))
    return cands, refs


SETS = {"random": _random_sets(1), "structured": _structured_sets(2),
        "goldens": _golden_sets()}
SYNONYMS = {"kitty": [1], "cat": [1, 2], "feline": [2], "woman": ["w"],
            "women": ["w"], "bike": [9], "bicycle": [9], "dog": [3],
            "puppy": [3]}


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("name", sorted(SETS))
def test_evaluate_captions_matches_original(name, with_table):
    cands, refs = SETS[name]
    kw = {}
    if with_table:
        kw = {"meteor_synonyms": meteor.SynonymTable(SYNONYMS),
              "meteor_paraphrases": meteor.ParaphraseTable(
                  {"nyc": ["new york", "new york city"]})}
        jkw = {"meteor_synonyms": jmeteor.SynonymTable(SYNONYMS),
               "meteor_paraphrases": jmeteor.ParaphraseTable(
                   {"nyc": ["new york", "new york city"]})}
    else:
        jkw = {}
    got = metric_suite.evaluate_captions(cands, refs, **kw)
    want = jsuite.evaluate_captions(cands, refs, **jkw)
    assert got == want
    assert ("METEOR" in got) == with_table
    assert got["Bleu_1"] > 0


@pytest.mark.parametrize("name", sorted(SETS))
def test_each_metric_matches_original(name):
    cands, refs = SETS[name]
    hyps = [c.split() for c in cands]
    refs_tok = [[r.split() for r in rs] for rs in refs]
    assert (bleu.corpus_bleu(refs_tok, hyps, max_n=4)
            == jbleu.corpus_bleu(refs_tok, hyps, max_n=4))
    for smoothing in (None, "method1", "method2"):
        for weights in bleu.WEIGHT_SETS.values():
            got = [bleu.sentence_bleu(r, h, weights, smoothing=smoothing)
                   for r, h in zip(refs_tok, hyps)]
            want = [jbleu.sentence_bleu(r, h, weights, smoothing=smoothing)
                    for r, h in zip(refs_tok, hyps)]
            assert got == want
    assert (bleu.batch_sentence_bleu(refs_tok, hyps)
            == jbleu.batch_sentence_bleu(refs_tok, hyps))
    assert (cider.CiderScorer().compute(refs_tok, hyps)
            == jcider.CiderScorer().compute(refs_tok, hyps))
    assert ([rouge.rouge_l(r, h) for r, h in zip(refs_tok, hyps)]
            == [jrouge.rouge_l(r, h) for r, h in zip(refs_tok, hyps)])
    assert (rouge.corpus_rouge_l(refs_tok, hyps)
            == jrouge.corpus_rouge_l(refs_tok, hyps))
    for params in ("2005", "1.5"):
        assert ([meteor.meteor_lite(r, h, params=params)
                 for r, h in zip(refs_tok, hyps)]
                == [jmeteor.meteor_lite(r, h, params=params)
                    for r, h in zip(refs_tok, hyps)])
    assert (meteor.corpus_meteor(refs_tok, hyps)
            == jmeteor.corpus_meteor(refs_tok, hyps))
    for table in (None, meteor.SynonymTable(SYNONYMS)):
        jtable = None if table is None else jmeteor.SynonymTable(SYNONYMS)
        assert ([spice.spice_lite(r, h, synonyms=table)
                 for r, h in zip(refs_tok, hyps)]
                == [jspice.spice_lite(r, h, synonyms=jtable)
                    for r, h in zip(refs_tok, hyps)])
    assert ([sorted(spice.parse_caption(h).all_tuples()) for h in hyps]
            == [sorted(jspice.parse_caption(h).all_tuples()) for h in hyps])
    words = sorted({w for c in cands + sum(refs, []) for w in c.split()})
    assert ([stem.porter_stem(w) for w in words + ["caresses", "relational",
                                                   "hopping", "generously"]]
            == [jstem.porter_stem(w) for w in words + [
                "caresses", "relational", "hopping", "generously"]])
    assert (metric_suite.bleu_table(cands, refs)
            == jsuite.bleu_table(cands, refs))


def test_suite_helpers_match_original():
    raw = ["A Dog runs, fast.", "<start> two cats <end>", "The  park!"]
    assert (metric_suite.clean_references(raw)
            == jsuite.clean_references(raw))
    caps = jsynthetic.synthetic_captions(range(1, 7), seed=5)
    tok = Tokenizer(num_words=40)
    tok.fit_on_texts([c for lines in caps.values() for c in lines])
    tok.install_pad()
    ids = np.random.default_rng(0).integers(0, 40, (6, 8))
    keys = list(range(1, 7))
    assert (metric_suite.evaluate_token_outputs(ids, keys, caps, tok)
            == jsuite.evaluate_token_outputs(ids, keys, caps, tok))
    assert meteor.default_function_words() == jmeteor.default_function_words()
    table = meteor.SynonymTable.default_caption_table()
    jtable = jmeteor.SynonymTable.default_caption_table()
    for word in ("woman", "women", "bike", "bicycle", "man", "zebra"):
        assert table.synsets(word) == jtable.synsets(word)


@pytest.mark.parametrize("name", sorted(SETS))
def test_guse_hash_scores_match_original(name):
    cands, refs = SETS[name]
    got = guse_sim.labelled_guse_scores(cands, refs)
    assert got == jguse.labelled_guse_scores(cands, refs)
    assert set(got) == {"GUSE_hash_pearson_r", "GUSE_hash_mean_corr"}
    sim = guse_sim.guse_similarity(cands, refs)
    jsim = jguse.guse_similarity(cands, refs)
    assert sim.keys() == jsim.keys()
    for key in sim:
        np.testing.assert_array_equal(sim[key], jsim[key])
    by_key = {i: r for i, r in enumerate(refs) if len(r) == len(refs[0])}
    k, table = guse_sim.embed_caption_table(by_key)
    jk, jtable = jguse.embed_caption_table(by_key)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(table, jtable)
    assert (guse_sim.nearest_training_captions(cands[:4], table, top_k=2)
            == jguse.nearest_training_captions(cands[:4], jtable, top_k=2))
    assert guse_sim.guse_clean("A Dog, runs.") == jguse.guse_clean(
        "A Dog, runs.")


def test_use_encoder_bundle_waits_for_its_port(tmp_path, monkeypatch):
    """The port of the USE encoder has come: with a USE weight bundle both
    packages run the real encoder (the port's on the device it is given),
    a file that is no bundle fails both alike, and without one both
    hash."""
    from masters_thesis_tpu.models.use_encoder import (
        USEEncoder as JUSEEncoder,
    )
    from masters_thesis_tpu.models.use_encoder import (
        init_use_params,
        save_use_bundle,
    )
    from masters_thesis_tpu_torch.models.use_encoder import USEEncoder

    bundle = tmp_path / "use_dan.npz"
    save_use_bundle(str(bundle), ["a", "dog"],
                    init_use_params(2, oov_buckets=4, embed_dim=8,
                                    hidden=(8,), out_dim=8), 4)
    assert isinstance(guse_sim.default_embedder(str(bundle), "cpu"),
                      USEEncoder)
    assert isinstance(jguse.default_embedder(str(bundle)), JUSEEncoder)
    broken = tmp_path / "broken.npz"
    np.savez(broken, x=np.zeros(1))
    with pytest.raises(KeyError):
        guse_sim.default_embedder(str(broken), "cpu")
    with pytest.raises(KeyError):
        jguse.default_embedder(str(broken))
    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    assert isinstance(guse_sim.default_embedder(), guse_sim.HashEmbedder)
