"""The port's beam search and sampling against the JAX package's, on the
CPU, on the same transplanted weights and numpy inputs.

Beam: for LcNIC, CnnRnn (both values of the zero-state quirk) and ShowTell
at widths 1, 3 and 5, the best tokens and every beam's history are
identical and the best scores, normalised scores and best alphas agree
within 1e-5 (fp32); ``<end>`` is the most frequent greedy word, so beams
finish early and freeze. The lattice reproduces the JAX shrinking-frontier
oracle (``tests/test_decode.py``: ``_TableModel`` with a boosted ``<end>``
and ``_shrinking_beam_oracle``) route for route, and the JAX lattice on
those table models token for token; the selection takes the W largest keys
with the lower index first among equal ones, as ``jax.lax.top_k`` does.
Beam-1 is the port's greedy decode up to ``<end>``.

Sampling: ``filter_logits`` equals a numpy transcription of the JAX filter
(sampling.py:45-48) with ties at the k-th logit kept; ``top_k=1`` gives the
greedy words in both packages; bad arguments raise the JAX package's
``ValueError``; the Captioner's (seed, call) gives the same words twice and
a new call new words."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.decode.beam import make_beam_decoder as j_beam
from masters_thesis_tpu.decode.greedy import make_greedy_decoder as j_greedy
from masters_thesis_tpu.decode.sampling import (
    make_sampling_decoder as j_sampling,
)
from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.models.showtell import ShowTell as JShowTell
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.decode.beam import NEG_INF, make_beam_decoder, top_w
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.decode.sampling import (
    filter_logits,
    make_sampling_decoder,
)
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.models.showtell import ShowTell
from masters_thesis_tpu_torch.ops.fused_decode import spread_for_check
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.transplant import to_flax
from test_decode import _shrinking_beam_oracle, _TableModel
from test_torch_cnn_rnn import nic_pair
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
UNITS, T, VOCAB, START, B = 16, 6, 40, 1, 8
LC = dict(units=UNITS, group_size=4, embedding_text=8, attn_units=8,
          vocab_size=VOCAB, max_length=T)
ST = dict(units=UNITS, embed_dim=8, embedding_text=8, vocab_size=VOCAB,
          max_length=T, encoder_activation="relu", head_inter=True,
          dropout=0.0)
N_VOXELS = 128


def _lc_pair(seed=0):
    layout = GroupLayout(synthetic_groups(N_VOXELS, 6, seed=seed), N_VOXELS)
    gen = torch.Generator().manual_seed(seed)
    tmodel = LcNIC(layout, generator=gen, **LC)
    spread_for_check(tmodel, gen)
    rows = np.random.default_rng(seed).standard_normal(
        (B, N_VOXELS)).astype(np.float32)
    return JLcNIC(layout=layout, **LC), to_flax(tmodel.state_dict()), \
        tmodel.eval(), rows


def _showtell_pair(seed=0):
    """Flax's initialisers leave ShowTell's logits near 0 and its words
    few: a wider vocab head, embedding and biases make them vary."""
    gen = torch.Generator().manual_seed(seed)
    tmodel = ShowTell(N_VOXELS, generator=gen, **ST)
    with torch.no_grad():
        for p, std in ((tmodel.embedding, 2.0),
                       (tmodel.fc_vocab.kernel, 12.0 / UNITS ** 0.5),
                       (tmodel.fc_vocab.bias, 0.2), (tmodel.lstm.bias, 0.5),
                       (tmodel.fc_embedding.bias, 0.3)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        tmodel.fc_embedding.kernel.mul_(3.0)
        tmodel.lstm.kernel.mul_(3.0)
    rows = np.random.default_rng(seed).standard_normal(
        (B, N_VOXELS)).astype(np.float32)
    return JShowTell(**ST), to_flax(tmodel.state_dict()), tmodel.eval(), rows


def _pair(case, seed=0):
    if case == "lc_nic":
        return _lc_pair(seed)
    if case == "showtell":
        return _showtell_pair(seed)
    jmodel, variables, tmodel, rows = nic_pair(case == "cnn_rnn-zero-state",
                                               seed=seed, units=UNITS,
                                               vocab=VOCAB, b=B)
    return jmodel, variables, tmodel, rows


def _end_id(tmodel, rows):
    """The most frequent greedy word after the first step, as ``<end>``:
    beams then finish early and freeze."""
    words = make_greedy_decoder(tmodel, T)(torch.from_numpy(rows),
                                           START)[0][:, 1:]
    ids, counts = np.unique(words.numpy(), return_counts=True)
    return int(ids[np.argmax(counts)])


CASES = ["lc_nic", "cnn_rnn-zero-state", "cnn_rnn-carried", "showtell"]


@pytest.mark.parametrize("width", [1, 3, 5])
@pytest.mark.parametrize("case", CASES)
def test_beam_matches_jax(case, width):
    jmodel, variables, tmodel, rows = _pair(case)
    end = _end_id(tmodel, rows)
    want = j_beam(jmodel, UNITS, T, beam_width=width)(variables, rows, START,
                                                      end)
    got = make_beam_decoder(tmodel, T, beam_width=width)(
        torch.from_numpy(rows), START, end)
    tokens, scores, alphas, hist, norm = got
    assert tokens.dtype == hist.dtype == torch.int32
    assert hist.shape == (B, width, T) and norm.shape == (B, width)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want[3]))
    for g, w in ((scores, want[1]), (alphas, want[2]), (norm, want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the comparison has teeth: words vary and some beams froze
    assert len(np.unique(tokens.numpy())) > 3
    assert (hist.numpy()[:, :, 1:] == end).any()
    if case == "showtell":
        assert alphas.shape == (B, T, 1) and not alphas.any()


@pytest.mark.parametrize("case", CASES)
def test_beam_of_one_is_greedy_up_to_end(case):
    """Beam-1 takes the argmax each step; once it emits ``<end>`` (from the
    second step on) it writes ``<pad>``."""
    _, _, tmodel, rows = _pair(case, seed=1)
    end = _end_id(tmodel, rows)
    greedy = make_greedy_decoder(tmodel, T)(torch.from_numpy(rows),
                                            START)[0].numpy()
    beam = make_beam_decoder(tmodel, T, beam_width=1)(
        torch.from_numpy(rows), START, end)[0].numpy()
    ended = 0
    for g, b in zip(greedy, beam):
        stop = next((t for t in range(1, T) if g[t] == end), T - 1)
        ended += stop < T - 1
        np.testing.assert_array_equal(b[:stop + 1], g[:stop + 1])
        assert not b[stop + 1:].any()
    assert ended


class _TorchTableModel:
    """``_TableModel``'s decode contract in torch, on the same tables."""

    def __init__(self, tm):
        self.U, self.E, self.A, self.T, self.P = (
            torch.from_numpy(x) for x in (tm.U, tm.E, tm.A, tm.T, tm.P))

    def encode(self, x):
        return x[:, None, :]

    def init_carry(self, feat):
        h = torch.tanh(feat[:, 0, :] @ self.P)
        return h, torch.zeros_like(h)

    def decode_step(self, h, c, feat, tok):
        logits = torch.tanh(h) @ self.U + self.E[tok]
        h2 = torch.tanh(h @ self.A + self.T[tok])
        return h2, c, logits, torch.zeros(h.shape[0], 1)


def test_beam_matches_the_shrinking_frontier_oracle():
    """The JAX oracle test's cases (five table models, <end> boosted or
    not, widths 2 and 3, two inputs each): the port's lattice gives the
    oracle's route and score, and the JAX lattice's tokens, history and
    scores."""
    units, vocab, max_len, start_id, end_id = 8, 12, 6, 1, 2
    rng = np.random.default_rng(1)
    checked = finished = 0
    for seed in range(5):
        for boost in (0.0, 3.0):
            tm = _TableModel(units, vocab, end_id, boost, seed)
            ttm = _TorchTableModel(tm)
            for W in (2, 3):
                jdec = j_beam(tm, units, max_len, beam_width=W)
                dec = make_beam_decoder(ttm, max_len, beam_width=W)
                for _ in range(2):
                    x = rng.standard_normal((1, 4)).astype("f4")
                    route, score = _shrinking_beam_oracle(
                        tm, x, start_id, end_id, W, max_len)
                    got = dec(torch.from_numpy(x), start_id, end_id)
                    want = jdec({}, jnp.asarray(x), start_id, end_id)
                    np.testing.assert_array_equal(got[0].numpy(),
                                                  np.asarray(want[0]))
                    np.testing.assert_array_equal(got[3].numpy(),
                                                  np.asarray(want[3]))
                    np.testing.assert_allclose(got[4].numpy(),
                                               np.asarray(want[4]), **TOL)
                    row = got[0].numpy()[0]
                    stop = next((t for t in range(1, max_len)
                                 if row[t] == end_id), None)
                    finished += stop is not None
                    if score == float("-inf"):
                        assert float(got[1][0]) <= NEG_INF
                    else:
                        assert list(row[:stop]) == route, (seed, boost, W)
                        assert abs(float(got[1][0]) - score) < 1e-4
                    checked += 1
    assert checked == 40 and finished > 10


def test_top_w_breaks_ties_as_jax_top_k():
    """Equal keys, among them the dead slots' ``NEG_INF + logp``, which
    fp32 rounds to multiples of 64: the lower index comes first."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 4, (6, 50)).astype(np.float32)
    keys[:, ::7] = NEG_INF + rng.uniform(-5, 0, keys[:, ::7].shape).astype(
        np.float32)
    keys[2] = NEG_INF + np.float32(-1.0)
    for w in (1, 5, 17, 49):
        want_keys, want = jax.lax.top_k(jnp.asarray(keys), w)
        idx, got_keys = top_w(torch.from_numpy(keys), w)
        np.testing.assert_array_equal(idx[:, :w], np.asarray(want))
        np.testing.assert_array_equal(got_keys[:, :w], np.asarray(want_keys))
        assert idx.shape == (6, w + 1)


# ---- sampling ----

def _numpy_filter(logits, temperature, top_k):
    """sampling.py:45-48, in numpy."""
    logits = logits / np.float32(temperature)
    if top_k > 0:
        kth = np.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = np.where(logits < kth, -np.inf, logits)
    return logits


@pytest.mark.parametrize("top_k", [0, 1, 5, VOCAB])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_filter_logits_keeps_ties_at_the_kth(temperature, top_k):
    rng = np.random.default_rng(0)
    # logits on a coarse grid: ties at the k-th largest are common
    logits = np.round(rng.normal(0, 1, (16, VOCAB)), 0).astype(np.float32)
    got = filter_logits(torch.from_numpy(logits), temperature, top_k)
    want = _numpy_filter(logits, temperature, top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    kept = np.isfinite(want).sum(-1)
    if top_k in (1, 5):
        assert (kept >= top_k).all() and (kept > top_k).any()
    else:
        assert (kept == VOCAB).all()


@pytest.mark.parametrize("case", ["lc_nic", "cnn_rnn-zero-state",
                                  "showtell"])
def test_sampling_top_1_is_greedy_in_both_packages(case):
    jmodel, variables, tmodel, rows = _pair(case, seed=2)
    words = make_sampling_decoder(tmodel, T, top_k=1)(
        torch.from_numpy(rows), START, torch.Generator().manual_seed(5))
    greedy = make_greedy_decoder(tmodel, T)(torch.from_numpy(rows), START)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), greedy[0].numpy())
    jwords = j_sampling(jmodel, UNITS, T, top_k=1)(
        variables, rows, START, jax.random.PRNGKey(5))
    jgreedy = j_greedy(jmodel, UNITS, T)(variables, rows, START)[0]
    np.testing.assert_array_equal(np.asarray(jwords), np.asarray(jgreedy))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))


@pytest.mark.parametrize("kw,match", [
    (dict(temperature=0.0), "temperature"),
    (dict(temperature=-1.0), "temperature"),
    (dict(top_k=-1), "top_k"),
    (dict(top_k=VOCAB + 1), "top_k"),
])
def test_bad_sampling_arguments_raise_as_in_jax(kw, match):
    jmodel, _, tmodel, _ = _pair("lc_nic")
    with pytest.raises(ValueError, match=match):
        j_sampling(jmodel, UNITS, T, **kw)
    with pytest.raises(ValueError, match=match):
        make_sampling_decoder(tmodel, T, **kw)
    tok = Tokenizer(num_words=VOCAB)
    tok.fit_on_texts(["<start> a b <end>"])
    tok.install_pad()
    cap = Captioner(tmodel, tok, UNITS, T, device="cpu", **{
        "temperature" if "temperature" in kw else "sample_top_k":
        next(iter(kw.values()))})
    with pytest.raises(ValueError, match=match):
        cap.caption_ids(np.zeros((1, N_VOXELS), np.float32),
                        decoder="sample")


def test_sampling_seed_and_call_fix_the_words():
    """Two Captioners built alike give the same words on their n-th call;
    the next call draws new words, and another seed other words."""
    _, _, tmodel, rows = _pair("lc_nic", seed=3)
    tok = Tokenizer(num_words=VOCAB)
    tok.fit_on_texts(["<start> <end> " + " ".join(f"w{i}" for i in range(VOCAB))])
    tok.install_pad()

    def captioner(seed):
        return Captioner(tmodel, tok, UNITS, T, batch_size=B, device="cpu",
                         temperature=2.0, seed=seed)

    a, b, other = captioner(7), captioner(7), captioner(8)
    first = a.caption_ids(rows, decoder="sample")
    np.testing.assert_array_equal(b.caption_ids(rows, decoder="sample"),
                                  first)
    second = a.caption_ids(rows, decoder="sample")
    np.testing.assert_array_equal(b.caption_ids(rows, decoder="sample"),
                                  second)
    assert not np.array_equal(first, second)
    assert not np.array_equal(other.caption_ids(rows, decoder="sample"),
                              first)
