"""The port's scanned decoders against the JAX package's, on the CPU.

At ``tests/test_decode.py``'s sizes (units 16, attention 8, group 4, text
8, T 6, vocab 41; 16 synthetic keys x 64 voxels), on the weights of the
JAX ``init_model`` with their biases and BatchNorm statistics drawn from a
seed and every kernel and embedding x 8 (flax's initialisers give one
greedy word for every row), transplanted into the port: the scanned
greedy decoder gives the JAX ``make_scanned_greedy_decoder``'s words
exactly and, with ``return_logits``, its logits within 1e-5; the scanned
beam (width 3, K 2) gives the JAX ``make_scanned_beam_decoder``'s words
exactly; and each slice of either equals the port's single call
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.synthetic import synthetic_dataset
from masters_thesis_tpu.decode.beam import (
    make_scanned_beam_decoder as j_scanned_beam,
)
from masters_thesis_tpu.decode.greedy import (
    make_scanned_greedy_decoder as j_scanned_greedy,
)
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout as JGroupLayout
from masters_thesis_tpu.train.state import init_model as jinit_model
from masters_thesis_tpu_torch.decode import (
    make_beam_decoder,
    make_greedy_decoder,
    make_scanned_beam_decoder,
    make_scanned_greedy_decoder,
)
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.transplant import from_flax
from test_torch_families import _randomise
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = JConfig(top_k=40, batch_size=4, max_length=6, units=16, attn_units=8,
              group_size=4, embedding_text=8)
N_KEYS, N_VOXELS, N_GROUPS, B = 16, 64, 4, 4
KW = dict(units=CFG.units, group_size=CFG.group_size,
          embedding_text=CFG.embedding_text, attn_units=CFG.attn_units,
          vocab_size=CFG.vocab_size, max_length=CFG.max_length)
BEAM_WIDTH, BEAM_K = 3, 2
SPREAD = 8.0


@pytest.fixture(scope="module")
def pair():
    """(JAX model, numpy variables, port model with the same weights, the
    16 rows stacked (4, 4, 64), start id, end id)."""
    _, _, tok, store, groups = synthetic_dataset(
        n_keys=N_KEYS, n_voxels=N_VOXELS, n_groups=N_GROUPS, top_k=CFG.top_k)
    jmodel = JLcNIC(layout=JGroupLayout(groups, N_VOXELS), **KW)
    rows = store.gather_host(np.arange(N_KEYS, dtype=np.int32))
    variables = dict(zip(("params", "batch_stats"), jinit_model(
        jmodel, CFG, rows[:B], np.zeros((B, CFG.max_length), np.int32))[:2]))
    variables = _spread(_randomise(
        {k: _numpy(v) for k, v in variables.items()},
        np.random.default_rng(0)))
    tmodel = LcNIC(GroupLayout(groups, N_VOXELS), **KW)
    tmodel.load_state_dict(from_flax(variables))        # strict: key for key
    stacked = rows.reshape(N_KEYS // B, B, N_VOXELS)
    return (jmodel, variables, tmodel.eval(), stacked, tok.start_id,
            tok.end_id)


def _spread(tree):
    """Every kernel and embedding x SPREAD, so that the logits vary more
    than the head's bias and the greedy words with them."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _spread(v)
        elif k in ("kernel", "recurrent_kernel", "embedding"):
            tree[k] = v * SPREAD
    return tree


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_scanned_greedy_matches_jax(pair):
    jmodel, variables, tmodel, stacked, start, _ = pair
    want = np.asarray(j_scanned_greedy(jmodel, CFG.units, CFG.max_length)(
        variables, jnp.asarray(stacked), start))
    got = make_scanned_greedy_decoder(tmodel, CFG.max_length)(
        torch.from_numpy(stacked), start)
    assert got.dtype == torch.int32 and got.shape == want.shape == (
        N_KEYS // B, B, CFG.max_length)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 5             # the words vary


def test_scanned_greedy_logits_match_jax(pair):
    jmodel, variables, tmodel, stacked, start, _ = pair
    jwords, jlogits = j_scanned_greedy(
        jmodel, CFG.units, CFG.max_length, return_logits=True)(
        variables, jnp.asarray(stacked), start)
    words, logits = make_scanned_greedy_decoder(
        tmodel, CFG.max_length, return_logits=True)(
        torch.from_numpy(stacked), start)
    assert logits.shape == (N_KEYS // B, B, CFG.max_length, CFG.vocab_size)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_scanned_beam_matches_jax(pair):
    jmodel, variables, tmodel, stacked, start, end = pair
    stacked = stacked[:BEAM_K]
    want = np.asarray(j_scanned_beam(
        jmodel, CFG.units, CFG.max_length, beam_width=BEAM_WIDTH)(
        variables, jnp.asarray(stacked), start, end))
    got = make_scanned_beam_decoder(tmodel, CFG.max_length,
                                    beam_width=BEAM_WIDTH)(
        torch.from_numpy(stacked), start, end)
    assert got.dtype == torch.int32 and got.shape == want.shape == (
        BEAM_K, B, CFG.max_length)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_each_slice_equals_a_single_call(pair, decoder):
    """The K batches are walked one by one, as the JAX scan walks them: a
    slice is a single call's words bit for bit (and the greedy logits)."""
    _, _, tmodel, stacked, start, end = pair
    betas = torch.from_numpy(stacked)
    if decoder == "greedy":
        words, logits = make_scanned_greedy_decoder(
            tmodel, CFG.max_length, return_logits=True)(betas, start)
        single = make_greedy_decoder(tmodel, CFG.max_length)
        for k in range(len(betas)):
            w, lg, _ = single(betas[k], start)
            assert torch.equal(words[k], w) and torch.equal(logits[k], lg)
    else:
        words = make_scanned_beam_decoder(
            tmodel, CFG.max_length, beam_width=BEAM_WIDTH)(betas, start, end)
        single = make_beam_decoder(tmodel, CFG.max_length,
                                   beam_width=BEAM_WIDTH)
        for k in range(len(betas)):
            assert torch.equal(words[k], single(betas[k], start, end)[0])
