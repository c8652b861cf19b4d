"""The port's modules against the flax modules of the JAX package, in eval
mode, on the same transplanted weights and the same numpy inputs: fp32 on
the CPU agrees to 1e-5 (only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.attention import BahdanauAttention as JAttention
from masters_thesis_tpu.models.lstm import KerasLSTMCell as JLSTMCell
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.lstm import KerasLSTMCell
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.transplant import from_flax

TOL = dict(rtol=1e-5, atol=1e-5)
UNITS, GSIZE, EMB, ATTN, VOCAB, T = 16, 4, 8, 8, 40, 6


def _randomise(variables, rng):
    """Biases and BatchNorm statistics start at 0/1 in flax; give them
    random values so the comparison exercises them."""
    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "bias" or path[-1:] == ("input_bn",):
                node[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        return node
    walk(variables["params"])
    if "batch_stats" in variables:
        bn = variables["batch_stats"]["encoder"]["input_bn"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _pair(n_voxels=96, n_groups=5, vocab=VOCAB, true_vocab=0, b=5, seed=0):
    """(flax LcNIC, numpy variables, port LcNIC with the same weights,
    betas, tokens)."""
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=seed),
                         n_voxels)
    kw = dict(units=UNITS, group_size=GSIZE, embedding_text=EMB,
              attn_units=ATTN, vocab_size=vocab, max_length=T,
              true_vocab=true_vocab)
    jmodel = JLcNIC(layout=layout, **kw)
    rng = np.random.default_rng(seed)
    betas = rng.standard_normal((b, n_voxels)).astype(np.float32)
    tokens = rng.integers(0, true_vocab or vocab, (b, T)).astype(np.int32)
    a0 = np.zeros((b, UNITS), np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), betas, tokens, a0,
                                a0))
    variables = _randomise(variables, rng)
    tmodel = LcNIC(layout, **kw, generator=torch.Generator().manual_seed(seed))
    tmodel.load_state_dict(from_flax(variables))
    return jmodel, variables, tmodel.eval(), betas, tokens


def _close(actual, expected):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected),
                               **TOL)


@pytest.mark.parametrize("n_voxels,n_groups", [(96, 5), (4000, 8)])
def test_locally_dense_matches_flax(n_voxels, n_groups):
    """Ragged groups; (4000, 8) spreads them over several buckets."""
    jmodel, variables, tmodel, betas, _ = _pair(n_voxels, n_groups)
    if n_groups == 8:
        assert len(tmodel.encoder.layout.buckets) >= 2
    ref = jmodel.apply(variables, betas, False, method="encode")
    with torch.no_grad():
        _close(tmodel.encode(torch.from_numpy(betas)), ref)


def test_bahdanau_attention_matches_flax():
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((3, UNITS)).astype(np.float32)
    feats = rng.standard_normal((3, 7, GSIZE)).astype(np.float32)
    jatt = JAttention(ATTN)
    variables = _randomise(jax.tree_util.tree_map(
        np.asarray, jatt.init(jax.random.PRNGKey(0), hidden, feats)), rng)
    ctx_ref, alpha_ref = jatt.apply({"params": variables["params"]}, hidden,
                                    feats)
    tatt = BahdanauAttention(ATTN, GSIZE, UNITS)
    tatt.load_state_dict(from_flax({"params": variables["params"]}))
    with torch.no_grad():
        ctx, alpha = tatt(torch.from_numpy(hidden), torch.from_numpy(feats))
    assert alpha.shape == (3, 7, 1)
    _close(ctx, ctx_ref)
    _close(alpha, alpha_ref)


def test_keras_lstm_cell_matches_flax():
    rng = np.random.default_rng(2)
    h, c = (rng.standard_normal((4, UNITS)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((4, GSIZE + EMB)).astype(np.float32)
    jcell = JLSTMCell(UNITS)
    params = jax.tree_util.tree_map(
        np.asarray, jcell.init(jax.random.PRNGKey(0), (h, c), x))["params"]
    params["bias"] = rng.normal(0, 0.3, params["bias"].shape).astype(
        np.float32)
    (h_ref, c_ref), _ = jcell.apply({"params": params}, (h, c), x)
    tcell = KerasLSTMCell(GSIZE + EMB, UNITS)
    tcell.load_state_dict(from_flax({"params": params}))
    with torch.no_grad():
        (h_new, c_new), out = tcell(
            (torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    _close(h_new, h_ref)
    _close(c_new, c_ref)
    assert torch.equal(out, h_new)


@pytest.mark.parametrize("vocab,true_vocab", [(VOCAB, 0), (48, VOCAB)])
def test_decode_step_matches_flax(vocab, true_vocab):
    """One decode step from a random carry; the padded case masks ids
    >= true_vocab to -1e9 as the head's last op."""
    jmodel, variables, tmodel, betas, tokens = _pair(
        vocab=vocab, true_vocab=true_vocab)
    rng = np.random.default_rng(3)
    h, c = (rng.standard_normal((len(betas), UNITS)).astype(np.float32)
            for _ in range(2))
    feats = jmodel.apply(variables, betas, False, method="encode")
    ref = jmodel.apply(variables, h, c, feats, jnp.asarray(tokens[:, 0]),
                       method="decode_step")
    with torch.no_grad():
        out = tmodel.decode_step(
            torch.from_numpy(h), torch.from_numpy(c),
            tmodel.encode(torch.from_numpy(betas)),
            torch.from_numpy(tokens[:, 0]).long())
    for got, want in zip(out, ref):
        _close(got, want)
    if true_vocab:
        assert torch.all(out[2][:, true_vocab:] == -1e9)


def test_teacher_forced_forward_matches_flax():
    jmodel, variables, tmodel, betas, tokens = _pair()
    a0 = np.zeros((len(betas), UNITS), np.float32)
    logits_ref, alphas_ref = jmodel.apply(variables, betas, tokens, a0, a0)
    with torch.no_grad():
        logits, alphas = tmodel(torch.from_numpy(betas),
                                torch.from_numpy(tokens).long(),
                                torch.from_numpy(a0), torch.from_numpy(a0))
    assert logits.shape == (len(betas), T, VOCAB)
    _close(logits, logits_ref)
    _close(alphas, alphas_ref)


@pytest.mark.parametrize("kw,item", [
    # the GRU cell is ported (tests/test_torch_cnn_rnn.py); its family's
    # learned carry is not
    (dict(cell_type="gru", learned_init_state=True), "M11"),
    (dict(learned_init_state=True), "M11"),
    (dict(pretrained_embedding=np.zeros((VOCAB, EMB), np.float32)), "M11"),
])
def test_unported_variants_name_their_roadmap_item(kw, item):
    layout = GroupLayout(synthetic_groups(64, 4), 64)
    with pytest.raises(NotImplementedError, match=item):
        LcNIC(layout, units=UNITS, group_size=GSIZE, embedding_text=EMB,
              attn_units=ATTN, vocab_size=VOCAB, **kw)
