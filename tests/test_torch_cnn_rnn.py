"""The port's CnnRnn (GRU) modules against the flax modules of the JAX
package, on the same transplanted weights and the same numpy inputs: the
Keras GRU cell, the linear attention, both flavours of PatchDense (the
per-patch one with BatchNorm also in training mode), and CnnRnnNIC's
teacher-forced forward and decode step for both values of the zero-state
quirk. fp32 on the CPU agrees to 1e-5 (only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.attention import BahdanauAttention as JAttention
from masters_thesis_tpu.models.encoders import PatchDense as JPatchDense
from masters_thesis_tpu.models.lstm import KerasGRUCell as JGRUCell
from masters_thesis_tpu.models.nic import NIC as JNIC
from masters_thesis_tpu.models.nic import CnnRnnNIC as JCnnRnnNIC
from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.encoders import PatchDense
from masters_thesis_tpu_torch.models.lstm import KerasGRUCell
from masters_thesis_tpu_torch.models.nic import NIC, CnnRnnNIC
from masters_thesis_tpu_torch.ops.fused_decode import spread_for_check
from masters_thesis_tpu_torch.transplant import from_flax, to_flax

from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
P, C, EMB, UNITS, VOCAB, T, B = 6, 24, 64, 16, 40, 6, 8


def randomise(variables, rng, scale=0.3):
    """Biases and BatchNorm parameters and statistics start at 0/1 in flax;
    give them random values so the comparison exercises them."""
    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "bias" or (path and path[-1] == "bn"):
                node[k] = rng.normal(0, scale, v.shape).astype(np.float32)
    walk(variables["params"])
    for node in _find(variables.get("batch_stats", {}), "bn"):
        node["mean"] = rng.normal(0, 0.5, node["mean"].shape).astype(
            np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(
            np.float32)
    return variables


def _find(tree, name):
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == name:
                yield v
            else:
                yield from _find(v, name)


def _close(actual, expected):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected),
                               **TOL)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_keras_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, UNITS)).astype(np.float32)
    x = rng.standard_normal((B, C + EMB)).astype(np.float32)
    jcell = JGRUCell(UNITS)
    params = _numpy(jcell.init(jax.random.PRNGKey(0), h, x))["params"]
    params["bias"] = rng.normal(0, 0.3, params["bias"].shape).astype(
        np.float32)
    h_ref, out_ref = jcell.apply({"params": params}, h, x)
    tcell = KerasGRUCell(C + EMB, UNITS)
    tcell.load_state_dict(from_flax({"params": params}))
    assert tuple(tcell.bias.shape) == (2, 3 * UNITS)
    with torch.no_grad():
        h_new, out = tcell(torch.from_numpy(h), torch.from_numpy(x))
    _close(h_new, h_ref)
    _close(out, out_ref)


def test_linear_attention_matches_flax():
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((3, UNITS)).astype(np.float32)
    feats = rng.standard_normal((3, 7, EMB)).astype(np.float32)
    jatt = JAttention(UNITS, inner_activation="linear")
    variables = randomise(_numpy(jatt.init(jax.random.PRNGKey(0), hidden,
                                           feats)), rng)
    ctx_ref, alpha_ref = jatt.apply(variables, hidden, feats)
    tatt = BahdanauAttention(UNITS, EMB, UNITS, inner_activation="linear")
    tatt.load_state_dict(from_flax(variables))
    with torch.no_grad():
        ctx, alpha = tatt(torch.from_numpy(hidden), torch.from_numpy(feats))
    _close(ctx, ctx_ref)
    _close(alpha, alpha_ref)
    with pytest.raises(ValueError, match="inner_activation"):
        BahdanauAttention(UNITS, EMB, UNITS, inner_activation="relu")


PATCH_FLAVOURS = {
    "shared-relu": dict(activation="relu"),
    "shared-leaky": dict(activation="leaky_relu"),
    "per-patch-bn": dict(activation="leaky_relu", per_patch=True,
                         use_bn=True),
}


def _patch_pair(flavour, seed=0):
    kw = PATCH_FLAVOURS[flavour]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, P, C)).astype(np.float32)
    jenc = JPatchDense(EMB, **kw)
    variables = randomise(_numpy(jenc.init(jax.random.PRNGKey(seed), x)),
                          rng)
    tenc = PatchDense(P, C, EMB, **kw)
    tenc.load_state_dict(from_flax(variables))
    return jenc, variables, tenc, x


@pytest.mark.parametrize("flavour", list(PATCH_FLAVOURS))
def test_patch_dense_matches_flax_in_eval(flavour):
    jenc, variables, tenc, x = _patch_pair(flavour)
    assert tenc.row_shape == (P, C)
    with torch.no_grad():
        _close(tenc(torch.from_numpy(x)), jenc.apply(variables, x))


def test_per_patch_dense_matches_flax_in_training():
    """Batch statistics and the running averages after one step."""
    jenc, variables, tenc, x = _patch_pair("per-patch-bn", seed=3)
    y_ref, updates = jenc.apply(variables, x, training=True,
                                mutable=["batch_stats"])
    with torch.no_grad():
        y = tenc(torch.from_numpy(x), training=True)
    _close(y, y_ref)
    _close(tenc.bn.mean, updates["batch_stats"]["bn"]["mean"])
    _close(tenc.bn.var, updates["batch_stats"]["bn"]["var"])


def nic_pair(zero_state, seed=0, units=UNITS, vocab=VOCAB, true_vocab=0,
             patches=P, b=B, spread=True):
    """(flax CnnRnnNIC, numpy variables, port CnnRnnNIC with the same
    weights, rows (b, patches, C)). With ``spread`` the weights are the
    port's seeded ones under ``spread_for_check`` (every bias live, greedy
    words that vary, logits up to ~15), handed to flax with ``to_flax``;
    otherwise flax's initialisers with random biases (logits near 1, for
    the forward's 1e-5 comparison)."""
    kw = dict(embed_dim=EMB, units=units, vocab_size=vocab,
              true_vocab=true_vocab, max_length=T, gru_zero_state=zero_state)
    rows = np.random.default_rng(seed).standard_normal(
        (b, patches, C)).astype(np.float32)
    jmodel = JCnnRnnNIC(**kw)
    gen = torch.Generator().manual_seed(seed)
    tmodel = CnnRnnNIC(n_patches=patches, in_channels=C, generator=gen, **kw)
    if spread:
        spread_for_check(tmodel, gen)
        variables = to_flax(tmodel.state_dict())
    else:
        a0 = np.zeros((b, units), np.float32)
        variables = randomise(_numpy(jmodel.init(
            jax.random.PRNGKey(seed), rows, np.zeros((b, T), np.int32), a0,
            a0)), np.random.default_rng(seed))
        tmodel.load_state_dict(from_flax(variables))
    return jmodel, variables, tmodel.eval(), rows


@pytest.mark.parametrize("zero_state", [True, False])
def test_cnn_rnn_teacher_forced_forward_matches_flax(zero_state):
    jmodel, variables, tmodel, rows = nic_pair(zero_state, spread=False)
    tokens = np.random.default_rng(5).integers(0, VOCAB, (B, T)).astype(
        np.int32)
    a0 = np.zeros((B, UNITS), np.float32)
    logits_ref, alphas_ref = jmodel.apply(variables, rows, tokens, a0, a0)
    with torch.no_grad():
        logits, alphas = tmodel(torch.from_numpy(rows),
                                torch.from_numpy(tokens).long(),
                                torch.from_numpy(a0), torch.from_numpy(a0))
    assert logits.shape == (B, T, VOCAB) and alphas.shape == (B, T, P)
    _close(logits, logits_ref)
    _close(alphas, alphas_ref)


@pytest.mark.parametrize("zero_state", [True, False])
def test_cnn_rnn_decode_step_matches_flax(zero_state):
    """One step from a random carry: under zero state the cell ignores h,
    which feeds only the attention; c comes back unchanged."""
    jmodel, variables, tmodel, rows = nic_pair(zero_state, seed=1,
                                               spread=False)
    rng = np.random.default_rng(6)
    h, c = (rng.standard_normal((B, UNITS)).astype(np.float32)
            for _ in range(2))
    tok = rng.integers(0, VOCAB, B).astype(np.int32)
    feats = jmodel.apply(variables, rows, False, method="encode")
    ref = jmodel.apply(variables, h, c, feats, jnp.asarray(tok),
                       method="decode_step")
    with torch.no_grad():
        out = tmodel.decode_step(torch.from_numpy(h), torch.from_numpy(c),
                                 tmodel.encode(torch.from_numpy(rows)),
                                 torch.from_numpy(tok).long())
    for got, want in zip(out, ref):
        _close(got, want)
    assert torch.equal(out[1], torch.from_numpy(c))


def test_cnn_rnn_factory_matches_the_reference_configuration():
    """configs/cnn_rnn.yaml through experiment.build_model: a relu
    PatchDense to 256, GRU 512, attention 512, linear head 512, zero-state
    recurrence, no attention dropout."""
    model = CnnRnnNIC(generator=torch.Generator().manual_seed(0))
    jmodel = JCnnRnnNIC(embed_dim=256, units=512, vocab_size=5001)
    assert model.cell_type == jmodel.cell_type == "gru"
    assert model.gru_zero_state is jmodel.gru_zero_state is True
    assert model.head_activation == jmodel.head_activation == "linear"
    assert (model.attn_inner_activation == jmodel.attn_inner_activation
            == "linear")
    assert model.encoder.row_shape == (64, 2048)
    assert tuple(model.encoder.proj.kernel.shape) == (2048, 256)
    assert tuple(model.gru.kernel.shape) == (512, 1536)
    assert tuple(model.attention.W2.kernel.shape) == (512, 512)
    assert tuple(model.dense_inter.kernel.shape) == (512, 512)
    assert model.attention.dropout == 0.0


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("per_patch", [False, True])
def test_cnn_rnn_tree_transplants_exactly(per_patch):
    """The CnnRnn tree (``gru/*``, ``encoder/proj/*``) and the per-patch
    encoder's (``encoder/kernel``, ``encoder/bn``, its batch_stats) map key
    for key, and a round trip is bit-exact."""
    encoder_kw = (dict(activation="leaky_relu", per_patch=True, use_bn=True)
                  if per_patch else dict(activation="relu"))
    kw = dict(units=UNITS, embedding_text=EMB, attn_units=UNITS,
              vocab_size=VOCAB, max_length=T, cell_type="gru",
              head_dim=UNITS, head_activation="linear",
              attn_inner_activation="linear")
    jmodel = JNIC(encoder=JPatchDense(EMB, name="encoder", **encoder_kw),
                  **kw)
    rows = np.zeros((2, P, C), np.float32)
    a0 = np.zeros((2, UNITS), np.float32)
    variables = randomise(_numpy(jmodel.init(
        jax.random.PRNGKey(0), rows, np.zeros((2, T), np.int32), a0, a0)),
        np.random.default_rng(0))
    state = from_flax(variables)
    tmodel = NIC(encoder=PatchDense(P, C, EMB, **encoder_kw), **kw)
    assert set(state) == set(tmodel.state_dict())
    assert "gru.recurrent_kernel" in state
    assert ("encoder.bn.var" in state) == per_patch
    assert ("encoder.proj.kernel" in state) != per_patch
    tmodel.load_state_dict(state)
    back = dict(_leaves(to_flax(tmodel.state_dict())))
    want = dict(_leaves(variables))
    assert back.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
