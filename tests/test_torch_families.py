"""Every model family of the JAX package's ``experiment.build_model`` in the
port against the JAX package, on the CPU: both factories build the family
from one config, the flax variables (flax's initialisers with random biases
and BatchNorm statistics) load into the port strictly, key for key, and the
eval-mode teacher-forced forward, the initial carry and one decode step
agree within 1e-5 (fp32, summation order only). The variants: the learned
initial carry, GloVe tables frozen and trainable (also over a padded
vocab), the image, concat, deep and fully connected encoders, the ShowTell
family (showtell, thinkandtell, guse_nic) and ms2_nic in its modes split, a
and b. Then ``fused_train_supported`` gives the JAX answer on every family,
and 3-step dropout-off train trajectories of cnn_rnn, showtell (masked),
ms2_nic (subject split) and the learned-init lc_nic stay within 2e-5 of the
JAX steps (the JAX package's criterion)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.config import TPUConfig as JTPUConfig
from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.ops.fused_seq import (
    fused_train_supported as j_fused_train_supported,
)
from masters_thesis_tpu.train import optim as joptim
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu.train.state import TrainState as JTrainState
from masters_thesis_tpu.train.state import init_model as jinit_model
from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config, TPUConfig
from masters_thesis_tpu_torch.ops.fused_seq import fused_train_supported
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.state import new_state
from masters_thesis_tpu_torch.transplant import from_flax

from torch_threads import one_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
TRAJ = dict(rtol=2e-5, atol=2e-5)
N_VOXELS, N_GROUPS, B, P, C = 96, 5, 4, 6, 12
NO_DROPOUT = dict(dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
                  dropout_lstm=0.0, dropout_out=0.0, dropout_input=0.0)
CFG = dict(batch_size=B, max_length=6, top_k=39, units=16, attn_units=8,
           group_size=4, embedding_text=8, embedding_features=8,
           **NO_DROPOUT)
E_GLOVE = 8

FAMILIES = {
    "lc_nic-learned-init": dict(model="lc_nic", learned_init_state=True),
    "lc_nic-glove-frozen": dict(model="lc_nic", glove_trainable=False),
    "lc_nic-glove-trainable": dict(model="lc_nic", glove_trainable=True),
    "lc_nic-glove-frozen-padded-vocab": dict(model="lc_nic",
                                             glove_trainable=False,
                                             vocab_pad_multiple=64),
    "lc_nic-glove-trainable-padded-vocab": dict(model="lc_nic",
                                                glove_trainable=True,
                                                vocab_pad_multiple=64),
    "img_nic": dict(model="img_nic"),
    "img_nic-learned-init": dict(model="img_nic", learned_init_state=True),
    "cnn_rnn": dict(model="cnn_rnn"),
    "cnn_rnn-learned-init": dict(model="cnn_rnn", learned_init_state=True),
    "concat_lc_nic": dict(model="concat_lc_nic"),
    "deep_lc_nic": dict(model="deep_lc_nic"),
    "fc_nic": dict(model="fc_nic"),
    "showtell": dict(model="showtell"),
    "thinkandtell": dict(model="thinkandtell"),
    "guse_nic": dict(model="guse_nic"),
    "ms2_nic": dict(model="ms2_nic"),
}


def _configs(model="lc_nic", vocab_pad_multiple=0, **kw):
    fields = {**CFG, "model": model, **kw}
    return (JConfig(**fields,
                    tpu=JTPUConfig(vocab_pad_multiple=vocab_pad_multiple)),
            Config(**fields,
                   tpu=TPUConfig(vocab_pad_multiple=vocab_pad_multiple)))


def _row_shape(model):
    if model in ("img_nic", "cnn_rnn"):
        return (P, C)
    return (512,) if model == "guse_nic" else (N_VOXELS,)


def _randomise(variables, rng):
    """flax starts biases and BatchNorm at 0/1: random values make the
    comparison exercise them."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k.startswith("bias") or k == "scale":
                node[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            elif k == "mean":
                node[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    walk(variables)
    return variables


def family_pair(family, seed=0):
    """(JAX model, numpy variables, port model with the same weights,
    configs (JAX, port), numpy rows (B, *row), tokens (B, T))."""
    kw = dict(FAMILIES[family])
    jcfg, cfg = _configs(**kw)
    rng = np.random.default_rng(seed)
    groups = synthetic_groups(N_VOXELS, N_GROUPS, seed=seed)
    row_shape = _row_shape(cfg.model)
    table = None
    if "glove_trainable" in kw:
        table = rng.standard_normal((cfg.vocab_size, E_GLOVE)).astype(
            np.float32)
    jmodel, jrules, jmasked = jexp.build_model(
        jcfg, groups, row_shape[0], embedding_table=table)
    tmodel, rules, masked = experiment.build_model(
        cfg, groups, row_shape[0], embedding_table=table,
        row_shape=row_shape)
    assert masked == jmasked and len(rules) == len(jrules)
    rows = rng.standard_normal((B, *row_shape)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, cfg.max_length)).astype(
        np.int32)
    variables = jax.tree_util.tree_map(np.asarray, dict(zip(
        ("params", "batch_stats"), jinit_model(jmodel, jcfg, rows,
                                               tokens)[:2])))
    variables = _randomise(variables, rng)
    tmodel.load_state_dict(from_flax(variables))        # strict: key for key
    return jmodel, variables, tmodel.eval(), (jcfg, cfg), rows, tokens


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or FWD))


def _check_forward(jmodel, variables, tmodel, rows, tokens, units):
    a0 = np.zeros((len(rows), units), np.float32)
    logits_ref, attn_ref = jmodel.apply(variables, rows, tokens, a0, a0)
    with torch.no_grad():
        logits, attn = tmodel(torch.from_numpy(rows),
                              torch.from_numpy(tokens).long(),
                              torch.from_numpy(a0), torch.from_numpy(a0))
    _close(logits, logits_ref)
    _close(attn, attn_ref)
    # the decode API: initial carry, then one step from the start token
    feats = jmodel.apply(variables, rows, False, method="encode")
    h, c = jmodel.apply(variables, feats, method="init_carry")
    ref = jmodel.apply(variables, h, c, feats,
                       jnp.full((len(rows),), 1, jnp.int32),
                       method="decode_step")
    with torch.no_grad():
        tfeats = tmodel.encode(torch.from_numpy(rows))
        th, tc = tmodel.init_carry(tfeats)
        out = tmodel.decode_step(th, tc, tfeats,
                                 torch.full((len(rows),), 1))
    _close(tfeats, feats)
    _close(th, h)
    _close(tc, c)
    for got, want in zip(out, ref):
        _close(got, want)
    return np.asarray(logits_ref)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax_in_eval(family):
    jmodel, variables, tmodel, (_, cfg), rows, tokens = family_pair(family)
    assert tmodel.row_shape == rows.shape[1:]
    logits = _check_forward(jmodel, variables, tmodel, rows, tokens,
                            cfg.units)
    assert logits.shape == (B, cfg.max_length, cfg.padded_vocab_size)
    if "glove" in family:
        table = jmodel.pretrained_embedding
        emb = tmodel.embedding.detach().numpy()
        np.testing.assert_array_equal(emb[:len(table)], table)
        assert not emb[len(table):].any()
        frozen = "frozen" in family
        assert ("embedding" in dict(tmodel.named_parameters())) != frozen
        assert ("embedding" in tmodel.state_dict()) != frozen
        assert ("embedding" in variables["params"]) != frozen


@pytest.mark.parametrize("mode", ["split", "a", "b"])
def test_ms2_nic_modes_match_jax(mode):
    """The split layout sends the first half through encoder_a and the
    second through encoder_b; "a" and "b" send every row through one."""
    jmodel, variables, tmodel, (_, cfg), rows, tokens = family_pair(
        "ms2_nic", seed=3)
    jmodel = dataclasses.replace(jmodel, encoder=dataclasses.replace(
        jmodel.encoder, mode=mode))
    tmodel.encoder.mode = mode
    _check_forward(jmodel, variables, tmodel, rows, tokens, cfg.units)
    with torch.no_grad():
        feats = tmodel.encode(torch.from_numpy(rows))
        a = tmodel.encoder.encoder_a(torch.from_numpy(rows))
    if mode == "split":
        assert not torch.allclose(feats, a)
        assert torch.equal(feats[:B // 2], a[:B // 2])
    else:
        assert torch.equal(feats, a) == (mode == "a")


def test_ms2_split_refuses_an_odd_batch():
    _, _, tmodel, _, rows, _ = family_pair("ms2_nic")
    with pytest.raises(ValueError, match="even batch"):
        tmodel.encode(torch.from_numpy(rows[:3]))


@pytest.mark.parametrize("family", list(FAMILIES) + ["lc_nic", "ms_nic"])
@pytest.mark.parametrize("remat", [False, True])
def test_fused_train_supported_matches_jax(family, remat):
    """The port routes a family through the fused sequence's custom
    backward exactly when the JAX package does: an LSTM NIC with a zero
    initial carry and a trainable embedding, without remat."""
    kw = dict(FAMILIES.get(family, {"model": family}))
    kw.pop("vocab_pad_multiple", None)
    jcfg, cfg = _configs(**kw)
    jcfg.tpu.remat = cfg.tpu.remat = remat
    groups = synthetic_groups(N_VOXELS, N_GROUPS, seed=0)
    row_shape = _row_shape(cfg.model)
    table = (np.ones((cfg.vocab_size, E_GLOVE), np.float32)
             if "glove_trainable" in kw else None)
    jmodel, _, _ = jexp.build_model(jcfg, groups, row_shape[0],
                                    embedding_table=table)
    tmodel, _, _ = experiment.build_model(cfg, groups, row_shape[0],
                                          embedding_table=table,
                                          row_shape=row_shape)
    want = j_fused_train_supported(jmodel, jcfg)
    assert fused_train_supported(tmodel, cfg) == want
    assert want == (family in ("lc_nic", "ms_nic", "concat_lc_nic",
                               "deep_lc_nic", "fc_nic", "img_nic",
                               "ms2_nic", "lc_nic-glove-trainable",
                               "lc_nic-glove-trainable-padded-vocab")
                    and not remat)


def test_families_refuse_as_the_jax_factory_does():
    groups = synthetic_groups(N_VOXELS, N_GROUPS, seed=0)
    table = np.zeros((40, E_GLOVE), np.float32)
    for model in ("showtell", "cnn_rnn", "ms2_nic"):
        _, cfg = _configs(model=model)
        with pytest.raises(ValueError, match="glove_path"):
            experiment.build_model(cfg, groups, N_VOXELS,
                                   embedding_table=table,
                                   row_shape=_row_shape(model))
    for model in ("ms2_nic", "guse_nic", "showtell", "thinkandtell"):
        _, cfg = _configs(model=model, learned_init_state=True)
        with pytest.raises(ValueError, match="learned_init_state"):
            experiment.build_model(cfg, groups, N_VOXELS,
                                   row_shape=_row_shape(model))
    _, cfg = _configs(model="lc_nac")
    with pytest.raises(ValueError, match="unknown model"):
        experiment.build_model(cfg, groups, N_VOXELS)
    assert set(experiment.PORTED_MODELS) == {
        "lc_nic", "ms_nic", "concat_lc_nic", "deep_lc_nic", "fc_nic",
        "ms2_nic", "img_nic", "cnn_rnn", "showtell", "thinkandtell",
        "guse_nic"}


# ---- 3-step trajectories ----

def _jax_state(variables, jcfg):
    return JTrainState.create(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables.get("batch_stats", {})),
        tx=joptim.make_optimizer(jcfg), rng=jax.random.PRNGKey(0))


KEYS = ("loss", "L2", "attention", "accuracy", "total", "grad_norm")


@pytest.mark.parametrize("family", ["cnn_rnn", "showtell", "ms2_nic",
                                    "lc_nic-learned-init"])
def test_three_train_steps_match_jax(family):
    """cnn_rnn and showtell train on the masked CCE (a padded tail in the
    targets), ms2_nic on a [A-half ; B-half] batch. The attention's V.bias
    has an exactly-0 gradient (softmax shift), so Adam turns each side's
    rounding into steps of up to lr: it is held to that bound."""
    jmodel, variables, tmodel, (jcfg, cfg), rows, tokens = family_pair(
        family, seed=2)
    jcfg = dataclasses.replace(jcfg, alpha=1e-3)
    cfg = dataclasses.replace(cfg, alpha=1e-3)
    target = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)], 1)
    target[0, -3:] = 0
    _, jrules, masked = jexp.build_model(
        jcfg, synthetic_groups(N_VOXELS, N_GROUPS, seed=2), rows.shape[1])
    rules = experiment.build_model(
        cfg, synthetic_groups(N_VOXELS, N_GROUPS, seed=2), rows.shape[1],
        row_shape=rows.shape[1:])[1]
    assert masked == (family in ("cnn_rnn", "showtell"))
    state = new_state(tmodel.train(), cfg, "cpu")
    step = steps.make_train_step(cfg, rules, masked=masked)
    jstep = jsteps.make_train_step(jmodel, jcfg, jrules, masked=masked,
                                   donate=False)
    jstate = _jax_state(variables, jcfg)
    batch = (rows, tokens, target)
    for _ in range(3):
        state, m = step(state, *(torch.from_numpy(a) for a in batch))
        jstate, jm = jstep(jstate, *batch)
        for key in KEYS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **TRAJ)
    params = jax.device_get(jstate.params)
    initial = variables["params"]
    if "attention" in params:
        v_bias = params["attention"]["V"].pop("bias")
        bound = 3 * cfg.alpha * 1.001
        start = initial["attention"]["V"]["bias"]
        for got in (state.model.attention.V.bias.detach().numpy(), v_bias):
            assert np.abs(got - start).max() <= bound
    got = state.model.state_dict()
    want = from_flax({"params": params,
                      "batch_stats": jax.device_get(jstate.batch_stats)})
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), value.numpy(),
                                   err_msg=key, **TRAJ)
