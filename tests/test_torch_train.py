"""The port's training path against the JAX package, piece by piece, on the
same transplanted weights and the same numpy inputs, fp32 on the CPU: the
training-mode BatchNorm, the LcNIC training forward (raw and pregathered
input), the loss terms and their gradients, the optimizer chain and its
schedules, and the train, SAM, gathered, eval and scanned steps.

Dropout streams cannot match across frameworks, so every comparison runs
with each dropout rate at 0 (the reference's own standard,
``tests/test_fused_seq.py``) and dropout is tested on its own. Tolerances:
1e-5 for one forward (summation order only), 1e-6 for one optimizer update,
2e-5 for 3-step trajectories (ROADMAP M5)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu.train import losses as jlosses
from masters_thesis_tpu.train import optim as joptim
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu.train.state import TrainState as JTrainState
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.models.common import BatchNorm, dropout
from masters_thesis_tpu_torch.ops.gather import gather_rows
from masters_thesis_tpu_torch.train import losses, optim, steps
from masters_thesis_tpu_torch.train.state import init_model
from masters_thesis_tpu_torch.transplant import from_flax, to_flax

from torch_threads import one_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
TRAJ = dict(rtol=2e-5, atol=2e-5)
N_VOXELS, N_GROUPS, B = 96, 5, 4
NO_DROPOUT = dict(dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
                  dropout_lstm=0.0, dropout_out=0.0, dropout_input=0.0)
CFG = dict(batch_size=B, max_length=6, top_k=39, units=16, attn_units=8,
           group_size=4, embedding_text=8, **NO_DROPOUT)


def _configs(**kw):
    return JConfig(**{**CFG, **kw}), Config(**{**CFG, **kw})


def _randomise(variables, rng):
    """flax starts biases and BatchNorm at 0/1; random values make the
    comparison exercise them."""
    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "bias" or path[-1:] == ("input_bn",):
                node[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
    walk(variables["params"])
    bn = variables["batch_stats"]["encoder"]["input_bn"]
    bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _setup(pregathered=False, seed=0, **cfg_kw):
    """JAX model, numpy variables, port TrainState with the same weights,
    configs and a numpy batch (betas in the model's input layout)."""
    jcfg, cfg = _configs(**cfg_kw)
    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=seed),
                         N_VOXELS)
    jmodel = JLcNIC(layout=layout, units=cfg.units,
                    group_size=cfg.group_size,
                    embedding_text=cfg.embedding_text,
                    attn_units=cfg.attn_units, vocab_size=cfg.vocab_size,
                    max_length=cfg.max_length, pregathered=pregathered,
                    **NO_DROPOUT)
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((B, N_VOXELS)).astype(np.float32)
    betas = layout.permute_rows(raw) if pregathered else raw
    tokens = rng.integers(1, cfg.vocab_size, (B, cfg.max_length)).astype(
        np.int32)
    target = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)], 1)
    target[0, -3:] = 0                    # padding for the masked variants
    a0 = np.zeros((B, cfg.units), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), betas, tokens, a0, a0))
    variables = _randomise(variables, rng)
    state = init_model(cfg, layout, "cpu", pregathered=pregathered)
    state.model.load_state_dict(from_flax(variables))
    return jmodel, variables, state, jcfg, cfg, (betas, tokens, target)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _assert_tree_close(state_dict, variables, **tol):
    """Every leaf of a flax variable tree against the port's tensor of the
    same name."""
    for key, want in from_flax(variables).items():
        np.testing.assert_allclose(state_dict[key].detach().numpy(),
                                   want.numpy(), err_msg=key, **tol)


# ---- dropout, on its own ----

def test_dropout_keeps_one_minus_rate_and_scales_the_kept():
    x = torch.ones(400_000)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0), training=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.all(y[kept] == 1 / 0.7)


def test_dropout_is_the_identity_in_eval_and_at_rate_zero():
    x = torch.randn(50)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.5, gen, training=False) is x
    assert dropout(x, 0.0, gen, training=True) is x
    assert torch.equal(dropout(x, 1.0, gen, training=True),
                       torch.zeros(50))


def test_dropout_same_generator_seed_same_masks():
    x = torch.randn(1000)
    draw = lambda seed: dropout(  # noqa: E731
        x, 0.4, torch.Generator().manual_seed(seed), training=True)
    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))


def test_train_step_masks_follow_seed_and_step():
    """The step's masks depend on (seed, step) alone: two states with the
    same seed take the same dropout step, another seed another."""
    outs = []
    for seed in (1, 1, 2):
        _, _, state, _, cfg, batch = _setup(
            dropout_text=0.5, dropout_lstm=0.5)
        state.seed = seed
        _, m = steps.make_train_step(cfg, [])(state, *_t(*batch))
        outs.append(float(m["loss"]))
    assert outs[0] == outs[1] != outs[2]


# ---- BatchNorm in training mode ----

def test_batchnorm_training_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7, 6)).astype(np.float32) * 2 + 0.5
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   "bias": rng.normal(0, 0.3, 6).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.5, 6).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3)
    want, mutated = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = BatchNorm(6)
    bn.load_state_dict(from_flax(variables))
    got = bn(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    _assert_tree_close(bn.state_dict(), {
        "params": variables["params"], **mutated}, **FWD)
    # eval mode reads the running statistics and leaves them alone
    before = bn.mean.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.mean, before)


# ---- the model's training forward ----

@pytest.mark.parametrize("pregathered", [False, True],
                         ids=["raw", "pregathered"])
def test_training_forward_matches_flax(pregathered):
    jmodel, variables, state, _, cfg, (betas, tokens, _) = _setup(
        pregathered)
    a0 = np.zeros((B, cfg.units), np.float32)
    (logits_ref, alphas_ref), mutated = jmodel.apply(
        variables, betas, tokens, a0, a0, training=True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    logits, alphas = state.model(*_t(betas, tokens, a0, a0), training=True)
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, **FWD)
    np.testing.assert_allclose(alphas.detach().numpy(), alphas_ref, **FWD)
    stats = {k: v for k, v in state.model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    _assert_tree_close(stats, mutated, **FWD)


def test_pregathered_input_must_cover_the_layout():
    _, _, state, _, cfg, (betas, tokens, _) = _setup(pregathered=True)
    a0 = torch.zeros(B, cfg.units)
    with pytest.raises(ValueError, match="pregathered"):
        state.model(torch.from_numpy(betas[:, :-1]), torch.from_numpy(tokens),
                    a0, a0)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_terms_match_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    target = rng.integers(0, 11, (3, 5)).astype(np.int32)
    target[1, 2:] = 0
    logits[0, 0, target[0, 0]] = 50.0          # at least one hit
    alphas = rng.dirichlet(np.ones(7), (3, 5)).astype(np.float32)
    mask = (target != 0) if masked else None
    tl, tt, ta = _t(logits, target, alphas)
    tmask = torch.from_numpy(mask) if masked else None
    for got, want in [
        (losses.caption_loss(tl, tt, tmask),
         jlosses.caption_loss(logits, target, mask)),
        (losses.accuracy(tl, tt, tmask),
         jlosses.accuracy(logits, target, mask)),
        (losses.attention_loss(ta), jlosses.attention_loss(alphas)),
    ]:
        np.testing.assert_allclose(float(got), float(want), **FWD)


def test_l2_rules_match_by_flax_name():
    _, variables, state, jcfg, cfg, _ = _setup()
    want = jlosses.l2_loss(variables["params"],
                           jlosses.lc_nic_l2_rules(jcfg))
    got = losses.l2_loss(state.model, losses.lc_nic_l2_rules(cfg))
    np.testing.assert_allclose(float(got), float(want), **FWD)
    names = [n for n, _ in state.model.named_parameters()
             if any(c and losses._matches(tuple(n.split(".")), p)
                    for p, c in losses.lc_nic_l2_rules(cfg))]
    assert "lstm.kernel" in names and "lstm.recurrent_kernel" not in names
    assert "encoder.kernel_0" in names and "attention.V.kernel" not in names


@pytest.mark.parametrize("pregathered", [False, True],
                         ids=["raw", "pregathered"])
def test_loss_and_gradients_match_jax_grad(pregathered):
    """The total training loss (CCE + L2 + attention) and its gradient by
    parameter: each leaf within 1e-5 of the JAX leaf's norm."""
    jmodel, variables, state, jcfg, cfg, (betas, tokens, target) = _setup(
        pregathered, attn_loss=True)
    jrules = jlosses.lc_nic_l2_rules(jcfg)

    def jloss(params):
        return jsteps._forward_loss(
            jmodel, jcfg, jrules, params, variables["batch_stats"],
            jax.random.PRNGKey(0), betas, tokens, target)

    (jtotal, (jmetrics, _)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])
    total, metrics = steps._forward_loss(
        state.model, cfg, losses.lc_nic_l2_rules(cfg), *_t(betas, tokens,
                                                           target), None,
        None)
    names, params = zip(*state.model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    np.testing.assert_allclose(float(total), float(jtotal), **FWD)
    for key in ("loss", "L2", "attention", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), **FWD)
    for key, want in _leaves(jgrads):
        got = grads[key].numpy()
        if key == "attention.V.bias":
            # softmax over regions ignores a shift of every score, so this
            # gradient is exactly 0; both sides hold rounding noise
            assert np.abs(got).max() < 1e-7 and np.abs(want).max() < 1e-7
            continue
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.linalg.norm(want), key


# ---- the optimizer chain ----

def _grads_and_params(scale=1.0):
    rng = np.random.default_rng(6)
    shapes = {"a": (7,), "b": (5, 3), "c": (4, 6, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
    grads["b"] *= 50            # one tensor far above the clip norms
    return grads, params


def _apply_optax(tx, params, grads_seq):
    state = tx.init(params)
    for grads in grads_seq:
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("name", ["clipnorm", "agc"])
def test_gradient_clips_match_optax(name):
    grads, params = _grads_and_params(scale=0.2)
    if name == "clipnorm":
        tx = joptim.clip_by_per_tensor_norm(0.5)
        got = optim.clip_by_per_tensor_norm(_t(*grads.values()), 0.5)
    else:
        tx = joptim.adaptive_grad_clip(0.3)
        got = optim.adaptive_grad_clip(_t(*grads.values()),
                                       _t(*params.values()), 0.3)
    want, _ = tx.update(grads, tx.init(params), params)
    clipped = 0
    for g, key in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), want[key], rtol=1e-6,
                                   atol=1e-7)
        clipped += not np.array_equal(want[key], grads[key])
    assert 0 < clipped < len(grads)     # some tensors clip, some do not


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_updates_match_optax(name):
    """Three updates of the whole chain (AGC, clipnorm, then Adam or SGD)
    on the same gradients."""
    _, cfg = _configs(optimizer=name, clipnorm=0.5, agc_clip=0.3,
                      alpha=1e-2)
    jcfg, _ = _configs(optimizer=name, clipnorm=0.5, agc_clip=0.3,
                       alpha=1e-2)
    grads, params = _grads_and_params(scale=0.2)
    seq = [{k: g * (i + 1) for k, g in grads.items()} for i in range(3)]
    want = _apply_optax(joptim.make_optimizer(jcfg), params, seq)
    tparams = [torch.from_numpy(p.copy()) for p in params.values()]
    opt = optim.make_optimizer(cfg, tparams)
    for g in seq:
        opt.step(_t(*g.values()))
    assert opt.count == 3
    for p, key in zip(tparams, params):
        np.testing.assert_allclose(p.numpy(), want[key], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["warmup", "cosine", "warmup+cosine"])
def test_schedules_match_optax_at_each_step(kind):
    """Evaluated at optax's count (0 at the first update); the warmup's
    values are equal bit for bit. optax's cosine takes XLA's fp32 cos,
    which is not correctly rounded, and torch's differs from it in the
    last bits at some counts (34 of the first 1,100 at decay_steps 1000):
    the cosine is held to 1e-6 of the base rate."""
    warmup, decay, base = (5 if "warmup" in kind else 0,
                           40 if "cosine" in kind else 0, 1e-3)
    _, cfg = _configs(alpha=base, warmup_steps=warmup,
                      cosine_decay_steps=decay)
    _, params = _grads_and_params()
    if kind == "warmup":
        jfn = joptim.warmup_schedule(base, warmup)
    elif kind == "cosine":
        jfn = optax.cosine_decay_schedule(base, decay)
    else:
        jfn = optax.join_schedules(
            [optax.linear_schedule(0.0, base, warmup),
             optax.cosine_decay_schedule(base, decay)], [warmup])
    opt = optim.make_optimizer(cfg, _t(*params.values()))
    got = np.array([opt.lr(c) for c in range(60)], np.float32)
    want = np.array([np.asarray(jfn(c)) for c in range(60)], np.float32)
    if kind == "warmup":
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0.0 and got[warmup] == np.float32(base)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * base)


def test_warmup_leaves_the_first_update_at_zero():
    """optax's count before the increment: lr 0 at the first update, so the
    parameters do not move; they move at the second."""
    _, cfg = _configs(warmup_steps=3, alpha=1e-2)
    grads, params = _grads_and_params()
    tparams = [torch.from_numpy(p.copy()) for p in params.values()]
    opt = optim.make_optimizer(cfg, tparams)
    opt.step(_t(*grads.values()))
    assert all(np.array_equal(p.numpy(), params[k])
               for p, k in zip(tparams, params))
    opt.step(_t(*grads.values()))
    assert not np.array_equal(tparams[0].numpy(), params["a"])


# ---- the steps ----

def _jax_state(variables, jcfg):
    return JTrainState.create(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        tx=joptim.make_optimizer(jcfg), rng=jax.random.PRNGKey(0))


def _assert_state_close(state, jstate, initial, **tol):
    """Every parameter and statistic within ``tol`` of the JAX state's, but
    ``attention.V.bias``: its gradient is exactly 0 (softmax ignores a shift
    of all scores), and Adam scales each side's rounding noise up to steps
    of up to lr. It is held to staying within lr a step of ``initial``."""
    params = jax.device_get(jstate.params)
    v_bias = params["attention"]["V"].pop("bias")
    _assert_tree_close(state.model.state_dict(),
                       {"params": params,
                        "batch_stats": jax.device_get(jstate.batch_stats)},
                       **tol)
    bound = state.step * state.tx.lr(0) * 1.001
    start = initial["params"]["attention"]["V"]["bias"]
    for got in (state.model.attention.V.bias.detach().numpy(), v_bias):
        assert np.abs(got - start).max() <= bound


KEYS = ("loss", "L2", "attention", "accuracy", "total", "grad_norm")


@pytest.mark.parametrize("variant", ["plain", "sam", "masked"])
def test_train_step_matches_jax_over_three_steps(variant):
    kw = {"sam": dict(sam_rho=0.05), "masked": {}, "plain": {}}[variant]
    masked = variant == "masked"
    _, variables, state, jcfg, cfg, batch = _setup(alpha=1e-3, **kw)
    jmodel, *_ = _setup(alpha=1e-3, **kw)
    rules, jrules = (losses.lc_nic_l2_rules(cfg),
                     jlosses.lc_nic_l2_rules(jcfg))
    step = steps.make_train_step(cfg, rules, masked=masked)
    jstep = jsteps.make_train_step(jmodel, jcfg, jrules, masked=masked,
                                   donate=False)
    jstate = _jax_state(variables, jcfg)
    for _ in range(3):
        state, m = step(state, *_t(*batch))
        jstate, jm = jstep(jstate, *batch)
        for key in KEYS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **TRAJ)
    assert state.step == int(jstate.step) == 3
    _assert_state_close(state, jstate, variables, **TRAJ)


def test_eval_step_matches_jax():
    jmodel, variables, state, jcfg, cfg, batch = _setup()
    want = jsteps.make_eval_step(jmodel, jcfg,
                                 jlosses.lc_nic_l2_rules(jcfg))(
        _jax_state(variables, jcfg), *batch)
    got = steps.make_eval_step(cfg, losses.lc_nic_l2_rules(cfg))(
        state, *_t(*batch))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), **FWD)


def _tables(seed=7, n_keys=9, n_pairs=20, K=3):
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n_keys, N_VOXELS)).astype(np.float32)
    store_idx = rng.integers(0, n_keys, n_pairs).astype(np.int32)
    tokens = rng.integers(1, CFG["top_k"] + 1,
                          (n_pairs, CFG["max_length"])).astype(np.int32)
    target = np.concatenate([tokens[:, 1:],
                             np.zeros((n_pairs, 1), np.int32)], 1)
    pair_idx = np.stack([rng.permutation(n_pairs)[:B]
                         for _ in range(K)]).astype(np.int32)
    return store, store_idx, tokens, target, pair_idx


@pytest.mark.parametrize("pregathered", [False, True],
                         ids=["raw", "pregathered"])
def test_scanned_steps_from_tables_match_jax(pregathered):
    """Three steps in one call, each gathering its batch from the store by
    pair id; the JAX side runs its own function of the same name on the
    packed-free 2-D store. Then the scanned eval over the same pair ids."""
    jmodel, variables, state, jcfg, cfg, _ = _setup(pregathered,
                                                     alpha=1e-3)
    store, store_idx, tokens, target, pair_idx = _tables()
    if pregathered:
        store = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=0),
                            N_VOXELS).permute_rows(store)
    rules, jrules = (losses.lc_nic_l2_rules(cfg),
                     jlosses.lc_nic_l2_rules(jcfg))
    tabs = (store, store_idx, tokens, target, pair_idx)
    jstate, jm = jsteps.make_scanned_train_steps_from_tables(
        jmodel, jcfg, jrules)(_jax_state(variables, jcfg), *tabs)
    state, m = steps.make_scanned_train_steps_from_tables(cfg, rules)(
        state, *_t(*tabs))
    assert set(m) == set(KEYS) and m["loss"].shape == (3,)
    for key in KEYS:
        np.testing.assert_allclose(m[key].numpy(), jm[key], err_msg=key,
                                   **TRAJ)
    _assert_state_close(state, jstate, variables, **TRAJ)

    jev = jsteps.make_scanned_eval_steps_from_tables(jmodel, jcfg, jrules)(
        jstate, *tabs)
    ev = steps.make_scanned_eval_steps_from_tables(cfg, rules)(
        state, *_t(*tabs))
    for key in jev:
        np.testing.assert_allclose(ev[key].numpy(), jev[key], err_msg=key,
                                   **TRAJ)


def test_gathered_train_step_matches_gather_then_step():
    """The gathered step is K1 (its plain version here) then the train
    step, clamping an out-of-range id as K1 does."""
    _, _, state, _, cfg, batch = _setup(alpha=1e-3)
    _, _, state2, _, _, _ = _setup(alpha=1e-3)
    store, _, tokens, target, _ = _tables()
    idx = np.asarray([3, 3, 0, 40], np.int32)
    rules = losses.lc_nic_l2_rules(cfg)
    tok, tgt = _t(tokens[:B], target[:B])
    _, m = steps.make_gathered_train_step(cfg, rules)(
        state, *_t(store, idx), tok, tgt)
    _, m2 = steps.make_train_step(cfg, rules)(
        state2, torch.from_numpy(store[[3, 3, 0, 8]]), tok, tgt)
    for key in KEYS:
        assert torch.equal(m[key], m2[key]), key


# ---- configuration and transplant ----

def test_config_defaults_and_names_match_the_jax_config():
    ref = JConfig().to_dict()
    cfg = Config.from_dict(ref)
    for key, value in vars(cfg).items():
        if key in ("tpu", "dataset", "input"):
            for k, v in vars(value).items():
                assert ref[key][k] == v, k
        else:
            assert ref[key] == value, key
    assert Config() == cfg and cfg.vocab_size == JConfig().vocab_size
    cfg = Config.from_dict({"units": 8, "tpu": {"scan_steps": 5},
                            "unknown": 1})
    assert cfg.units == 8 and cfg.tpu.scan_steps == 5


def test_trained_batch_stats_round_trip_through_flax():
    """After training-mode steps, ``to_flax`` carries the moved BatchNorm
    statistics, and the JAX model in eval mode on them gives the port's
    eval logits."""
    jmodel, _, state, _, cfg, (betas, tokens, target) = _setup(alpha=1e-3)
    step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
    before = state.model.encoder.input_bn.var.clone()
    for _ in range(2):
        state, _ = step(state, *_t(betas, tokens, target))
    assert not torch.equal(state.model.encoder.input_bn.var, before)
    variables = to_flax(state.model.state_dict())
    np.testing.assert_array_equal(
        variables["batch_stats"]["encoder"]["input_bn"]["var"],
        state.model.encoder.input_bn.var.numpy())
    a0 = np.zeros((B, cfg.units), np.float32)
    want, _ = jmodel.apply(variables, betas, tokens, a0, a0)
    with torch.no_grad():
        got, _ = state.model(*_t(betas, tokens, a0, a0))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_store_gather_feeds_the_step_on_the_cpu():
    """On CPU tensors the steps take K1's plain version and count no
    launch."""
    before = gather_rows.launches
    _, _, state, _, cfg, _ = _setup()
    tabs = _t(*_tables(K=2))
    state, m = steps.make_scanned_train_steps_from_tables(cfg, [])(
        state, *tabs)
    assert gather_rows.launches == before and state.step == 2
    assert torch.isfinite(m["loss"]).all()
