"""Mixed precision (``tpu.compute_dtype: bfloat16``, ``tpu.param_dtype``) in
the port against the JAX package, on the CPU, with the same transplanted
fp32 parameters and numpy inputs.

Both packages train in bf16 only on their accelerator and in fp32 on the
CPU (each ``train.steps._compute_dtype``), so each test forces the
accelerator's rule on both sides with ``monkeypatch``. XLA's CPU backend has
no BF16 x BF16 = F32 dot (the accelerator's bf16 product with fp32 sums,
``preferred_element_type=float32``: "Unsupported element type for
DotThunk::Execute"), so the ``bf16_dots`` fixture lowers such a dot as the
same dot of its operands widened to fp32, which is exact (the product of
two bf16 values is an fp32 value) and sums in fp32, as the TPU does; the
JAX package is not edited.

What is held, dropout off (dropout streams cannot match across
frameworks):

- one LcNIC train step (BatchNorm in training mode): the loss terms, every
  gradient and the new BatchNorm statistics. The tolerances (``LOSS_ATOL``,
  ``GRAD_RTOL`` of max(1, the leaf's largest entry), ``STAT_ATOL``) sit at
  least ``CONTROL`` (4) times below the distance between the port's fp32
  step and the JAX bf16 step, measured on the same inputs in the same
  test: the tests see where the roundings are;
- a 3-step Adam trajectory at bf16, the masters and statistics still fp32;
- the fused train route at bf16 (the scan forward and the custom backward)
  against the JAX ``make_train_forward_loss``, with the same control;
- K4's plain version with bf16 weights against the TPU kernel's own body
  (``_forward_pallas`` at ``cdt`` bf16 as the TPU runs it, in Pallas
  interpret mode), which the fp32 kernel misses by more than the tolerance;
- ``param_dtype: bfloat16`` trains to the fp32 numbers bit for bit in both
  packages (nothing reads it);
- every family of ``configs/*.yaml`` (and the other encoders) takes one bf16
  step with a finite loss and fp32 masters.
"""

import contextlib
import copy
import dataclasses
import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.interpreters import mlir
from jax._src.lax import lax as jax_lax

from masters_thesis_tpu.ops import fused_seq as jfused
from masters_thesis_tpu.train import losses as jlosses
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.ops import fused_seq
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.train import losses, steps
from masters_thesis_tpu_torch.train.state import LAYOUT_MODELS, init_model
from test_torch_fused_seq import _pair as fused_pair
from test_torch_fused_seq import _port_w, _seq_inputs
from test_torch_train import (
    _assert_state_close,
    _jax_state,
    _leaves,
    _setup,
    _t,
)
from torch_threads import one_thread  # noqa: F401

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5          # of max(1, the leaf's largest entry)
STAT_ATOL = 1e-6
TRAJ_ATOL = 2e-5          # losses and parameters over 3 steps
K4_ATOL = 1e-5            # K4's residuals
CONTROL = 4.0             # the fp32 control's distance over the tolerance
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture
def bf16_dots():
    """Lower a BF16 x BF16 = F32 dot on XLA's CPU backend as the same dot of
    its operands widened to fp32 (the module docstring), for the test."""
    prim = jax_lax.dot_general_p
    table = mlir._platform_specific_lowerings["cpu"]
    kept = table[prim]

    def rule(ctx, lhs, rhs, **params):
        avals = list(ctx.avals_in)
        if (ctx.avals_out[0].dtype == np.float32
                and any(a.dtype == jnp.bfloat16 for a in avals)):
            wide = [a.update(dtype=np.dtype(np.float32)) for a in avals]
            lhs, rhs = (mlir.convert_hlo(ctx, x, a, w)
                        if a.dtype != w.dtype else x
                        for x, a, w in zip((lhs, rhs), avals, wide))
            ctx = ctx.replace(avals_in=wide)
        return kept.rule(ctx, lhs, rhs, **params)

    table[prim] = mlir.LoweringRuleEntry(rule, kept.inline)
    try:
        yield
    finally:
        table[prim] = kept


@pytest.fixture
def bf16_on_both(monkeypatch, bf16_dots):
    """Both packages' ``_compute_dtype`` as on their accelerator: bf16
    wherever ``tpu.compute_dtype`` asks for it."""
    monkeypatch.setattr(
        jsteps, "_compute_dtype",
        lambda cfg: (jnp.bfloat16 if cfg.tpu.compute_dtype == "bfloat16"
                     else jnp.float32))
    monkeypatch.setattr(
        steps, "_compute_dtype",
        lambda cfg, device: (torch.bfloat16
                             if cfg.tpu.compute_dtype == "bfloat16"
                             else torch.float32))


def _bf16(cfg):
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype="bfloat16"))


def _distances(total, metrics, grads, stats, want):
    """The largest distance of each kind to the JAX numbers ``want`` =
    (total, metrics, grads by name, BatchNorm stats by name): the loss
    terms, the gradients over max(1, |leaf|), the statistics."""
    jtotal, jmetrics, jgrads, jstats = want
    loss = max([abs(float(total) - float(jtotal))]
               + [abs(float(metrics[k]) - float(jmetrics[k]))
                  for k in ("loss", "L2", "attention")])
    grad = max(float(np.abs(grads[k].numpy() - w).max())
               / max(1.0, float(np.abs(w).max()))
               for k, w in jgrads.items())
    stat = max(float(np.abs(stats[k].numpy() - w).max())
               for k, w in jstats.items())
    return loss, grad, stat


def _assert_bf16_close_and_control(got, control, what):
    """``got`` (loss, grad, stat distances of the bf16 port) within the
    tolerances, and ``control`` (the fp32 port's) at least CONTROL times
    farther."""
    for name, g, c, tol in zip(("loss", "gradient", "statistic"), got,
                               control, (LOSS_ATOL, GRAD_RTOL, STAT_ATOL)):
        assert g <= tol, f"{what}: {name} {g:.3g} > {tol:g}"
        assert c >= CONTROL * tol, (
            f"{what}: the fp32 control's {name} distance {c:.3g} is under "
            f"{CONTROL:g} x {tol:g}")


def _bn_stats(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("input_bn.mean", "input_bn.var"))}


def _jax_bn_stats(stats):
    return {f"encoder.input_bn.{k}": np.asarray(v)
            for k, v in stats["encoder"]["input_bn"].items()}


# ---- (a) one train step ----

@pytest.fixture
def jax_bf16_step(bf16_on_both):
    jmodel, variables, _, jcfg, _, (betas, tokens, target) = _setup(
        attn_loss=True)
    jcfg = _bf16(jcfg)
    rules = jlosses.lc_nic_l2_rules(jcfg)

    def loss(params):
        return jsteps._forward_loss(jmodel, jcfg, rules, params,
                                    variables["batch_stats"],
                                    jax.random.PRNGKey(0), betas, tokens,
                                    target)

    (total, (metrics, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    for leaf in jax.tree_util.tree_leaves(stats):
        assert leaf.dtype == jnp.float32
    return (float(total), jax.device_get(metrics), dict(_leaves(grads)),
            _jax_bn_stats(stats))


def _port_step(cdt):
    """The port's training loss, gradients and new BatchNorm statistics on
    ``_setup``'s batch with the forward in ``cdt``."""
    _, _, state, _, cfg, batch = _setup(attn_loss=True)
    total, metrics = steps._forward_loss(
        state.model, cfg, losses.lc_nic_l2_rules(cfg), *_t(*batch), None,
        None, cdt)
    names, params = zip(*state.model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    assert all(g.dtype == torch.float32 for g in grads.values())
    return total.detach(), metrics, grads, _bn_stats(state.model)


def test_bf16_train_step_matches_the_jax_bf16_step(jax_bf16_step):
    """The loss terms, every gradient (on the fp32 masters) and the
    BatchNorm statistics of one bf16 step, against the JAX bf16 step; the
    port's fp32 step is the control."""
    bf16 = _port_step(torch.bfloat16)
    control = _distances(*_port_step(torch.float32), jax_bf16_step)
    _assert_bf16_close_and_control(_distances(*bf16, jax_bf16_step),
                                   control, "train step")
    assert float(bf16[1]["accuracy"]) == float(jax_bf16_step[1]["accuracy"])


def test_compute_dtype_is_bf16_only_on_the_card():
    """The JAX rule: bf16 on the accelerator, fp32 elsewhere."""
    cfg = _bf16(Config())
    assert steps._compute_dtype(cfg, "cpu") == torch.float32
    assert steps._compute_dtype(cfg, torch.device("cuda")) == torch.bfloat16
    assert steps._compute_dtype(Config(), "cuda") == torch.float32


def test_carries_keep_a_float64_models_precision():
    """The carry's re-cast after every cell widens bf16 to fp32 and keeps
    float64: the gradients of a float64 model's forward equal those of the
    custom backward in float64 within 1e-12 of max(1, |leaf|), as the
    card's check of the fused sequence holds them."""
    _, _, state, _, cfg, (betas, tokens, target) = _fused_pair()
    model = copy.deepcopy(state.model).double().eval()
    x, tokens, target = _t(betas, tokens.astype(np.int64), target)
    x = x.double()
    a0 = torch.zeros(len(x), cfg.units, dtype=torch.float64)
    params = list(model.parameters())
    want = torch.autograd.grad(losses.caption_loss(
        model(x, tokens, a0, a0)[0], target), params)
    got = torch.autograd.grad(fused_seq.make_fused_forward_loss(
        model, None, "scan")(x, tokens, target), params)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-12 * max(
            1.0, float(w.abs().max()))


# ---- (b) a 3-step Adam trajectory ----

def test_bf16_trajectory_matches_the_jax_bf16_trajectory(bf16_on_both):
    """Three Adam steps at bf16: the losses and every parameter and
    statistic within 2e-5 of the JAX steps, the masters and statistics fp32
    after them."""
    jmodel, variables, state, jcfg, cfg, batch = _setup(alpha=1e-3)
    jcfg, cfg = _bf16(jcfg), _bf16(cfg)
    jstep = jsteps.make_train_step(jmodel, jcfg,
                                   jlosses.lc_nic_l2_rules(jcfg),
                                   donate=False)
    step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
    jstate = _jax_state(variables, jcfg)
    got, want = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, *batch)
        state, m = step(state, *_t(*batch))
        want.append(float(jm["loss"]))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_ATOL)
    _assert_state_close(state, jstate, variables, rtol=0, atol=TRAJ_ATOL)
    for t in state.model.state_dict().values():
        assert t.dtype == torch.float32
    for leaf in jax.tree_util.tree_leaves((jstate.params,
                                           jstate.batch_stats)):
        assert leaf.dtype == jnp.float32


# ---- (c) the fused train route ----

def _fused_pair():
    jmodel, variables, state, jcfg, cfg, batch = fused_pair(fused=True,
                                                            attn_loss=True)
    return jmodel, variables, state, _bf16(jcfg), _bf16(cfg), batch


def test_fused_route_at_bf16_matches_the_jax_fused_route(bf16_on_both):
    """``tpu.fused_seq`` at bf16: the scan forward and the custom backward
    with the JAX route's casts (bf16 encoder, fp32 features and embeddings,
    ``_mm``/``_ein`` products), against the JAX ``make_train_forward_loss``;
    the port's fp32 route is the control."""
    jmodel, variables, _, jcfg, _, (betas, tokens, target) = _fused_pair()
    fwd = jfused.make_train_forward_loss(jmodel, jcfg,
                                         jlosses.lc_nic_l2_rules(jcfg))
    (jtotal, (jmetrics, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: fwd(p, variables["batch_stats"], jax.random.PRNGKey(0),
                      betas, tokens, target), has_aux=True))(
        variables["params"])
    want = (float(jtotal), jax.device_get(jmetrics), dict(_leaves(jgrads)),
            _jax_bn_stats(jstats))

    def port(cdt):
        _, _, state, _, cfg, batch = _fused_pair()
        assert fused_seq.fused_train_supported(state.model, cfg)
        forward = fused_seq.make_train_forward_loss(
            state.model, cfg, losses.lc_nic_l2_rules(cfg), cdt)
        total, metrics = forward(*_t(*batch), None, torch.Generator(),
                                 key=None)
        names, params = zip(*state.model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        return total.detach(), metrics, grads, _bn_stats(state.model)

    _assert_bf16_close_and_control(_distances(*port(torch.bfloat16), want),
                                   _distances(*port(torch.float32), want),
                                   "fused route")


def test_fused_route_is_taken_at_bf16(bf16_on_both, monkeypatch):
    """A ``tpu.fused_seq`` step at bf16 builds the fused route once, in
    bf16."""
    built = []
    make = steps.make_train_forward_loss
    monkeypatch.setattr(steps, "make_train_forward_loss",
                        lambda *a: built.append(a[3]) or make(*a))
    _, _, state, _, cfg, batch = _fused_pair()
    step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
    for _ in range(2):
        state, m = step(state, *_t(*batch))
        assert np.isfinite(m["loss"].item())
    assert built == [torch.bfloat16]


# ---- (d) K4 with bf16 weights ----

class _OnTheTPU(types.ModuleType):
    """``jax`` as ``ops/fused_seq.py`` sees it, with ``default_backend``
    saying "tpu", so that ``_forward_pallas`` takes the bf16 weights of its
    TPU branch (``:228``)."""

    def __init__(self):
        super().__init__("jax")

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def tpu_kernel_bf16(bf16_dots, monkeypatch):
    """The TPU kernel at ``cdt`` bf16, as the TPU runs it, through Pallas
    interpret mode: ``_forward_pallas`` on bf16 ``w2``, ``wx``, ``wh``."""
    pallas_call = jfused.pl.pallas_call
    monkeypatch.setattr(jfused, "jax", _OnTheTPU())
    monkeypatch.setattr(jfused, "pl", types.SimpleNamespace(
        **{k: getattr(jfused.pl, k) for k in dir(jfused.pl)
           if not k.startswith("_") and k != "pallas_call"},
        pallas_call=lambda *a, **kw: pallas_call(*a, **{**kw,
                                                        "interpret": True})))
    pre, features, emb, w = _seq_inputs()
    return [np.asarray(x) for x in jfused._forward_pallas(
        w, pre, features, emb, 0.2, cdt=jnp.bfloat16)]


def _bf16_weights(w):
    return [t.to(torch.bfloat16) if k in fused_seq.BF16_ARGS else t
            for k, t in zip(fused_seq.W_KEYS, _port_w(w))]


def test_bf16_k4_plain_version_matches_the_tpu_kernel(tpu_kernel_bf16):
    """Every residual of the bf16 plain version within 1e-5 of the TPU
    kernel's at bf16; the fp32 plain version misses it by more."""
    pre, features, emb, w = _seq_inputs()
    got = fused_seq.fused_seq_forward_reference(
        *_t(pre, features, emb), *_bf16_weights(w), 0.2)
    fp32 = fused_seq.fused_seq_forward_reference(
        *_t(pre, features, emb), *_port_w(w), 0.2)
    control = 0.0
    for name, g, f, want in zip(("h", "c", "alpha", "z", "hw_pre"), got,
                                fp32, tpu_kernel_bf16):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=K4_ATOL,
                                   err_msg=name)
        control = max(control, float(np.abs(f.numpy() - want).max()))
    assert control > CONTROL * K4_ATOL


@pytest.mark.parametrize("weights", ["fp32", "bf16"])
def test_plain_k4_on_its_own_carries_repeats_itself(weights):
    """K4's plain version started at each step from given carries (the
    card's step-by-step check of the bf16 kernel): on its own carries it
    gives its own residuals bit for bit; on other carries, other ones."""
    pre, features, emb, w = _seq_inputs()
    ws = _bf16_weights(w) if weights == "bf16" else _port_w(w)
    args = (*_t(pre, features, emb), *ws)
    free = fused_seq.fused_seq_forward_reference(*args, 0.2)
    stepped = fused_seq.fused_seq_forward_reference(
        *args, 0.2, carries=(free[0], free[1]))
    for a, b in zip(free, stepped):
        assert torch.equal(a, b)
    moved = fused_seq.fused_seq_forward_reference(
        *args, 0.2, carries=(free[0] * 0.5, free[1]))
    assert not torch.equal(moved[0][:, 1:], free[0][:, 1:])
    assert torch.equal(moved[0][:, 0], free[0][:, 0])


def test_kernel_backend_at_bf16_runs_the_bf16_plain_version():
    """``make_fused_sequence(backend="kernel", compute_dtype=bf16)`` takes
    the seven weights in bf16, as the JAX train route hands them over, and
    gives K4 bf16 ``w2``, ``wx``, ``wh`` and the others widened back to
    fp32 (on CPU tensors the plain version); its custom backward gives the
    fp32 weights fp32 gradients, unrounded, as the JAX custom_vjp does."""
    pre, features, emb, w = _seq_inputs()
    seen = []
    real = fused_seq.fused_seq_forward

    def spy(*args):
        seen.append([a.dtype for a in args[3:10]])
        return real(*args)

    inputs = [t.requires_grad_(True) for t in _port_w(w)]
    with _patched(fused_seq, "fused_seq_forward", spy):
        seq = fused_seq.make_fused_sequence(0.2, "kernel",
                                            compute_dtype=torch.bfloat16)
        hseq, alphas = seq(dict(zip(fused_seq.W_KEYS, inputs)),
                           *_t(pre, features, emb))
    assert seen == [[torch.bfloat16 if k in fused_seq.BF16_ARGS
                     else torch.float32 for k in fused_seq.W_KEYS]]
    rounded = [t.to(torch.bfloat16) if k in fused_seq.BF16_ARGS
               else t.to(torch.bfloat16).float()
               for k, t in zip(fused_seq.W_KEYS, _port_w(w))]
    want = fused_seq.fused_seq_forward_reference(
        *_t(pre, features, emb), *rounded, 0.2)
    assert torch.equal(hseq, want[0]) and torch.equal(alphas, want[2])
    grads = torch.autograd.grad(hseq.sum() + alphas.sum(), inputs)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    # unrounded: some gradient is not a bf16 value
    assert any(not torch.equal(g, g.to(torch.bfloat16).float())
               for g in grads)


@contextlib.contextmanager
def _patched(obj, name, value):
    kept = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, kept)


def test_compute_dtype_must_be_fp32_or_bf16():
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_seq.make_fused_sequence(compute_dtype=torch.float16)


# ---- (e) param_dtype ----

def test_param_dtype_changes_nothing_in_either_package():
    """``tpu.param_dtype: bfloat16`` is read by nothing: three steps give
    the float32 numbers bit for bit, in the JAX package and in the port."""
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jmodel, variables, state, jcfg, cfg, batch = _setup(alpha=1e-3)
        jcfg = dataclasses.replace(jcfg, tpu=dataclasses.replace(
            jcfg.tpu, param_dtype=dtype))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, param_dtype=dtype))
        jstep = jsteps.make_train_step(jmodel, jcfg,
                                       jlosses.lc_nic_l2_rules(jcfg),
                                       donate=False)
        step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
        jstate = _jax_state(variables, jcfg)
        for _ in range(3):
            jstate, _ = jstep(jstate, *batch)
            state, _ = step(state, *_t(*batch))
        runs[dtype] = (dict(_leaves(jax.device_get(jstate.params))),
                       {k: v.clone() for k, v in
                        state.model.state_dict().items()})
    (j32, t32), (j16, t16) = runs["float32"], runs["bfloat16"]
    assert j32.keys() == j16.keys() and t32.keys() == t16.keys()
    for k in j32:
        np.testing.assert_array_equal(j16[k], j32[k], err_msg=k)
    for k in t32:
        assert torch.equal(t16[k], t32[k]), k


# ---- (f) every family ----

FAMILY_WIDTHS = dict(batch_size=4, max_length=5, top_k=39, units=16,
                     attn_units=8, group_size=4, embedding_text=8,
                     embedding_features=8, glove_path="", warm_start="")
EXTRA_FAMILIES = ("img_nic", "concat_lc_nic", "deep_lc_nic", "fc_nic")


def _family_cases():
    files = sorted(glob.glob(os.path.join(CONFIGS, "*.yaml")))
    return ([os.path.basename(f) for f in files]
            + [f"smoke.yaml:{m}" for m in EXTRA_FAMILIES])


@pytest.mark.parametrize("case", _family_cases())
def test_every_family_takes_a_bf16_step(case, bf16_on_both):
    """One bf16 train step of the config's family (at narrow widths, its
    dropouts on): a finite loss, gradients on fp32 masters, fp32 BatchNorm
    statistics; the step in fp32 gives another loss."""
    name, _, model = case.partition(":")
    cfg = Config.load(os.path.join(CONFIGS, name))
    cfg = dataclasses.replace(cfg, **FAMILY_WIDTHS,
                              **({"model": model} if model else {}))
    fam = cfg.model.lower()
    n_voxels = 96
    layout = (GroupLayout(synthetic_groups(n_voxels, 5, seed=0), n_voxels)
              if fam in LAYOUT_MODELS else None)
    row_shape = {"img_nic": (6, 12), "cnn_rnn": (6, 12),
                 "guse_nic": (512,)}.get(fam, (n_voxels,))
    masked = fam in ("cnn_rnn", "showtell", "thinkandtell", "guse_nic")
    rules = (losses.lc_nic_l2_rules(cfg) if fam not in
             ("showtell", "thinkandtell", "guse_nic") else [])
    gen = torch.Generator().manual_seed(0)
    rows = torch.randn(4, *row_shape, generator=gen)
    if len(row_shape) > 1:
        rows = rows.reshape(4, -1)
    tokens = torch.randint(1, cfg.vocab_size, (4, 5), generator=gen)
    target = torch.roll(tokens, -1, 1)
    target[0, -2:] = 0
    out = {}
    for dtype in ("bfloat16", "float32"):
        run = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, compute_dtype=dtype))
        state = init_model(run, layout, "cpu", row_shape=row_shape)
        state, m = steps.make_train_step(run, rules, masked)(state, rows,
                                                             tokens, target)
        out[dtype] = m["loss"].item()
        assert np.isfinite(out[dtype]) and np.isfinite(
            m["grad_norm"].item())
        for key, t in state.model.state_dict().items():
            if t.is_floating_point():
                assert t.dtype == torch.float32, key
    assert out["bfloat16"] != out["float32"]
