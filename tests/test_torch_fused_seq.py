"""The port's fused teacher-forced sequence (``ops/fused_seq.py``) against the
JAX package's, on the same transplanted weights and the same numpy inputs,
fp32 on the CPU: K4's plain version against the TPU kernel in Pallas
interpret mode and the scan forward against the XLA scan (all five
residuals, 1e-5); the loss and every gradient through the custom backward,
both forwards, against ``jax.grad`` of the JAX fused loss and against
autograd of the port's own model (2e-5 of the larger of 1 and the leaf's
largest entry, the JAX package's criterion; 1e-6 on the betas); and a
3-step ``tpu.fused_seq`` trajectory with dropout off against the JAX fused
train step and the port's autograd step (2e-5 on losses, 5e-5 on
parameters, as ``tests/test_fused_seq.py``). Dropout streams cannot match
across frameworks, so the attention-dropout path is held on the port's side
alone. Widths are those of ``tests/test_fused_seq.py``: 6 regions, padded to
8 in the TPU kernel."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops import fused_seq as jfused
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu.train import losses as jlosses
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu_torch.config import Config, TPUConfig
from masters_thesis_tpu_torch.models.nic import CnnRnnNIC, LcNIC
from masters_thesis_tpu_torch.ops import fused_seq
from masters_thesis_tpu_torch.train import losses, steps
from masters_thesis_tpu_torch.train.optim import make_optimizer
from masters_thesis_tpu_torch.train.state import TrainState, init_model
from masters_thesis_tpu_torch.transplant import from_flax
from test_torch_train import (
    _assert_state_close,
    _jax_state,
    _leaves,
    _randomise,
)
from torch_threads import one_thread  # noqa: F401

N_VOXELS, N_GROUPS, B, T = 192, 6, 6, 7
R, A, D, E, U = N_GROUPS, 8, 4, 16, 24
NO_DROPOUT = dict(dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
                  dropout_lstm=0.0, dropout_out=0.0, dropout_input=0.0)
CFG = dict(batch_size=B, max_length=T, top_k=200, units=U, attn_units=A,
           group_size=D, embedding_text=E, alpha=1e-3, **NO_DROPOUT)
FWD_ATOL = 1e-5
GRAD_RTOL = 2e-5            # of max(1, the leaf's largest entry)
LOSS_ATOL, PARAM_ATOL = 2e-5, 5e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _pair(fused=False, **cfg_kw):
    """The JAX model and numpy variables (biases and BatchNorm random), a
    port TrainState with the same weights, both configs and a numpy batch."""
    jcfg = JConfig(**{**CFG, **cfg_kw})
    cfg = Config(**{**CFG, **cfg_kw}, tpu=TPUConfig(fused_seq=fused))
    if fused:
        jcfg = dataclasses.replace(
            jcfg, tpu=dataclasses.replace(jcfg.tpu, fused_seq=True))
    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=0),
                         N_VOXELS)
    jmodel = JLcNIC(layout=layout, units=U, group_size=D, embedding_text=E,
                    attn_units=A, vocab_size=cfg.vocab_size, max_length=T,
                    **NO_DROPOUT)
    rng = np.random.default_rng(0)
    betas = rng.standard_normal((B, N_VOXELS)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    target = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)], 1)
    a0 = np.zeros((B, U), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), betas, tokens, a0, a0))
    variables = _randomise(variables, rng)
    state = init_model(cfg, layout, "cpu")
    state.model.load_state_dict(from_flax(variables))
    return jmodel, variables, state, jcfg, cfg, (betas, tokens, target)


# ---- the forwards ----

def _seq_inputs(seed=1):
    """Numpy pre, features, emb and the JAX weight dict (bv a scalar)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (  # noqa: E731
        rng.standard_normal(s) * scale).astype(np.float32)
    w = {"w2": f(U, A, scale=2 / U ** 0.5), "b2": f(A, scale=0.5),
         "v": f(A, scale=3 / A ** 0.5), "bv": np.float32(0.3),
         "wx": f(D + E, 4 * U, scale=1 / (D + E) ** 0.5),
         "wh": f(U, 4 * U, scale=1 / U ** 0.5), "b": f(4 * U, scale=0.5)}
    return f(B, R, A), f(B, R, D), f(B, T, E), w


def _port_w(w):
    return [torch.from_numpy(np.atleast_1d(w[k])) for k in fused_seq.W_KEYS]


@pytest.fixture(scope="module")
def jax_forwards():
    pre, features, emb, w = _seq_inputs()
    return {"pallas": jfused._forward_pallas(w, pre, features, emb, 0.2),
            "xla": jfused._forward_xla(w, pre, features, emb, 0.2)}


@pytest.mark.parametrize("port,jax_backend", [
    ("reference", "pallas"), ("scan", "xla")])
def test_forward_residuals_match_jax(jax_forwards, port, jax_backend):
    """K4's plain version against the TPU kernel in interpret mode, and the
    scan forward against the XLA scan: h, c, alpha, z and hw_pre."""
    pre, features, emb, w = _seq_inputs()
    fn = (fused_seq.fused_seq_forward_reference if port == "reference"
          else fused_seq._forward_scan)
    got = fn(*_t(pre, features, emb), *_port_w(w), 0.2)
    for name, g, want, width in zip(
            ("h", "c", "alpha", "z", "hw_pre"), got, jax_forwards[jax_backend],
            (U, U, R, 4 * U, A)):
        assert g.shape == want.shape == (B, T, width), name
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=FWD_ATOL, err_msg=name)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    pre, features, emb, w = _seq_inputs()
    args = (*_t(pre, features, emb), *_port_w(w))
    before = fused_seq.fused_seq_forward.launches
    got = fused_seq.fused_seq_forward(*args, 0.2)
    assert fused_seq.fused_seq_forward.launches == before
    for g, want in zip(got, fused_seq.fused_seq_forward_reference(*args,
                                                                  0.2)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("shape, wgmma", [
    ((256, 128, 1024, 2048), True),    # the wide shape's cell
    ((64, 32, 512, 512), False),       # flagship: B <= 128, D of 32
    ((130, 64, 64, 128), True),
    ((200, 320, 64, 64), True),        # ctx fills the ring's first stages
    ((200, 384, 64, 64), False),       # ... and would overrun them
    ((130, 64, 32, 96), False),        # E and U not multiples of 64
    ((128, 128, 1024, 2048), False),   # 128 rows: the mma.sync tile
])
def test_wgmma_cell_takes_wide_batches_of_64_k_segments(shape, wgmma):
    """The bf16 K4's cell runs on wgmma for batches above 128 rows whose
    widths D, E, U are whole 64-k chunks with ctx in the ring's first five
    stages (the C side refuses anything else), on mma.sync otherwise."""
    assert fused_seq.wgmma_cell(*shape) is wgmma


# ---- the loss and its gradients in eval mode ----

@pytest.fixture(scope="module")
def jax_eval():
    """Loss and gradients (parameters and betas) of the JAX fused loss."""
    jmodel, variables, _, jcfg, _, (betas, tokens, target) = _pair()
    raw = jfused.make_fused_forward_loss(jmodel, jcfg, backend="xla")

    def fn(params, x):
        return raw(params, x, tokens, target,
                   batch_stats=variables["batch_stats"])

    loss, (grads, dbetas) = jax.value_and_grad(fn, argnums=(0, 1))(
        variables["params"], betas)
    return float(loss), dict(_leaves(grads)), np.asarray(dbetas)


def _port_eval(backend):
    """The port's fused loss (``backend`` ``"autograd"``: the model's own
    forward) and its gradients by parameter name and on the betas."""
    _, _, state, _, cfg, batch = _pair()
    model = state.model
    betas, tokens, target = _t(*batch)
    betas.requires_grad_(True)
    if backend == "autograd":
        a0 = torch.zeros(B, U)
        loss = losses.caption_loss(model(betas, tokens.long(), a0, a0)[0],
                                   target)
    else:
        loss = fused_seq.make_fused_forward_loss(model, cfg, backend)(
            betas, tokens, target)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params + (betas,))
    return loss.item(), dict(zip(names, grads[:-1])), grads[-1]


@pytest.fixture(scope="module")
def port_autograd():
    return _port_eval("autograd")


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=key)


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_loss_and_every_gradient_match_jax_and_autograd(jax_eval,
                                                        port_autograd,
                                                        backend):
    """Every parameter gets its gradient through the custom backward: the
    encoder and W1 through dfeatures and dpre, W2, V and the LSTM inside it,
    the embedding through demb, the head through dhseq."""
    loss, grads, _ = _port_eval(backend)
    jloss, jgrads, _ = jax_eval
    ref_loss, ref_grads, _ = port_autograd
    assert abs(loss - jloss) < 1e-5 and abs(loss - ref_loss) < 1e-5
    _assert_grads_close(grads, jgrads)
    _assert_grads_close(grads, {k: g.numpy() for k, g in ref_grads.items()})
    assert len(grads) >= 10


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_gradient_on_the_betas_matches_jax(jax_eval, port_autograd, backend):
    """dloss/dbetas closes through the custom backward's dfeatures and dpre
    into the encoder."""
    _, _, dbetas = _port_eval(backend)
    np.testing.assert_allclose(dbetas.numpy(), jax_eval[2], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dbetas.numpy(), port_autograd[2].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("head", ["relu", "linear"])
def test_eval_loss_follows_the_model_head(head):
    """The fused eval loss takes the model's own head under every head
    activation (the JAX function applies only a LeakyReLU: ROADMAP F6)."""
    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=0),
                         N_VOXELS)
    model = LcNIC(layout, units=U, group_size=D, embedding_text=E,
                  attn_units=A, vocab_size=40, max_length=T,
                  head_activation=head,
                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():          # negative pre-activations in the head
        model.dense_inter.bias.normal_(0, 1.0, generator=gen)
    betas = torch.randn(B, N_VOXELS, generator=gen)
    tokens = torch.randint(1, 40, (B, T), generator=gen)
    target = torch.roll(tokens, -1, 1)
    a0 = torch.zeros(B, U)
    want = losses.caption_loss(model(betas, tokens, a0, a0)[0], target)
    got = fused_seq.make_fused_forward_loss(model, None)(betas, tokens,
                                                         target)
    assert abs(got.item() - want.item()) < 1e-6


# ---- the train step with tpu.fused_seq ----

def _train(state, cfg, batch, n=3):
    step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
    out = []
    for _ in range(n):
        state, m = step(state, *_t(*batch))
        out.append(m["loss"].item())
    return out, state


@pytest.fixture(scope="module")
def jax_fused_trajectory():
    jmodel, variables, _, jcfg, _, batch = _pair(fused=True)
    jstep = jsteps.make_train_step(jmodel, jcfg,
                                   jlosses.lc_nic_l2_rules(jcfg),
                                   donate=False)
    jstate = _jax_state(variables, jcfg)
    out = []
    for _ in range(3):
        jstate, m = jstep(jstate, *batch)
        out.append(float(m["loss"]))
    return out, jstate


def test_fused_train_steps_match_the_jax_fused_step(jax_fused_trajectory,
                                                    monkeypatch):
    """Three ``tpu.fused_seq`` steps with dropout off, built once and routed
    through the custom backward, against the JAX step with
    ``fused_seq=True``."""
    built = []
    make = steps.make_train_forward_loss
    monkeypatch.setattr(steps, "make_train_forward_loss",
                        lambda *a: built.append(1) or make(*a))
    _, variables, state, _, cfg, batch = _pair(fused=True)
    got, state = _train(state, cfg, batch)
    assert built == [1]
    want, jstate = jax_fused_trajectory
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_state_close(state, jstate, variables, rtol=0, atol=PARAM_ATOL)


def test_fused_train_steps_match_the_autograd_steps():
    """The same three steps through autograd of the model's forward.
    ``attention.V.bias`` has a gradient of exactly 0 (softmax ignores a
    shift of every score); Adam scales each route's rounding noise up to
    steps of up to lr, so it is held to lr a step, not to the tolerance."""
    _, _, fused, _, cfg, batch = _pair(fused=True)
    _, _, plain, _, cfg_plain, _ = _pair()
    got, fused = _train(fused, cfg, batch)
    want, plain = _train(plain, cfg_plain, batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    ref = dict(plain.model.named_parameters())
    for name, p in fused.model.named_parameters():
        atol = 3 * cfg.alpha * 1.001 if name == "attention.V.bias" else (
            PARAM_ATOL)
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def test_fused_step_on_a_gru_model_takes_autograd(monkeypatch):
    """A CnnRnn (GRU) model is not supported by the fused sequence: its
    ``tpu.fused_seq`` step is the autograd step, metric for metric."""
    monkeypatch.setattr(steps, "make_train_forward_loss", None)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randn(4, 5, 12, generator=gen)
    tokens = torch.randint(1, 40, (4, 6), generator=gen)
    target = torch.roll(tokens, -1, 1)
    metrics = []
    for fused in (True, False):
        model = CnnRnnNIC(embed_dim=8, units=16, vocab_size=40, max_length=6,
                          n_patches=5, in_channels=12,
                          generator=torch.Generator().manual_seed(1))
        cfg = Config(units=16, tpu=TPUConfig(fused_seq=fused))
        assert not fused_seq.fused_train_supported(model, cfg)
        state = TrainState(model=model,
                           tx=make_optimizer(cfg, model.parameters()),
                           generator=torch.Generator(), seed=5)
        _, m = steps.make_train_step(cfg, [])(state, rows, tokens, target)
        metrics.append(m)
    for key in metrics[0]:
        assert torch.equal(metrics[0][key], metrics[1][key]), key


# ---- dropout, on the port's side ----

def _dropout_model():
    _, _, state, _, cfg, batch = _pair(dropout_attn=0.5, dropout_text=0.3,
                                       dropout_lstm=0.3, dropout_out=0.3)
    return state.model, cfg, _t(*batch)


def test_attention_dropout_follows_the_key():
    """The same key gives the same loss, another key another; the gradients
    are finite and not all zero."""
    model, cfg, (betas, tokens, target) = _dropout_model()
    fwd = fused_seq.make_train_forward_loss(model, cfg,
                                            losses.lc_nic_l2_rules(cfg))
    run = lambda key: fwd(  # noqa: E731
        betas, tokens, target, None, torch.Generator().manual_seed(3),
        key)[0]
    t1, t2, t3 = run(7), run(7), run(8)
    assert t1.item() == t2.item() != t3.item()
    grads = torch.autograd.grad(t1, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def test_backward_regenerates_the_forward_masks():
    """Attention dropout 0.5 alone: the custom backward's gradients equal
    plain autograd of the scan forward drawing the same masks from the same
    key, and the masks do drop (the outputs differ from dropout off)."""
    pre, features, emb, w = _seq_inputs(seed=4)
    gen = torch.Generator().manual_seed(4)
    dh = torch.randn(B, T, U, generator=gen)
    dalpha = torch.randn(B, T, R, generator=gen)
    results = []
    for route in ("custom", "autograd", "off"):
        inputs = [t.clone().requires_grad_(True) for t in (
            *_port_w(w), *_t(pre, features, emb))]
        wd = dict(zip(fused_seq.W_KEYS, inputs[:7]))
        if route == "autograd":
            out = fused_seq._forward_scan(*inputs[7:], *inputs[:7], 0.2, 0.5,
                                          11)
            hseq, alphas = out[0], out[2]
        else:
            seq = fused_seq.make_fused_sequence(
                0.2, "scan", 0.5 if route == "custom" else 0.0)
            hseq, alphas = seq(wd, *inputs[7:], key=11)
        loss = (hseq * dh).sum() + (alphas * dalpha).sum()
        results.append((hseq.detach(), torch.autograd.grad(loss, inputs)))
    (h_custom, g_custom), (h_auto, g_auto), (h_off, _) = results
    assert torch.equal(h_custom, h_auto) and not torch.allclose(h_custom,
                                                                h_off)
    for g, want in zip(g_custom, g_auto):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_custom_backward_in_float64_equals_autograd(backend):
    """In float64 the custom backward equals autograd of its own forward to
    rounding: the algebra is exact, and every intermediate keeps the
    inputs' dtype."""
    pre, features, emb, w = _seq_inputs(seed=5)
    gen = torch.Generator().manual_seed(5)
    dh = torch.randn(B, T, U, generator=gen, dtype=torch.float64)
    dalpha = torch.randn(B, T, R, generator=gen, dtype=torch.float64)
    plain = (fused_seq.fused_seq_forward_reference if backend == "kernel"
             else fused_seq._forward_scan)
    grads = []
    for route in ("custom", "autograd"):
        inputs = [t.double().requires_grad_(True) for t in (
            *_port_w(w), *_t(pre, features, emb))]
        if route == "custom":
            hseq, alphas = fused_seq.make_fused_sequence(0.2, backend)(
                dict(zip(fused_seq.W_KEYS, inputs[:7])), *inputs[7:])
        else:
            out = plain(*inputs[7:], *inputs[:7], 0.2)
            hseq, alphas = out[0], out[2]
        loss = (hseq * dh).sum() + (alphas * dalpha).sum()
        grads.append(torch.autograd.grad(loss, inputs))
    for g, want in zip(*grads):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)


# ---- errors and options ----

def test_kernel_forward_has_no_dropout_path():
    with pytest.raises(ValueError, match="dropout"):
        fused_seq.make_fused_sequence(0.2, "kernel", 0.2)
    with pytest.raises(ValueError, match="backend"):
        fused_seq.make_fused_sequence(0.2, "pallas")
    seq = fused_seq.make_fused_sequence(0.2, "scan", 0.2)
    pre, features, emb, w = _seq_inputs()
    with pytest.raises(ValueError, match="key"):
        seq(dict(zip(fused_seq.W_KEYS, _port_w(w))), *_t(pre, features, emb))


def test_fused_train_supported_and_its_fallbacks():
    _, _, state, _, cfg, _ = _pair()
    assert fused_seq.fused_train_supported(state.model, cfg)
    remat = SimpleNamespace(tpu=SimpleNamespace(remat=True))
    assert not fused_seq.fused_train_supported(state.model, remat)
    gru = CnnRnnNIC(embed_dim=8, units=16, vocab_size=40, n_patches=5,
                    in_channels=12)
    assert not fused_seq.fused_train_supported(gru, cfg)
    with pytest.raises(ValueError, match="LSTM"):
        fused_seq.make_train_forward_loss(gru, cfg, [])
    with pytest.raises(ValueError, match="LSTM"):
        fused_seq.make_fused_forward_loss(gru, cfg)


def test_config_from_dict_keeps_fused_seq():
    ref = JConfig()
    ref = dataclasses.replace(ref, tpu=dataclasses.replace(ref.tpu,
                                                           fused_seq=True))
    assert Config.from_dict(ref.to_dict()).tpu.fused_seq is True
    assert Config().tpu.fused_seq is False
