"""``tpu.remat`` in the port: each decoder step under
``torch.utils.checkpoint``, recomputed in the backward.

``checkpoint`` restores the global RNG states only, never the
``torch.Generator`` the port draws every dropout mask from; the step keeps
its generator's state and replays it in the recompute
(``models.nic.NIC._checkpointed_step``). So a step with every dropout on
gives the loss and the updated parameters of the step without remat
(within 1e-6: the same masks, the same arithmetic, the backward's sums in
another order), in fp32, in bf16 and on a 1 x 2 mesh whose masks are
slices of the global batch's (``parallel.collectives.batch_rand``). With
dropout off a remat trajectory follows the JAX package's (2e-5, its
criterion). ``remat`` reaches the NIC, ImgNIC and CnnRnnNIC models as the
JAX ``build_model`` passes it, and keeps ``tpu.fused_seq`` on autograd.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.train import losses as jlosses
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.models.nic import NIC
from masters_thesis_tpu_torch.ops import fused_seq
from masters_thesis_tpu_torch.train import losses, steps
from test_torch_families import FAMILIES, N_GROUPS, N_VOXELS
from test_torch_families import _configs as family_configs
from test_torch_families import _row_shape
from test_torch_train import _assert_state_close, _jax_state, _setup, _t
from torch_parallel_child import run_ranks

SAME = 1e-6               # remat against no remat, dropout on
TRAJ_ATOL = 2e-5          # against the JAX package, dropout off
DROPOUT = dict(dropout_features=0.3, dropout_text=0.3, dropout_attn=0.3,
               dropout_lstm=0.3, dropout_out=0.3, dropout_input=0.3)


def _remat(cfg, on=True):
    return dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu,
                                                            remat=on))


def _one_step(remat, **kw):
    """One train step of ``_setup``'s LcNIC (its weights randomised) with
    ``kw`` (by default every dropout on): (metrics, state dict)."""
    _, _, state, _, cfg, batch = _setup(**{**DROPOUT, **kw})
    state.model.remat = remat
    step = steps.make_train_step(_remat(cfg, remat),
                                 losses.lc_nic_l2_rules(cfg))
    state, metrics = step(state, *_t(*batch))
    return metrics, {k: v.clone() for k, v in
                     state.model.state_dict().items()}


def _assert_same_step():
    m_plain, s_plain = _one_step(False)
    m_remat, s_remat = _one_step(True)
    m_off, _ = _one_step(False, **{k: 0.0 for k in DROPOUT})
    for key in m_plain:
        assert abs(float(m_plain[key]) - float(m_remat[key])) <= SAME, key
    # the masks were on, and drew something other than the identity
    assert abs(float(m_plain["loss"]) - float(m_off["loss"])) > 100 * SAME
    for key, want in s_plain.items():
        np.testing.assert_allclose(s_remat[key].numpy(), want.numpy(),
                                   rtol=0, atol=SAME, err_msg=key)
        assert s_remat[key].dtype == want.dtype


def test_remat_step_with_dropout_equals_the_plain_step():
    """(a) fp32, every dropout on: the same loss and parameters."""
    _assert_same_step()


def test_remat_step_with_dropout_equals_the_plain_step_in_bf16(monkeypatch):
    """(b) the same with the forward in bf16 (the card's rule forced)."""
    monkeypatch.setattr(steps, "_compute_dtype",
                        lambda cfg, device: torch.bfloat16)
    _assert_same_step()


def test_remat_recomputes_each_step_in_the_backward(monkeypatch):
    """Under remat the backward runs every decoder step again (2T calls of
    the step body for T steps), and leaves the generator where the forward
    left it."""
    calls = []
    body = NIC._teacher_step
    monkeypatch.setattr(NIC, "_teacher_step",
                        lambda self, *a: calls.append(1) or body(self, *a))
    _, _, state, _, cfg, batch = _setup(**DROPOUT)
    model = state.model
    model.remat = True
    betas, tokens, target = _t(*batch)
    gen = torch.Generator().manual_seed(3)
    a0 = torch.zeros(betas.shape[0], cfg.units)
    logits, _ = model(betas, tokens.long(), a0, a0, training=True,
                      generator=gen)
    after_forward = gen.get_state()
    assert len(calls) == tokens.shape[1]
    loss = losses.caption_loss(logits, target)
    torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == 2 * tokens.shape[1]
    assert torch.equal(gen.get_state(), after_forward)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_step_on_a_mesh_equals_the_plain_step(compute_dtype):
    """(c) One sharded step on a 1 x 2 CPU mesh (gloo), every dropout on,
    the masks this rank's slices of the global batch's: remat and no remat
    give the same loss and the same whole parameters."""
    report = run_ranks(2, "remat_step", compute_dtype)
    assert abs(report["plain"] - report["remat"]) <= SAME
    assert abs(report["plain"] - report["off"]) > 100 * SAME
    assert report["max_param_diff"] <= SAME
    assert report["dtypes"] == ["torch.float32"]


def test_remat_trajectory_matches_jax_with_dropout_off():
    """(d) Three steps with remat on both sides, dropout off: the losses
    and every parameter within 2e-5 of the JAX steps."""
    jmodel, variables, state, jcfg, cfg, batch = _setup(alpha=1e-3)
    jmodel = jmodel.clone(remat=True)
    jcfg, cfg = _remat(jcfg), _remat(cfg)
    state.model.remat = True
    jstep = jsteps.make_train_step(jmodel, jcfg,
                                   jlosses.lc_nic_l2_rules(jcfg),
                                   donate=False)
    step = steps.make_train_step(cfg, losses.lc_nic_l2_rules(cfg))
    jstate = _jax_state(variables, jcfg)
    got, want = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, *batch)
        state, m = step(state, *_t(*batch))
        got.append(m["loss"].item())
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_ATOL)
    _assert_state_close(state, jstate, variables, rtol=0, atol=TRAJ_ATOL)


@pytest.mark.parametrize("family", list(FAMILIES) + ["lc_nic", "ms_nic"])
def test_remat_reaches_the_families_jax_gives_it(family):
    """(e) ``tpu.remat`` reaches exactly the models the JAX ``build_model``
    builds with it: NIC, ImgNIC and CnnRnnNIC (lc_nic, ms_nic, the concat,
    deep and fully connected encoders, img_nic, cnn_rnn); not Ms2NIC nor
    the ShowTell family."""
    kw = dict(FAMILIES.get(family, {"model": family}))
    kw.pop("vocab_pad_multiple", None)
    jcfg, cfg = family_configs(**kw)
    jcfg.tpu.remat = cfg.tpu.remat = True
    groups = synthetic_groups(N_VOXELS, N_GROUPS, seed=0)
    row_shape = _row_shape(cfg.model)
    table = (np.ones((cfg.vocab_size, 8), np.float32)
             if "glove_trainable" in kw else None)
    jmodel, _, _ = jexp.build_model(jcfg, groups, row_shape[0],
                                    embedding_table=table)
    tmodel, _, _ = experiment.build_model(cfg, groups, row_shape[0],
                                          embedding_table=table,
                                          row_shape=row_shape)
    want = bool(getattr(jmodel, "remat", False))
    assert bool(getattr(tmodel, "remat", False)) == want
    assert want == (cfg.model not in ("ms2_nic", "showtell", "thinkandtell",
                                      "guse_nic"))


def test_remat_keeps_the_fused_sequence_off():
    """(f) ``fused_train_supported`` is false under remat, as in JAX: the
    custom backward stores every step's residuals."""
    _, _, state, _, cfg, _ = _setup()
    assert fused_seq.fused_train_supported(state.model, cfg)
    assert not fused_seq.fused_train_supported(state.model, _remat(cfg))
