"""``tpu.vocab_pad_multiple`` in the port against the JAX package's, on the
CPU.

The fixture of ``tests/test_vocab_padding.py``: vocab 61 (top_k 60)
padded to 64, the padded JAX model's weights the unpadded ones with zero
rows and columns. The port's padded model on those weights gives the JAX
padded model's logits (1e-6) with -1e9 on the pad slots, the same loss and
L2 (1e-6); its greedy words (K2's plain version) are the JAX unpadded
model's; five port train steps with dropout on keep the padded model's
losses on the unpadded port model's (1e-6) and its pad rows and columns
exactly zero. The knob runs through ``run_training`` in one process (a
run directory whose checkpoint and ``Captioner`` hold the padded vocab)
and over a model axis of 2 ranks, whose run equals the single-process run
(epoch and val losses 1e-5, parameter norm 1e-4)."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.config import TPUConfig as JTPUConfig
from masters_thesis_tpu.data.pairs import encode_pairs as jencode
from masters_thesis_tpu.data.pipeline import BatchPipeline as JPipeline
from masters_thesis_tpu.data.synthetic import synthetic_dataset
from masters_thesis_tpu.decode.greedy import make_greedy_decoder as jgreedy
from masters_thesis_tpu.experiment import build_model as jbuild
from masters_thesis_tpu.train.losses import caption_loss as jcaption_loss
from masters_thesis_tpu.train.losses import l2_loss as jl2_loss
from masters_thesis_tpu.train.state import init_model as jinit
from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config, TPUConfig
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.losses import (
    caption_loss,
    l2_loss,
    lc_nic_l2_rules,
)
from masters_thesis_tpu_torch.train.state import model_for, new_state
from masters_thesis_tpu_torch.transplant import from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_child import run_ranks  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401

ATOL = 1e-6
TRUE, PADDED = 61, 64


def _widths(**kw):
    return dict(run="test", top_k=60, batch_size=8, max_length=8, units=32,
                attn_units=8, group_size=4, embedding_text=16, epochs=1,
                **kw)


def _padded(src, dst):
    """src's leaves zero-padded to dst's shapes (the padding contract)."""
    def one(s, d):
        s = np.asarray(s)
        pad = [(0, dd - ss) for ss, dd in zip(s.shape, np.shape(d))]
        return np.pad(s, pad)
    return jax.tree_util.tree_map(one, src, dst)


@pytest.fixture(scope="module")
def padded():
    cfg, cfg_p = (JConfig(**_widths(), tpu=JTPUConfig(vocab_pad_multiple=m))
                  for m in (0, 8))
    split, pairs, tok, store, groups = synthetic_dataset(
        n_keys=24, n_voxels=256, n_groups=6, top_k=cfg.top_k)
    model, _, _ = jbuild(cfg, groups, 256)
    model_p, _, _ = jbuild(cfg_p, groups, 256)
    enc = jencode(pairs["train"], tok, max_len=cfg.max_length)
    batch = next(iter(JPipeline(enc, store, batch_size=8, seed=0,
                                prefetch=0).epoch()))
    params, bstats, _ = jinit(model, cfg, batch["betas"], batch["tokens"])
    params_p, bstats_p, _ = jinit(model_p, cfg_p, batch["betas"],
                                  batch["tokens"])
    params_p = _padded(params, params_p)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, model=model, model_p=model_p, params=params,
                bstats=bstats, params_p=params_p, bstats_p=bstats_p,
                variables={"params": to_np(params),
                           "batch_stats": to_np(bstats)},
                variables_p={"params": to_np(params_p),
                             "batch_stats": to_np(bstats_p)},
                groups=groups, batch=batch)


def _port_model(fx, pad_multiple):
    cfg = Config(**_widths(), tpu=TPUConfig(vocab_pad_multiple=pad_multiple))
    model = model_for(cfg, GroupLayout(fx["groups"], 256))
    model.load_state_dict(from_flax(fx["variables_p" if pad_multiple
                                       else "variables"]))
    return cfg, model


def test_forward_loss_and_l2_match_the_jax_padded_model(padded):
    fx = padded
    cfg, model = _port_model(fx, 8)
    assert (model.vocab_size, model.true_vocab) == (PADDED, TRUE)
    betas = jnp.asarray(fx["batch"]["betas"])
    tokens = jnp.asarray(fx["batch"]["tokens"])
    a0 = jnp.zeros((8, cfg.units))
    want, _ = fx["model_p"].apply({"params": fx["params_p"],
                                   "batch_stats": fx["bstats_p"]},
                                  betas, tokens, a0, a0, training=False)
    z = torch.zeros(8, cfg.units)
    with torch.no_grad():
        got, _ = model(torch.as_tensor(fx["batch"]["betas"]),
                       torch.as_tensor(fx["batch"]["tokens"]).long(), z, z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert (got[..., TRUE:] == -1e9).all()
    target = fx["batch"]["target"]
    np.testing.assert_allclose(
        float(caption_loss(got, torch.as_tensor(target))),
        float(jcaption_loss(want, jnp.asarray(target))), rtol=ATOL)
    rules = lc_nic_l2_rules(cfg)
    from masters_thesis_tpu.train.losses import lc_nic_l2_rules as jrules

    with torch.no_grad():
        got_l2 = float(l2_loss(model, rules))
    np.testing.assert_allclose(got_l2,
                               float(jl2_loss(fx["params"], jrules(cfg))),
                               rtol=ATOL)


def test_greedy_words_are_the_jax_unpadded_models(padded):
    fx = padded
    _, model = _port_model(fx, 8)
    want = jgreedy(fx["model"], 32, 8)(fx["variables"],
                                       jnp.asarray(fx["batch"]["betas"]),
                                       1)[0]
    got = make_whole_fused_greedy_decoder(model.eval(), 8)(
        torch.as_tensor(fx["batch"]["betas"]), 1)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_training_keeps_the_unpadded_losses_and_zero_pads(padded):
    """Five steps with dropout on (the same masks: no mask has a vocab
    axis) on the padded and the unpadded port models."""
    fx = padded
    b = fx["batch"]
    batch = (torch.as_tensor(b["betas"]), torch.as_tensor(b["tokens"]),
             torch.as_tensor(b["target"]))
    losses, states = {}, {}
    for pad in (0, 8):
        cfg, model = _port_model(fx, pad)
        cfg = dataclasses.replace(cfg, clipnorm=1.0)
        state = new_state(model, cfg, "cpu")
        step = steps.make_train_step(cfg, lc_nic_l2_rules(cfg))
        losses[pad] = []
        for _ in range(5):
            state, metrics = step(state, *batch)
            losses[pad].append(float(metrics["loss"]))
        states[pad] = state
    np.testing.assert_allclose(losses[8], losses[0], rtol=ATOL)
    model = states[8].model
    assert (model.embedding[TRUE:] == 0).all()
    assert (model.dense_out.kernel[:, TRUE:] == 0).all()
    assert (model.dense_out.bias[TRUE:] == 0).all()
    np.testing.assert_allclose(model.embedding[:TRUE].detach(),
                               states[0].model.embedding.detach(),
                               rtol=1e-5, atol=1e-7)


def test_run_training_takes_the_knob_in_one_process(tmp_path):
    cfg = Config.load(Path(__file__).resolve().parents[1] / "configs" /
                      "smoke.yaml")
    cfg = dataclasses.replace(cfg, log=str(tmp_path), tpu=dataclasses.replace(
        cfg.tpu, vocab_pad_multiple=8))
    assert (cfg.vocab_size, cfg.padded_vocab_size) == (TRUE, PADDED)
    run_path, logs, bundle = experiment.run_training(cfg, epochs=1,
                                                     smoke_keys=12,
                                                     device="cpu")
    assert bundle["model"].embedding.shape[0] == PADDED
    assert (bundle["model"].embedding[TRUE:] == 0).all()
    cap = Captioner.from_run_dir(run_path, device="cpu")
    rows = np.random.default_rng(0).standard_normal(
        (3, cap.input_width)).astype(np.float32)
    ids = cap.caption_ids(rows)
    assert ids.shape == (3, cfg.max_length) and (ids < TRUE).all()


def test_padded_vocab_shards_over_the_model_axis(tmp_path):
    """vocab 61 padded to 64 on data 1 x model 2: the embedding and the
    head shard, and the run equals the single-process run."""
    from test_torch_parallel import _in_threads

    got, want = _in_threads(
        lambda: run_ranks(2, "padded_vocab_run", str(tmp_path / "mp"), 1, 2),
        lambda: run_ranks(1, "padded_vocab_run", str(tmp_path / "sp"), 1, 1))
    assert got["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["epoch_val_losses"],
                               want["epoch_val_losses"], rtol=0, atol=1e-5)
    assert abs(got["param_norm"] - want["param_norm"]) <= 1e-4
