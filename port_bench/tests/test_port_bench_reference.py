"""The plain reference against the program at a tiny size, and the frozen
arithmetic pinned to the chip records' figures."""

import pytest
import torch

from port_bench import programs
from port_bench.harness import port, traffic
from port_bench.harness.bench import read_json
from port_bench.programs import lc_nic as lc_nic_program
from port_bench.reference import atlas, cnn_rnn, compare, family, flops
from port_bench.reference import lc_nic
from port_bench.reference.roofline import decode_bound, gather_bound
from port_bench.tests import tiny

FLAGSHIP = read_json("configs", "lcnic_flagship")
CNN_RNN = read_json("configs", "cnn_rnn")


def test_k2_bound():
    c = FLAGSHIP
    b = decode_bound("lstm", batch=64, regions=c["n_groups"],
                     feat_dim=c["group_size"], attn_units=c["attn_units"],
                     units=c["units"], emb_dim=c["embedding_text"],
                     head_dim=c["head_dim"], vocab=c["vocab_size"],
                     steps=c["max_length"])
    step = flops.decode_step_flops(
        "lstm", regions=360, feat_dim=32, attn_units=32, units=512,
        emb_dim=512, head_dim=256, vocab=5001)
    assert 64 * 15 * step == pytest.approx(6.938e9, rel=1e-3)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.1035, abs=5e-5)


def test_k3_bound():
    c = CNN_RNN
    b = decode_bound("gru", batch=64, regions=c["n_patches"],
                     feat_dim=c["embed_dim"], attn_units=c["units"],
                     units=c["units"], emb_dim=c["embed_dim"],
                     head_dim=c["units"], vocab=c["vocab_size"],
                     steps=c["max_length"], zero_state=True)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.1123, abs=5e-5)


def test_k1_bound_and_the_atlas():
    assert atlas.padded_total(FLAGSHIP) == \
        lc_nic_program.layout(FLAGSHIP).padded_total
    us = 1e3 * gather_bound(64, 4 * atlas.padded_total(FLAGSHIP))["bound_ms"]
    assert us == pytest.approx(72.23, abs=0.005)


def test_model_flops():
    # bench.py::flagship_flops_per_step(1): 421.3 MFLOP a sample
    assert lc_nic.train_flops_per_sample(FLAGSHIP) == \
        pytest.approx(421.29e6, rel=1e-4)
    assert lc_nic.caption_flops(FLAGSHIP) == pytest.approx(
        2 * 327684 * 32 + 2 * 360 * 32 * 32 + 6.938e9 / 64, rel=1e-3)
    assert cnn_rnn.caption_flops(CNN_RNN) == pytest.approx(
        2 * 64 * 2048 * 256 + 2 * 64 * 256 * 512 + 7.527e9 / 64, rel=1e-3)


@pytest.mark.parametrize("name", ["lcnic_flagship", "cnn_rnn"])
def test_decode_agrees_with_the_program(name):
    from masters_thesis_tpu_torch.ops.fused_decode import (
        make_whole_fused_greedy_decoder,
    )

    cfg = read_json("configs", name)
    cfg.update(tiny.CONFIGS[name])
    cfg["store"].update(tiny.STORES[name])
    dev = torch.device("cpu")
    ref = family(cfg)
    w = ref.weights(cfg, 7, dev)
    model = port.model(cfg, w, dev).eval()
    keys = [1, 5, 9, 30]
    x = traffic.rows_for(cfg, 3, keys, dev)
    rows = programs.family(cfg).to_store(model, x)
    words, alphas = make_whole_fused_greedy_decoder(model, cfg["max_length"])(
        rows, cfg["tokens"]["start"])
    tokens = torch.cat([torch.full_like(words[:, :1], cfg["tokens"]["start"]),
                        words[:, :-1]], dim=1)
    with torch.no_grad():
        logits, ref_alphas = ref.teacher_forced(w, cfg, x, tokens)
    r = compare.decode_readings(logits, ref_alphas, words, alphas)
    assert r["logit_gap"] <= 1e-5 and r["alpha_err"] <= 1e-5
    assert len(set(words.flatten().tolist())) >= 3    # not one word


def test_train_steps_agree_with_the_program():
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import new_state

    cfg = read_json("configs", "lcnic_flagship")
    cfg.update(tiny.CONFIGS["lcnic_flagship"])
    cfg["store"].update(tiny.STORES["lcnic_flagship"])
    tr = dict(read_json("traffic", "train_b512"),
              **tiny.TRAFFIC["train_b512"])
    dev, seed = torch.device("cpu"), 11
    w = lc_nic.weights(cfg, 5, dev)
    model = port.model(cfg, w, dev)
    pcfg = lc_nic_program.train_config(cfg, seed)
    state = new_state(model, pcfg, dev, seed=seed)
    tokens = traffic.captions(cfg, tr, seed)
    target = traffic.targets(tokens)
    check = traffic.check_batches(cfg, tr["batch"], 2, seed)
    keys = check // cfg["store"]["captions_per_key"]
    store = lc_nic_program.to_store(model, traffic.rows_for(
        cfg, seed, range(cfg["store"]["keys"]), dev))
    tables = (torch.arange(len(tokens)) // cfg["store"]["captions_per_key"],
              torch.as_tensor(tokens), torch.as_tensor(target))
    step = steps.make_scanned_train_steps_from_tables(pcfg,
                                                      lc_nic_l2_rules(pcfg))
    state, m = step(state, store, *tables, torch.as_tensor(check))
    ref = lc_nic.train_steps(w, cfg, [
        (traffic.rows_for(cfg, seed, k, dev), torch.as_tensor(tokens[c]),
         torch.as_tensor(target[c])) for k, c in zip(keys, check)], seed)
    assert m["loss"].tolist() == pytest.approx(ref["loss"], rel=1e-5)
