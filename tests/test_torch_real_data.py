"""The port's real-data path against the JAX package's, on the CPU, on the
layout of ``tests/test_real_data_path.py::_make_dataset`` (conditions CSVs,
KID caption files, a beta pack, atlas label vectors).

``build_data`` gives the JAX split, pairs, tokenizer, store keys and rows
and Glasser groups, with ``groups_to_remove`` and for the two-subject
``ms2_nic`` and ``ms_nic`` cases (subject B's keys offset, its per-key
``.npy`` rows after A's); its store stays on the host. Three dropout-off
train steps from the real pack's rows follow the JAX steps within 2e-5.
``caption --pre`` and ``serve --pre`` on raw rows, through the JAX
preprocess chain, give the JAX words from the JAX run's weights; the
``features --pack`` output trains ``img_nic``; ``run_training`` uploads a
pack's store to the device."""

import dataclasses
import io
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.pack import open_pack as jopen_pack
from masters_thesis_tpu.serve import Captioner as JCaptioner
from masters_thesis_tpu.serve import PreTransformCaptioner as JPre
from masters_thesis_tpu.train import steps as jsteps
from masters_thesis_tpu.train.state import init_model as jinit_model
from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.pairs import encode_pairs
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.server import serve_forever
from masters_thesis_tpu_torch.train import steps
from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
from masters_thesis_tpu_torch.train.state import new_state
from masters_thesis_tpu_torch.transplant import from_flax
from test_real_data_path import _make_dataset, _make_two_subject_dataset
from test_torch_families import KEYS as STEP_KEYS
from test_torch_families import _jax_state, _randomise
from torch_threads import one_thread  # noqa: F401

TRAJ = dict(rtol=2e-5, atol=2e-5)       # tests/test_torch_trainer.py:38
WIDTHS = dict(epochs=1, batch_size=8, max_length=8, top_k=30, units=16,
              attn_units=8, group_size=4, embedding_text=8,
              embedding_features=16)
NO_DROPOUT = dict(dropout_input=0.0, dropout_features=0.0, dropout_text=0.0,
                  dropout_attn=0.0, dropout_lstm=0.0, dropout_out=0.0)


def _configs(tmp_path, model="lc_nic", dataset=None, **kw):
    """(JAX config, port config) of the same YAML, logging under tmp."""
    jcfg = JConfig(run=model, model=model, log=str(tmp_path / "logs"),
                   **{**WIDTHS, **kw})
    for key, value in (dataset or {}).items():
        setattr(jcfg.dataset, key, str(value))
    jcfg.save(tmp_path / f"{model}.yaml")
    return jcfg, Config.load(tmp_path / f"{model}.yaml")


def _single(tmp_path):
    nsd, caps, betas = _make_dataset(tmp_path)
    return dict(betas_path=betas, captions_path=caps, nsd_dir=nsd)


def _two(tmp_path):
    nsd, caps, betas, caps_b, betas_b = _make_two_subject_dataset(tmp_path)
    return dict(betas_path=betas, captions_path=caps, nsd_dir=nsd,
                betas_path_b=betas_b, captions_path_b=caps_b)


@pytest.mark.parametrize("model,layout,remove", [
    ("lc_nic", _single, ()), ("lc_nic", _single, (1, 142, 17)),
    ("ms2_nic", _two, ()), ("ms_nic", _two, ())])
def test_build_data_matches_jax(tmp_path, model, layout, remove):
    jcfg, cfg = _configs(tmp_path, model, layout(tmp_path),
                         groups_to_remove=list(remove))
    jsplit, jpairs, jtok, jstore, jgroups = jexp.build_data(jcfg)
    split, pairs, tok, store, groups = experiment.build_data(cfg)
    for name in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(split, name),
                                      getattr(jsplit, name))
        assert pairs[name] == jpairs[name]
    assert tok.word_index == jtok.word_index
    assert not store.device_resident
    np.testing.assert_array_equal(store.keys, jstore.keys)
    # two subjects' rows are their arrays end to end, uncopied
    rows = np.concatenate(getattr(store.data, "parts", [store.data]))
    np.testing.assert_array_equal(rows, np.asarray(jstore.data))
    np.testing.assert_array_equal(store.upload("cpu").numpy(), rows)
    assert store.row_shape == jstore.row_shape == (96,)
    assert len(groups) == len(jgroups) == (2 if remove else 3)
    for a, b in zip(groups, jgroups):
        np.testing.assert_array_equal(a, b)
    if model != "lc_nic":
        assert {p[4] for p in pairs["train"]} == {"A", "B"}
        b_key = int(experiment.B_KEY_OFFSET + 50)
        np.testing.assert_array_equal(
            rows[store.indices_for([1, b_key])],
            np.asarray(jstore.data)[jstore.indices_for([1, b_key])])


def test_three_train_steps_on_the_real_pack_match_jax(tmp_path):
    """LcNIC on the real pack's rows and captions: the same randomised
    weights, three dropout-off Adam steps, every metric and parameter
    within 2e-5 (V.bias, whose gradient is 0, within Adam's 3 * lr)."""
    jcfg, cfg = _configs(tmp_path, "lc_nic", _single(tmp_path), alpha=1e-3,
                         **NO_DROPOUT)
    _, pairs, tok, store, groups = experiment.build_data(cfg)
    enc = encode_pairs(pairs["train"][::7][:8], tok, cfg.max_length)
    rows = store.gather_host(store.indices_for(enc.keys)).astype(np.float32)
    tokens = enc.tokens.astype(np.int32)
    target = np.concatenate([tokens[:, 1:], np.zeros((8, 1), np.int32)], 1)
    jmodel, jrules, _ = jexp.build_model(jcfg, groups, rows.shape[1])
    model, rules, masked = experiment.build_model(cfg, groups, rows.shape[1])
    variables = jax.tree_util.tree_map(np.asarray, dict(zip(
        ("params", "batch_stats"), jinit_model(jmodel, jcfg, rows,
                                               tokens)[:2])))
    variables = _randomise(variables, np.random.default_rng(0))
    model.load_state_dict(from_flax(variables))
    state = new_state(model.train(), cfg, "cpu")
    step = steps.make_train_step(cfg, rules, masked=masked)
    jstep = jsteps.make_train_step(jmodel, jcfg, jrules, masked=masked,
                                   donate=False)
    jstate = _jax_state(variables, jcfg)
    for _ in range(3):
        state, m = step(state, *(torch.from_numpy(a)
                                 for a in (rows, tokens, target)))
        jstate, jm = jstep(jstate, rows, tokens, target)
        for key in STEP_KEYS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **TRAJ)
    params = jax.device_get(jstate.params)
    v_bias = params["attention"]["V"].pop("bias")
    start = variables["params"]["attention"]["V"]["bias"]
    for got in (state.model.attention.V.bias.detach().numpy(), v_bias):
        assert np.abs(got - start).max() <= 3 * cfg.alpha * 1.001
    got = state.model.state_dict()
    for key, value in from_flax({"params": params}).items():
        np.testing.assert_allclose(got[key].detach().numpy(), value.numpy(),
                                   err_msg=key, **TRAJ)


def test_run_training_uploads_the_pack_and_trains(tmp_path):
    _, cfg = _configs(tmp_path, "lc_nic", _single(tmp_path))
    run_path, logs, bundle = experiment.run_training(cfg, device="cpu")
    assert np.isfinite(logs["loss"]) and np.isfinite(logs["val_loss"])
    store = bundle["store"]
    assert store.device_resident and store.device == torch.device("cpu")
    want = jopen_pack(cfg.dataset.betas_path)
    np.testing.assert_array_equal(store.keys, want.keys)
    np.testing.assert_array_equal(store.data.numpy(), np.asarray(want.data))
    out = experiment.run_eval(bundle, run_path)
    assert len(out["texts"]) == len(bundle["pairs"]["test"])


@pytest.fixture(scope="module")
def pre_runs(tmp_path_factory):
    """The JAX package: preprocess the exploded pack (vc 1,2 -> normalize
    -> PCA 4) and train ThinkAndTell one epoch on the PCA pack. The port: a
    run directory of the same config on the same pack holding the JAX
    run's weights as its best checkpoint."""
    tmp = tmp_path_factory.mktemp("pre_runs")
    data = _single(tmp)
    src = jopen_pack(str(data["betas_path"]))
    raw = tmp / "raw_betas"
    raw.mkdir()
    for i, key in enumerate(src.keys.tolist()):
        np.save(raw / f"subj02_KID{key}.npy", np.asarray(src.data[i]))
    jcfg, _ = _configs(tmp, "thinkandtell", {**data, "betas_path": raw})
    jexp.run_preprocess(jcfg, str(tmp / "pre"), pca_components=4,
                        vc_parcels="1,2", normalize=True)
    pca_pack = str(tmp / "pre" / "betas_pack_pca")
    jcfg, cfg = _configs(tmp, "thinkandtell", {**data,
                                               "betas_path": pca_pack})
    jrun, _, _ = jexp.run_training(jcfg, epochs=1)
    jcap = JCaptioner.from_run_dir(jrun)
    variables = jax.tree_util.tree_map(np.asarray, dict(jcap.variables))
    run_path, _, bundle = experiment.run_training(
        dataclasses.replace(cfg, run="port"), device="cpu")
    model = bundle["model"]
    model.load_state_dict(from_flax(variables))
    mgr = CheckpointManager(f"{run_path}/model")
    mgr.save(new_state(model, cfg, "cpu"), 1, val_loss=-1.0)
    mgr.close()
    rows = np.asarray(src.data)[:11]
    return {"tmp": tmp, "pre": str(tmp / "pre"), "run": run_path,
            "rows": rows,
            "words": JPre(jcap, str(tmp / "pre")).caption(rows)}


def test_caption_pre_gives_the_jax_words(pre_runs, capsys):
    tmp = pre_runs["tmp"]
    np.save(tmp / "raw.npy", pre_runs["rows"])
    argv = ["caption", "--run", pre_runs["run"], "--pre", pre_runs["pre"],
            "--betas", str(tmp / "raw.npy"), "--device", "cpu"]
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.splitlines() == pre_runs["words"]
    cap = Captioner.from_run_dir(pre_runs["run"], device="cpu")
    assert cap.epoch == 1 and cap.input_width == 4
    np.save(tmp / "raw4.npy", pre_runs["rows"][:, :4])
    with pytest.raises(ValueError, match="recorded on rows"):
        cli.main([*argv[:-4], "--betas", str(tmp / "raw4.npy"), "--device",
                  "cpu"])


def test_serve_pre_answers_a_post_with_the_jax_words(pre_runs):
    args = cli._parser().parse_args([
        "serve", "--run", pre_runs["run"], "--pre", pre_runs["pre"],
        "--port", "0", "--max-wait-ms", "1", "--device", "cpu"])
    server = cli.make_server(args)
    thread = threading.Thread(target=serve_forever, args=(server,),
                              daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        body = io.BytesIO()
        np.save(body, pre_runs["rows"])
        req = urllib.request.Request(
            f"http://{host}:{port}/caption", data=body.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert out["captions"] == pre_runs["words"]
    assert health["n_voxels"] == 96


def test_features_pack_trains_img_nic(tmp_path, capsys):
    data = _single(tmp_path)
    keys = np.asarray(sorted(list(range(1, 21)) + list(range(100, 106))),
                      np.int64)
    images = np.random.default_rng(0).integers(
        0, 255, (int(keys.max()), 32, 32, 3)).astype(np.uint8)
    np.save(tmp_path / "imgs.npy", images)
    np.save(tmp_path / "keys.npy", keys)
    assert cli.main(["features", "--backbone", "vgg16", "--head", "conv5",
                     "--images", str(tmp_path / "imgs.npy"), "--keys",
                     str(tmp_path / "keys.npy"), "--out",
                     str(tmp_path / "feat_pack"), "--pack", "--batch-size",
                     "8", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["pack"]["n_rows"] == 26
    assert report["pack"]["row_shape"] == [4, 512]
    _, cfg = _configs(tmp_path, "img_nic", {**data, "betas_path":
                                            tmp_path / "feat_pack"})
    run_path, logs, bundle = experiment.run_training(cfg, device="cpu")
    assert bundle["store"].row_shape == (4, 512)
    assert np.isfinite(logs["loss"])
    out = experiment.run_eval(bundle, run_path)
    assert out["words"].shape == (len(bundle["pairs"]["test"]),
                                  cfg.max_length)
