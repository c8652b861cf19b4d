"""The ported training product against the JAX package's, on the CPU.

From a temporary copy of ``configs/smoke.yaml`` with every dropout 0: JAX
``run_training`` A (1 epoch) makes a checkpoint; JAX run B warm-starts
from A and trains 2 epochs; A's best parameters, read through the JAX
``CheckpointManager`` and ``transplant.from_flax``, become a port checkpoint
directory, from which the port's ``run_training`` warm-starts and trains 2
epochs. The per-epoch ``loss`` and ``val_loss`` match B's within 2e-5, as
the trainer tests hold them; the two run directories hold the same files
outside ``model/``, the same ``metrics.jsonl`` kinds and keys and CSV
headers. The port's ``run_eval`` on B's final parameters gives B's words,
near-ties excepted, and ``run_metrics`` on B's texts gives the JAX dict
exactly. Then the port alone: resume is bit for bit with dropout on,
``from_run_dir`` serves the run's words, the CLI prints the JAX CLI's keys,
the parts a former slice refused (the other families, GloVe tables, the
learned carry, beam and sampling, the profiling knobs, and their CLI flags)
run, CaptionImagePreview's images carry the JAX run's tags and steps, and
every part that waits refuses, naming its ROADMAP item."""

import copy
import dataclasses
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.train.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.store import permute_rows
from masters_thesis_tpu_torch.ops.fused_decode import (
    decode_inputs,
    fused_greedy_decode_reference,
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
from masters_thesis_tpu_torch.train.state import new_state
from masters_thesis_tpu_torch.transplant import from_flax

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke.yaml"
KEYS = 24
TRAJ = dict(rtol=2e-5, atol=2e-5)       # tests/test_torch_trainer.py:38
TIE_MARGIN = 1e-3
DROPOUTS = ("dropout_features", "dropout_text", "dropout_lstm",
            "dropout_attn", "dropout_out")


def _smoke_yaml(tmp: Path, dropout_off: bool = True,
                extra: str = "") -> Path:
    """A copy of configs/smoke.yaml logging under ``tmp``."""
    text = SMOKE.read_text().replace("log: /tmp/mtt_logs/",
                                     f"log: {tmp / 'logs'}/")
    if dropout_off:
        text += "".join(f"{k}: 0.0\n" for k in DROPOUTS)
    text += extra
    path = tmp / "smoke.yaml"
    path.write_text(text)
    return path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX A -> JAX B (warm start, 2 epochs, then run_eval and
    run_metrics); A's best parameters as a port checkpoint -> port P (warm
    start, 2 epochs)."""
    tmp = tmp_path_factory.mktemp("slice")
    path = _smoke_yaml(tmp, extra="caption_metrics_every: 1\n")
    jcfg = JConfig.load(path)
    run_a, _, _ = jexp.run_training(dataclasses.replace(jcfg, run="A"),
                                    epochs=1, smoke_keys=KEYS)
    jb_path, jb_logs, jb = jexp.run_training(
        dataclasses.replace(jcfg, run="B", warm_start=run_a), epochs=2,
        smoke_keys=KEYS)
    jb_eval = jexp.run_eval(jb, jb_path)
    jb_metrics = jexp.run_metrics(jb, jb_eval)

    # A's best parameters, through the JAX manager, into a port checkpoint
    params, epoch = JCheckpointManager(
        os.path.join(run_a, "model")).restore_params_only(None, best=True)
    cfg = Config.load(path)
    _, _, _, store, groups = experiment.build_data(cfg, KEYS)
    model, _, _ = experiment.build_model(cfg, groups, store.row_shape[0])
    missing, unexpected = model.load_state_dict(
        from_flax({"params": _np(params)}), strict=False)
    assert not unexpected and all(k.endswith((".mean", ".var"))
                                  for k in missing)
    port_a = tmp / "logs" / "portA"
    mgr = CheckpointManager(str(port_a / "model"))
    mgr.save(new_state(model, cfg, "cpu"), epoch)
    mgr.close()

    p_cfg = dataclasses.replace(cfg, run="P", warm_start=str(port_a))
    p_path, p_logs, p = experiment.run_training(p_cfg, epochs=2,
                                                smoke_keys=KEYS,
                                                device="cpu")
    return {"jb": jb, "jb_path": jb_path, "jb_logs": jb_logs,
            "jb_eval": jb_eval, "jb_metrics": jb_metrics, "p": p,
            "p_path": p_path, "p_logs": p_logs, "tmp": tmp, "yaml": path,
            "run_a": run_a, "port_a": str(port_a)}


def _records(run_path, kind="epoch"):
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_training_matches_the_jax_run(runs):
    got, want = _records(runs["p_path"]), _records(runs["jb_path"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], **TRAJ,
                                   err_msg=key)
    assert got[-1]["loss"] == runs["p_logs"]["loss"]


def _listing(run_path):
    """Every file of a run directory outside model/; TensorBoard event
    files by their suffix alone (their names carry a time and a pid)."""
    out = set()
    for path in Path(run_path).rglob("*"):
        rel = path.relative_to(run_path)
        if rel.parts[0] == "model" or path.is_dir():
            continue
        if rel.name.startswith("events.out.tfevents."):
            # events.out.tfevents.<time>.mtt.<pid><suffix>
            suffix = rel.name.split(".")[6:]
            rel = rel.parent / ".".join(["events", *suffix])
        out.add(str(rel))
    return out


def test_run_directory_matches_the_jax_run(runs):
    """The same files, ``tb/events.captions`` of CaptionImagePreview
    included."""
    p, jb = runs["p_path"], runs["jb_path"]
    experiment.run_eval(runs["p"], p)
    assert _listing(p) == _listing(jb)
    assert "tb/events.captions" in _listing(p)
    assert sorted(os.listdir(Path(p) / "model")) == [
        "ep000", "ep001", "meta.json"]
    for name in ("loss_history.csv", "batch_training_log.csv",
                 "df_grads.csv"):
        assert ((Path(p) / name).read_text().splitlines()[0]
                == (Path(jb) / name).read_text().splitlines()[0]), name
    assert ((Path(p) / "df_grads.csv").read_text().count("\n")
            == (Path(jb) / "df_grads.csv").read_text().count("\n"))
    assert ((Path(p) / "modelsummary.txt").read_text()
            == (Path(jb) / "modelsummary.txt").read_text())
    for kind in ("epoch", "caption_metrics"):
        got, want = _records(p, kind), _records(jb, kind)
        assert [sorted(r) for r in got] == [sorted(r) for r in want], kind
        assert len(got) == 2, kind
    meta = json.loads((Path(p) / "run_meta.json").read_text())
    jmeta = json.loads((Path(jb) / "run_meta.json").read_text())
    # the port also records tpu.prng_impl, which changes nothing there, and
    # the training forward's dtype
    assert set(meta) - set(jmeta) == {"prng_impl", "compute_dtype"}
    assert meta["compute_dtype"] == "float32"
    assert set(jmeta) - set(meta) == set()
    assert meta["input_row_shape"] == jmeta["input_row_shape"]
    assert meta["backend"] == "cpu"
    assert Config.load(Path(p) / "config.yaml").to_dict() == JConfig.load(
        Path(p) / "config.yaml").to_dict()


def test_caption_images_match_the_jax_runs_tags_and_steps(runs):
    """CaptionImagePreview's image summaries: the JAX run's tags at the
    JAX run's steps, each image as large as its PNG."""
    from test_torch_preview import image_events

    events = {}
    for name in ("p_path", "jb_path"):
        (path,) = Path(runs[name], "tb").glob("events.out.tfevents.*.captions")
        events[name] = image_events(path, wrapped=name == "p_path")
    assert ([e[:2] for e in events["p_path"]]
            == [e[:2] for e in events["jb_path"]])
    assert [e[1] for e in events["p_path"]] == [
        f"captions/sample_{i}" for i in range(4)]
    for _, _, h, w, png in events["p_path"]:
        assert struct.unpack(">II", png[16:24]) == (w, h)


def _port_bundle_with_jax_weights(runs):
    """The port's bundle with B's final parameters and BatchNorm statistics
    loaded into a copy of its model."""
    bundle = dict(runs["p"])
    jstate = runs["jb"]["state"]
    model = copy.deepcopy(bundle["model"])
    model.load_state_dict(from_flax({
        "params": _np(jstate.params),
        "batch_stats": _np(jstate.batch_stats)}))
    bundle["model"] = model
    return bundle


def _equal_but_at_near_ties(bundle, got, want):
    """``run_eval``'s words ``got`` equal ``want``'s, but on rows that first
    differ at a near-tie of ``bundle``'s model (top-2 logit margin <
    TIE_MARGIN): two decodes that sum in different orders may part there.
    At most a tenth of the rows."""
    np.testing.assert_array_equal(got["keys"], want["keys"])
    words, jwords = got["words"], np.asarray(want["words"])
    assert words.shape == jwords.shape and words.dtype == np.int32
    differs = np.nonzero((words != jwords).any(axis=1))[0]
    if len(differs):
        store, cfg = bundle["store"], bundle["cfg"]
        rows = store.device_array()[store.indices_for(got["keys"][differs])]
        model = bundle["model"].eval()
        _, _, margins = fused_greedy_decode_reference(
            *decode_inputs(model, rows, bundle["tokenizer"].start_id),
            max_length=cfg.max_length, return_margins=True)
        for i, row in enumerate(differs):
            first = int(np.argmax(words[row] != jwords[row]))
            assert float(margins[i, first]) < TIE_MARGIN, row
    assert len(differs) <= len(words) // 10


def test_eval_on_jax_weights_gives_the_jax_words(runs):
    bundle = _port_bundle_with_jax_weights(runs)
    out_dir = runs["tmp"] / "eval"
    out_dir.mkdir()
    got = experiment.run_eval(bundle, str(out_dir))
    want = runs["jb_eval"]
    np.testing.assert_array_equal(got["keys"], want["keys"])
    assert got["epoch"] == want["epoch"] == 1
    _equal_but_at_near_ties(bundle, got, want)
    for name in ("output_captions_1.npy", "attention_scores_1.npy",
                 "captions_1.txt"):
        assert (out_dir / name).exists()


def _no_pallas(cfg):
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, use_pallas=False))


@pytest.fixture(scope="module")
def plain_runs(runs):
    """The fixture's warm-started runs again under ``tpu.use_pallas:
    false``: JAX C from A and the port's Q from A's port checkpoint, 2
    epochs each, then ``run_eval``; and P's ``run_eval``, the knob-on
    twin's words."""
    jcfg = _no_pallas(JConfig.load(runs["yaml"]))
    jc_path, _, jc = jexp.run_training(
        dataclasses.replace(jcfg, run="C", warm_start=runs["run_a"]),
        epochs=2, smoke_keys=KEYS)
    cfg = _no_pallas(Config.load(runs["yaml"]))
    q_path, _, q = experiment.run_training(
        dataclasses.replace(cfg, run="Q", warm_start=runs["port_a"]),
        epochs=2, smoke_keys=KEYS, device="cpu")
    p_eval = runs["tmp"] / "p_eval"
    p_eval.mkdir()
    return {"jc_path": jc_path, "jc_eval": jexp.run_eval(jc, jc_path),
            "q": q, "q_path": q_path,
            "q_eval": experiment.run_eval(q, q_path),
            "p_eval": experiment.run_eval(runs["p"], str(p_eval))}


def test_plain_route_matches_the_jax_plain_run(plain_runs):
    """``use_pallas: false`` in both packages: the port's epoch losses
    within TRAJ of the JAX run's, and its words, near-ties excepted."""
    got, want = (_records(plain_runs[k]) for k in ("q_path", "jc_path"))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], **TRAJ,
                                   err_msg=key)
    _equal_but_at_near_ties(plain_runs["q"], plain_runs["q_eval"],
                            plain_runs["jc_eval"])


def test_plain_route_equals_the_kernel_route_bit_for_bit(runs, plain_runs):
    """The port's runs with the knob off and on from the same checkpoint:
    every epoch record's loss and val loss and the final parameters equal
    bit for bit (a gather is a copy either way); the words of the step loop
    and of K2's plain version, near-ties excepted."""
    got, want = _records(plain_runs["q_path"]), _records(runs["p_path"])
    for key in ("loss", "val_loss", "accuracy", "L2"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    q_state = plain_runs["q"]["state"].model.state_dict()
    p_state = runs["p"]["state"].model.state_dict()
    assert q_state.keys() == p_state.keys()
    assert all(torch.equal(q_state[k], p_state[k]) for k in q_state)
    _equal_but_at_near_ties(runs["p"], plain_runs["q_eval"],
                            plain_runs["p_eval"])


@pytest.mark.parametrize("scan_steps", [0, 2])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_picks_the_route(use_pallas, scan_steps, tmp_path,
                                    monkeypatch):
    """``run_training`` and ``run_eval`` on the CPU, per step and scanned:
    with the knob off, K1's wrapper (``ops.gather.gather_rows``) and the
    whole-decode factory are never called; with it on, both are."""
    from masters_thesis_tpu_torch.ops import gather

    calls = {"gather_rows": 0, "make_whole_fused_greedy_decoder": 0}

    def watched(name, fn):
        def call(*args, **kwargs):
            if not use_pallas:
                raise AssertionError(f"{name} called under use_pallas: "
                                     f"false")
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(gather, "gather_rows",
                        watched("gather_rows", gather.gather_rows))
    monkeypatch.setattr(experiment, "make_whole_fused_greedy_decoder",
                        watched("make_whole_fused_greedy_decoder",
                                experiment.make_whole_fused_greedy_decoder))
    cfg = dataclasses.replace(
        _cfg(use_pallas=use_pallas, scan_steps=scan_steps,
             caption_metrics_every=1), log=str(tmp_path))
    run_path, logs, bundle = experiment.run_training(
        cfg, epochs=1, smoke_keys=KEYS, device="cpu")
    out = experiment.run_eval(bundle, run_path)
    rows = bundle["store"].device_gather([0, 1])
    assert np.isfinite(logs["loss"]) and len(out["words"]) and len(rows) == 2
    assert bundle["store"].kernel is use_pallas
    if use_pallas:
        assert all(calls.values()), calls


def test_metrics_on_the_jax_texts_give_the_jax_dict(runs):
    got = experiment.run_metrics(runs["p"], runs["jb_eval"])
    assert got == runs["jb_metrics"]
    assert "GUSE_hash_pearson_r" in got and "METEOR_lite" in got


def test_resume_is_bit_for_bit_with_dropout_on(tmp_path):
    """Two epochs in one run, or one and then ``resume`` for one more: the
    same per-epoch metrics, the same final parameters, BatchNorm
    statistics and Adam state."""
    cfg = Config.load(_smoke_yaml(tmp_path, dropout_off=False))
    assert cfg.dropout_lstm == 0.2
    path_x, _, x = experiment.run_training(
        dataclasses.replace(cfg, run="X"), epochs=2, smoke_keys=KEYS,
        device="cpu")
    ycfg = dataclasses.replace(cfg, run="Y")
    experiment.run_training(ycfg, epochs=1, smoke_keys=KEYS, device="cpu")
    path_y, _, y = experiment.run_training(ycfg, epochs=2, smoke_keys=KEYS,
                                           resume=True, device="cpu")
    timing = {"ts", "epoch_time", "steps_per_sec"}
    rx, ry = _records(path_x), _records(path_y)
    assert len(rx) == len(ry) == 2
    for a, b in zip(rx, ry):
        assert ({k: v for k, v in a.items() if k not in timing}
                == {k: v for k, v in b.items() if k not in timing})
    assert ((Path(path_x) / "batch_training_log.csv").read_text()
            == (Path(path_y) / "batch_training_log.csv").read_text())
    sx, sy = x["state"], y["state"]
    assert (sx.step, sx.tx.count) == (sy.step, sy.tx.count)
    for (name, a), b in zip(sx.model.state_dict().items(),
                            sy.model.state_dict().values()):
        assert torch.equal(a, b), name
    for slot in ("mu", "nu"):
        for a, b in zip(getattr(sx.tx, slot), getattr(sy.tx, slot)):
            assert torch.equal(a, b), slot


def test_from_run_dir_serves_the_runs_words(runs):
    """The run directory's best checkpoint, rebuilt on the CPU, gives the
    words of an in-memory Captioner on the same weights and rows."""
    p = runs["p"]
    cap = Captioner.from_run_dir(runs["p_path"], device="cpu")
    best = p["manager"].best_epoch()
    assert cap.epoch == best
    model = copy.deepcopy(p["model"])
    saved = p["manager"].read(best)
    model.load_state_dict(from_flax({"params": saved["params"],
                                     "batch_stats": saved["batch_stats"]}))
    mem = Captioner(model, p["tokenizer"], p["cfg"].units,
                    p["cfg"].max_length, device="cpu")
    rows = p["store"].device_array()[:11].numpy()
    np.testing.assert_array_equal(cap.caption_ids(rows),
                                  mem.caption_ids(rows))
    assert cap.input_row_shape == (rows.shape[1],)


def test_from_run_dir_takes_raw_rows_of_a_pregathered_model(runs):
    """A run trained from a pregathered store keeps checkpoints a raw-row
    model loads: ``layout.npz`` rebuilds the voxel -> group layout, so the
    served model on raw rows decodes as the pregathered model on the same
    rows permuted into its layout, words and attention."""
    p = runs["p"]
    cap = Captioner.from_run_dir(runs["p_path"], device="cpu")
    layout = GroupLayout.load(os.path.join(runs["p_path"], "layout.npz"))
    pre, _, _ = experiment.build_model(p["cfg"], layout.to_groups(),
                                       layout.n_voxels, pregathered=True)
    saved = p["manager"].read(cap.epoch)
    pre.load_state_dict(from_flax({"params": saved["params"],
                                   "batch_stats": saved["batch_stats"]}))
    pre.eval()
    rows = p["store"].device_array()[:11]
    start = p["tokenizer"].start_id
    words, alphas = make_whole_fused_greedy_decoder(
        cap.model, cap.max_length)(rows, start)
    pre_words, pre_alphas = make_whole_fused_greedy_decoder(
        pre, cap.max_length)(permute_rows(rows, layout), start)
    assert torch.equal(words, pre_words)
    assert torch.equal(alphas, pre_alphas)
    assert (alphas[:, 0] - alphas[:1, 0]).abs().max() > 1e-3


def _cli(argv, capsys):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_prints_the_jax_cli_keys(runs, tmp_path, capsys):
    """``train``, ``eval`` and ``metrics`` print the keys the JAX CLI
    composes from the same calls (``masters_thesis_tpu/cli.py``); ``train``
    also through ``python -m``."""
    path = str(_smoke_yaml(tmp_path, extra="caption_metrics_every: 1\n"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
         "--config", path, "--epochs", "1", "--smoke-keys", "16",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    train = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(train) == {"run_path", *runs["jb_logs"]}
    assert os.path.exists(os.path.join(train["run_path"], "tokenizer.json"))
    common = ["--config", path, "--epochs", "1", "--smoke-keys", "16",
              "--device", "cpu"]
    out = _cli(["eval", *common], capsys)
    assert set(out) == {"run_path", "n_captions"} and out["n_captions"] > 0
    out = _cli(["metrics", *common], capsys)
    jkeys = {k for k, v in runs["jb_metrics"].items() if v is not None}
    assert set(out) == {"run_path", "n_captions", *jkeys}
    assert "GUSE_hash_pearson_r" in out and "GUSE_pearson_r" not in out


def test_cli_eval_resume_decodes_without_retraining(tmp_path, capsys):
    path = str(_smoke_yaml(tmp_path))
    common = ["--config", path, "--smoke-keys", "16", "--device", "cpu"]
    run_path = _cli(["train", *common, "--epochs", "2"], capsys)["run_path"]
    hist = (Path(run_path) / "loss_history.csv").read_text()
    out = _cli(["eval", *common, "--epochs", "0", "--resume"], capsys)
    assert out["run_path"] == run_path and out["n_captions"] > 0
    assert (Path(run_path) / "loss_history.csv").read_text() == hist
    assert (Path(run_path) / "output_captions_1.npy").exists()


def test_cli_caption_writes_one_line_per_row(runs, tmp_path, capsys):
    rows = runs["p"]["store"].device_array()[:5].numpy()
    np.save(tmp_path / "rows.npy", rows)
    out_txt = tmp_path / "captions.txt"
    out = _cli(["caption", "--run", runs["p_path"], "--betas",
                str(tmp_path / "rows.npy"), "--out", str(out_txt),
                "--device", "cpu"], capsys)
    assert out == {"n": 5, "out": str(out_txt)}
    lines = out_txt.read_text().splitlines()
    cap = Captioner.from_run_dir(runs["p_path"], device="cpu")
    assert lines == cap.caption(rows)
    assert cli.main(["caption", "--run", runs["p_path"], "--betas",
                     str(tmp_path / "rows.npy"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == lines


def _cfg(**kw):
    cfg = Config.load(SMOKE)
    tpu = {k: kw.pop(k) for k in list(kw) if hasattr(cfg.tpu, k)}
    dataset = {k: kw.pop(k) for k in list(kw) if hasattr(cfg.dataset, k)}
    return dataclasses.replace(
        cfg, **kw, tpu=dataclasses.replace(cfg.tpu, **tpu),
        dataset=dataclasses.replace(cfg.dataset, **dataset))


def _train(tmp_path, **kw):
    cfg = dataclasses.replace(_cfg(**kw), log=str(tmp_path))
    experiment.run_training(cfg, epochs=1, smoke_keys=12, device="cpu")


def _captioner_decoder(tmp_path, decoder):
    def run():
        from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
        from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
        from masters_thesis_tpu_torch.models.nic import LcNIC
        from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

        tok = Tokenizer()
        tok.fit_on_texts(["<start> a dog <end>"])
        tok.install_pad()
        layout = GroupLayout(synthetic_groups(32, 4), 32)
        cap = Captioner(LcNIC(layout, units=8, group_size=4,
                              embedding_text=4, attn_units=4, vocab_size=6,
                              max_length=3), tok, 8, 3, device="cpu")
        return cap.caption(np.zeros((1, 32), np.float32), decoder=decoder)
    return run


# knobs -> the dtype run_meta.json records; "bf16 on the card" forces the
# card's rule (bf16 wherever compute_dtype asks for it) on the CPU
PRECISION_RUNS = {
    "bf16 params": (dict(param_dtype="bfloat16"), "float32"),
    "bf16 compute": (dict(compute_dtype="bfloat16"), "float32"),
    "bf16 on the card": (dict(compute_dtype="bfloat16"), "bfloat16"),
    "remat": (dict(remat=True), "float32"),
}


@pytest.mark.parametrize("case", sorted(PRECISION_RUNS))
def test_precision_and_remat_knobs_train_end_to_end(case, tmp_path,
                                                    monkeypatch):
    """``tpu.param_dtype``, ``tpu.compute_dtype: bfloat16`` and
    ``tpu.remat`` train through ``run_training``: one epoch with finite
    losses, the chosen forward dtype in ``run_meta.json`` (fp32 on the CPU,
    the JAX package's rule off its accelerator) and fp32 parameters in the
    checkpoint."""
    from masters_thesis_tpu_torch.train import steps

    knobs, dtype = PRECISION_RUNS[case]
    if case == "bf16 on the card":
        monkeypatch.setattr(
            steps, "_compute_dtype",
            lambda cfg, device: (torch.bfloat16
                                 if cfg.tpu.compute_dtype == "bfloat16"
                                 else torch.float32))
    _train(tmp_path, **knobs)
    (meta,) = tmp_path.rglob("run_meta.json")
    assert json.loads(meta.read_text())["compute_dtype"] == dtype
    (metrics,) = tmp_path.rglob("metrics.jsonl")
    losses = [r["loss"] for r in map(json.loads,
                                     metrics.read_text().splitlines())
              if "loss" in r]
    assert losses and np.all(np.isfinite(losses))
    (state,) = tmp_path.rglob("state.pt")
    params = torch.load(state, weights_only=False)
    floats = [t for t in _tensors(params) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _glove_run(tmp_path):
    table = np.random.default_rng(0).standard_normal((61, 16)).astype(
        np.float32)
    np.save(tmp_path / "g.npy", table)
    _train(tmp_path, glove_path=str(tmp_path / "g.npy"),
           glove_trainable=False)
    (kept,) = tmp_path.rglob("glove_table.npy")
    np.testing.assert_array_equal(np.load(kept), table)


def _learned_init_run(tmp_path):
    _train(tmp_path, learned_init_state=True)
    (summary,) = tmp_path.rglob("modelsummary.txt")
    assert "hidden_init" in summary.read_text()


def _beam_eval(tmp_path):
    cfg = dataclasses.replace(_cfg(), log=str(tmp_path))
    run_path, _, bundle = experiment.run_training(cfg, epochs=1,
                                                  smoke_keys=12, device="cpu")
    out = experiment.run_eval(bundle, run_path, decoder="beam", beam_width=3)
    attn = np.load(Path(run_path) / f"attention_scores_{out['epoch']}.npy")
    assert attn.shape == (*out["words"].shape,
                          bundle["model"].encoder.layout.n_groups)


def _real_data_run(tmp_path):
    from test_real_data_path import _make_dataset

    nsd, caps, betas = _make_dataset(tmp_path)
    _train(tmp_path, betas_path=str(betas), captions_path=str(caps),
           nsd_dir=str(nsd))


def _use_metrics_run(tmp_path):
    """A USE weight bundle in the config's guse dir: run_metrics scores
    with the port's encoder and labels GUSE_* (it refused, naming M12)."""
    from masters_thesis_tpu_torch.models.use_encoder import (
        init_use_params,
        save_use_bundle,
    )

    vocab = ["a", "the", "dog", "runs"]
    save_use_bundle(str(tmp_path / "use_dan.npz"), vocab,
                    init_use_params(len(vocab), oov_buckets=8, embed_dim=16,
                                    hidden=(16,), out_dim=16), 8)
    cfg = dataclasses.replace(_cfg(guse_path=str(tmp_path)),
                              log=str(tmp_path))
    run_path, _, bundle = experiment.run_training(cfg, epochs=1,
                                                  smoke_keys=12, device="cpu")
    scores = experiment.run_metrics(bundle,
                                    experiment.run_eval(bundle, run_path))
    assert "GUSE_pearson_r" in scores and "GUSE_hash_pearson_r" not in scores


# parts a former slice refused, naming ROADMAP M9, M11, M12, M14 or M19,
# now run
FORMERLY_REFUSED = {
    "step profiling": lambda t: _train(t, profile_steps=5),
    "profiler trace": lambda t: _train(t, profile_trace=True),
    "USE encoder": _use_metrics_run,
    "real NSD data": _real_data_run,
    "another model family": lambda t: _train(t, model="showtell"),
    "GloVe table": _glove_run,
    "learned initial state": _learned_init_run,
    "beam eval": _beam_eval,
    "beam serving": lambda t: _captioner_decoder(t, "beam")(),
    "sampled serving": lambda t: _captioner_decoder(t, "sample")(),
}


@pytest.mark.parametrize("case", sorted(FORMERLY_REFUSED))
def test_formerly_refused_parts_run(case, tmp_path):
    out = FORMERLY_REFUSED[case](tmp_path)
    if case.endswith("serving"):
        assert len(out) == 1 and isinstance(out[0], str)
    else:
        assert list(tmp_path.rglob("run_meta.json"))


@pytest.mark.parametrize("argv", [
    ["eval", "--decoder", "beam"],
    ["eval", "--beam-width", "3"],
    ["metrics", "--subject", "b"],
    ["metrics", "--decoder", "beam", "--beam-width", "3"],
    ["caption", "--decoder", "sample"],
    ["caption", "--decoder", "sample", "--temperature", "0.7"],
    ["caption", "--decoder", "sample", "--sample-top-k", "5"],
    ["caption", "--decoder", "sample", "--seed", "3"],
    ["caption", "--pre", "pre"],
])
def test_cli_decoder_flags_run(argv, runs, tmp_path, capsys):
    """The flags a former slice refused: eval and metrics decode with the
    beam (``--subject`` picks an ms2_nic run's encoder and is ignored by
    any other family); caption samples, a seed fixing the words; caption
    replays a preprocess chain (here one that only normalizes) on raw
    rows."""
    if argv[0] == "caption":
        rows = runs["p"]["store"].device_array()[:5].numpy()
        np.save(tmp_path / "rows.npy", rows)
        if "--pre" in argv:
            pre = tmp_path / "pre"
            pre.mkdir()
            np.savez(pre / "norm_stats.npz", mean=np.full(rows.shape[1], 0.5,
                                                          np.float32),
                     std=np.full(rows.shape[1], 2.0, np.float32))
            (pre / "transform.json").write_text(json.dumps({
                "stages": [{"stage": "normalize", "file": "norm_stats.npz"}],
                "input_row_shape": [rows.shape[1]],
                "final_row_shape": [rows.shape[1]]}))
            argv = [argv[0], "--pre", str(pre)]
            want = Captioner.from_run_dir(runs["p_path"], device="cpu") \
                .caption((rows - 0.5) / 2.0)
        argv = [*argv, "--run", runs["p_path"], "--betas",
                str(tmp_path / "rows.npy"), "--device", "cpu"]
        assert cli.main(argv) == 0
        first = capsys.readouterr().out.splitlines()
        assert len(first) == 5
        if "--pre" in argv:
            assert first == want
        assert cli.main(argv) == 0
        assert capsys.readouterr().out.splitlines() == first
    else:
        path = str(_smoke_yaml(tmp_path))
        out = _cli([*argv, "--config", path, "--epochs", "1",
                    "--smoke-keys", "12", "--device", "cpu"], capsys)
        assert out["n_captions"] > 0
