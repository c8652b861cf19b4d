"""The port's training product for every model family, on the CPU: for each
``configs/*.yaml``, on a copy whose ``log:`` is under a temporary directory
and at smoke size, ``metrics`` trains, decodes greedily and scores, then
``metrics --resume --epochs 0 --decoder beam`` decodes the same run with the
beam and scores it, and ``caption --decoder beam|sample`` serves the run
directory (an ``ms2_nic`` run also through ``--subject b``). Then
``Captioner.from_run_dir`` gives ``run_eval``'s words on the run's own test
rows for a frozen-GloVe run and the two image families."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.serve import Captioner

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))
KEYS, ROWS = "16", 5


def _copy(name: str, tmp: Path) -> Path:
    text = (ROOT / "configs" / f"{name}.yaml").read_text()
    text = re.sub(r"(?m)^log:.*$", f"log: {tmp / 'logs'}/", text)
    path = tmp / f"{name}.yaml"
    path.write_text(text)
    return path


def _cli(argv, capsys) -> dict:
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _caption(argv, capsys) -> list[str]:
    assert cli.main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", CONFIGS)
def test_config_trains_decodes_scores_and_serves(name, tmp_path, capsys):
    common = ["--config", str(_copy(name, tmp_path)), "--smoke-keys", KEYS,
              "--device", "cpu"]
    greedy = _cli(["metrics", *common, "--epochs", "1"], capsys)
    beam = _cli(["metrics", *common, "--epochs", "0", "--resume",
                 "--decoder", "beam", "--beam-width", "3"], capsys)
    assert greedy["run_path"] == beam["run_path"]
    for out in (greedy, beam):
        assert out["n_captions"] > 0 and "Bleu_4" in out and "CIDEr" in out
    run = Path(greedy["run_path"])
    words = np.load(run / "output_captions_0.npy")
    assert words.shape == (greedy["n_captions"], Config.load(
        run / "config.yaml").max_length)

    meta = json.loads((run / "run_meta.json").read_text())
    rows = np.random.default_rng(0).standard_normal(
        (ROWS, *meta["input_row_shape"])).astype(np.float32)
    np.save(tmp_path / "rows.npy", rows)
    serve = ["caption", "--run", str(run), "--betas",
             str(tmp_path / "rows.npy"), "--device", "cpu"]
    for decoder in ("beam", "sample"):
        lines = _caption([*serve, "--decoder", decoder], capsys)
        assert len(lines) == ROWS
    if meta["model"] == "ms2_nic":
        assert len(_caption([*serve, "--subject", "b"], capsys)) == ROWS


RUNS = {
    "glove-frozen": ("smoke", dict(glove_trainable=False)),
    "img_nic": ("smoke", dict(model="img_nic")),
    "cnn_rnn": ("cnn_rnn", {}),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_from_run_dir_gives_run_eval_words(case, tmp_path):
    name, overrides = RUNS[case]
    cfg = dataclasses.replace(Config.load(_copy(name, tmp_path)),
                              **overrides)
    if case == "glove-frozen":
        table = np.random.default_rng(1).standard_normal(
            (cfg.vocab_size, 12)).astype(np.float32)
        np.save(tmp_path / "glove.npy", table)
        cfg = dataclasses.replace(cfg, glove_path=str(tmp_path / "glove.npy"))
    run_path, _, bundle = experiment.run_training(cfg, epochs=1,
                                                  smoke_keys=int(KEYS),
                                                  device="cpu")
    out = experiment.run_eval(bundle, run_path)
    store = bundle["store"]
    rows = store.device_array()[store.indices_for(out["keys"])].numpy()
    rows = rows.reshape(len(rows), *store.row_shape)
    cap = Captioner.from_run_dir(run_path, best=False, device="cpu")
    assert cap.input_row_shape == store.row_shape
    np.testing.assert_array_equal(cap.caption_ids(rows), out["words"])
    # the words of two epochs of random captions barely vary: the alphas,
    # which depend on the row, carry the check
    _, alphas = make_whole_fused_greedy_decoder(cap.model, cap.max_length)(
        torch.from_numpy(rows), bundle["tokenizer"].start_id)
    want = np.load(Path(run_path) / f"attention_scores_{out['epoch']}.npy")
    np.testing.assert_allclose(alphas.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.abs(want[:, 0] - want[:1, 0]).max() > 1e-4
    if case == "glove-frozen":
        assert "embedding" not in dict(cap.model.named_parameters())
        np.testing.assert_array_equal(
            cap.model.embedding.numpy()[:len(table)], table)
    else:
        assert len(store.row_shape) == 2
