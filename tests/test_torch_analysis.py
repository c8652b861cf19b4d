"""The port's ``evalsuite/analysis.py`` and ``analyze`` command against the
JAX package's, on the CPU.

Every function that ``tests/test_analysis.py`` exercises runs in both
packages on the same inputs (that file's own), and the results are equal:
numbers, rankings, dicts, and the PNG files the drawing functions write,
byte for byte (both draw with the same matplotlib calls). Then ``analyze``
through both CLIs on the same run directories (that file's temporal and
betas-flag cases, and a port training run's directory with its eval
output): the same JSON report, output paths aside, and the same files."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from masters_thesis_tpu import cli as jcli
from masters_thesis_tpu.evalsuite import analysis as jan
from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.evalsuite import analysis as pan

from torch_threads import one_thread  # noqa: F401


def _same(a, b, where="result"):
    """Equal, exactly: nested dicts, lists and tuples, arrays (NaN equal
    to NaN) and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert a.dtype == np.asarray(b).dtype, where
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _loader(calls):
    def load(key):
        calls.append(key)
        return np.full((4, 4, 3), 10 * key, np.uint8)
    return load


def _grid_entries(m):
    calls = []
    keys = [1, 2, 3, 4]
    texts = ["a dog runs", "a cat sits", "total nonsense words here",
             "a bird flies"]
    refs = {1: ["a dog runs"], 2: ["a cat sits"],
            3: ["a man rides a horse"], 4: ["a bird flies"]}
    return (m.caption_grid_entries(keys, texts, image_loader=_loader(calls),
                                   references=refs, n=2),
            calls, m.caption_grid_entries(keys, texts, n=3),
            m.caption_grid_entries([7], ["a cat on a mat"],
                                   references={7: ["A cat on a mat."]}, n=2))


def _similarity(m):
    rng = np.random.default_rng(1)
    n, v, d = 60, 32, 8
    z = rng.normal(size=(n, d)).astype(np.float32)
    guse = z @ rng.normal(size=(d, 16)).astype(np.float32)
    betas = (z @ rng.normal(size=(d, v)).astype(np.float32)
             + 0.05 * rng.normal(size=(n, v)).astype(np.float32))
    return (m.betas_semantic_similarity(betas, guse, targets=[3, 17],
                                        n_similar=8, n_random=20, seed=4),
            m.betas_semantic_similarity(betas, np.stack([guse, guse], 1),
                                        targets=[3, 17], n_similar=8,
                                        n_random=20, seed=4),
            m.betas_semantic_similarity(betas[:6], guse[:6], targets=[2],
                                        n_similar=100, n_random=10, seed=1))


def _most_active(m):
    rng = np.random.default_rng(0)
    base = rng.normal(size=64).astype(np.float32)
    base[:10] += 10.0
    a = base + 0.1 * rng.normal(size=(40, 64)).astype(np.float32)
    b = base + 0.1 * rng.normal(size=(40, 64)).astype(np.float32)
    ties = np.zeros((4, 12), np.float32)
    ties[:, 3] = ties[:, 8] = 2.0
    ties[:, 5] = 1.0
    return (m.most_active_vertices(a, b, top_n=10, chunk=7),
            m.most_active_vertices(ties, top_n=3))


def _memmap(m, tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(25, 40)).astype(np.float32)
    np.save(tmp_path / "betas.npy", arr)
    mm = np.load(tmp_path / "betas.npy", mmap_mode="r")
    guse = rng.normal(size=(25, 8)).astype(np.float32)
    return (m.streamed_betas_stats(mm, chunk=7),
            m.betas_semantic_similarity(mm, guse, targets=[4], n_similar=5,
                                        n_random=5, seed=0))


def _loss_curves(m, tmp_path):
    p = tmp_path / "loss_history.csv"
    p.write_text("epoch,loss,val_loss\n0,2.0,2.5\n1,1.5,\n2,1.2,2.0\n")
    return m.loss_curves(str(p))


def _tag_attention():
    attn = np.zeros((2, 3, 4), np.float32)
    attn[0, 1, 0] = attn[1, 1, 0] = attn[0, 2, 3] = 1.0
    return attn


def _time_attention():
    attn = np.zeros((5, 3, 8), np.float32)
    attn[:, 0, 2], attn[:, 1, 5], attn[:, 2, 0] = 1.0, 0.5, 0.25
    return attn


# name -> fn(analysis module, tmp_path): the inputs of tests/test_analysis.py
CASES = {
    "perplexity": lambda m, t: (
        m.perplexity(np.zeros((2, 4, 10)), np.ones((2, 4), np.int64)),
        m.perplexity(np.random.default_rng(0).normal(size=(3, 5, 7)),
                     np.array([[1, 2, 0, 0, 0], [3, 3, 3, 1, 0],
                               [6, 5, 4, 3, 2]]))),
    "caption_table": lambda m, t: (
        m.caption_table(["a dog runs", "completely wrong words"],
                        [["a dog runs fast"], ["a cat sits"]], keys=[5, 9]),
        m.caption_table(["a cat on a mat", "some words here"],
                        [["A cat on a mat."], []], keys=[1, 2],
                        logits=np.random.default_rng(1).normal(
                            size=(2, 5, 6)),
                        token_ids=np.array([[1, 2, 3, 0, 0],
                                            [4, 5, 0, 0, 0]]))),
    "hit_rate": lambda m, t: [m.hit_rate(
        {1: "a dog in the park", 2: "red car"},
        {1: "the dog runs", 2: "blue bicycle", 3: "unshared"}, n=n)
        for n in (1, 2)],
    "attention_by_region": lambda m, t: m.attention_by_region(
        np.random.default_rng(2).random((2, 3, 4)),
        region_names=list("abcd"), top_k=2),
    "loss_curves": _loss_curves,
    "attention_tsne": lambda m, t: m.attention_tsne(
        np.random.default_rng(0).random((12, 5, 30)).astype(np.float32),
        perplexity=5.0),
    "attention_to_vertices": lambda m, t: m.attention_to_vertices(
        np.array([0.5, 0.9, 0.1]),
        [np.array([0, 2]), np.array([5]), np.array([1, 3, 4])], 8),
    "caption_grid_entries": lambda m, t: _grid_entries(m),
    "attention_over_time": lambda m, t: m.attention_over_time(
        _time_attention(), top_k=2),
    "attention_by_tag": lambda m, t: m.attention_by_tag(
        ["a dog riding", "red dog <end>"], _tag_attention()),
    "pos_tag_word": lambda m, t: [m.pos_tag_word(w) for w in (
        "a", "on", "running", "dog", "is", "red", "3", "<end>")],
    "caption_pos_stats": lambda m, t: m.caption_pos_stats(
        ["a dog riding on the red bus", "<start> two cats <end>", ""]),
    "most_active_vertices": lambda m, t: _most_active(m),
    "betas_semantic_similarity": lambda m, t: _similarity(m),
    "spearman": lambda m, t: [m._spearman(x, y) for x, y in (
        (np.arange(5.0), 2 * np.arange(5.0) + 1), (np.arange(5.0),
                                                    -np.arange(5.0)),
        (np.array([1.0, 1, 2, 2]), np.array([1.0, 1, 2, 2])),
        (np.array([1.0]), np.array([2.0])))],
    "memmap streaming": _memmap,
    "load_behavior_hits and bleu_by_hit_rate": lambda m, t: _hits(m, t),
}


def _hits(m, tmp_path):
    tsv = tmp_path / "responses.tsv"
    tsv.write_text("73KID\tISCORRECT\n1\t1\n1\t0\n1\t1\n2\t\n2\t1\n3\t0\n")
    hits = m.load_behavior_hits(str(tsv))
    caps = {1: "a dog runs <end>", 2: "a red car", 3: "nothing like it"}
    refs = {1: ["A dog runs."], 2: ["a red car, parked"], 3: ["a cat"]}
    return hits, m.bleu_by_hit_rate(caps, refs, hits)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analysis_function_equals_the_original(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    _same(CASES[case](pan, tmp_path / "port"),
          CASES[case](jan, tmp_path / "jax"), case)


def test_analysis_refusals_match_the_original():
    for m in (pan, jan):
        with pytest.raises(AssertionError, match="attention regions"):
            m.attention_to_vertices(np.zeros(2), [np.array([0])] * 3, 8)
        with pytest.raises(ValueError, match="guse rows"):
            m.betas_semantic_similarity(np.zeros((4, 3)), np.zeros((5, 2)))


def _figures():
    rng = np.random.default_rng(0)
    vals = rng.random(40).astype(np.float32)
    vals[3] = np.nan
    region, tsne, steps, word = (rng.random(360), rng.random((10, 2)),
                                 rng.random((3, 8)), rng.random((3, 8)))
    coords = {"lh": rng.random((20, 2)), "rh": rng.random((20, 2))}
    by_tag = jan.attention_by_tag(["a dog riding", "red dog <end>"],
                                  _tag_attention())
    sim = jan.betas_semantic_similarity(rng.random((20, 8)),
                                        rng.random((20, 4)), targets=[0, 3],
                                        n_similar=4, n_random=4)
    return {
        "region.png": lambda m, p: m.plot_region_attention(region, p),
        "region_ids.png": lambda m, p: m.plot_region_attention(
            np.arange(6.0), p, region_ids=np.array([0, 1, 2, 4, 5, 7]),
            n_total=8),
        "tsne.png": lambda m, p: m.plot_tsne(tsne, p,
                                             labels=np.arange(10) % 2),
        "raster.png": lambda m, p: m.plot_vertex_attention(vals, p, n_lh=20),
        "flat.png": lambda m, p: m.plot_vertex_attention(vals, p, n_lh=20,
                                                         coords=coords),
        "grid.png": lambda m, p: m.plot_caption_grid(
            [(np.full((4, 4, 3), 9, np.uint8), "1: a dog", "BLEU-4 1.000"),
             (None, "2: a cat", None)], p),
        "over_time.png": lambda m, p: m.plot_attention_over_time(steps, p),
        "by_tag.png": lambda m, p: m.plot_attention_by_tag(by_tag, p),
        "word_map.png": lambda m, p: m.plot_attention_word_map(
            "a dog runs", word, p),
        "loss.png": lambda m, p: m.plot_loss(p + ".csv", p),
        "hits.png": lambda m, p: m.plot_bleu_hit_rate(
            {"BLEU-1": {0: [0.1, 0.2], 1: []}, "BLEU-4": {0: [0.0], 1: [1.0]},
             "n_scored": 3}, p),
        "similarity.png": lambda m, p: m.plot_betas_similarity(sim, p),
    }


def test_drawing_functions_write_the_originals_files(tmp_path):
    """Same calls, same matplotlib: the same PNG bytes. Each figure's
    random inputs are drawn once and handed to both packages."""
    figures = _figures()
    (tmp_path / "loss.png.csv").write_text(
        "epoch,loss,val_loss\n0,2.0,2.5\n1,1.5,2.0\n")
    for name, draw in figures.items():
        outs = []
        for m, side in ((pan, "port"), (jan, "jax")):
            path = tmp_path / f"{side}_{name}"
            if name == "loss.png":
                shutil.copy(tmp_path / "loss.png.csv", f"{path}.csv")
            draw(m, str(path))
            outs.append(path.read_bytes())
        assert len(outs[0]) > 500, name
        assert outs[0] == outs[1], name


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _both(run, tmp_path, extra=()):
    """analyze through both CLIs on ``run``; the reports with each output
    directory written as <out>, and the files each wrote."""
    out = {}
    for name, main, tail in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        dest = tmp_path / f"out_{name}"
        report = _run(main, ["analyze", "--run", str(run), "--out",
                             str(dest), *extra, *tail])
        text = json.dumps(report).replace(str(dest), "<out>")
        out[name] = (json.loads(text), sorted(os.listdir(dest)))
    return out


def test_analyze_temporal_attention_matches_the_jax_cli(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    attn = np.random.default_rng(0).random((4, 3, 360)).astype(np.float32)
    np.save(run / "attention_scores_2.npy", attn)
    (run / "captions_2.txt").write_text(
        "1\ta dog runs\n2\tthe red cat\n3\ta man walks\n4\tblue boat sails\n")
    out = _both(run, tmp_path, ["--word-map", "1"])
    assert out["port"] == out["jax"]
    report, files = out["port"]
    assert {"attention_over_time_2.png", "attention_by_tag_2.png",
            "attention_word_map_2_1.png", "caption_grid_2.png"} <= set(files)
    assert report["top_region_per_step_2"][0]["region"].startswith(
        ("LH_", "RH_"))


def test_analyze_betas_flags_match_the_jax_cli(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rng = np.random.default_rng(2)
    betas = rng.normal(size=(30, 40)).astype(np.float32)
    np.save(tmp_path / "betas.npy", betas)
    np.save(tmp_path / "betas_b.npy", betas + 0.01)
    np.save(tmp_path / "guse.npy", rng.normal(size=(30, 12)).astype(
        np.float32))
    out = _both(run, tmp_path, [
        "--betas", str(tmp_path / "betas.npy"), "--betas-b",
        str(tmp_path / "betas_b.npy"), "--top-verts", "8", "--guse",
        str(tmp_path / "guse.npy"), "--sim-targets", "0,5"])
    assert out["port"] == out["jax"]
    report, files = out["port"]
    assert {"most_active_vert.txt", "betas_guse_similarity.png",
            "betas_mean.png", "betas_l1norm.png", "betas_tsne.png"} <= set(
        files)
    assert report["most_active_vertices"]["top_n"] == 8
    assert ((tmp_path / "out_port" / "most_active_vert.txt").read_text()
            == (tmp_path / "out_jax" / "most_active_vert.txt").read_text())


def test_analyze_on_a_port_run_matches_the_jax_cli(tmp_path):
    """A port training run's directory (loss history, previews, eval
    captions and attention, its config) with an atlas, flat coordinates
    and a comparison run: the same report and files from both CLIs."""
    cfg = Config.load(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "smoke.yaml"))
    cfg.log = str(tmp_path / "logs")
    run_path, _, bundle = experiment.run_training(cfg, epochs=1,
                                                  smoke_keys=12, device="cpu")
    experiment.run_eval(bundle, run_path)
    layout = bundle["model"].encoder.layout
    n = layout.n_voxels
    labels = np.zeros(n, np.int64)
    for g, idx in enumerate(layout.to_groups()):
        labels[np.asarray(idx)] = g + 1
    half = n // 2
    np.save(tmp_path / "lh.npy", labels[:half])
    np.save(tmp_path / "rh.npy", np.where(labels[half:] > 0,
                                          labels[half:] - labels[half:].min()
                                          + 1, 0))
    other = tmp_path / "other"
    other.mkdir()
    for f in os.listdir(run_path):
        if f.startswith("captions_"):
            shutil.copy(os.path.join(run_path, f), other / f)
    out = _both(run_path, tmp_path, [
        "--compare-run", str(other), "--word-map", "0",
        "--atlas-lh", str(tmp_path / "lh.npy"),
        "--atlas-rh", str(tmp_path / "rh.npy")])
    assert out["port"] == out["jax"]
    report, files = out["port"]
    assert "loss.png" in files and "pos_stats" in report
    assert any(k.startswith("cross_run_hit_rate_") for k in report)
