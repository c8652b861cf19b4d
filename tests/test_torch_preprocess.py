"""The port's preprocessing against the JAX package's, on the CPU.

``fit_pca`` (PyTorch, here on the CPU) against the JAX ``fit_pca``: with
``use_jax=False`` (the same numpy test matrix) components up to sign within
1e-4 and explained variance within 1e-4 relative; with ``use_jax=True``
(another generator) the subspace within principal angles of 1e-3. On a
card-less host the default device refuses (no fallback).

``run_preprocess`` of both packages on one fixture of NSD session files
(one ``.npy`` session and one ``.mgh``, repeats, two hemispheres of labels,
a conditions CSV) with sessions -> vc mask -> normalize -> PCA: the port's
through its CLI. The per-trial files, every pack but the PCA one, the
statistics, the mask, ``transform.json`` and ``tokenizer.json`` are equal;
the PCA model and pack within 1e-4, components up to sign; the reports
equal but for the port's ``seconds``. ``apply_preprocess_chain`` and
``transform`` replay a chain as the JAX ones do, and refuse rows of the
wrong raw width."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.data.preprocess import mgh as jmgh
from masters_thesis_tpu.data.preprocess import pca as jpca
from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.data.pack import open_pack
from masters_thesis_tpu_torch.data.preprocess import pca

from torch_threads import one_thread  # noqa: F401

TOL = 1e-4
V_HALF = 20                  # vertices per hemisphere
TRAIN, SHARED, TEST = list(range(1, 21)), list(range(100, 106)), [100, 101]


def _spectrum_matrix(rng, n, v, rank, noise):
    """Rows of a decaying rank-``rank`` signal plus ``noise``, offset."""
    u = np.linalg.qr(rng.standard_normal((n, rank)))[0]
    w = np.linalg.qr(rng.standard_normal((v, rank)))[0]
    spec = 10.0 * 0.8 ** np.arange(rank)
    x = (u * spec) @ w.T + noise * rng.standard_normal((n, v)) + 3.0
    return x.astype(np.float32)


def _align(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got``'s rows with the signs that bring them nearest ``want``'s."""
    sign = np.sign((got * want).sum(axis=-1, keepdims=True))
    return got * np.where(sign == 0, 1, sign)


def test_fit_pca_follows_the_numpy_recipe():
    x = _spectrum_matrix(np.random.default_rng(0), 90, 140, 30, 1e-3)
    for k, p, n_iter, seed in ((8, 10, 4, 0), (5, 3, 2, 7), (12, 10, 0, 1)):
        want = jpca.fit_pca(x, k, p, n_iter, seed, use_jax=False)
        got = pca.fit_pca(x, k, p, n_iter, seed, device="cpu")
        assert got.components.shape == want.components.shape == (k, 140)
        np.testing.assert_allclose(got.mean, want.mean, atol=TOL)
        np.testing.assert_allclose(_align(got.components, want.components),
                                   want.components, atol=TOL)
        np.testing.assert_allclose(got.explained_variance,
                                   want.explained_variance, rtol=TOL)
    # numpy rows are left as they were; a float32 tensor on the device is
    # centred in place, with the same fit
    got = pca.fit_pca(x, 8, device="cpu")
    t = torch.from_numpy(x.copy())
    again = pca.fit_pca(t, 8, device="cpu")
    np.testing.assert_allclose(t.numpy(), x - x.mean(axis=0), atol=1e-5)
    np.testing.assert_array_equal(got.components, again.components)
    np.testing.assert_array_equal(got.mean, again.mean)
    twice = torch.from_numpy(x.astype(np.float64))
    pca.fit_pca(twice, 8, device="cpu")
    np.testing.assert_array_equal(twice.numpy(), x.astype(np.float64))


def test_fit_pca_spans_the_jax_fit_subspace():
    """Against the JAX accelerator fit (its own generator's test matrix) on
    a low-rank-plus-noise matrix: the principal angles between the two
    k-dimensional subspaces, and the explained variances."""
    x = _spectrum_matrix(np.random.default_rng(1), 120, 200, 10, 1e-3)
    want = jpca.fit_pca(x, 10, use_jax=True)
    got = pca.fit_pca(x, 10, device="cpu")
    cos = np.linalg.svd(got.components.astype(np.float64)
                        @ want.components.T, compute_uv=False)
    assert np.arccos(np.clip(cos, -1, 1)).max() <= 1e-3
    np.testing.assert_allclose(got.explained_variance,
                               want.explained_variance, rtol=1e-3)


def test_fit_pca_has_no_fallback_off_its_device():
    """The default device is the card; without one the fit raises instead
    of running somewhere else."""
    x = np.zeros((4, 3), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pca.fit_pca(x, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pca.projector(pca.PCAModel(x[0], x[:2], x[0, :2]))


def test_projector_is_the_numpy_transform():
    rng = np.random.default_rng(2)
    model = pca.fit_pca(_spectrum_matrix(rng, 40, 50, 8, 1e-2), 6,
                        device="cpu")
    rows = rng.standard_normal((7, 50)).astype(np.float32)
    want = model.transform(rows)
    got = pca.projector(model, "cpu")(rows)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


# ---- run_preprocess: port against JAX ----

def _write_sessions(root: Path):
    """Two sessions of 30 trials over 2 x 20 vertices (session 1 as .npy,
    session 2 as .mgh), every key at least once and some twice; a behavior
    CSV, a captions JSON, and nsd_dir with the split CSVs and the atlas."""
    rng = np.random.default_rng(5)
    sessions, nsd = root / "sessions", root / "nsd"
    sessions.mkdir()
    nsd.mkdir()
    keys = TRAIN + SHARED
    schedule = np.concatenate([keys, rng.choice(keys, 60 - len(keys))])
    rng.shuffle(schedule)
    lines = ["SUBJECT,SESSION,RUN,TRIAL,73KID"]
    for s in (1, 2):
        for hemi in ("lh", "rh"):
            arr = rng.standard_normal((V_HALF, 30)) * (1 + s)
            path = sessions / f"{hemi}.betas_session{s:02d}"
            if s == 1:
                np.save(f"{path}.npy", arr)
            else:
                jmgh.write_mgh(f"{path}.mgh", arr.astype(np.float32))
        for t in range(30):
            lines.append(f"1,{s},{1 + t // 15},{1 + t % 15},"
                         f"{schedule[(s - 1) * 30 + t]}")
    (root / "behavior.csv").write_text("\n".join(lines) + "\n")
    words = "a the dog cat runs sits park red blue big small".split()
    caps = {str(k): [" ".join(rng.choice(words, 5)) + "." for _ in range(3)]
            for k in keys}
    (root / "captions.json").write_text(json.dumps(caps))
    (nsd / "subj01_conditions.csv").write_text(
        "nsd_key,is_shared\n" + "".join(f"{k},0\n" for k in TRAIN)
        + "".join(f"{k},1\n" for k in SHARED))
    (nsd / "test_conditions.csv").write_text(
        "nsd_key\n" + "".join(f"{k}\n" for k in TEST))
    np.save(nsd / "glasser_lh.npy", rng.integers(0, 4, V_HALF))
    np.save(nsd / "glasser_rh.npy", rng.integers(0, 4, V_HALF))
    return sessions, nsd


@pytest.fixture(scope="module")
def pre(tmp_path_factory):
    """The fixture through both packages' ``run_preprocess`` (the port's
    through its CLI, on the CPU): sessions -> pack -> stats -> vc mask
    (parcels 1, 2) -> normalize -> PCA 6. Returns the root, the JAX report
    and the port's printed report."""
    root = tmp_path_factory.mktemp("pre")
    sessions, nsd = _write_sessions(root)
    jcfg = JConfig(top_k=20)
    jcfg.dataset.nsd_dir = str(nsd)
    jcfg.save(root / "c.yaml")
    kw = dict(pca_components=6, from_sessions=str(sessions),
              behavior=str(root / "behavior.csv"),
              captions_json=str(root / "captions.json"), n_sessions=3,
              vc_parcels="1,2", normalize=True)
    jreport = jexp.run_preprocess(jcfg, str(root / "jax"), **kw)
    argv = ["preprocess", "--config", str(root / "c.yaml"), "--out",
            str(root / "port"), "--pca", "6", "--from-sessions",
            str(sessions), "--behavior", str(root / "behavior.csv"),
            "--captions-json", str(root / "captions.json"), "--n-sessions",
            "3", "--vc-parcels", "1,2", "--normalize", "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return root, jreport, json.loads(out.getvalue().strip().splitlines()[-1])


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_run_preprocess_writes_the_jax_files(pre):
    root, jreport, report = pre
    report = dict(report)
    seconds = report.pop("seconds")
    assert set(seconds) == {"ingest", "pack", "stats", "vc", "normalize",
                            "pca_fit", "pca_transform", "tokenizer"}
    assert json.loads(json.dumps(report).replace(str(root / "port"), "@")) \
        == json.loads(json.dumps(jreport).replace(str(root / "jax"), "@"))
    assert report["pca"]["fit_on"] == "train_split:20"
    assert report["transform"]["stages"] == ["vc_mask", "normalize", "pca"]
    port, jax_files = _files(root / "port"), _files(root / "jax")
    assert set(port) == set(jax_files)
    for rel, path in port.items():
        want = jax_files[rel]
        if rel.startswith("betas_pack_pca/") and rel.endswith("data.bin"):
            continue                         # below, up to sign
        if rel.endswith(".npz"):
            got, ref = np.load(path), np.load(want)
            assert set(got.files) == set(ref.files), rel
            if rel == "pca_model.npz":
                np.testing.assert_allclose(got["mean"], ref["mean"],
                                           atol=TOL)
                np.testing.assert_allclose(
                    _align(got["components"], ref["components"]),
                    ref["components"], atol=TOL)
                np.testing.assert_allclose(got["explained_variance"],
                                           ref["explained_variance"],
                                           rtol=TOL)
            else:
                for name in got.files:
                    np.testing.assert_array_equal(got[name], ref[name])
        elif rel.endswith(".txt"):           # caption files name their beta
            assert (path.read_text().replace(str(root / "port"), "@")
                    == want.read_text().replace(str(root / "jax"), "@")), rel
        else:
            assert path.read_bytes() == want.read_bytes(), rel
    got = open_pack(str(root / "port" / "betas_pack_pca"))
    ref = open_pack(str(root / "jax" / "betas_pack_pca"))
    np.testing.assert_array_equal(got.keys, ref.keys)
    comps = np.load(root / "port" / "pca_model.npz")["components"]
    jcomps = np.load(root / "jax" / "pca_model.npz")["components"]
    sign = np.sign((comps * jcomps).sum(axis=1))
    scale = np.abs(ref.data).max()
    np.testing.assert_allclose(got.data * sign, ref.data, atol=TOL * scale)
    # the device projection is the numpy transform of the chain's replay
    raw = open_pack(str(root / "port" / "betas_pack"))
    replay = experiment.apply_preprocess_chain(str(root / "port"),
                                               np.asarray(raw.data))
    np.testing.assert_allclose(replay, got.data, rtol=TOL,
                               atol=TOL * scale)


def test_apply_preprocess_chain_and_transform_replay_as_jax(pre, tmp_path,
                                                            capsys):
    root, _, _ = pre
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((5, 2 * V_HALF)).astype(np.float32)
    jdir = str(root / "jax")
    want = jexp.apply_preprocess_chain(jdir, rows)
    np.testing.assert_array_equal(
        experiment.apply_preprocess_chain(jdir, rows), want)
    np.save(tmp_path / "x.npy", rows)
    assert cli.main(["transform", "--pre", jdir, "--betas",
                     str(tmp_path / "x.npy"), "--out",
                     str(tmp_path / "y.npy")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"out": str(tmp_path / "y.npy"), "shape": [5, 6]}
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)
    for module in (experiment, jexp):
        with pytest.raises(ValueError, match="recorded on rows"):
            module.apply_preprocess_chain(
                jdir, np.zeros((2, 2 * V_HALF + 1), np.float32))


@pytest.mark.parametrize("spec,want", [
    ("1,2,3", [1, 2, 3]), (",0\n0,1\n1,2\n", [1, 2]), ("parcel\n4\n5\n", [4, 5]),
    ("1,2,3\n", [1, 2, 3]), ("idx,parcel\n0,7\n1,8\n2,9\n", [7, 8, 9]),
    ("region,parcel\n1,7\n2,8\n3,9\n", [7, 8, 9]),
    ("1,2,3,\n4,5,6,\n", [1, 2, 3, 4, 5, 6]), ("a,b\n7,8\n9,10\n",
                                                [7, 8, 9, 10]),
    ("parcel\nV1\n", ValueError), ("\n\n", ValueError)])
def test_parse_visual_parcels_as_jax(spec, want, tmp_path):
    if "\n" in spec:
        path = tmp_path / "vm.csv"
        path.write_text(spec)
        spec = str(path)
    if want is ValueError:
        for module in (experiment, jexp):
            with pytest.raises(ValueError):
                module._parse_visual_parcels(spec)
    else:
        assert (experiment._parse_visual_parcels(spec)
                == jexp._parse_visual_parcels(spec) == want)


def test_train_split_indices_and_corpus_stats_as_jax(pre):
    root, _, _ = pre
    nsd = root / "nsd"
    view = open_pack(str(root / "port" / "betas_pack"))
    (nsd / "subj00_conditions.csv").write_text(
        "nsd_key,is_shared\n" + "".join(f"{k},0\n" for k in range(500, 530)))
    try:
        from masters_thesis_tpu.data.pack import open_pack as jopen

        got = experiment._train_split_indices(view, str(nsd))
        want = jexp._train_split_indices(jopen(str(root / "port" /
                                                   "betas_pack")), str(nsd))
    finally:
        (nsd / "subj00_conditions.csv").unlink()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == "train_split:20"
    assert experiment._train_split_indices(view, None) == (None, "all_rows")
    texts = ["a dog runs", "the cat", "a big red dog sits here", ""]
    assert experiment.corpus_stats(texts) == jexp.corpus_stats(texts)
