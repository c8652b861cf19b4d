"""The port's USE-DAN sentence encoder and what stands on it, against the
JAX package on the same inputs: the FarmHash copy (goldens of
``tf.strings.to_hash_bucket_fast`` and the original on random unicode
words), ``USEDan`` on JAX-initialised parameters brought across (2e-6
max-abs), weight bundles written by either package and loaded by the
other (goldens verified, corruption refused), the chunked ``embed``,
``default_embedder``'s resolution, ``run_metrics``' honest GUSE labels,
``run_guse_precompute`` file by file (the hash embedder exactly, the
encoder within 2e-6) and its output training ``guse_nic``, and the
``guse`` and ``score`` commands' JSON against the JAX CLI's. Small widths:
a 300-word vocabulary, 16 OOV buckets, embed 32, hidden (32, 32), out 32;
everything on the CPU. The JAX graph has no Pallas kernel (``jnp.take``
and flax ``Dense``), so the port's eager PyTorch is compared with it
directly."""

import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from masters_thesis_tpu.models import use_encoder as juse
from masters_thesis_tpu.utils import farmhash as jfarmhash
from masters_thesis_tpu_torch.models import use_encoder as tuse
from masters_thesis_tpu_torch.utils import farmhash as tfarmhash

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
WIDTHS = dict(embed_dim=32, hidden=(32, 32), out_dim=32)
OOV = 16
ATOL = 2e-6     # fp32 summation order of the pooled sum and the GEMMs


def _vocab(n=300):
    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = {"a", "the", "dog", "cat", "runs", "sits", "park", "man"}
    while len(words) < n:
        words.add("".join(rng.choice(letters, int(rng.integers(2, 9)))))
    return sorted(words)


VOCAB = _vocab()


def _sentences(seed=0, n=40):
    """Seeded sentences over the vocabulary and OOV words, with an empty
    one, one of 80 words (past the 64-token width), one that is only the
    word of row 0, and one of only OOV words."""
    rng = np.random.default_rng(seed)
    oov = ["zebra", "flies", "café", "über", "naïve", "x" * 40, "ünïcödé"]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 14))
        words = [VOCAB[int(i)] if rng.random() < 0.85
                 else oov[int(rng.integers(len(oov)))]
                 for i in rng.integers(0, len(VOCAB), k)]
        out.append(" ".join(words).capitalize() + ".")
    out += ["", "  .  ,", " ".join(VOCAB[int(i)]
                                   for i in rng.integers(0, 300, 80)),
            VOCAB[0], "Zebra, flies. CAFÉ"]
    return out


@pytest.fixture(scope="module")
def jax_params():
    return juse.init_use_params(len(VOCAB), oov_buckets=OOV, seed=0,
                                **WIDTHS)


def _pair(params):
    enc_j = juse.USEEncoder(VOCAB, params, OOV, WIDTHS["hidden"],
                            WIDTHS["embed_dim"], WIDTHS["out_dim"])
    enc_t = tuse.USEEncoder(VOCAB, params, OOV, WIDTHS["hidden"],
                            WIDTHS["embed_dim"], WIDTHS["out_dim"],
                            device="cpu")
    return enc_j, enc_t


# ---------------------------------------------------------------- farmhash

def test_farmhash_copy_matches_tf_goldens_and_the_original():
    with open(TESTS / "data" / "farmhash_goldens.json") as f:
        cases = json.load(f)
    assert len(cases) >= 30
    for c in cases:
        for buckets, key in ((2 ** 30, "mod_2_30"), (997, "mod_997")):
            assert tfarmhash.hash_bucket_fast(c["s"], buckets) == c[key]
            assert (tfarmhash.hash_bucket_fast(c["s"], buckets)
                    == jfarmhash.hash_bucket_fast(c["s"], buckets))


@pytest.mark.parametrize("lengths", [(0, 17), (17, 33), (33, 65), (65, 400)])
def test_farmhash_copy_matches_the_original_on_random_unicode(lengths):
    """Every length regime of Fingerprint64 (0-16, 17-32, 33-64 and the
    64-byte block loop), on words drawn from ASCII, Latin-1, CJK and
    astral code points, as str and as bytes."""
    rng = np.random.default_rng(lengths[0])
    ranges = [(0x20, 0x7F), (0xA0, 0x250), (0x4E00, 0x9FFF),
              (0x1F300, 0x1F64F)]
    for _ in range(200):
        n = int(rng.integers(*lengths))
        lo, hi = ranges[int(rng.integers(len(ranges)))]
        word = "".join(chr(int(c)) for c in rng.integers(lo, hi, n))
        data = word.encode("utf-8")[: int(rng.integers(*lengths))]
        for s in (word, data):
            got = tfarmhash.fingerprint64(s)
            assert got == jfarmhash.fingerprint64(s)
            assert 0 <= got < 2 ** 64
            assert (tfarmhash.hash_bucket_fast(s, OOV)
                    == jfarmhash.hash_bucket_fast(s, OOV))


# ---------------------------------------------------------------- the DAN

def test_clean_sentence_and_token_ids_match_the_original(jax_params):
    enc_j, enc_t = _pair(jax_params)
    for s in _sentences(1):
        assert tuse.clean_sentence(s) == juse.clean_sentence(s)
        assert enc_t.token_ids(s) == enc_j.token_ids(s)
    for w in ("zebra", "ünïcödé", "x" * 70):
        assert tuse._oov_bucket(w, OOV) == juse._oov_bucket(w, OOV)
    ids, lengths = enc_t.tokenize(_sentences(1))
    assert ids.shape == (len(lengths), 64) and lengths.max() == 64
    assert (ids[lengths == 0] == 0).all()


def test_use_dan_matches_flax_on_jax_parameters(jax_params):
    """The module on raw ids (token id 0 inside a row and as padding, rows
    of length 0 and of the full width) and the encoder on sentences (empty,
    80 words, OOV, row 0's word), within 2e-6 of the JAX graph."""
    import jax.numpy as jnp
    import torch

    from masters_thesis_tpu_torch.transplant import from_flax

    rows = len(VOCAB) + OOV
    rng = np.random.default_rng(2)
    ids = rng.integers(0, rows, (16, 64)).astype(np.int32)
    ids[:, 3] = 0
    lengths = rng.integers(0, 65, 16).astype(np.int32)
    lengths[:3] = (0, 64, 1)
    model_j = juse.USEDan(vocab_rows=rows, **WIDTHS)
    want = np.asarray(model_j.apply({"params": jax_params}, jnp.asarray(ids),
                                    jnp.asarray(lengths)))
    model_t = tuse.USEDan(rows, **WIDTHS)
    model_t.load_state_dict(from_flax({"params": jax_params}))
    with torch.no_grad():
        got = model_t(torch.from_numpy(ids), torch.from_numpy(lengths))
    assert np.abs(got.numpy() - want).max() <= ATOL

    enc_j, enc_t = _pair(jax_params)
    sentences = _sentences(3)
    want = enc_j.embed(sentences)
    got = enc_t.embed(sentences)
    assert got.shape == want.shape == (len(sentences), WIDTHS["out_dim"])
    assert np.abs(got - want).max() <= ATOL
    # unit norm but where the DAN's zero biases leave an empty sentence 0
    np.testing.assert_allclose(np.linalg.norm(got[:40], axis=1), 1.0,
                               rtol=1e-5)
    assert enc_t.seconds["tokenize"] > 0 and enc_t.seconds["device"] > 0


def test_parameters_are_named_after_the_flax_tree():
    params = tuse.init_use_params(len(VOCAB), oov_buckets=OOV, seed=3,
                                  **WIDTHS)
    jparams = juse.init_use_params(len(VOCAB), oov_buckets=OOV, seed=3,
                                   **WIDTHS)

    def shapes(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from shapes(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(np.shape(v))

    assert dict(shapes(params)) == dict(shapes(jparams))
    again = tuse.init_use_params(len(VOCAB), oov_buckets=OOV, seed=3,
                                 **WIDTHS)
    np.testing.assert_array_equal(params["embedding"], again["embedding"])
    std = params["embedding"].std()
    assert abs(std * np.sqrt(WIDTHS["embed_dim"]) - 1.0) < 0.05


@pytest.mark.parametrize("chunk", [1, 7, None])
def test_chunked_embed_gives_each_row_the_same_vector(jax_params, chunk):
    """Rows are independent: any chunk size (1, 7, all at once, and the
    default 4,096) gives every sentence the vector of the one-call
    embed."""
    _, enc_t = _pair(jax_params)
    sentences = _sentences(4)
    whole = enc_t.embed(sentences, chunk=len(sentences))
    got = enc_t.embed(sentences, chunk=chunk or len(sentences))
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)
    np.testing.assert_allclose(enc_t.embed(sentences), whole, rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- bundles

def _golden_sentences():
    return ["a dog runs in the park", "zebra flies over unicode café",
            "", VOCAB[0], " ".join(VOCAB[:70])]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bundles_load_across_packages_with_their_goldens(tmp_path, writer,
                                                         jax_params):
    """A bundle written by either package, with goldens from its own
    encoder, loads and verifies in the other; the vectors agree."""
    sentences = _golden_sentences()
    enc_j, enc_t = _pair(jax_params)
    path = str(tmp_path / "use_dan.npz")
    if writer == "jax":
        juse.save_use_bundle(path, VOCAB, jax_params, OOV,
                             goldens=(sentences, enc_j.embed(sentences)))
        loaded = tuse.USEEncoder.from_npz(path, device="cpu")
        other = enc_j
    else:
        tuse.save_use_bundle(path, VOCAB, jax_params, OOV,
                             goldens=(sentences, enc_t.embed(sentences)))
        loaded = juse.USEEncoder.from_npz(path)
        other = enc_t
    probes = _sentences(5)
    assert np.abs(loaded.embed(probes) - other.embed(probes)).max() <= ATOL
    blob = np.load(path)
    assert blob["__vocab__"].dtype == np.asarray(VOCAB).dtype
    assert sorted(blob.files) == sorted(
        ["__vocab__", "__oov_buckets__", "__golden_sentences__",
         "__golden_vectors__", "embedding", "dan_layer_0/kernel",
         "dan_layer_0/bias", "dan_layer_1/kernel", "dan_layer_1/bias",
         "dan_out/kernel", "dan_out/bias"])


def test_corrupted_bundle_is_refused(tmp_path, jax_params):
    """Two swapped embedding rows that the goldens use fail
    self-verification with the JAX message; verify=False still loads."""
    sentences = _golden_sentences()
    _, enc_t = _pair(jax_params)
    vectors = enc_t.embed(sentences)
    params = {k: (dict(v) if isinstance(v, dict) else v.copy())
              for k, v in jax_params.items()}
    a, b = VOCAB.index("dog"), VOCAB.index("park")
    params["embedding"][[a, b]] = params["embedding"][[b, a]]
    path = str(tmp_path / "bad.npz")
    tuse.save_use_bundle(path, VOCAB, params, OOV,
                         goldens=(sentences, vectors))
    with pytest.raises(ValueError, match="self-verification.*"
                       "convert_tfhub_use"):
        tuse.USEEncoder.from_npz(path, device="cpu")
    with pytest.raises(ValueError, match="self-verification"):
        juse.USEEncoder.from_npz(path)
    enc = tuse.USEEncoder.from_npz(path, device="cpu", verify=False)
    assert enc.embed(["a dog"]).shape == (1, WIDTHS["out_dim"])


def test_saved_bundle_keeps_long_tokens(tmp_path):
    long_tok = "a" * 80
    vocab = ["<pad>", "dog", long_tok]
    params = tuse.init_use_params(3, oov_buckets=8, embed_dim=16,
                                  hidden=(8,), out_dim=4, seed=0)
    path = str(tmp_path / "use.npz")
    tuse.save_use_bundle(path, vocab, params, oov_buckets=8)
    enc = tuse.USEEncoder.from_npz(path, device="cpu")
    assert enc.token_ids(long_tok) == [2]
    assert juse.USEEncoder.from_npz(path).token_ids(long_tok) == [2]


@pytest.fixture
def bundle_path(tmp_path, jax_params):
    path = str(tmp_path / "bundle" / "use_dan.npz")
    os.makedirs(os.path.dirname(path))
    juse.save_use_bundle(path, VOCAB, jax_params, OOV)
    return path


def test_default_embedder_resolution(bundle_path, monkeypatch):
    from masters_thesis_tpu_torch.evalsuite.guse_sim import (
        HashEmbedder,
        default_embedder,
    )

    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    assert isinstance(default_embedder(), HashEmbedder)
    assert isinstance(default_embedder(bundle_path, "cpu"), tuse.USEEncoder)
    monkeypatch.setenv("MTT_GUSE_WEIGHTS", bundle_path)
    enc = default_embedder(device="cpu")
    assert isinstance(enc, tuse.USEEncoder) and enc.device.type == "cpu"
    # a missing path falls back to the hash embedder, as the original does
    monkeypatch.setenv("MTT_GUSE_WEIGHTS", bundle_path + ".missing")
    assert isinstance(default_embedder(device="cpu"), HashEmbedder)
    if not __import__("torch").cuda.is_available():
        # the card is the default: without one, a bundle raises
        monkeypatch.setenv("MTT_GUSE_WEIGHTS", bundle_path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_embedder()


def test_run_metrics_labels_guse_honestly(bundle_path, monkeypatch,
                                          tmp_path):
    """GUSE_* keys only with the real encoder, GUSE_hash_* otherwise; the
    scores equal the JAX run_metrics' (text metrics exactly)."""
    from masters_thesis_tpu.config import Config as JConfig
    from masters_thesis_tpu.experiment import run_metrics as jrun_metrics
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.experiment import run_metrics

    pairs = {"test": [
        (1, "<start> a dog runs <end>", 0, 0, 0),
        (1, "<start> the dog runs <end>", 1, 0, 0),
        (2, "<start> a cat sits <end>", 0, 0, 0),
        (2, "<start> the cat sits <end>", 1, 0, 0),
        (3, "<start> the man sits in the park <end>", 0, 0, 0),
        (3, "<start> a man in a park <end>", 1, 0, 0),
    ]}
    eval_out = {"texts": ["a dog runs", "a cat sits", "a man sits"],
                "keys": np.asarray([1, 2, 3])}

    def both():
        got = run_metrics({"cfg": Config(), "pairs": pairs}, eval_out,
                          device="cpu")
        want = jrun_metrics({"cfg": JConfig(), "pairs": pairs}, eval_out)
        assert got.keys() == want.keys()
        for k in got:
            if k.startswith("GUSE"):
                assert got[k] == pytest.approx(want[k], abs=1e-5), k
            else:
                assert got[k] == want[k], k
        return got

    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    scores = both()
    assert "GUSE_hash_pearson_r" in scores and "GUSE_pearson_r" not in scores
    monkeypatch.setenv("MTT_GUSE_WEIGHTS", bundle_path)
    scores = both()
    assert "GUSE_pearson_r" in scores and "GUSE_hash_pearson_r" not in scores

    # the config's guse dir (use_dan.npz inside it)
    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    gdir = tmp_path / "guse"
    gdir.mkdir()
    shutil.copy(bundle_path, gdir / "use_dan.npz")
    cfg = Config()
    cfg.dataset.guse_path = str(gdir)
    scores = run_metrics({"cfg": cfg, "pairs": pairs}, eval_out,
                         device="cpu")
    assert "GUSE_pearson_r" in scores


# ---------------------------------------------------------------- precompute

def _captions(root: Path, keys, n_caps=5) -> str:
    rng = np.random.default_rng(7)
    cap_dir = root / "captions"
    cap_dir.mkdir()
    for k in keys:
        lines = [" ".join(VOCAB[int(i)] for i in rng.integers(0, 300, 6))
                 + (" zebra." if i % 2 else ".") for i in range(n_caps)]
        (cap_dir / f"KID{k}.txt").write_text("\n".join(lines) + "\n")
    return str(cap_dir)


@pytest.mark.parametrize("embedder", ["hash", "use_dan"])
def test_run_guse_precompute_matches_the_original(tmp_path, embedder,
                                                  bundle_path, monkeypatch):
    """The same files as the JAX precompute: keys and meta.json equal, the
    brick and the per-key vectors exactly with the hash embedder and within
    2e-6 with the encoder."""
    from masters_thesis_tpu.config import Config as JConfig
    from masters_thesis_tpu.experiment import (
        run_guse_precompute as jrun_guse_precompute,
    )
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.experiment import run_guse_precompute

    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    cap_dir = _captions(tmp_path, [3, 11, 5, 40])
    reports = {}
    for name, make, run, kw in (
            ("jax", JConfig, jrun_guse_precompute, {}),
            ("port", Config, run_guse_precompute, {"device": "cpu"})):
        cfg = make(run="g", log=str(tmp_path / "log"))
        cfg.dataset.captions_path = cap_dir
        if embedder == "use_dan":
            cfg.dataset.guse_path = os.path.dirname(bundle_path)
        reports[name] = run(cfg, str(tmp_path / name), **kw)
    assert ({**reports["port"], "out": None}
            == {**reports["jax"], "out": None})
    assert reports["port"]["embedder"] == embedder
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for name in ("meta.json",):
        assert (tdir / name).read_text() == (jdir / name).read_text()
    np.testing.assert_array_equal(np.load(tdir / "keys.npy"),
                                  np.load(jdir / "keys.npy"))
    assert np.load(tdir / "keys.npy").tolist() == [3, 5, 11, 40]
    atol = 0.0 if embedder == "hash" else ATOL
    table = np.load(tdir / "guse_pre_processed.npy")
    assert table.shape == (4, 5, 512 if embedder == "hash"
                           else WIDTHS["out_dim"])
    np.testing.assert_allclose(table, np.load(jdir / "guse_pre_processed.npy"),
                               rtol=0, atol=atol)
    files = sorted(os.listdir(tdir / "guse_averaged"))
    assert files == sorted(os.listdir(jdir / "guse_averaged"))
    for f in files:
        np.testing.assert_allclose(np.load(tdir / "guse_averaged" / f),
                                   np.load(jdir / "guse_averaged" / f),
                                   rtol=0, atol=atol)


def test_run_guse_precompute_missing_captions_raises(tmp_path):
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.experiment import run_guse_precompute

    cfg = Config(run="t", log=str(tmp_path / "log"))
    cfg.dataset.captions_path = str(tmp_path / "nope")
    os.makedirs(cfg.dataset.captions_path)
    with pytest.raises(FileNotFoundError):
        run_guse_precompute(cfg, str(tmp_path / "out"), device="cpu")


def test_guse_precompute_output_trains_guse_nic(tmp_path, monkeypatch):
    """guse's guse_averaged/ per-key vectors are the betas_path a guse_nic
    config trains on in the port (get_guse.py output feeding guse_NIC.py)."""
    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.experiment import (
        run_guse_precompute,
        run_training,
    )

    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    unique, shared = list(range(1, 9)), [100, 101, 102]
    cap_dir = _captions(tmp_path, unique + shared)
    nsd = tmp_path / "nsd"
    nsd.mkdir()
    lines = (["nsd_key,is_shared"] + [f"{k},0" for k in unique]
             + [f"{k},1" for k in shared])
    (nsd / "subj02_conditions.csv").write_text("\n".join(lines))
    (nsd / "test_conditions.csv").write_text("nsd_key\n100\n")
    np.save(nsd / "glasser_lh.npy", np.zeros(4, np.int64))
    np.save(nsd / "glasser_rh.npy", np.zeros(4, np.int64))
    cfg = Config(run="guse_chain", model="guse_nic", epochs=1, batch_size=4,
                 max_length=6, top_k=40, units=16, embedding_features=16,
                 log=str(tmp_path / "logs"))
    cfg.dataset.captions_path = cap_dir
    cfg.dataset.nsd_dir = str(nsd)
    out = str(tmp_path / "guse")
    run_guse_precompute(cfg, out, device="cpu")
    cfg.dataset.betas_path = os.path.join(out, "guse_averaged")
    run_path, logs, bundle = run_training(cfg, epochs=1, device="cpu")
    assert bundle["store"].row_shape == (512,)
    assert np.isfinite(logs["loss"])


# ---------------------------------------------------------------- the CLI

def _cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("embedder", ["hash", "use_dan"])
def test_guse_command_prints_the_jax_json(tmp_path, embedder, bundle_path,
                                          monkeypatch):
    from masters_thesis_tpu.cli import main as jmain
    from masters_thesis_tpu.config import Config as JConfig
    from masters_thesis_tpu_torch.cli import main

    monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
    cfg = JConfig(run="g", log=str(tmp_path / "log"))
    cfg.dataset.captions_path = _captions(tmp_path, [2, 4, 6])
    if embedder == "use_dan":
        cfg.dataset.guse_path = os.path.dirname(bundle_path)
    cfg.save(tmp_path / "c.yaml")
    base = ["guse", "--config", str(tmp_path / "c.yaml"), "--out"]
    want = _cli(jmain, base + [str(tmp_path / "j"), "--no-per-key"])
    got = _cli(main, base + [str(tmp_path / "t"), "--no-per-key",
                             "--device", "cpu"])
    assert {**got, "out": None} == {**want, "out": None}
    assert got["per_key_files"] == 0 and got["embedder"] == embedder
    assert not (tmp_path / "t" / "guse_averaged").exists()


def test_score_command_prints_the_jax_json(tmp_path, bundle_path,
                                           monkeypatch):
    """captions_{e}.txt, an output_captions_{e}.npy with its tokenizer and
    keys, a KID*.txt directory and a JSON dict of references, with and
    without a bundle: BLEU, METEOR, ROUGE, CIDEr and the BLEU table equal
    the JAX CLI's exactly, GUSE within 1e-5, under the same labels."""
    from masters_thesis_tpu.cli import main as jmain
    from masters_thesis_tpu_torch.cli import main
    from masters_thesis_tpu_torch.data.tokenizer import Tokenizer

    refs = tmp_path / "captions"
    refs.mkdir()
    (refs / "KID7.txt").write_text("A dog runs fast.\nA dog running.\n")
    (refs / "KID9.txt").write_text("A red boat.\nThe boat sails.\n")
    (refs / "KID12.txt").write_text("The man sits in the park.\n"
                                    "A man on a bench.\n")
    caps = tmp_path / "captions_3.txt"
    caps.write_text("7\ta dog runs fast\n9\ta boat\n11\tno refs here\n"
                    "12\ta man sits\n")
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"7": ["a dog runs"], "9": ["a red boat"],
                               "12": ["a man in the park"]}))
    tok = Tokenizer()
    tok.fit_on_texts(["a dog runs fast", "a red boat", "a man sits"])
    tok.install_pad()
    ids = np.zeros((3, 8, 1), np.int32)
    for r, seq in enumerate(tok.texts_to_sequences(
            ["a dog runs fast", "a red boat", "a man sits"])):
        ids[r, :len(seq), 0] = seq
    np.save(tmp_path / "output_captions_3.npy", ids)
    (tmp_path / "tokenizer.json").write_text(tok.to_json())
    (tmp_path / "keys.txt").write_text("7\n9\n12\n")
    runs = (["--captions", str(caps), "--references", str(refs),
             "--bleu-table"],
            ["--captions", str(tmp_path / "output_captions_3.npy"),
             "--tokenizer", str(tmp_path / "tokenizer.json"), "--keys",
             str(tmp_path / "keys.txt"), "--references", str(ann)])
    for weights, prefix in ((None, "GUSE_hash_"), (bundle_path, "GUSE_")):
        if weights:
            monkeypatch.setenv("MTT_GUSE_WEIGHTS", weights)
        else:
            monkeypatch.delenv("MTT_GUSE_WEIGHTS", raising=False)
        for argv in runs:
            want = _cli(jmain, ["score", *argv])
            got = _cli(main, ["score", *argv, "--device", "cpu"])
            assert got.keys() == want.keys()
            assert got["scores"].keys() == want["scores"].keys()
            for k, v in want["scores"].items():
                if k.startswith("GUSE"):
                    assert k.startswith(prefix)
                    assert got["scores"][k] == pytest.approx(v, abs=1e-5)
                else:
                    assert got["scores"][k] == v, k
            assert ({k: v for k, v in got.items() if k != "scores"}
                    == {k: v for k, v in want.items() if k != "scores"})
            assert f"{prefix}pearson_r" in got["scores"]
