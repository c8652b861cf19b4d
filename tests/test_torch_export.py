"""The port's ``export`` (``torch.export``) against the JAX package's
(``jax.export``), on the CPU, mirroring ``tests/test_export.py`` case by
case.

A tiny JAX lc_nic run (``tests/conftest.py::shared_run``'s widths) is
exported by the JAX package; its weights, transplanted with
``transplant.from_flax`` into a port run directory (the JAX run's
``config.yaml``, ``tokenizer.json``, ``run_meta.json`` and ``layout.npz``
beside a port checkpoint), are exported by the port. The port's artifact
gives the JAX artifact's words on the same rows, a row apart only at a
near-tie of the port's decode (top-2 logit margin < 1e-3), and the port's
live unfused decoders' words bit for bit. Then the JAX cases on the port:
beam, chunking, the width, decoder, version, subject and platform
refusals, HTTP serving through ``serve --export``, ms2_nic, ShowTell, the
padding contract, and ``--pre``, which bakes the preprocess chain in so
that the artifact takes raw rows."""

import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu import experiment as jexp
from masters_thesis_tpu import export as jexport
from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu.serve import Captioner as JCaptioner
from masters_thesis_tpu_torch import cli, experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.export import (
    ARTIFACT_VERSION,
    ExportedCaptioner,
    export_run,
    load_exported,
)
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.server import serve_forever
from masters_thesis_tpu_torch.train.checkpoint import CheckpointManager
from masters_thesis_tpu_torch.train.state import new_state
from masters_thesis_tpu_torch.transplant import from_flax

WIDTHS = dict(model="lc_nic", epochs=1, batch_size=4, max_length=6,
              top_k=40, units=16, attn_units=8, group_size=4,
              embedding_text=8)
TIE_MARGIN = 1e-3
ROWS = 9


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, its greedy artifact and words; the port run directory
    holding the JAX run's weights; rows of the run's width."""
    tmp = tmp_path_factory.mktemp("export")
    jcfg = JConfig(run="jax", log=str(tmp / "logs"), **WIDTHS)
    jrun, _, _ = jexp.run_training(jcfg, epochs=1, smoke_keys=12)
    jcap = JCaptioner.from_run_dir(jrun, batch_size=4, use_fused=False)
    jexport.export_run(jrun, str(tmp / "jax.mttx"), decoder="greedy",
                       batch_size=4)

    port = tmp / "port"
    port.mkdir()
    for name in ("config.yaml", "tokenizer.json", "run_meta.json",
                 "layout.npz"):
        shutil.copy(os.path.join(jrun, name), port / name)
    cfg = Config.load(port / "config.yaml")
    layout = GroupLayout.load(str(port / "layout.npz"))
    model, _, _ = experiment.build_model(cfg, layout.to_groups(),
                                         layout.n_voxels)
    model.load_state_dict(from_flax({
        "params": _np(jcap.variables["params"]),
        "batch_stats": _np(jcap.variables["batch_stats"])}))
    mgr = CheckpointManager(str(port / "model"))
    mgr.save(new_state(model, cfg, "cpu"), 0)
    mgr.close()
    rows = np.random.default_rng(0).standard_normal(
        (ROWS, layout.n_voxels)).astype(np.float32)
    jexp_words = jexport.load_exported(str(tmp / "jax.mttx")).caption_ids(
        rows)
    return {"tmp": tmp, "jax_run": jrun, "run": str(port), "rows": rows,
            "jax_words": jexp_words}


def _export(runs, name, **kw):
    out = str(runs["tmp"] / name)
    if not os.path.exists(out):
        export_run(runs["run"], out, batch_size=4, platforms=("cpu",), **kw)
    return out


def test_port_artifact_on_jax_weights_gives_the_jax_artifacts_words(runs):
    """The route of ``test_eval_on_jax_weights_gives_the_jax_words``: the
    same weights, the same rows, each package's own artifact."""
    exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
    words, jwords = exp.caption_ids(runs["rows"]), runs["jax_words"]
    assert words.shape == jwords.shape == (ROWS, WIDTHS["max_length"])
    differs = np.nonzero((words != jwords).any(axis=1))[0]
    if len(differs):
        cap = Captioner.from_run_dir(runs["run"], device="cpu")
        _, logits, _ = make_greedy_decoder(cap.model, cap.max_length)(
            torch.from_numpy(runs["rows"][differs]), cap.tokenizer.start_id)
        top2 = logits.topk(2, dim=-1).values
        for i, row in enumerate(differs):
            first = int(np.argmax(words[row] != jwords[row]))
            assert float(top2[i, first, 0] - top2[i, first, 1]) < TIE_MARGIN
    assert len(differs) <= ROWS // 3
    assert exp.meta.keys() == json.loads(zipfile.ZipFile(
        runs["tmp"] / "jax.mttx").read("meta.json")).keys()


def test_port_export_greedy_matches_live_decode(runs):
    exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
    meta = exp.meta
    assert meta["version"] == ARTIFACT_VERSION
    assert meta["input_width"] == runs["rows"].shape[1]
    assert meta["platforms"] == ["cpu"] and meta["decoder"] == "greedy"
    live = Captioner.from_run_dir(runs["run"], batch_size=4, device="cpu",
                                  use_fused=False)
    rows = runs["rows"][:3]
    np.testing.assert_array_equal(exp.caption_ids(rows),
                                  live.caption_ids(rows))
    assert exp.caption(rows) == live.caption(rows)


def test_port_export_beam_matches_live_decode(runs):
    exp = load_exported(_export(runs, "beam3.mttx", decoder="beam",
                                beam_width=3), device="cpu")
    assert exp.meta["beam_width"] == 3 and exp.meta["decoder"] == "beam"
    live = Captioner.from_run_dir(runs["run"], batch_size=4, beam_width=3,
                                  device="cpu")
    rows = runs["rows"]
    np.testing.assert_array_equal(exp.caption_ids(rows),
                                  live.caption_ids(rows, decoder="beam"))


def test_port_beam_program_keeps_the_stable_sort(runs):
    """The beam takes its W best in a defined order among equal keys (a
    stable sort, as ``lax.top_k``): the exported graph must keep it."""
    with zipfile.ZipFile(_export(runs, "beam3.mttx", decoder="beam",
                                 beam_width=3)) as z:
        program = torch.export.load(io.BytesIO(z.read("decode.cpu.pt2")))
    # the decode sits in the program's no_grad region, a submodule
    sorts = [n for module in program.graph_module.modules()
             if isinstance(module, torch.fx.GraphModule)
             for n in module.graph.nodes
             if n.op == "call_function" and "sort" in str(n.target)]
    assert sorts and all(n.kwargs.get("stable", False) or
                         (len(n.args) > 1 and n.args[1] is True)
                         for n in sorts), [(n.target, n.args, n.kwargs)
                                           for n in sorts]


def test_port_export_chunks_requests_past_batch_size(runs):
    exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
    ids = exp.caption_ids(runs["rows"])          # 9 rows through batch 4
    assert ids.shape[0] == ROWS
    # padding rows never leak: row i as in a solo decode of row i
    np.testing.assert_array_equal(ids[8],
                                  exp.caption_ids(runs["rows"][8:9])[0])


def test_port_export_rejects_wrong_width(runs):
    exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        exp.caption_ids(np.zeros((2, 7), np.float32))


def test_port_export_rejects_unknown_decoder(runs, tmp_path):
    with pytest.raises(ValueError, match="decoder"):
        export_run(runs["run"], str(tmp_path / "s.mttx"), decoder="sample",
                   platforms=("cpu",))
    assert not list(tmp_path.iterdir())


def _rewrite(src, dst, meta_edit=None, rename=None):
    with zipfile.ZipFile(src) as a, zipfile.ZipFile(dst, "w") as b:
        for name in a.namelist():
            data = a.read(name)
            if name == "meta.json" and meta_edit:
                meta = json.loads(data)
                meta_edit(meta)
                data = json.dumps(meta).encode()
            b.writestr((rename or {}).get(name, name), data)


def test_port_load_rejects_future_version(runs, tmp_path):
    tampered = str(tmp_path / "future.mttx")
    _rewrite(_export(runs, "greedy.mttx"), tampered, meta_edit=lambda m:
             m.update(version=ARTIFACT_VERSION + 1))
    with pytest.raises(ValueError, match="version"):
        load_exported(tampered, device="cpu")


def test_port_load_refuses_a_platform_the_artifact_lacks(runs, tmp_path):
    """An artifact with only a ``cuda`` program cannot be loaded on the
    CPU, and the loader says which platforms it has."""
    cuda_only = str(tmp_path / "cuda_only.mttx")
    _rewrite(_export(runs, "greedy.mttx"), cuda_only,
             meta_edit=lambda m: m.update(platforms=["cuda"]),
             rename={"decode.cpu.pt2": "decode.cuda.pt2"})
    with pytest.raises(ValueError, match="no program for platform 'cpu'"):
        load_exported(cuda_only, device="cpu")


def test_port_load_refuses_the_jax_artifact(runs):
    with pytest.raises(ValueError, match="StableHLO"):
        load_exported(str(runs["tmp"] / "jax.mttx"), device="cpu")


def test_port_export_and_load_default_to_the_card(runs, tmp_path,
                                                  monkeypatch):
    """No fallback: without ``platforms`` or ``device`` both ask for
    ``cuda``, and on a machine without a card they raise."""
    artifact = _export(runs, "greedy.mttx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_run(runs["run"], str(tmp_path / "d.mttx"), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported(artifact)


def test_port_http_serves_from_exported_artifact(runs):
    """``serve --export``: the HTTP service runs from the artifact alone."""
    args = cli._parser().parse_args([
        "serve", "--export", _export(runs, "greedy.mttx"), "--port", "0",
        "--max-wait-ms", "0", "--device", "cpu"])
    server = cli.make_server(args)
    assert args.decoder == "greedy"
    host, port = server.server_address[:2]
    t = threading.Thread(target=serve_forever, args=(server,), daemon=True)
    t.start()
    try:
        rows = runs["rows"][:2]
        body = json.dumps({"betas": rows.tolist()}).encode()
        req = urllib.request.Request(
            f"http://{host}:{port}/caption", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            got = json.loads(resp.read().decode())
        exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
        assert got["captions"] == exp.caption(rows)
        # a decoder the artifact does not freeze fails cleanly
        req = urllib.request.Request(
            f"http://{host}:{port}/caption?decoder=beam", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(req, timeout=30)
    finally:
        server.shutdown()
        server.server_close()


def _port_run(tmp_path, **kw):
    cfg = Config(run=kw.get("model", "lc_nic"), log=str(tmp_path / "logs"),
                 **{**WIDTHS, **kw})
    return experiment.run_training(cfg, epochs=1, smoke_keys=12,
                                   device="cpu")


def test_port_export_ms2_freezes_one_subject_encoder(tmp_path):
    """ms2 artifacts freeze one per-subject encoder (``export
    --subject``): each subject's words are the live per-subject
    Captioner's."""
    run_path, _, bundle = _port_run(tmp_path, model="ms2_nic")
    rows = bundle["store"].device_array()[:2].numpy()
    for subject in ("a", "b"):
        out = str(tmp_path / f"ms2_{subject}.mttx")
        meta = export_run(run_path, out, decoder="greedy", batch_size=4,
                          subject=subject, platforms=("cpu",))
        assert meta["subject"] == subject
        exp = load_exported(out, device="cpu")
        live = Captioner.from_run_dir(run_path, batch_size=4, device="cpu",
                                      subject=subject, use_fused=False)
        np.testing.assert_array_equal(exp.caption_ids(rows),
                                      live.caption_ids(rows))


def test_port_export_subject_rejected_for_single_encoder_runs(runs,
                                                              tmp_path):
    with pytest.raises(ValueError, match="not an ms2_nic run"):
        export_run(runs["run"], str(tmp_path / "b.mttx"), subject="b",
                   platforms=("cpu",))


@pytest.mark.parametrize("extra,message", [
    (["--decoder", "beam"], "freezes"),
    (["--subject", "b"], "subject"),
    (["--run", "somewhere"], "exactly one"),
])
def test_port_serve_cli_refusals(runs, extra, message):
    """A contradictory ``--decoder``, a ``--subject`` (frozen at export
    time) and ``--run`` beside ``--export`` are refused, as by the JAX
    CLI."""
    with pytest.raises(SystemExit, match=message):
        cli.main(["serve", "--export", _export(runs, "greedy.mttx"),
                  "--port", "0", "--device", "cpu", *extra])


def test_port_exported_empty_input_returns_empty_ids(runs):
    exp = load_exported(_export(runs, "greedy.mttx"), device="cpu")
    ids = exp.caption_ids(np.zeros((0, runs["rows"].shape[1]), np.float32))
    assert ids.shape == (0, exp.meta["max_length"])


def test_port_export_showtell_run(tmp_path):
    """Families without a layout export too: the artifact's input spec
    comes from the recorded trained row shape."""
    run_path, _, bundle = _port_run(tmp_path, model="showtell",
                                    embedding_features=16)
    meta = export_run(run_path, str(tmp_path / "st.mttx"), batch_size=4,
                      platforms=("cpu",))
    width = bundle["store"].row_shape[0]
    assert meta["input_width"] == width
    exp = load_exported(str(tmp_path / "st.mttx"), device="cpu")
    rows = bundle["store"].device_array()[:2].numpy()
    live = Captioner.from_run_dir(run_path, batch_size=4, device="cpu")
    np.testing.assert_array_equal(exp.caption_ids(rows),
                                  live.caption_ids(rows))


def test_port_exported_decoder_guard_unit():
    exp = ExportedCaptioner(program=None, tokenizer=None,
                            meta={"batch_size": 4, "input_width": 5,
                                  "decoder": "greedy"}, device="cpu")
    with pytest.raises(ValueError, match="freezes"):
        exp.caption_ids(np.zeros((1, 5), np.float32), decoder="beam")


def test_port_exported_captioner_padding_unit():
    """The padding and chunking without a real program."""
    def program(chunk):
        assert chunk.shape == (4, 5)  # always the static shape
        return chunk[:, :2].to(torch.int32)

    meta = {"batch_size": 4, "input_width": 5, "max_length": 2,
            "decoder": "greedy"}
    exp = ExportedCaptioner(program, tokenizer=None, meta=meta, device="cpu")
    x = np.arange(7 * 5, dtype=np.float32).reshape(7, 5)
    ids = exp.caption_ids(x)
    assert ids.shape == (7, 2)
    np.testing.assert_array_equal(ids, x[:, :2].astype(np.int32))


def test_port_exported_captioner_defaults_to_the_card(monkeypatch):
    """With no ``device`` the captioner asks for CUDA, as ``load_exported``
    does: without a card it raises, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = {"batch_size": 4, "input_width": 5, "max_length": 2,
            "decoder": "greedy"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedCaptioner(program=None, tokenizer=None, meta=meta)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported("never-read.mttx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    exp = ExportedCaptioner(program=None, tokenizer=None, meta=meta)
    assert exp.device == torch.device("cuda")


def test_port_export_cli_prints_the_jax_cli_keys(runs, tmp_path, capsys):
    out = str(tmp_path / "cli.mttx")
    assert cli.main(["export", "--run", runs["run"], "--out", out,
                     "--batch-size", "4", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jmeta = json.loads(zipfile.ZipFile(runs["tmp"] / "jax.mttx").read(
        "meta.json"))
    assert set(got) == {"out", *jmeta}
    assert got["platforms"] == ["cpu"]
    assert sorted(zipfile.ZipFile(out).namelist()) == [
        "decode.cpu.pt2", "meta.json", "tokenizer.json"]


def test_port_export_pre_bakes_transform_chain(tmp_path):
    """``export --pre``: the preprocess chain (vc mask -> normalize -> pca)
    is baked into the program; the artifact takes raw rows and its words
    are those of the host chain's replay and the live decode."""
    from masters_thesis_tpu_torch.experiment import (
        apply_preprocess_chain,
        run_preprocess,
    )

    # raw per-key betas + atlases + split (tests/test_export.py's fixture)
    nsd, caps, raw = (tmp_path / d for d in ("nsd", "caps", "raw"))
    for d in (nsd, caps, raw):
        d.mkdir()
    rng = np.random.default_rng(5)
    keys = list(range(1, 13))
    for k in keys:
        np.save(raw / f"subj02_KID{k}.npy",
                rng.standard_normal(64).astype(np.float32))
        (caps / f"KID{k}.txt").write_text("\n".join(
            " ".join(rng.choice("a the dog cat runs sits".split(), size=5))
            for _ in range(5)))
    np.save(nsd / "glasser_lh.npy", np.repeat([0, 1, 2], [24, 4, 4]))
    np.save(nsd / "glasser_rh.npy", np.repeat([0, 1], [26, 6]))
    (nsd / "subj02_conditions.csv").write_text("\n".join(
        ["nsd_key,is_shared"] + [f"{k},0" for k in keys[:9]]
        + [f"{k},1" for k in keys[9:]]))
    (nsd / "test_conditions.csv").write_text("nsd_key\n12\n")

    cfg = Config(run="exp_pre", model="thinkandtell", epochs=1,
                 batch_size=4, max_length=6, top_k=40, units=16,
                 embedding_features=16, log=str(tmp_path / "logs"))
    cfg.dataset.betas_path = str(raw)
    cfg.dataset.captions_path = str(caps)
    cfg.dataset.nsd_dir = str(nsd)
    pre = tmp_path / "pre"
    report = run_preprocess(cfg, str(pre), vc_parcels="1,2", normalize=True,
                            pca_components=4, device="cpu")
    cfg.dataset.betas_path = report["pca"]["pack"]
    run_path, _, _ = experiment.run_training(cfg, epochs=1, device="cpu")

    out = str(tmp_path / "pre.mttx")
    meta = export_run(run_path, out, decoder="greedy", batch_size=4,
                      pre=str(pre), platforms=("cpu",))
    assert meta["pre_stages"] == ["vc_mask", "normalize", "pca"]
    assert meta["input_width"] == 64  # the raw width, not the reduced 4

    exp = load_exported(out, device="cpu")
    raw_rows = rng.standard_normal((3, 64)).astype(np.float32)
    live = Captioner.from_run_dir(run_path, batch_size=4, device="cpu")
    expect = live.caption_ids(apply_preprocess_chain(str(pre), raw_rows))
    np.testing.assert_array_equal(exp.caption_ids(raw_rows), expect)
    with pytest.raises(ValueError, match="expected"):
        exp.caption_ids(np.zeros((1, 4), np.float32))
