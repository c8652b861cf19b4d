"""The port stands alone: in a fresh interpreter with jax, jaxlib, flax,
optax, orbax, yaml, h5py, PIL and matplotlib (which the card's machine
lacks; the port imports h5py and PIL only in the commands that read HDF5
or write PNG, and matplotlib only where ``analyze`` draws) and
the JAX package itself blocked by a meta-path finder, every module of the
port and ``chip_smoke.py`` import, and importing them
loads no module of the JAX package, does not load triton and builds no
kernel; under the same block the port's CLI (``python -m
masters_thesis_tpu_torch``) reads a config, trains, decodes and scores on
the CPU. No import statement of the port or of ``chip_smoke.py`` names the
JAX package, not even inside a function."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "masters_thesis_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "triton",
           "h5py", "PIL", "matplotlib", "masters_thesis_tpu")


def _port_modules() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "__main__.py":      # runs the CLI: see below
            continue
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


MODULES = _port_modules() + ["chip_smoke"]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, json, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Block())
    for name in MODULES:
        importlib.import_module(name)
    from masters_thesis_tpu_torch.ops import _build
    print(json.dumps({
        "loaded": sorted(sys.modules),
        "built": _build.load_library.cache_info().currsize,
    }))
""")


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"MODULES = {MODULES!r}\nBLOCKED = {BLOCKED!r}\n{SCRIPT}"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_with_jax_flax_and_yaml_blocked(imported):
    loaded = set(imported["loaded"])
    assert set(MODULES) <= loaded
    for name in ("server", "models.encoders", "experiment", "cli",
                 "train.checkpoint", "train.callbacks",
                 "evalsuite.metric_suite", "evalsuite.guse_sim",
                 "utils.tensorboard", "utils.summary", "decode.beam",
                 "decode.sampling", "models.showtell", "models.multisubject",
                 "data.captions", "data.pack", "data.nsd_images",
                 "data.preprocess.sessions", "data.preprocess.pca",
                 "data.preprocess.mgh", "data.preprocess.glasser",
                 "data.preprocess.hcp_regions", "data.preprocess.zscore",
                 "models.backbones", "models.resnet", "models.inception",
                 "models.efficientnet", "models.use_encoder",
                 "utils.farmhash", "utils.keras_import", "tune",
                 "tune.search", "tune.asha", "tune.runner",
                 "tune.dispatch", "export", "evalsuite.analysis",
                 "evalsuite.coco_adapter", "utils.profiling",
                 "utils.monitor"):
        assert f"masters_thesis_tpu_torch.{name}" in loaded
    for blocked in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                    "matplotlib"):
        assert blocked not in loaded


def test_import_loads_no_triton_and_builds_nothing(imported):
    assert not any(m.split(".")[0] == "triton" for m in imported["loaded"])
    assert imported["built"] == 0


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_shares_only_framework_free_modules_of_the_reference(imported):
    """The port once shared the JAX package's framework-free modules; it
    now shares none. Importing it loads no module of the JAX package, and
    no import statement of its sources or of ``chip_smoke.py``, at module
    level or inside a function, names the JAX package."""
    shared = [m for m in imported["loaded"]
              if m == "masters_thesis_tpu"
              or m.startswith("masters_thesis_tpu.")]
    assert shared == []
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        for name in _imported_names(path):
            assert name.split(".")[0] != "masters_thesis_tpu", (path, name)


CLI_SCRIPT = textwrap.dedent("""
    import importlib.abc, json, runpy, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Block())
    sys.argv = ["masters_thesis_tpu_torch", *ARGV]
    try:
        runpy.run_module("masters_thesis_tpu_torch", run_name="__main__")
    except SystemExit as exc:
        assert not exc.code, exc.code
    print(json.dumps(sorted(sys.modules)))
""")


def test_cli_runs_with_jax_flax_and_yaml_blocked(tmp_path):
    """``metrics`` on a copy of configs/smoke.yaml, on the CPU: the port's
    own YAML reader, training, decoding and the metric suite, with no module
    of the JAX package, jax or yaml loaded."""
    cfg = tmp_path / "smoke.yaml"
    cfg.write_text((ROOT / "configs" / "smoke.yaml").read_text().replace(
        "log: /tmp/mtt_logs/", f"log: {tmp_path}/"))
    argv = ["metrics", "--config", str(cfg), "--epochs", "1",
            "--smoke-keys", "12", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"ARGV = {argv!r}\nBLOCKED = {BLOCKED!r}\n{CLI_SCRIPT}"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    *_, result, loaded = proc.stdout.strip().splitlines()
    assert "Bleu_4" in json.loads(result)
    loaded = set(json.loads(loaded))
    assert "masters_thesis_tpu_torch.cli" in loaded
    for blocked in BLOCKED:
        assert not any(m.split(".")[0] == blocked for m in loaded), blocked


def test_guse_score_and_tune_run_with_jax_flax_yaml_and_h5py_blocked(
        tmp_path):
    """``guse`` with a USE bundle, ``score`` on its captions and ``tune``
    (one trial), on the CPU, with the same modules blocked: the encoder,
    FarmHash, the metric suite and ``tune/`` load none of them (h5py is
    imported only when a Keras file is read)."""
    import numpy as np

    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.models.use_encoder import (
        init_use_params,
        save_use_bundle,
    )

    caps = tmp_path / "captions"
    caps.mkdir()
    for k in (3, 5):
        (caps / f"KID{k}.txt").write_text("a dog runs.\nthe zebra sits\n")
    vocab = ["a", "dog", "runs", "the", "sits"]
    (tmp_path / "guse").mkdir()
    save_use_bundle(str(tmp_path / "guse" / "use_dan.npz"), vocab,
                    init_use_params(len(vocab), oov_buckets=4, embed_dim=8,
                                    hidden=(8,), out_dim=8), 4)
    cfg = Config.load(ROOT / "configs" / "smoke.yaml")
    cfg.log = str(tmp_path / "logs")
    cfg.dataset.captions_path = str(caps)
    cfg.dataset.guse_path = str(tmp_path / "guse")
    cfg.save(tmp_path / "c.yaml")
    (tmp_path / "captions_0.txt").write_text("3\ta dog runs\n5\tthe zebra\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        MTT_GUSE_WEIGHTS=str(tmp_path / "guse" / "use_dan.npz"))
    for argv, key in (
            (["guse", "--config", str(tmp_path / "c.yaml"), "--out",
              str(tmp_path / "out"), "--device", "cpu"], "embedder"),
            (["score", "--captions", str(tmp_path / "captions_0.txt"),
              "--references", str(caps), "--device", "cpu"], "scores"),
            (["tune", "--config", str(tmp_path / "c.yaml"), "--num-samples",
              "1", "--epochs", "1", "--smoke-keys", "12", "--device", "cpu"],
             "best")):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"ARGV = {argv!r}\nBLOCKED = {BLOCKED!r}\n{CLI_SCRIPT}"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
        *_, result, loaded = proc.stdout.strip().splitlines()
        result = json.loads(result)
        assert key in result
        if argv[0] == "guse":
            assert result["embedder"] == "use_dan"
        if argv[0] == "score":
            assert "GUSE_pearson_r" in result["scores"]
        loaded = set(json.loads(loaded))
        for blocked in BLOCKED:
            assert not any(m.split(".")[0] == blocked for m in loaded), (
                argv[0], blocked)
    assert np.load(tmp_path / "out" / "keys.npy").tolist() == [3, 5]


def test_deploy_commands_run_with_matplotlib_blocked(tmp_path):
    """A training run with ``tpu.profile_steps`` and ``tpu.profile_trace``
    (its caption images drawn by the port's own font), ``export`` of it and
    the artifact loaded, on the CPU, with matplotlib and the JAX package
    blocked; ``analyze`` there exits non-zero naming matplotlib before it
    writes anything."""
    cfg = tmp_path / "smoke.yaml"
    cfg.write_text((ROOT / "configs" / "smoke.yaml").read_text().replace(
        "log: /tmp/mtt_logs/", f"log: {tmp_path}/")
        + "tpu:\n  profile_steps: 3\n  profile_trace: true\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

    def run(argv):
        return subprocess.run(
            [sys.executable, "-c",
             f"ARGV = {argv!r}\nBLOCKED = {BLOCKED!r}\n{CLI_SCRIPT}"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)

    proc = run(["train", "--config", str(cfg), "--epochs", "2",
                "--smoke-keys", "48", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    run_path = Path(json.loads(proc.stdout.strip().splitlines()[-2])[
        "run_path"])
    assert (run_path / "profile.json").exists()
    assert list((run_path / "trace").glob("*.pt.trace.json"))
    assert list((run_path / "tb").glob("*.captions"))
    proc = run(["export", "--run", str(run_path), "--out",
                str(tmp_path / "a.mttx"), "--batch-size", "4", "--device",
                "cpu"])
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-2])["platforms"] == [
        "cpu"]
    proc = run(["analyze", "--run", str(run_path), "--device", "cpu"])
    assert proc.returncode != 0 and "matplotlib" in proc.stderr
    assert not (run_path / "analysis").exists()
