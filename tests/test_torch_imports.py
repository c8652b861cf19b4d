"""The port imports on a machine without JAX: in a fresh interpreter with
jax, jaxlib, flax, optax, orbax and yaml blocked by a meta-path finder, the
package, its serving and training modules and the reference modules that
they and ``chip_smoke.py`` share import, and importing them neither loads
triton nor builds a kernel."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "masters_thesis_tpu_torch",
    "masters_thesis_tpu_torch.models",
    "masters_thesis_tpu_torch.ops",
    "masters_thesis_tpu_torch.ops._build",
    "masters_thesis_tpu_torch.ops.fused_decode",
    "masters_thesis_tpu_torch.ops.gather",
    "masters_thesis_tpu_torch.decode.greedy",
    "masters_thesis_tpu_torch.transplant",
    "masters_thesis_tpu_torch.serve",
    "masters_thesis_tpu_torch.config",
    "masters_thesis_tpu_torch.data.store",
    "masters_thesis_tpu_torch.train.losses",
    "masters_thesis_tpu_torch.train.optim",
    "masters_thesis_tpu_torch.train.state",
    "masters_thesis_tpu_torch.train.steps",
    "masters_thesis_tpu_torch.train.loop",
    # shared from the reference by the training path and chip_smoke.py
    "masters_thesis_tpu.server",
    "masters_thesis_tpu.data.pairs",
    "masters_thesis_tpu.data.pipeline",
    "masters_thesis_tpu.data.splits",
    "masters_thesis_tpu.data.synthetic",
    "masters_thesis_tpu.data.tokenizer",
]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, json, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml"}

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
        [sys.executable, "-c", f"MODULES = {MODULES!r}\n{SCRIPT}"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_with_jax_flax_and_yaml_blocked(imported):
    loaded = set(imported["loaded"])
    assert set(MODULES) <= loaded
    for blocked in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml"):
        assert blocked not in loaded


def test_import_loads_no_triton_and_builds_nothing(imported):
    assert not any(m.split(".")[0] == "triton" for m in imported["loaded"])
    assert imported["built"] == 0


def test_port_shares_only_framework_free_modules_of_the_reference(imported):
    """What the port takes from the JAX package: the modules named as
    framework-free (ROADMAP's list, with the training slice's pipeline,
    pairs and splits), and the package plumbing they pull in."""
    shared = {m for m in imported["loaded"]
              if m.startswith("masters_thesis_tpu.")}
    for needed in ("ops.group_layout", "data.tokenizer", "data.synthetic",
                   "evalsuite.tokens", "serve", "server", "data.pipeline",
                   "data.pairs", "data.splits"):
        assert f"masters_thesis_tpu.{needed}" in shared
    for never in ("config", "experiment", "models", "decode", "train",
                  "ops.fused_decode", "ops.gather"):
        assert not any(m == f"masters_thesis_tpu.{never}"
                       or m.startswith(f"masters_thesis_tpu.{never}.")
                       for m in shared), never
