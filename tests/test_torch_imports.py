"""The port stands alone: in a fresh interpreter with jax, jaxlib, flax,
optax, orbax, yaml and the JAX package itself blocked by a meta-path finder,
every module of the port and ``chip_smoke.py`` import, and importing them
loads no module of the JAX package, does not load triton and builds no
kernel. No import statement of the port or of ``chip_smoke.py`` names the
JAX package, not even inside a function."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "masters_thesis_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "triton",
           "masters_thesis_tpu")


def _port_modules() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
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
    import json

    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_with_jax_flax_and_yaml_blocked(imported):
    loaded = set(imported["loaded"])
    assert set(MODULES) <= loaded
    assert "masters_thesis_tpu_torch.server" in loaded
    assert "masters_thesis_tpu_torch.models.encoders" in loaded
    for blocked in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml"):
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
