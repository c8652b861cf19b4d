"""No module of JAX, of its libraries or of the JAX package is loaded in a
run's process, names compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the program; a run without a
CUDA card prints no result."""

import ast
import json
import subprocess
import sys

import pytest

from port_bench.harness.bench import ROOT, loaded_forbidden

RUN_TINY = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {root!r})
from port_bench.harness.bench import loaded_forbidden
from port_bench.tests import tiny
root = tiny.tiny_root(Path(tempfile.mkdtemp()))
for cell in tiny.cells(root):
    assert tiny.run(root, cell, seconds=0.1)["correct"]
print(json.dumps({{"forbidden": loaded_forbidden(),
                  "port": "masters_thesis_tpu_torch" in sys.modules}}))
"""


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "masters_thesis_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert loaded_forbidden() == ["flax.linen"]


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


@pytest.mark.parametrize("path", sorted(
    (ROOT / "port_bench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in (
                "masters_thesis_tpu_torch", "masters_thesis_tpu", "jax",
                "flax", "optax", "jaxlib"), (path.name, name)
            assert not name.startswith("port_bench.harness"), (path.name,
                                                                name)


def test_without_a_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "port_bench" / "run.py"),
                          "--workload", "cnnrnn_eval_greedy", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0 and out.stdout == ""
