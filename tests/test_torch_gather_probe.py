"""The port's gather probe (``masters_thesis_tpu_torch/scripts/gather_probe.py``)
and the plain versions of its kernels against the JAX probe's own Pallas
kernels, run in interpret mode on the CPU.

``scripts/gather_probe.py`` runs a 1.34 GB benchmark at module level, so it
is neither imported nor run: its kernel factories (``_gather_kernel``,
``make_pallas_take``, ``make_dma_take``, ``xla_take`` and, from the
module-level ``try``, ``_check``) are taken from its source and executed in a
namespace of small sizes whose ``pl.pallas_call`` passes ``interpret=True``.
Only ids in range go to JAX: interpret mode reads id N as row N - 1 and id
-1 as the last row, and the TPU's DMA reads whatever lies there; the port's
clamp is held against its own plain version."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from masters_thesis_tpu_torch.ops.gather import (
    MAX_STAGES,
    gather_rows_bulk,
    gather_rows_chunked,
    gather_rows_reference,
)
from masters_thesis_tpu_torch.scripts import gather_probe as probe

from torch_threads import one_thread  # noqa: F401

JAX_PROBE = Path(__file__).resolve().parents[1] / "scripts" / "gather_probe.py"
TAKEN = ("_gather_kernel", "make_pallas_take", "make_dma_take", "xla_take",
         "_check")
# small sizes: 12 rows of 1,000 columns (padded to 8 x 128), 3 steps of 5
N, V, S, K, B = 12, 1000, 8, 3, 5
SUM_RTOL = 1e-6     # fp32 sums of the same values in another order


class _InterpretPallas:
    """``pallas`` with ``pallas_call`` run in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _taken_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    found = []
    for node in tree.body:
        body = node.body if isinstance(node, ast.Try) else [node]
        found += [n for n in body
                  if isinstance(n, ast.FunctionDef) and n.name in TAKEN]
    return found


@pytest.fixture(scope="module")
def data():
    """The JAX probe's draw at small sizes: the store, then the ids, from
    one ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    store = rng.standard_normal((N, V)).astype(np.float32)
    idx = rng.integers(0, N, (K, B)).astype(np.int32)
    return store, idx


@pytest.fixture(scope="module")
def jax_probe(data):
    store, idx = data
    tree = ast.parse(JAX_PROBE.read_text())
    nodes = _taken_functions(tree)
    assert sorted(n.name for n in nodes) == sorted(TAKEN)
    ns = dict(jax=jax, jnp=jnp, pl=_InterpretPallas(), pltpu=pltpu, S=S,
              V=V, store=jnp.asarray(store), one_idx=jnp.asarray(idx[0]))
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(JAX_PROBE),
                 "exec"), ns)
    return ns


def _padded(store: np.ndarray) -> np.ndarray:
    return np.pad(store, ((0, 0), (0, S * 128 - V)))


def test_probe_sizes_and_settings_are_the_jax_probes():
    """The port's defaults and sweeps are the JAX probe's: N, V, B, K at
    :15, the s_block values at :71 (S is the padded width / 128), the nb
    values at :130, P3's 4 DMAs at :146."""
    tree = ast.parse(JAX_PROBE.read_text())
    sizes = next(n for n in tree.body if isinstance(n, ast.Assign)
                 and isinstance(n.targets[0], ast.Tuple)
                 and [t.id for t in n.targets[0].elts] == list("NVBK"))
    assert ast.literal_eval(sizes.value) == (probe.N, probe.V, probe.B,
                                             probe.K)
    loops = {n.target.id: n.iter for n in tree.body
             if isinstance(n, ast.For)}
    s = probe.padded_cols(probe.V) // probe.LANES
    assert tuple(eval(compile(ast.Expression(loops["sb"]), "", "eval"),
                      {"S": s})) == probe.S_BLOCKS
    assert ast.literal_eval(loops["nb"]) == probe.STAGES
    assert "sem.at[i % 4]" in ast.unparse(
        next(n for n in _taken_functions(tree) if n.name == "_check"))
    assert probe.EXACT_STAGES == 4


@pytest.mark.parametrize("s_block", [1, 8])
def test_chunked_gather_loop_matches_jax_p1(jax_probe, data, s_block):
    """P1's K-step sum: the JAX kernel over the packed (N, S, 128) store
    against the port's loop over the padded 2-D store."""
    store, idx = data
    want = float(jax_probe["make_pallas_take"](s_block)(
        jnp.asarray(_padded(store).reshape(N, S, 128)), jnp.asarray(idx)))
    np.testing.assert_allclose(want, store[idx].astype(np.float64).sum(),
                               rtol=SUM_RTOL)
    got = probe.k_step_sum(
        functools.partial(gather_rows_chunked, chunk_cols=s_block * 128),
        torch.from_numpy(_padded(store)), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


@pytest.mark.parametrize("nb", [2, 4])
def test_bulk_gather_loop_matches_jax_p2(jax_probe, data, nb):
    store, idx = data
    want = float(jax_probe["make_dma_take"](nb, None)(jnp.asarray(store),
                                                      jnp.asarray(idx)))
    np.testing.assert_allclose(want, store[idx].astype(np.float64).sum(),
                               rtol=SUM_RTOL)
    got = probe.k_step_sum(functools.partial(gather_rows_bulk, stages=nb),
                           torch.from_numpy(store), torch.from_numpy(idx))
    np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


def test_index_select_loop_matches_xla_take(jax_probe, data):
    store, idx = data
    want = float(jax_probe["xla_take"](jnp.asarray(store), jnp.asarray(idx)))
    gather = probe.variants()[0][-1]
    got = probe.k_step_sum(gather, torch.from_numpy(store),
                           torch.from_numpy(idx))
    np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


def test_p3_rows_equal_the_jax_check(jax_probe, data):
    """P3: the JAX probe's ``_check`` (P2's body at nb = 4, rows returned)
    against the bulk gather at 4 stages, exactly."""
    store, idx = data
    want = np.asarray(jax_probe["_check"]())
    np.testing.assert_array_equal(want, store[idx[0]])
    got = gather_rows_bulk(torch.from_numpy(store), torch.from_numpy(idx[0]),
                           stages=probe.EXACT_STAGES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe.exact_check(torch.from_numpy(store),
                             torch.from_numpy(idx[0]))


def test_probe_main_on_the_cpu_prints_every_tag(capsys):
    assert probe.main(["--device", "cpu", "--rows", "12", "--cols", "1000",
                       "--batch", "5", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    for tag in ["index_select"] + [
            f"pallas gather s_block={sb}" for sb in probe.S_BLOCKS] + [
            f"dma hbm2hbm 2D nb={nb}" for nb in probe.STAGES]:
        assert f"{tag:26s}: " in out, tag
    assert "GB/s" in out and "us per 5-row gather alone" in out
    assert out.strip().endswith("dma gather exact: True")


def test_probe_run_counts_no_launch_on_the_cpu():
    before = (gather_rows_chunked.launches, gather_rows_bulk.launches)
    result = probe.run(rows=9, cols=300, batch=4, steps=2, device="cpu")
    assert (gather_rows_chunked.launches, gather_rows_bulk.launches) == before
    assert result["exact"] and result["exact_launches"] == 0
    assert [v["tag"] for v in result["variants"]] == [
        tag for tag, *_ in probe.variants()]
    assert all(v["launches"] == 0 for v in result["variants"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_clamp_like_the_plain_version(dtype):
    """Repeated ids and ids past both ends, on CPU tensors: the plain
    version, and no launch counted."""
    store = torch.randn(7, 333).to(dtype)
    ids = torch.tensor([5, 0, 5, 6, -1, 9, 2, -7, 2])
    want = gather_rows_reference(store, ids, 201)
    before = (gather_rows_chunked.launches, gather_rows_bulk.launches)
    for got in (gather_rows_chunked(store, ids, 100, 201),
                gather_rows_bulk(store, ids.int(), 3, 201)):
        assert torch.equal(got, want)
    assert torch.equal(want, store[[5, 0, 5, 6, 0, 6, 2, 0, 2], :201])
    assert (gather_rows_chunked.launches, gather_rows_bulk.launches) == before


def test_wrappers_refuse_settings_and_devices():
    """A chunk under one column, stages outside [1, 32], and tensors that
    are neither all on the CPU nor on one CUDA device raise."""
    store, ids = torch.randn(4, 8), torch.tensor([1, 2])
    with pytest.raises(ValueError, match="chunk_cols"):
        gather_rows_chunked(store, ids, 0)
    for stages in (0, MAX_STAGES + 1):
        with pytest.raises(ValueError, match="stages"):
            gather_rows_bulk(store, ids, stages)
    meta = (torch.empty(4, 8, device="meta"),
            torch.zeros(2, dtype=torch.long, device="meta"))
    before = (gather_rows_chunked.launches, gather_rows_bulk.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows_chunked(*meta, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows_bulk(meta[0], ids, 2)
    assert (gather_rows_chunked.launches, gather_rows_bulk.launches) == before
