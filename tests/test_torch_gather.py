"""K1's plain version and the port's device store against the JAX package:
the row gather against the TPU kernel run in interpret mode on the packed
store, and the store's permute at upload against ``GroupLayout``. Both are
copies, so every comparison is exact. Also K1's launch plan
(``gather_plan``): its choice by row bytes at every edge, its constants
against the kernel source's, and a walk of the kernel's loops over the
plan that must copy every vector of every row exactly once."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pairs import encode_pairs
from masters_thesis_tpu.data.pipeline import BatchPipeline
from masters_thesis_tpu.data.synthetic import synthetic_dataset, synthetic_groups
from masters_thesis_tpu.ops.gather import _pallas_gather, pack_rows
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.data.store import (
    ArrayStore,
    permute_rows,
    store_dtype,
)
from masters_thesis_tpu_torch.ops import gather
from masters_thesis_tpu_torch.ops.gather import (
    GatherPlan,
    gather_plan,
    gather_rows,
    gather_rows_reference,
    vector_bytes,
)

# repeated ids, both ends, and ids past both ends (clamped)
IDS = [5, 0, 5, 6, -1, 9, 2, -7, 2]


def _pallas_rows(data: np.ndarray, idx, width, dtype):
    """The TPU kernel in interpret mode, with the TPU path's clamp."""
    n, w = data.shape
    ids = jnp.clip(jnp.asarray(idx, jnp.int32), 0, n - 1)
    rows = _pallas_gather(pack_rows(data, dtype=dtype), ids, interpret=True)
    rows = np.asarray(rows.astype(jnp.float32)).reshape(len(idx), -1)
    return rows[:, :w if width is None else width]


@pytest.mark.parametrize("width", [None, 300, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_reference_matches_pallas_kernel_interpret_mode(width, dtype,
                                                        id_dtype):
    data = np.random.default_rng(0).standard_normal((7, 333)).astype(
        np.float32)
    want = _pallas_rows(data, IDS, width, getattr(jnp, dtype))
    store = torch.from_numpy(data).to(store_dtype(dtype))
    got = gather_rows_reference(store, torch.tensor(IDS, dtype=id_dtype),
                                width)
    assert got.dtype == store.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_reference_matches_pallas_kernel_on_pca_pack_rows(dtype, id_dtype):
    """The 512 columns of ThinkAndTell's PCA pack, the narrowest store K1
    gathers from."""
    data = np.random.default_rng(1).standard_normal((7, 512)).astype(
        np.float32)
    want = _pallas_rows(data, IDS, None, getattr(jnp, dtype))
    store = torch.from_numpy(data).to(store_dtype(dtype))
    got = gather_rows_reference(store, torch.tensor(IDS, dtype=id_dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    store = torch.randn(6, 40)
    before = gather_rows.launches
    got = gather_rows(store, torch.tensor([3, 3, 8, -2]), 17)
    assert gather_rows.launches == before
    assert torch.equal(got, store[[3, 3, 5, 0], :17])


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device, or a store
    and ids on two devices, raise instead of reaching index_select."""
    before = gather_rows.launches
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.empty(4, 8, device="meta"),
                    torch.zeros(2, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.empty(4, 8, device="meta"),
                    torch.zeros(2, dtype=torch.long))
    assert gather_rows.launches == before


def test_permute_at_upload_matches_group_layout():
    groups = synthetic_groups(700, 9, seed=3)
    layout = GroupLayout(groups, 700)
    data = np.random.default_rng(1).standard_normal((11, 700)).astype(
        np.float32)
    got = permute_rows(torch.from_numpy(data), layout, chunk=4)
    assert got.shape == (11, layout.padded_total)
    np.testing.assert_array_equal(got.numpy(), layout.permute_rows(data))
    with pytest.raises(ValueError, match="700"):
        permute_rows(torch.zeros(2, 699), layout)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_store_device_gather_and_lookup(dtype):
    data = np.random.default_rng(2).standard_normal((6, 50)).astype(
        np.float32)
    keys = [31, 7, 12, 99, 4, 18]
    store = ArrayStore(data, keys, device="cpu", dtype=dtype)
    assert store.device_resident and store.device == torch.device("cpu")
    assert store.n_cols == 50 and store.row_shape == (50,)
    assert len(store) == 6 and store.key_to_idx[99] == 3
    assert store.indices_for([18, 31]).tolist() == [5, 0]
    assert store.indices_for([18]).dtype == np.int32
    want = store_dtype(dtype or "float32")
    assert store.device_array().dtype == want
    got = store.device_gather(np.asarray([2, 5, 2], np.int32))
    assert got.dtype == want
    assert torch.equal(got, torch.from_numpy(data[[2, 5, 2]]).to(want))


def test_store_refuses_duplicate_keys_and_unknown_dtypes():
    with pytest.raises(ValueError, match="duplicate"):
        ArrayStore(np.zeros((2, 3), np.float32), [1, 1], device="cpu")
    with pytest.raises(ValueError, match="keys"):
        ArrayStore(np.zeros((2, 3), np.float32), [1], device="cpu")
    with pytest.raises(ValueError, match="float16"):
        ArrayStore(np.zeros((2, 3), np.float32), [1, 2], device="cpu",
                   dtype="float16")


def test_shared_pipeline_batches_gather_from_the_port_store():
    """The JAX package's BatchPipeline drives the port's store: the ids it
    hands out gather the same rows as the JAX package's store."""
    _, pairs, tok, jstore, _ = synthetic_dataset(n_keys=16, n_voxels=40,
                                                 n_groups=3, top_k=30)
    store = ArrayStore(np.asarray(jstore.data), jstore.keys, device="cpu")
    enc = encode_pairs(pairs["train"], tok, 5)
    pipe = BatchPipeline(enc, store, 4, seed=0, prefetch=0)
    jpipe = BatchPipeline(enc, jstore, 4, seed=0, prefetch=0)
    for batch, jbatch in zip(pipe.epoch(0), jpipe.epoch(0)):
        assert "betas" not in batch
        np.testing.assert_array_equal(store.device_gather(batch["idx"]),
                                      jbatch["betas"])


# ---- K1's launch plan ----

SOURCE = Path(gather.__file__).resolve().parents[1] / "csrc" / "gather.cu"
SWEEP = gather.THREADS * gather.UNROLL


def test_plan_constants_are_the_kernel_source_s():
    text = SOURCE.read_text()
    for name, value in (("kThreads", gather.THREADS),
                        ("kUnroll", gather.UNROLL)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1)) == value, name


@pytest.mark.parametrize("align,want", [(0x7F0000000000 | 2048, 16),
                                        (655_368, 8), (12, 4), (6, 2),
                                        (0x7F0000000200 | 333, 1), (32, 16)])
def test_vector_bytes_is_the_widest_dividing_load(align, want):
    assert vector_bytes(align) == want


# (row bytes, vector bytes) -> (threads, pieces, piece's vectors, stream):
# the stores the port gathers from, then every edge of the plan
PLANS = {
    "pca 2 KB": ((2_048, 16), (128, 1, 128, 1)),
    "img_nic 401,408 B": ((401_408, 16), (256, 25, 1_004, 1)),
    "cnn_rnn 512 KB": ((524_288, 16), (256, 32, 1_024, 1)),
    "lc_nic 1.64 MB": ((1_638_400, 16), (256, 200, 512, 0)),
    "flagship 1.89 MB": ((1_890_304, 16), (256, 231, 512, 0)),
    "flagship raw bf16": ((655_368, 8), (256, 81, 1_012, 1)),
    "one vector": ((4, 4), (32, 1, 1, 1)),
    "three bf16 vectors": ((6, 2), (32, 1, 3, 1)),
    "a warp": ((512, 16), (32, 1, 32, 1)),
    "a vector past it": ((528, 16), (64, 1, 33, 1)),
    "a whole block, one vector a thread": ((4_096, 16), (256, 1, 256, 1)),
    "a vector past it, two a thread": ((4_112, 16), (256, 1, 257, 1)),
    "the last whole row": ((16_368, 16), (256, 1, 1_023, 1)),
    "a block's sweep": ((16_384, 16), (256, 1, 1_024, 1)),
    "a vector past it, two pieces": ((16_400, 16), (256, 2, 513, 1)),
    "the last streamed row": ((1_048_560, 16), (256, 64, 1_024, 1)),
    "1 MiB, half sweeps": ((1_048_576, 16), (256, 128, 512, 0)),
    "a vector past it": ((1_048_592, 16), (256, 129, 509, 0)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_by_row_bytes(name):
    args, want = PLANS[name]
    assert gather_plan(*args) == GatherPlan(args[1], *want)


def walk(plan: GatherPlan, row_vecs: int, n_rows: int) -> np.ndarray:
    """How many times csrc/gather.cu's kernel, launched under ``plan``,
    copies each vector of each row: a (piece, row) grid, each block's
    threads over their piece in ``UNROLL`` rounds of ``threads``."""
    copies = np.zeros((n_rows, row_vecs), np.int64)
    for r in range(n_rows):
        for piece in range(plan.pieces):
            begin = piece * plan.piece_vecs
            end = min(begin + plan.piece_vecs, row_vecs)
            for t in range(plan.threads):
                for u in range(gather.UNROLL):
                    i = begin + t + u * plan.threads
                    if i < end:
                        copies[r, i] += 1
    return copies


@pytest.mark.parametrize("row_vecs", [1, 3, 31, 32, 33, 127, 128, 129, 255,
                                      256, 257, 511, 1_023, 1_024, 1_025,
                                      2_049, 25_088, 65_535, 65_536, 70_001])
def test_plan_copies_every_vector_once(row_vecs):
    """The plan's blocks, in the kernel's loops, cover each row exactly; a
    row under a sweep has one block of a thread a vector (a warp at least,
    ``THREADS`` at most); no piece is empty or longer than its block's
    sweep (half a sweep from ``WIDE_ROW``, where loads stop streaming), and
    pieces differ by less than their number."""
    plan = gather_plan(row_vecs * 16, 16)
    assert (walk(plan, row_vecs, 3) == 1).all()
    assert plan.threads % gather.WARP == 0
    assert gather.WARP <= plan.threads <= gather.THREADS
    assert 1 <= plan.piece_vecs <= plan.threads * gather.UNROLL
    assert (plan.pieces - 1) * plan.piece_vecs < row_vecs
    assert plan.pieces * plan.piece_vecs >= row_vecs
    if row_vecs < SWEEP:
        assert plan.pieces == 1
        assert plan.threads == min(gather.THREADS,
                                   -(-row_vecs // gather.WARP) * gather.WARP)
    else:
        assert plan.threads == gather.THREADS
        assert plan.piece_vecs - (row_vecs - (plan.pieces - 1)
                                  * plan.piece_vecs) < plan.pieces
    wide = row_vecs * 16 >= gather.WIDE_ROW
    assert plan.stream == (not wide)
    assert not wide or plan.piece_vecs <= SWEEP // 2


@pytest.mark.parametrize("threads", [32, 96, 256])
def test_other_blocks_and_pieces_cover_the_row(threads):
    for row_vecs, pieces in ((100, 1), (3_000, 3), (3_000, 12), (70, 4)):
        piece_vecs = -(-row_vecs // pieces)
        if piece_vecs <= threads * gather.UNROLL:
            plan = GatherPlan(16, threads, pieces, piece_vecs, 0)
            assert (walk(plan, row_vecs, 2) == 1).all()


def test_timing_script_on_the_cpu():
    """``scripts.gather_timing`` at a small size on the CPU: K1's plain
    version held to itself, both gathers timed by the host clock alone, no
    device time claimed, and the plans around K1's own in reach."""
    from masters_thesis_tpu_torch.scripts import gather_timing

    out = gather_timing.run(["pca", "img_nic"], batch=8, turns=2,
                            device="cpu",
                            stores={"pca": (40, 512), "img_nic": (20, 4_100)})
    for result in out.values():
        for name in ("K1", "index_select"):
            assert "device_us" not in result[name]
            assert len(result[name]["events_us"]) == 2
            assert result[name]["host_us"] > 0
        assert result["bound_us"] > 0
    plans = gather_timing.candidate_plans(torch.empty(2, 4_100))
    assert plans["plan"] == gather_plan(16_400, 16)
    assert {p.pieces for p in plans.values()} == {2, 4, 8}
