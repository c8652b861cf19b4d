"""K1's plain version and the port's device store against the JAX package:
the row gather against the TPU kernel run in interpret mode on the packed
store, and the store's permute at upload against ``GroupLayout``. Both are
copies, so every comparison is exact."""

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
from masters_thesis_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_reference,
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
