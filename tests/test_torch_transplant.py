"""transplant.from_flax / to_flax: the flax LcNIC tree and the port's state
dict map key for key, shape for shape, and a round trip is bit-exact."""

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.transplant import from_flax, to_flax

from torch_threads import one_thread  # noqa: F401

KW = dict(units=16, group_size=4, embedding_text=8, attn_units=8,
          vocab_size=40, max_length=5)


@pytest.fixture(scope="module")
def trees():
    layout = GroupLayout(synthetic_groups(4000, 8, seed=1), 4000)
    rng = np.random.default_rng(0)
    betas = rng.standard_normal((2, 4000)).astype(np.float32)
    tokens = np.zeros((2, 5), np.int32)
    a0 = np.zeros((2, 16), np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, JLcNIC(layout=layout, **KW).init(
            jax.random.PRNGKey(0), betas, tokens, a0, a0))
    bn = variables["batch_stats"]["encoder"]["input_bn"]
    bn["mean"] = rng.normal(size=4).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    model = LcNIC(layout, **KW, generator=torch.Generator().manual_seed(0))
    return variables, model


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_round_trip_is_bit_exact(trees):
    variables, _ = trees
    back = to_flax(from_flax(variables))
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_every_flax_key_maps_to_one_port_key_of_the_same_shape(trees):
    variables, model = trees
    state = from_flax(variables)
    port = model.state_dict()
    assert set(state) == set(port)
    assert len(state) == len(list(_leaves(variables)))
    for key, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port[key].shape), key
    # the buckets, BatchNorm statistics and head all come across by name
    assert "encoder.kernel_1" in state and "encoder.input_bn.var" in state
    assert "attention.V.bias" in state and "dense_out.kernel" in state
    model.load_state_dict(state)  # strict: no missing or unexpected keys
    np.testing.assert_array_equal(
        model.encoder.input_bn.var.numpy(),
        variables["batch_stats"]["encoder"]["input_bn"]["var"])


def test_port_init_round_trips_through_flax_layout(trees):
    """The port's own seeded weights survive to_flax -> from_flax, so a
    port-initialised model can be handed to the JAX package and back."""
    _, model = trees
    state = model.state_dict()
    back = from_flax(to_flax(state))
    assert set(back) == set(state)
    for key, tensor in state.items():
        assert torch.equal(back[key], tensor), key


def test_unknown_collection_is_refused():
    with pytest.raises(ValueError, match="collections"):
        from_flax({"params": {}, "cache": {}})
