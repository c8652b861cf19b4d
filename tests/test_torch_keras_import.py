"""The port's copy of ``utils/keras_import.py`` against the original, on a
fake Keras ``save_weights`` file in the reference's lc_NIC layout (rebuilt
here as ``tests/test_keras_import.py`` builds it): both fill the same
flax-path dict, the port's ``LcNIC`` takes it through
``transplant.from_flax`` and gives the JAX forward's logits and alphas on
it within the LcNIC tolerance (1e-5), and an h5 without the attention
block raises as the original does. h5py is on this box only: the card's
machine has none, so nothing on the card reads a Keras file."""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import jax
import torch

from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout as JLayout
from masters_thesis_tpu.utils import keras_import as jkeras
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.transplant import from_flax, to_flax
from masters_thesis_tpu_torch.utils import keras_import

from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)        # tests/test_torch_models.py
WIDTHS = dict(units=12, group_size=4, embedding_text=8, attn_units=6,
              vocab_size=30, max_length=5)
N_VOXELS, N_GROUPS, B = 96, 3, 2


def _write_fake_keras_h5(path, groups, rng):
    """The reference's save_weights names for lc_NIC, random values."""
    w = WIDTHS
    g = w["group_size"]
    arrs = {}
    with h5py.File(path, "w") as f:
        def ds(key, name, shape):
            arr = rng.standard_normal(shape).astype(np.float32)
            if "variance" in name:
                arr = np.abs(arr) + 0.1
            f.create_dataset(name, data=arr)
            arrs[key] = arr

        ds("emb", "emb_text/embeddings:0", (w["vocab_size"],
                                            w["embedding_text"]))
        ds("lk", "lstm/lstm_cell/kernel:0",
           (g + w["embedding_text"], 4 * w["units"]))
        ds("lr", "lstm/lstm_cell/recurrent_kernel:0",
           (w["units"], 4 * w["units"]))
        ds("lb", "lstm/lstm_cell/bias:0", (4 * w["units"],))
        ds("di_k", "time_distributed_nonlinear/dense/kernel:0",
           (w["units"], 256))
        ds("di_b", "time_distributed_nonlinear/dense/bias:0", (256,))
        ds("do_k", "time_distributed_softmax/dense_1/kernel:0",
           (256, w["vocab_size"]))
        ds("do_b", "time_distributed_softmax/dense_1/bias:0",
           (w["vocab_size"],))
        ds("w1", "attention/dense_2/kernel:0", (g, w["attn_units"]))
        ds("w1b", "attention/dense_2/bias:0", (w["attn_units"],))
        ds("w2", "attention/dense_3/kernel:0", (w["units"], w["attn_units"]))
        ds("w2b", "attention/dense_3/bias:0", (w["attn_units"],))
        ds("v", "attention/dense_4/kernel:0", (w["attn_units"], 1))
        ds("vb", "attention/dense_4/bias:0", (1,))
        for i, grp in enumerate(groups):
            suffix = "" if i == 0 else f"_{i}"
            ds(f"g{i}k", f"locally_dense/dense{suffix}/kernel:0",
               (len(grp), g))
            ds(f"g{i}b", f"locally_dense/dense{suffix}/bias:0", (g,))
        ds("bn_g", "locally_dense/input_bn/gamma:0", (g,))
        ds("bn_b", "locally_dense/input_bn/beta:0", (g,))
        ds("bn_mm", "locally_dense/input_bn/moving_mean:0", (g,))
        ds("bn_mv", "locally_dense/input_bn/moving_variance:0", (g,))
    return arrs


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The fake file, read by both importers onto each package's fresh
    LcNIC parameter tree."""
    groups = synthetic_groups(N_VOXELS, N_GROUPS, seed=0)
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("keras") / "model-ep001.h5")
    arrs = _write_fake_keras_h5(path, groups, rng)

    jlayout = JLayout(groups, N_VOXELS)
    jmodel = JLcNIC(layout=jlayout, **WIDTHS)
    betas = rng.standard_normal((B, N_VOXELS)).astype(np.float32)
    tokens = rng.integers(0, WIDTHS["vocab_size"],
                          (B, WIDTHS["max_length"])).astype(np.int32)
    a0 = np.zeros((B, WIDTHS["units"]), np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), betas, tokens, a0,
                                a0))
    jparams = jkeras.import_lc_nic_h5(path, variables["params"], jlayout)
    jstats = jkeras.import_bn_stats_h5(path, variables["batch_stats"])

    layout = GroupLayout(groups, N_VOXELS)
    model = LcNIC(layout, **WIDTHS,
                  generator=torch.Generator().manual_seed(0)).eval()
    tree = to_flax(model.state_dict())
    params = keras_import.import_lc_nic_h5(path, tree["params"], layout)
    stats = keras_import.import_bn_stats_h5(path, tree["batch_stats"])
    return dict(path=path, arrs=arrs, groups=groups, layout=layout,
                jmodel=jmodel, jparams=jparams, jstats=jstats, model=model,
                params=params, stats=stats, betas=betas, tokens=tokens,
                a0=a0)


def test_read_h5_weights_matches_the_original(imported):
    got = keras_import.read_h5_weights(imported["path"])
    want = jkeras.read_h5_weights(imported["path"])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_import_fills_the_jax_flax_path_dict(imported):
    """Every leaf of the original's import, by the same path and shape,
    equal; the bucket rows past a group's size stay zero."""
    got = dict(_flat(imported["params"]))
    want = dict(_flat(imported["jparams"]))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("mean", "var"):
        np.testing.assert_array_equal(
            imported["stats"]["encoder"]["input_bn"][name],
            imported["jstats"]["encoder"]["input_bn"][name])
    arrs, layout = imported["arrs"], imported["layout"]
    np.testing.assert_array_equal(imported["params"]["embedding"],
                                  arrs["emb"])
    for b, bucket in enumerate(layout.buckets):
        for row, gid in enumerate(bucket.group_ids):
            size = len(imported["groups"][gid])
            kernel = imported["params"]["encoder"][f"kernel_{b}"][row]
            np.testing.assert_array_equal(kernel[:size], arrs[f"g{gid}k"])
            assert np.all(kernel[size:] == 0)


def test_imported_weights_give_the_jax_forward(imported):
    """transplant.from_flax loads the imported dict into the port's LcNIC
    key for key, and its teacher-forced forward gives the JAX model's
    logits and alphas on the same imported weights."""
    model = imported["model"]
    missing, unexpected = model.load_state_dict(from_flax(
        {"params": imported["params"], "batch_stats": imported["stats"]}),
        strict=True)
    assert not missing and not unexpected
    want_logits, want_alphas = imported["jmodel"].apply(
        {"params": imported["jparams"], "batch_stats": imported["jstats"]},
        imported["betas"], imported["tokens"], imported["a0"],
        imported["a0"], training=False)
    with torch.no_grad():
        logits, alphas = model(torch.from_numpy(imported["betas"]),
                               torch.from_numpy(imported["tokens"]).long(),
                               torch.from_numpy(imported["a0"]),
                               torch.from_numpy(imported["a0"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want_alphas), **TOL)


def test_import_raises_when_attention_missing(tmp_path):
    """An h5 whose attention sub-Denses cannot be found fails fast in both
    packages, with the same message, rather than leave attention at its
    random init."""
    path = tmp_path / "w.h5"
    with h5py.File(path, "w") as f:
        for name, shape in (
                ("emb_text/emb_text/embeddings:0", (50, 16)),
                ("lstm/lstm/kernel:0", (24, 128)),
                ("lstm/lstm/recurrent_kernel:0", (32, 128)),
                ("lstm/lstm/bias:0", (128,)),
                ("time_distributed_softmax/dense_1/kernel:0", (32, 50)),
                ("time_distributed_softmax/dense_1/bias:0", (50,)),
                ("time_distributed_nonlinear/dense_0/kernel:0", (32, 32)),
                ("time_distributed_nonlinear/dense_0/bias:0", (32,))):
            f.create_dataset(name, data=np.zeros(shape, np.float32))
    groups = [np.arange(i * 8, (i + 1) * 8) for i in range(4)]
    layout = GroupLayout(groups, 32)
    model = LcNIC(layout, units=32, group_size=8, embedding_text=16,
                  attn_units=8, vocab_size=50, max_length=5)
    params = to_flax(model.state_dict())["params"]
    with pytest.raises(KeyError, match="attention") as got:
        keras_import.import_lc_nic_h5(str(path), params, layout)
    with pytest.raises(KeyError, match="attention") as want:
        jkeras.import_lc_nic_h5(str(path), params, JLayout(groups, 32))
    assert str(got.value) == str(want.value)


def test_bn_stats_without_moving_statistics_pass_through(tmp_path):
    path = tmp_path / "w.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("emb_text/embeddings:0",
                         data=np.zeros((3, 2), np.float32))
    stats = {"encoder": {"input_bn": {"mean": np.zeros(4),
                                      "var": np.ones(4)}}}
    assert keras_import.import_bn_stats_h5(str(path), stats) is stats
    assert jkeras.import_bn_stats_h5(str(path), stats) is stats
