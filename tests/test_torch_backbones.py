"""The port's image backbones against the JAX package's flax modules, on the
CPU: VGG16 (fc2, conv5 and logits), ResNet-50, InceptionV3 (patches and
pooled), EfficientNet-B0 and B3 (pooled), each from random-init flax
variables (BatchNorm statistics, scales and biases spread away from 0/1)
transplanted with ``transplant.from_flax``, on small images whose height and
width differ in parity, so that flax's asymmetric "SAME" padding at stride 2
shows; every head within 1e-4 x max|out|. The npz weight files of the JAX
package load into both alike, and the ``features`` command writes the JAX
command's file (flat and packed) from the same weights. TF32 is off."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu import cli as jcli
from masters_thesis_tpu_torch import cli
from masters_thesis_tpu_torch.data.pack import open_pack
from masters_thesis_tpu_torch.models import backbones
from masters_thesis_tpu_torch.models import efficientnet as efficientnet_t
from masters_thesis_tpu_torch.models import inception as inception_t
from masters_thesis_tpu_torch.models import resnet as resnet_t
from masters_thesis_tpu_torch.transplant import from_flax

from torch_threads import one_thread  # noqa: F401

jb = importlib.import_module("masters_thesis_tpu.models.backbones")
jr = importlib.import_module("masters_thesis_tpu.models.resnet")
ji = importlib.import_module("masters_thesis_tpu.models.inception")
je = importlib.import_module("masters_thesis_tpu.models.efficientnet")

TOL = 1e-4

# name: (flax module, port module, (H, W), heads)
CASES = {
    "vgg16": (lambda: jb.VGG16(), lambda: backbones.VGG16(
        image_size=(38, 35)), (38, 35), ("fc2", "conv5", "logits")),
    "resnet50": (lambda: jr.resnet("resnet50"),
                 lambda: resnet_t.resnet("resnet50"), (34, 37),
                 ("pooled", "patches")),
    "inception_v3": (lambda: ji.InceptionV3(),
                     lambda: inception_t.InceptionV3(), (76, 79),
                     ("patches", "pooled")),
    "efficientnet_b0": (lambda: je.efficientnet("b0")[0],
                        lambda: efficientnet_t.efficientnet("b0")[0],
                        (34, 37), ("pooled", "patches")),
    "efficientnet_b3": (lambda: je.efficientnet("b3")[0],
                        lambda: efficientnet_t.efficientnet("b3")[0],
                        (37, 34), ("pooled",)),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def spread(variables: dict, seed: int = 0) -> dict:
    """Random-init flax variables as numpy, with every BatchNorm statistic,
    scale and bias moved off its init value (0 or 1), so that each takes
    part in the check."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "mean":
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, dict(variables))


def flax_variables(module, hw, seed: int = 0) -> dict:
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    return spread(jax.jit(module.init)(jax.random.PRNGKey(seed), x), seed)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_backbone_matches_flax(name):
    make_flax, make_port, hw, heads = CASES[name]
    module = make_flax()
    variables = flax_variables(module, hw)
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax.jit(module.apply)(variables, x)
    model = make_port()
    model.load_state_dict(from_flax(variables))        # strict: key for key
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for head in heads:
        _close(got[head].numpy(), want[head])


@pytest.mark.parametrize("size,kernel,stride", [
    (s, k, st) for s in (1, 2, 7, 8, 33, 34) for k in (1, 2, 3, 5, 7)
    for st in (1, 2, 3)])
def test_same_padding_is_flax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert backbones.same_pads(size, kernel, stride) == tuple(want[0])


def _npz(variables: dict, path) -> None:
    """The layout of scripts/convert_*.py: '/'-joined flax paths, the
    BatchNorm statistics under ``stats/``."""
    flat = {}
    for collection, prefix in (("params", ""), ("batch_stats", "stats/")):
        for keys, leaf in jax.tree_util.tree_flatten_with_path(
                variables.get(collection, {}))[0]:
            flat[prefix + "/".join(k.key for k in keys)] = np.asarray(leaf)
    np.savez(path, **flat)


def test_load_npz_variables_gives_the_jax_outputs(tmp_path):
    hw = (33, 34)
    module = jr.resnet("resnet50")
    variables = flax_variables(module, hw, seed=3)
    _npz(variables, tmp_path / "w.npz")
    init = jax.tree_util.tree_map(np.asarray, dict(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))))
    loaded = jb.load_npz_variables(init, str(tmp_path / "w.npz"))
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax.jit(module.apply)(loaded, x)["pooled"]
    model = backbones.load_npz_variables(resnet_t.resnet("resnet50"),
                                         str(tmp_path / "w.npz"))
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x))["pooled"].numpy(), want)
    # parameters only: the BatchNorm statistics keep their init values
    params_only = backbones.load_npz_weights(resnet_t.resnet("resnet50"),
                                             str(tmp_path / "w.npz"))
    assert float(params_only.stem.bn.var.min()) == 1.0
    assert torch.equal(params_only.stem.conv.kernel,
                       torch.tensor(variables["params"]["stem"]["conv"]
                                    ["kernel"]))


def test_features_command_writes_the_jax_file(tmp_path, capsys):
    """``features`` with npz weights: the flat .npy of fc2 and the packed
    conv5 rows of ``--keys`` equal the JAX command's within 1e-4 x max,
    with a short tail batch."""
    hw = (35, 32)
    images = np.random.default_rng(4).integers(0, 255, (9, *hw, 3)).astype(
        np.uint8)
    np.save(tmp_path / "imgs.npy", images)
    np.save(tmp_path / "keys.npy", np.array([9, 2, 5, 1, 7], np.int64))
    _npz(flax_variables(jb.VGG16(), hw, seed=5), tmp_path / "w.npz")
    common = ["features", "--backbone", "vgg16", "--images",
              str(tmp_path / "imgs.npy"), "--weights", str(tmp_path / "w.npz"),
              "--batch-size", "4"]
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        assert main([*common, "--out", str(tmp_path / f"{pkg}.npy"),
                     *extra]) == 0
        assert main([*common, "--head", "conv5", "--keys",
                     str(tmp_path / "keys.npy"), "--pack", "--out",
                     str(tmp_path / f"{pkg}_pack"), *extra]) == 0
    outs = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert json.loads(outs[2])["shape"] == [9, 4096]
    assert (json.loads(outs[2]).keys() == json.loads(outs[0]).keys())
    _close(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    got = open_pack(str(tmp_path / "port_pack"))
    want = open_pack(str(tmp_path / "jax_pack"))
    assert got.keys.tolist() == want.keys.tolist() == [9, 2, 5, 1, 7]
    assert got.row_shape == want.row_shape == (4, 512)   # 2 x 2 patches
    _close(np.asarray(got.data), np.asarray(want.data))
