"""Show, Attend and Tell from pixels on EfficientNet-B3: what only this
backbone has, against the benchmark's plain reference
(``port_bench/reference/cnn_rnn_efficientnet.py``, written from Keras'
``efficientnet.py`` and importing nothing of the port), at the published
widths. The cases it shares with InceptionV3 (patches, the decode through
``make_whole_fused_greedy_decoder`` and ``serve.Captioner``, the rows'
shape, the layout, the lower precision, the TF32 flag, the faults of a
squeeze-and-excitation gate left out and a residual dropped, and the
``features`` output) are ``tests/test_torch_inception_captioner.py``'s,
run over both backbones.

Here: the top map's side and the module's 130 convolutions against the
reference's layer table; ``model_for`` and ``CnnRnnNIC`` choosing the
backbone by name and refusing an unknown one; the training refusal naming
the backbone it would have trained; ``features --backbone
efficientnet_b3`` giving, bit for bit, what the block gave before its
span (its arithmetic written out here as it was); ``spread_for_check`` on
the pixel encoder; the weights' rule keeping the patches like drawn patch
rows. Every comparison but the rule's is exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.models import efficientnet
from masters_thesis_tpu_torch.models.encoders import (
    DEFAULT_BACKBONE,
    PIXEL_BACKBONES,
    PixelPatchDense,
)
from masters_thesis_tpu_torch.models.nic import CnnRnnNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.train.state import model_for
from port_bench.programs import cnn_rnn_efficientnet as program
from port_bench.reference import cnn_rnn_efficientnet as ref

from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


def small_config(**changes) -> Config:
    return Config(model="cnn_rnn", units=16, max_length=6, top_k=30,
                  **changes)


@pytest.mark.parametrize("size, side", [(33, 2), (64, 2), (96, 3),
                                        (128, 4), (300, 10)])
def test_grid_is_the_reference_top_side(size, side):
    assert efficientnet.grid(size) == ref.top_side(size) == side


def test_module_is_the_reference_layer_table():
    """The port's EfficientNet-B3 convolves as ``LAYERS`` does, layer by
    layer in Keras' order: 130 convolutions (26 of them depthwise), each
    kernel's shape, stride and groups; 10.59 M kernel values; and the
    reference's blocks skip where the port's do."""
    net, res = efficientnet.efficientnet("b3")
    assert res == 300
    layers = program.convolutions(net)
    assert [name for _, name in layers] == [row[0] for row in ref.LAYERS]
    assert len(layers) == 130
    for layer, (name, cin, cout, k, stride, groups, kind) in zip(
            (m for m, _ in layers), ref.LAYERS):
        conv = getattr(layer, "conv", layer)
        assert tuple(conv.kernel.shape) == (k, k, cin // groups, cout), name
        assert conv.strides == (stride, stride) and conv.groups == groups
        assert (conv.bias is not None) == (kind == "se"), name
    assert sum(name.endswith("_dwconv") for name, *_ in ref.LAYERS) == 26
    assert sum(layer.conv.kernel.numel() if hasattr(layer, "conv")
               else layer.kernel.numel() for layer, _ in layers) == 10_588_856
    for i, (name, cin, cout, _, stride, _) in enumerate(ref.BLOCKS):
        assert getattr(net, f"block{i}").skip == (stride == 1
                                                  and cin == cout), name


def test_model_for_picks_the_backbone_it_is_named():
    cfg = small_config()
    named = model_for(cfg, row_shape=(96, 96, 3), backbone="efficientnet_b3")
    default = model_for(cfg, row_shape=(96, 96, 3))
    assert DEFAULT_BACKBONE == "inception_v3"
    assert type(named.encoder) is type(default.encoder) is PixelPatchDense
    assert named.encoder.backbone_name == "efficientnet_b3"
    assert type(named.encoder.backbone) is efficientnet.EfficientNet
    assert default.encoder.backbone_name == "inception_v3"
    assert named.row_shape == default.row_shape == (96, 96, 3)
    assert named.encoder.proj.kernel.shape == (1536, 256)
    assert default.encoder.proj.kernel.shape == (2048, 256)
    direct = CnnRnnNIC(image_size=(64, 64), backbone="efficientnet_b3",
                       units=16, max_length=6)
    assert direct.encoder.backbone_name == "efficientnet_b3"
    assert direct.encoder.proj.kernel.shape == (1536, 256)
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(
        direct.eval(), 6)(torch.zeros(2, 64 * 64 * 3), 2)
    assert words.shape == (2, 6) and alphas.shape == (2, 6, 4)
    assert sorted(PIXEL_BACKBONES) == ["efficientnet_b3", "inception_v3"]


@pytest.mark.parametrize("row_shape", [(64, 64, 3), (4, 2048)])
def test_model_for_refuses_an_unknown_backbone(row_shape):
    with pytest.raises(ValueError, match="backbone 'resnet50'"):
        model_for(small_config(), row_shape=row_shape, backbone="resnet50")
    with pytest.raises(ValueError, match="backbone 'efficientnet_b0'"):
        CnnRnnNIC(image_size=(64, 64), backbone="efficientnet_b0")


def test_training_refusal_names_the_backbone_it_would_train(tmp_path,
                                                            monkeypatch):
    """``run_training`` builds through ``model_for`` with its default
    backbone: the refusal names that backbone and how to train on its
    patches instead."""
    cfg = small_config(log=str(tmp_path))
    split, pairs, tok, store, groups = experiment.build_data(cfg, 12)
    images = np.zeros((len(store.keys), 64, 64, 3), np.float32)
    monkeypatch.setattr(experiment, "build_data", lambda *a: (
        split, pairs, tok, ArrayStore(images, store.keys, device="cpu"),
        groups))
    with pytest.raises(ValueError) as refused:
        experiment.run_training(cfg, epochs=1, smoke_keys=12, device="cpu")
    text = str(refused.value)
    assert "does not train InceptionV3" in text
    assert "the inception_v3 backbone" in text
    assert "features --backbone inception_v3 --pack" in text


def block_before_its_span(block, x):
    """``efficientnet.MBConv.forward`` as it was before the span
    ``encode.depthwise_se``: the same operations in the same order."""
    inp = x
    if block.expand is not None:
        x = block.expand(x)
    x = block.depthwise(x)
    se = x.mean(dim=(2, 3), keepdim=True)
    se = torch.sigmoid(block.se_expand(F.silu(block.se_reduce(se))))
    x = block.project(x * se)
    if block.skip:
        x = x + inp
    return x


def test_features_output_is_as_before_the_span(tmp_path, capsys,
                                               monkeypatch):
    """``features --backbone efficientnet_b3`` (seed 0) writes, bit for
    bit, what the network gives with each block run as before the span,
    with the span's profiler off and on."""
    from masters_thesis_tpu_torch import cli

    images = np.random.default_rng(4).integers(0, 256, (3, 64, 64, 3))
    np.save(tmp_path / "imgs.npy", images.astype(np.uint8))
    assert cli.main(["features", "--backbone", "efficientnet_b3",
                     "--images", str(tmp_path / "imgs.npy"), "--out",
                     str(tmp_path / "f.npy"), "--batch-size", "3",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    got = np.load(tmp_path / "f.npy")
    net, _ = efficientnet.efficientnet(
        "b3", generator=torch.Generator().manual_seed(0))
    net.eval()
    x = torch.from_numpy(efficientnet.preprocess(images))
    with torch.inference_mode():
        now = net(x)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            traced = net(x)
    monkeypatch.setattr(efficientnet.MBConv, "forward",
                        block_before_its_span)
    with torch.inference_mode():
        before = net(x)
    np.testing.assert_array_equal(got, before["pooled"].numpy())
    for head in ("pooled", "patches"):
        assert torch.equal(now[head], before[head])
        assert torch.equal(traced[head], before[head])


def test_spread_for_check_takes_the_pixel_encoder():
    """``spread_for_check`` accepts the EfficientNet pixel encoder: the
    squeeze-and-excitation biases and the backbone's BatchNorm shifts
    become seeded values, and a decode of it then runs."""
    model = CnnRnnNIC(embed_dim=8, units=16, vocab_size=40, max_length=5,
                      image_size=(64, 64), backbone="efficientnet_b3",
                      generator=torch.Generator().manual_seed(0)).eval()
    se = model.encoder.backbone.block3.se_reduce.bias
    shift = model.encoder.backbone.block3.depthwise.bn.bias
    assert not se.any() and not shift.any()
    fused_decode.spread_for_check(model, torch.Generator().manual_seed(1))
    assert se.abs().min() > 0 and shift.abs().min() > 0
    rows = torch.randn(4, 64 * 64 * 3,
                       generator=torch.Generator().manual_seed(2))
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(
        model, 5)(rows, 2)
    assert words.shape == (4, 5) and torch.isfinite(alphas).all()


def test_weights_keep_the_patches_like_drawn_patch_rows():
    """At 96 x 96, under the benchmark's rule: post-swish patches (least
    above swish's minimum, -0.2785) with a mean in 0.1-2, as
    ``cnn_rnn``'s drawn rows, that differ image to image; the same seed
    draws the same weights. The statistics come from 89 images there
    (800 top-map positions), from 8 at 300 x 300."""
    cfg = {"model": "cnn_rnn_efficientnet", "image_size": [96, 96],
           "n_patches": 9, "in_channels": 1536, "embed_dim": 256,
           "units": 512, "vocab_size": 5001, "max_length": 15}
    assert ref.calibration_images(cfg) == 89
    assert ref.calibration_images(dict(cfg, image_size=[300, 300],
                                       n_patches=100)) == 8
    w = ref.weights(cfg, 2**40 + 11, CPU)
    again = ref.weights(cfg, 2**40 + 11, CPU)
    assert all(torch.equal(w[k], again[k]) for k in w)
    x = ref.draw_rows(cfg, 4, torch.Generator().manual_seed(1), CPU)
    with torch.no_grad():
        p = ref.encode_patches(w, cfg, x)
    assert float(p.min()) >= -0.2785 and 0.1 <= float(p.mean()) <= 2.0
    assert float(p.std(dim=0).mean() / p.std()) > 0.3
