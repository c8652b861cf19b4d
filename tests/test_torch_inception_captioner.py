"""Show, Attend and Tell from pixels: the port's CnnRnn with a CNN
backbone inside its encoder (``encoders.PixelPatchDense``, ``CnnRnnNIC(
image_size=..., backbone=...)``) against the benchmark's plain reference
of each backbone, which imports nothing of the port, on weights drawn by
the benchmark's rule, at the published widths on small images, batch 3:
InceptionV3 (``port_bench/reference/cnn_rnn_inception.py``, after Keras'
``inception_v3.py``) at 107 x 107 (a 2 x 2 mixed10 map, 4 patches) and
139 x 139 (9 patches); EfficientNet-B3
(``port_bench/reference/cnn_rnn_efficientnet.py``, after Keras'
``efficientnet.py``) at 64 x 64 (a 2 x 2 top map) and 96 x 96 (9
patches). ``tests/test_torch_efficientnet_captioner.py`` holds what only
EfficientNet-B3 has.

Tolerances. The random network is slightly chaotic: fp32 rounding grows
by ~15% a layer through its 94 convolutions, and the reference's own fp32
patches lie ~7e-5 x max|patch| from its float64 ones at 107 (1.5e-4 at
299). The program's convolutions on the CPU (channels-last) round more
than the reference's (NCHW) and land 1.2e-4 (107) and 1.4e-4 (139) x max
away: ``PATCH_TOL`` (5e-4 x max) leaves 3.5x room, and a dropped branch or
BatchNorm shift moves the patches by 6e-2 to 1 x max. Through the decoder
that error reaches the alphas at 1.1e-4 (107) and 3.5e-5 (139):
``ALPHA_TOL`` (1e-3) leaves 9x room, and the two faults move them by 4e-2
and 0.5. Words are held by the top-2 margin: the served word's reference
logit lies within ``LOGIT_TOL`` (1e-3) of the best at every step (0 on
these rows: every served word is the reference's best).

EfficientNet-B3's random network is not chaotic under the rule (its
BatchNorm statistics over 800 top-map positions): the reference's fp32
patches lie ~1e-5 x max from its float64 ones at 64, 96 and 300, and the
program's on the CPU 0.9e-5 to 1.8e-5 x max from the reference's (3 seeds
at each size): its ``patch_tol`` (1e-4 x max) leaves 5.5x room, and a gate
left out or a residual dropped moves the patches by 0.1 x max or more.
The alphas lie 2e-6 to 7.3e-6 from the reference's: its ``alpha_tol``
(1e-4) leaves 13x room.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch import experiment
from masters_thesis_tpu_torch.config import Config
from masters_thesis_tpu_torch.data.store import ArrayStore
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.models import (
    backbones,
    efficientnet,
    inception,
)
from masters_thesis_tpu_torch.models.encoders import (
    PatchDense,
    PixelPatchDense,
)
from masters_thesis_tpu_torch.ops.fused_decode import (
    make_whole_fused_greedy_decoder,
)
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.train.state import model_for
from port_bench.harness import port
from port_bench.programs import cnn_rnn_efficientnet, cnn_rnn_inception
from port_bench.reference import cnn_rnn_efficientnet as effnet_ref
from port_bench.reference import cnn_rnn_inception as inception_ref
from port_bench.reference import compare

from torch_threads import one_thread  # noqa: F401

LOGIT_TOL = 1e-3
B, START = 3, 2
CPU = torch.device("cpu")


class Backbone(NamedTuple):
    """A backbone's family in the benchmark (its reference and program
    modules), its module in the port, its top map's channels, the image
    sides the tests run it at, and its tolerances (the module docstring)."""

    model: str
    ref: object
    program: object
    module: object
    channels: int
    sizes: tuple
    patch_tol: float
    alpha_tol: float


BACKBONES = {
    "inception_v3": Backbone("cnn_rnn_inception", inception_ref,
                             cnn_rnn_inception, inception, 2048, (107, 139),
                             5e-4, 1e-3),
    "efficientnet_b3": Backbone("cnn_rnn_efficientnet", effnet_ref,
                                cnn_rnn_efficientnet, efficientnet, 1536,
                                (64, 96), 1e-4, 1e-4),
}
CASES = [(name, size) for name, b in BACKBONES.items() for size in b.sizes]


def config(backbone: str, size: int) -> dict:
    b = BACKBONES[backbone]
    side = b.module.grid(size)
    return {"model": b.model, "image_size": [size, size],
            "n_patches": side * side, "in_channels": b.channels,
            "embed_dim": 256, "units": 512, "vocab_size": 5001,
            "max_length": 15}


def build(backbone: str, size: int) -> tuple:
    """(backbone, cfg, reference weights, the program's model holding
    them, raw pixel rows (B, H·W·3))."""
    b = BACKBONES[backbone]
    cfg = config(backbone, size)
    w = b.ref.weights(cfg, 2**40 + size, CPU)
    model = port.model(cfg, w, CPU).eval()
    rows = b.ref.draw_rows(cfg, B, torch.Generator().manual_seed(5), CPU)
    return b, cfg, w, model, rows


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{name}-{size}" for name, size in CASES])
def pair(request):
    return build(*request.param)


def patch_gap(b, model, w, cfg, rows) -> float:
    """The program's top-map patches against the reference's, over the
    reference's largest."""
    stored = b.program.to_store(model, rows)
    with torch.inference_mode():
        got = model.encoder.backbone(stored.view(
            B, *model.row_shape))["patches"]
        want = b.ref.encode_patches(w, cfg, rows)
    return float((got - want).abs().max() / want.abs().max())


def readings(b, w, cfg, rows, words, alphas) -> dict:
    """``logit_gap`` and ``alpha_err`` of served words and alphas against
    the reference teacher-forced on the same words."""
    tokens = torch.cat([torch.full_like(words[:, :1], START),
                        words[:, :-1].long()], dim=1)
    with torch.no_grad():
        logits, want = b.ref.teacher_forced(w, cfg, rows, tokens)
    return compare.decode_readings(logits, want, words, alphas)


def tokenizer() -> Tokenizer:
    tok = Tokenizer(num_words=38)
    tok.fit_on_texts(["<start> a b c d e f g <end>"] * 3)
    tok.install_pad()
    return tok


def test_grid_is_the_reference_side():
    for size, side in ((75, 1), (107, 2), (139, 3), (299, 8)):
        assert inception.grid(size) == inception_ref.sides(size)["s7"] \
            == side
    with pytest.raises(ValueError, match="75 or more"):
        inception.grid(74)


def test_patches_match_the_reference(pair):
    b, cfg, w, model, rows = pair
    assert model.row_shape == (*cfg["image_size"], 3)
    assert model.encoder.row_shape == model.row_shape
    assert patch_gap(b, model, w, cfg, rows) <= b.patch_tol


@pytest.mark.parametrize("route", ["decoder", "captioner"])
def test_greedy_words_and_alphas_match_the_reference(pair, route):
    """The decode kernel's plain version on flat rows, and ``Captioner`` on
    (B, H, W, 3) images: the same words, held by the reference's top-2
    margin, and the kernel's alphas."""
    b, cfg, w, model, rows = pair
    stored = b.program.to_store(model, rows)
    decode = make_whole_fused_greedy_decoder(model, cfg["max_length"])
    words, alphas = decode(stored, START)
    assert words.shape == (B, cfg["max_length"])
    assert alphas.shape == (B, cfg["max_length"], cfg["n_patches"])
    if route == "captioner":
        cap = Captioner(model, tokenizer(), cfg["units"], cfg["max_length"],
                        batch_size=2, device="cpu")
        assert cap.input_row_shape == (*cfg["image_size"], 3)
        images = stored.view(B, *cap.input_row_shape).numpy()
        served = cap.caption_ids(images)            # a padded second chunk
        np.testing.assert_array_equal(served, words.numpy())
    r = readings(b, w, cfg, rows, words, alphas)
    assert r["logit_gap"] <= LOGIT_TOL and r["alpha_err"] <= b.alpha_tol, r
    assert len(torch.unique(words)) >= 3


def test_captioner_holds_image_rows_to_the_whole_shape(pair):
    _, cfg, _, model, rows = pair
    cap = Captioner(model, tokenizer(), cfg["units"], cfg["max_length"],
                    device="cpu")
    h, wd = cfg["image_size"]
    images = rows.view(B, h, wd, 3).numpy()
    with pytest.raises(ValueError, match="image rows"):
        cap.caption_ids(images[:, :-1])
    with pytest.raises(ValueError, match="image rows"):
        cap.caption_ids(images.reshape(B, -1, 3))


def test_patches_in_nchw_memory_match_the_reference(pair, monkeypatch):
    """The backbone with its activations NCHW-contiguous, the layout
    ``conv_memory_format`` picks for fp32 on CUDA without TF32 (forced
    here, on the CPU): every layer keeps it, and the patches are held to
    the reference as in the channels-last run."""
    b, cfg, w, model, rows = pair
    monkeypatch.setattr(backbones, "conv_memory_format",
                        lambda *_: torch.contiguous_format)
    assert backbones.nchw(torch.zeros(2, 5, 7, 3)).is_contiguous()
    assert patch_gap(b, model, w, cfg, rows) <= b.patch_tol


@pytest.mark.parametrize("device, dtype, tf32, layout", [
    ("cuda", torch.float32, False, torch.contiguous_format),
    ("cuda", torch.float32, True, torch.channels_last),
    ("cuda", torch.bfloat16, False, torch.channels_last),
    ("cuda", torch.float16, False, torch.channels_last),
    ("cuda", torch.bfloat16, True, torch.channels_last),
    ("cpu", torch.float32, False, torch.channels_last),
    ("cpu", torch.float32, True, torch.channels_last),
    ("cpu", torch.bfloat16, False, torch.channels_last),
])
def test_backbone_layout_follows_the_precision_in_force(device, dtype, tf32,
                                                        layout):
    """NCHW-contiguous where cuDNN's float32 kernels run (CUDA, TF32 off),
    channels-last elsewhere; on the CPU ``nchw`` gives the images
    themselves, permuted. The caller's flag is back after the test."""
    kept = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        assert backbones.conv_memory_format(device, dtype) == layout
        assert backbones.conv_memory_format(torch.device(device),
                                            dtype) == layout
        if device == "cpu":
            images = torch.arange(2 * 5 * 7 * 3, dtype=dtype).view(
                2, 5, 7, 3)
            x = backbones.nchw(images)
            assert x.data_ptr() == images.data_ptr()
            assert x.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(x, images.permute(0, 3, 1, 2))
    finally:
        torch.backends.cudnn.allow_tf32 = kept
    assert torch.backends.cudnn.allow_tf32 is kept


def test_the_reference_in_a_lower_precision_fails_the_tolerance(pair):
    """bfloat16, the nearest precision under the fp32 the configuration
    states that the CPU runs (TF32 is the card's control), moves the
    patches far past the backbone's ``patch_tol``: the tolerance can tell
    the two."""
    b, cfg, w, _, rows = pair
    low = {k: v.to(torch.bfloat16) for k, v in w.items()}
    with torch.no_grad():
        want = b.ref.encode_patches(w, cfg, rows)
        got = b.ref.encode_patches(low, cfg,
                                   rows.to(torch.bfloat16)).float()
    assert float((got - want).abs().max() / want.abs().max()) \
        > 20 * b.patch_tol


@pytest.mark.parametrize("backbone, size", [("inception_v3", 107),
                                            ("efficientnet_b3", 64)])
@pytest.mark.parametrize("flag", [True, False])
def test_backbone_convolves_without_tf32_and_keeps_the_callers_flag(
        flag, backbone, size):
    """PyTorch's default (True) lets cuDNN take TF32: the backbone runs
    with it off whatever the caller set, and the caller's value is back
    after the call, also after one that raises."""
    encoder = PixelPatchDense((size, size), 8, backbone).eval()
    channels = BACKBONES[backbone].channels
    seen = []

    def fake(images):
        seen.append(torch.backends.cudnn.allow_tf32)
        if len(seen) > 1:
            raise RuntimeError("a failing backbone")
        return {"patches": torch.zeros(images.shape[0], 4, channels)}

    encoder.backbone.forward = fake
    kept = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = flag
    try:
        encoder(torch.zeros(2, size * size * 3))
        assert torch.backends.cudnn.allow_tf32 is flag
        with pytest.raises(RuntimeError, match="a failing backbone"):
            encoder(torch.zeros(2, size * size * 3))
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = kept
    assert seen == [False, False]


def zero_pool_branch(model):
    """mixed5's average-pool branch gives zeros."""
    block = model.encoder.backbone.mixed5
    block.bpool.forward = lambda x: torch.zeros(
        x.shape[0], 192, *x.shape[2:])


def drop_one_shift(model):
    """mixed8's last BatchNorm loses its shift."""
    model.encoder.backbone.mixed8.b7x7x3_4.bn.bias.data.zero_()


def se_gate_left_out(model):
    """block10's squeeze-and-excitation gate is 1 on every channel: its
    depthwise output goes to the projection ungated."""
    block = model.encoder.backbone.block10
    block.se_expand.forward = lambda s: torch.full(
        (s.shape[0], block.se_expand.kernel.shape[-1], 1, 1), 40.0)


def residual_dropped(model):
    """block12 (stride 1, widths equal) loses its residual."""
    block = model.encoder.backbone.block12
    assert block.skip
    block.skip = False


FAULTS = [("inception_v3", zero_pool_branch), ("inception_v3", drop_one_shift),
          ("efficientnet_b3", se_gate_left_out),
          ("efficientnet_b3", residual_dropped)]


@pytest.mark.parametrize("backbone, fault", FAULTS,
                         ids=[f.__name__ for _, f in FAULTS])
def test_a_fault_fails_the_comparison(backbone, fault):
    b, cfg, w, model, rows = build(backbone, BACKBONES[backbone].sizes[0])
    fault(model)
    assert patch_gap(b, model, w, cfg, rows) > 20 * b.patch_tol
    words, alphas = make_whole_fused_greedy_decoder(
        model, cfg["max_length"])(b.program.to_store(model, rows), START)
    r = readings(b, w, cfg, rows, words, alphas)
    assert r["alpha_err"] > 5 * b.alpha_tol, r


def small_config(**changes) -> Config:
    return Config(model="cnn_rnn", units=16, max_length=6, top_k=30,
                  **changes)


def test_model_for_builds_the_pixel_encoder_from_image_rows():
    cfg = small_config()
    pixels = model_for(cfg, row_shape=(107, 107, 3))
    patches = model_for(cfg, row_shape=(4, 2048))
    assert type(pixels.encoder) is PixelPatchDense
    assert pixels.encoder.backbone_name == "inception_v3"
    assert type(patches.encoder) is PatchDense
    assert pixels.row_shape == (107, 107, 3)
    assert patches.row_shape == (4, 2048)
    shapes = {k: v.shape for k, v in pixels.state_dict().items()}
    backbone = {k for k in shapes if k.startswith("encoder.backbone.")}
    assert len([k for k in backbone if k.endswith(".conv.kernel")]) == 94
    assert {k: v for k, v in shapes.items() if k not in backbone} == {
        k: v.shape for k, v in patches.state_dict().items()}
    with pytest.raises(ValueError, match="RGB"):
        model_for(cfg, row_shape=(107, 107, 4))


def test_run_training_refuses_image_rows(tmp_path, monkeypatch):
    cfg = small_config(log=str(tmp_path))
    split, pairs, tok, store, groups = experiment.build_data(cfg, 12)
    images = np.zeros((len(store.keys), 107, 107, 3), np.float32)
    monkeypatch.setattr(experiment, "build_data", lambda *a: (
        split, pairs, tok, ArrayStore(images, store.keys, device="cpu"),
        groups))
    with pytest.raises(ValueError, match="does not train InceptionV3"):
        experiment.run_training(cfg, epochs=1, smoke_keys=12, device="cpu")


# the backbone the ``features`` command builds, its default head, and the
# image side the test feeds it
FEATURES = {
    "inception_v3": (lambda g: inception.InceptionV3(generator=g),
                     "patches", 107),
    "efficientnet_b3": (lambda g: efficientnet.efficientnet(
        "b3", generator=g)[0], "pooled", 64),
}


@pytest.mark.parametrize("backbone", list(FEATURES))
def test_features_output_is_the_backbone_of_the_pixel_encoder(
        tmp_path, capsys, backbone):
    """``features --backbone <name>`` writes what its backbone (seed 0)
    gives at its default head, and the pixel encoder's backbone, holding
    the same weights, gives the same output bit for bit."""
    from masters_thesis_tpu_torch import cli

    make, head, size = FEATURES[backbone]
    module = BACKBONES[backbone].module
    images = np.random.default_rng(3).integers(0, 256, (3, size, size, 3))
    np.save(tmp_path / "imgs.npy", images.astype(np.uint8))
    assert cli.main(["features", "--backbone", backbone, "--images",
                     str(tmp_path / "imgs.npy"), "--out",
                     str(tmp_path / "f.npy"), "--batch-size", "2",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    got = np.load(tmp_path / "f.npy")
    net = make(torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(module.preprocess(images))
    with torch.inference_mode():
        want = torch.cat([net(x[i:i + 2])[head] for i in (0, 2)]).numpy()
    np.testing.assert_array_equal(got, want)
    encoder = PixelPatchDense((size, size), 8, backbone).eval()
    encoder.backbone.load_state_dict(net.state_dict())
    with torch.inference_mode():
        # as the encoder shapes a flat (B, H·W·3) row
        mine = torch.cat([encoder.backbone(x[i:i + 2].flatten(1).view(
            -1, *encoder.row_shape))[head] for i in (0, 2)]).numpy()
    np.testing.assert_array_equal(mine, got)
