"""On the card: Show, Attend and Tell from pixels on EfficientNet-B3 at the
benchmark's configuration (300 x 300, the published widths, the weights'
rule of ``port_bench/reference/cnn_rnn_efficientnet.py``), batch 8. The
port's patches against the plain reference's in fp32, also with cuDNN's
TF32 flag at PyTorch's default, where the encoder still convolves in fp32
and the reference under the flag lies far off; and the whole greedy
decode through K3 on the top map's 100 regions, held to the fp32
reference within the cell's limits. A CUDA kernel has no CPU mode, so
every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_efficientnet_cuda.py
"""

import json
from pathlib import Path

import pytest
import torch

from masters_thesis_tpu_torch.ops import fused_decode

pytestmark = pytest.mark.cuda

PORT_BENCH = Path(__file__).resolve().parents[1] / "port_bench"
CELL, CONFIG = "cnnrnn_effnetb3_eval_greedy", "cnn_rnn_efficientnet_b3"
B = 8
# the CPU tests' tolerance of the patches (tests/
# test_torch_inception_captioner.py: the port 0.9e-5 to 1.8e-5 x max from
# the reference there)
PATCH_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_efficientnet_patches_and_decode_match_the_reference(cuda):
    """The port's top-map patches of 8 images within ``PATCH_TOL`` x max
    of the reference's, with cuDNN's flag off and at PyTorch's default
    (True; the encoder turns it off for its backbone and gives it back),
    where the reference lies over 20 times farther; the decode through K3
    (words, alphas on 100 regions) within the cell's limits, its words
    varied."""
    from port_bench.harness import port
    from port_bench.programs import cnn_rnn_efficientnet as program
    from port_bench.reference import cnn_rnn_efficientnet as ref
    from port_bench.reference import compare

    cfg = json.loads((PORT_BENCH / "configs" / f"{CONFIG}.json").read_text())
    limits = json.loads((PORT_BENCH / "limits" / f"{CELL}.json")
                        .read_text())
    start = cfg["tokens"]["start"]
    w = ref.weights(cfg, 2**40 + 300, cuda)
    model = port.model(cfg, w, cuda).eval()
    rows = ref.draw_rows(cfg, B, torch.Generator(device=cuda).manual_seed(5),
                         cuda)
    stored = program.to_store(model, rows)
    images = stored.view(B, *model.row_shape)
    with torch.no_grad():
        want = ref.encode_patches(w, cfg, rows)
    with torch.inference_mode():
        fp32 = model.encoder.backbone(images)["patches"]
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            guarded = model.encoder(stored)
        assert torch.backends.cudnn.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.no_grad():
            tf32 = ref.encode_patches(w, cfg, rows)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        unguarded = model.encoder(stored)
    assert fp32.shape == want.shape == (B, 100, 1536)
    assert _rel_gap(fp32, want) <= PATCH_TOL
    assert torch.equal(guarded, unguarded)
    assert _rel_gap(tf32, want) > 20 * PATCH_TOL
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(
        model, cfg["max_length"])(stored, start)
    torch.cuda.synchronize()
    assert alphas.shape == (B, cfg["max_length"], 100)
    assert len(torch.unique(words)) >= 3
    tokens = torch.cat([torch.full_like(words[:, :1], start),
                        words[:, :-1].long()], dim=1)
    with torch.no_grad():
        logits, ref_alphas = ref.teacher_forced(w, cfg, rows, tokens)
    ok, readings = compare.verdict(
        compare.decode_readings(logits, ref_alphas, words, alphas), limits)
    assert ok, readings
