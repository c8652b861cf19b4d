"""The whole-decode CUDA kernel (K2) against its plain PyTorch version on the
card, at a small shape and at flagship LcNIC width, and through the greedy
decoders. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA
Hopper GPU and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.ops import fused_decode

pytestmark = pytest.mark.cuda

# flagship: bench.py's synthetic layout and the lc_NIC widths
SHAPES = {
    "small": dict(n_voxels=512, n_groups=8, units=16, group_size=4,
                  embedding_text=8, attn_units=8, vocab_size=40,
                  max_length=6, batch=6),
    "flagship": dict(n_voxels=327_684, n_groups=360, units=512,
                     group_size=32, embedding_text=512, attn_units=32,
                     vocab_size=5001, max_length=15, batch=64),
}
# floor on distinct greedy words under spread_for_check, so that the
# comparison is not between a few constant ids
MIN_DISTINCT = {"small": 6, "flagship": 16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model_and_betas(device, shape, true_vocab=0):
    cfg = dict(SHAPES[shape])
    n_voxels, n_groups, batch = (cfg.pop(k) for k in
                                 ("n_voxels", "n_groups", "batch"))
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=0),
                         n_voxels)
    gen = torch.Generator().manual_seed(0)
    model = LcNIC(layout, true_vocab=true_vocab, generator=gen, **cfg)
    fused_decode.spread_for_check(model, gen)
    betas = torch.randn(batch, n_voxels, generator=gen)
    return model.to(device).eval(), betas.to(device)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_plain_version(cuda, shape):
    model, betas = _model_and_betas(cuda, shape)
    T = model.max_length
    with torch.inference_mode():
        inputs = fused_decode.decode_inputs(model, betas, 1)
        before = fused_decode.fused_greedy_decode.launches
        words, alphas = fused_decode.fused_greedy_decode(*inputs,
                                                         max_length=T)
        torch.cuda.synchronize()
        ref_words, ref_alphas, margins = (
            fused_decode.fused_greedy_decode_reference(
                *inputs, max_length=T, return_margins=True))
    assert fused_decode.fused_greedy_decode.launches == before + 1
    assert words.device.type == "cuda" and words.dtype == torch.int32
    assert words.shape == (len(betas), T)
    assert alphas.shape == (len(betas), T, inputs[0].shape[1])
    report = fused_decode.compare_with_reference(
        words, alphas, ref_words, ref_alphas, margins)
    assert report["bad_rows"] == [], report
    # rows that took another word at a near-tie stay a small minority
    assert report["near_tie_rows"] <= len(betas) // 4, report
    assert len(torch.unique(ref_words)) >= MIN_DISTINCT[shape]


def test_padded_vocab_never_wins_on_the_card(cuda):
    model, betas = _model_and_betas(cuda, "small", true_vocab=33)
    with torch.no_grad():
        model.dense_out.bias[33:] = 1e6     # padded ids would win unmasked
    words, _ = fused_decode.make_whole_fused_greedy_decoder(model, 6)(betas,
                                                                      1)
    assert int(words.max()) < 33


def test_fused_decoder_matches_unfused_greedy(cuda):
    model, betas = _model_and_betas(cuda, "small")
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(model, 6)(
        betas, 1)
    ref_words, logits, ref_alphas = make_greedy_decoder(model, 6)(betas, 1)
    top2 = torch.topk(logits, 2, dim=-1).values
    report = fused_decode.compare_with_reference(
        words, alphas, ref_words, ref_alphas, top2[..., 0] - top2[..., 1])
    assert report["bad_rows"] == [], report


def test_kernel_refuses_wrong_dtype(cuda):
    model, betas = _model_and_betas(cuda, "small")
    with torch.inference_mode():
        inputs = list(fused_decode.decode_inputs(model, betas, 1))
    inputs[0] = inputs[0].double()
    with pytest.raises(ValueError, match="float32"):
        fused_decode.fused_greedy_decode(*inputs, max_length=2)


def test_kernel_refuses_attention_wider_than_a_block(cuda):
    """The attention kernel gives one thread to each attention column; the
    entry point returns its own error for a wider one, and the wrapper
    raises it."""
    B, R, A, D, U, E, H, V = 2, 3, 300, 4, 8, 4, 8, 128
    z = lambda *s: torch.zeros(s, device=cuda)  # noqa: E731
    args = (z(B, R, A), z(B, R, D), z(U, A), z(A), z(A), z(1),
            z(D + E, 4 * U), z(U, 4 * U), z(4 * U), z(U, H), z(H), z(H, V),
            z(V), z(V, E), z(E), z(B, U), z(B, U))
    before = fused_decode.fused_greedy_decode.launches
    with pytest.raises(RuntimeError, match="must be <= 256"):
        fused_decode.fused_greedy_decode(*args, max_length=2)
    assert fused_decode.fused_greedy_decode.launches == before
