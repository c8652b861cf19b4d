"""The port's GRU whole-decode path (K3's plain PyTorch version) against the
JAX package's GRU whole-decode kernel, run in Pallas interpret mode on the
CPU, and against the JAX XLA greedy decoder; K2's plain version under other
head and attention activations against the JAX K2; and the port's Captioner
on a CnnRnn model against the JAX Captioner. The same transplanted weights
and numpy inputs give identical words and alphas within 1e-5 (fp32; only the
summation order differs)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_cnn_rnn import C, EMB, T, nic_pair

from masters_thesis_tpu.data.tokenizer import Tokenizer
from masters_thesis_tpu.decode.greedy import make_greedy_decoder as j_greedy
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.group_layout import GroupLayout as jGroupLayout
from masters_thesis_tpu.ops.fused_decode import (
    make_whole_fused_greedy_decoder as j_fused,
)
from masters_thesis_tpu.serve import Captioner as JCaptioner
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.models.encoders import PatchDense
from masters_thesis_tpu_torch.models.nic import NIC, CnnRnnNIC, LcNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.transplant import to_flax

START = 1
TOL = dict(rtol=1e-5, atol=1e-5)

# an odd region count, a padded vocab (true_vocab < vocab_size, on top of
# the kernel's own padding to 128), and an attention (= units) wider than a
# 256-thread block
GRU_CASES = {
    "regions_5": dict(patches=5),
    "regions_7_padded_vocab": dict(patches=7, vocab=48, true_vocab=40),
    "attention_300": dict(patches=5, units=300),
}


def _check(words, alphas, jwords, jalphas):
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(jalphas), **TOL)


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("case", list(GRU_CASES))
def test_gru_plain_version_matches_jax_kernel_and_xla_greedy(case,
                                                             zero_state):
    kw = GRU_CASES[case]
    jmodel, variables, tmodel, rows = nic_pair(zero_state, **kw)
    units = kw.get("units", tmodel.units)
    words_k, alphas_k = j_fused(jmodel, units, T)(variables, rows, START)
    words_x, _, alphas_x = j_greedy(jmodel, units, T)(variables, rows,
                                                      START)
    np.testing.assert_array_equal(np.asarray(words_k), np.asarray(words_x))

    words, alphas = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(rows), START)
    assert alphas.shape == np.asarray(alphas_k).shape        # (B, T, R)
    _check(words, alphas, words_k, alphas_k)
    _check(words, alphas, words_x, alphas_x)
    # the port's unfused decoder takes the same words
    words_u, _, alphas_u = make_greedy_decoder(tmodel, T)(
        torch.from_numpy(rows), START)
    _check(words_u, alphas_u, words_x, alphas_x)
    # the words are not one constant: the comparison has teeth
    assert len(np.unique(words.numpy())) > 2
    if "true_vocab" in kw:
        assert int(words.max()) < kw["true_vocab"]


def test_gru_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version without counting
    a launch; a tensor on neither the CPU nor CUDA is refused."""
    _, _, tmodel, rows = nic_pair(True)
    opts = fused_decode.decode_options(tmodel)
    assert opts == {"slope": 1.0, "attn_slope": 1.0, "zero_state": True}
    with torch.inference_mode():
        args = fused_decode.decode_inputs(tmodel, torch.from_numpy(rows),
                                          START)
        before = fused_decode.fused_greedy_decode_gru.launches
        got = fused_decode.fused_greedy_decode_gru(*args, max_length=T,
                                                   **opts)
        want = fused_decode.fused_greedy_decode_gru_reference(
            *args, max_length=T, **opts)
    assert fused_decode.fused_greedy_decode_gru.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = [torch.zeros(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        fused_decode.fused_greedy_decode_gru(*meta, max_length=2)


@pytest.mark.parametrize("dropped", ["b2", "b_in", "b_rec", "bi", "bo",
                                     "encoder"])
def test_spread_weights_expose_a_dropped_gru_parameter(dropped):
    """Under ``spread_for_check`` a CnnRnn decode that lost a bias (or the
    encoder's bias) disagrees with the plain version, in zero state too,
    where the recurrent bias still enters the h~ gate."""
    gen = torch.Generator().manual_seed(0)
    model = CnnRnnNIC(embed_dim=32, units=48, vocab_size=60, max_length=T,
                      n_patches=9, in_channels=24, generator=gen).eval()
    fused_decode.spread_for_check(model, gen)
    rows = torch.randn(16, 9, 24, generator=gen)
    names = fused_decode.DECODE_ARGS["gru"]
    opts = fused_decode.decode_options(model)
    ref = fused_decode.fused_greedy_decode_gru_reference
    with torch.inference_mode():
        args = list(fused_decode.decode_inputs(model, rows, START))
        words, alphas, margins = ref(*args, max_length=T, return_margins=True,
                                     **opts)
        assert len(torch.unique(words)) >= 8
        if dropped == "encoder":
            model.encoder.proj.bias.zero_()
            args = fused_decode.decode_inputs(model, rows, START)
        else:
            i = names.index(dropped)
            args[i] = torch.where(args[i] > -1e29, 0.0, args[i])  # keep pads
        got = ref(*args, max_length=T, **opts)
    report = fused_decode.compare_with_reference(*got, words, alphas, margins)
    assert len(report["bad_rows"]) >= len(rows) // 8, report


@pytest.mark.parametrize("zero_state", [True, False])
def test_spread_weights_keep_the_full_width_gru_decode_well_conditioned(
        zero_state):
    """At the full CnnRnn width under ``spread_for_check``, the fp32 plain
    version's alphas stay within 5e-7 of the same decode in float64, well
    under the 1e-6 that ``chip_smoke.py`` holds K3 to, so that a check at
    that limit fails on a fault and not on fp32 rounding. (A x5 V under the
    linear attention makes the attention near one-hot and this drift
    ~5e-5.)"""
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(0)
    model = CnnRnnNIC(gru_zero_state=zero_state, generator=gen)
    fused_decode.spread_for_check(model, gen)
    model = model.to(cpu).eval()
    rows = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64, 2048), dtype=np.float32)).to(cpu)
    opts = fused_decode.decode_options(model)
    ref = fused_decode.fused_greedy_decode_gru_reference
    with torch.inference_mode():
        args = fused_decode.decode_inputs(model, rows, START)
        words, alphas = ref(*args, max_length=model.max_length, **opts)
        wide = [a.double() if a.is_floating_point() else a for a in args]
        words64, alphas64 = ref(*wide, max_length=model.max_length, **opts)
    assert torch.equal(words, words64)
    assert float((alphas.double() - alphas64).abs().max()) <= 5e-7
    assert len(torch.unique(words)) >= 16


ACTIVATIONS = [("linear", "linear"), ("relu", "leaky_relu"),
               ("relu", "linear")]


@pytest.mark.parametrize("head,attn", ACTIVATIONS)
def test_lstm_plain_version_with_other_activations_matches_jax_kernel(
        head, attn):
    """K2's plain version takes the head's and the attention's slopes from
    the model (linear 1, relu 0, leaky_relu 0.2), as the JAX kernel does."""
    n_voxels, units = 256, 16
    groups = synthetic_groups(n_voxels, 6, seed=0)
    layout = GroupLayout(groups, n_voxels)
    kw = dict(units=units, group_size=8, embedding_text=16, attn_units=8,
              vocab_size=40, max_length=T, head_activation=head,
              attn_inner_activation=attn)
    gen = torch.Generator().manual_seed(0)
    tmodel = LcNIC(layout, generator=gen, **kw)
    fused_decode.spread_for_check(tmodel, gen)
    tmodel.eval()
    variables = to_flax(tmodel.state_dict())
    jmodel = JLcNIC(layout=jGroupLayout(groups, n_voxels), **kw)
    betas = np.random.default_rng(0).standard_normal((8, n_voxels)).astype(
        np.float32)
    assert fused_decode.decode_options(tmodel) == {
        "slope": {"linear": 1.0, "relu": 0.0}[head],
        "attn_slope": {"linear": 1.0, "leaky_relu": 0.2}[attn]}

    words_k, alphas_k = j_fused(jmodel, units, T)(variables, betas, START)
    words_x, _, alphas_x = j_greedy(jmodel, units, T)(variables, betas,
                                                      START)
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(betas), START)
    _check(words, alphas, words_k, alphas_k)
    _check(words, alphas, words_x, alphas_x)
    assert len(np.unique(words.numpy())) > 2


@pytest.mark.parametrize("n", [1, 7])
def test_captioner_on_cnn_rnn_matches_jax_captioner(n):
    """(N, P, C) image-patch rows through the port's Captioner and the JAX
    Captioner with its GRU kernel in interpret mode: identical ids; n = 7
    with a service batch of 4 pads the last chunk."""
    jmodel, variables, tmodel, _ = nic_pair(True, seed=2)
    rows = np.random.default_rng(9).standard_normal((n, 6, C)).astype(
        np.float32)
    tok = Tokenizer(num_words=38)
    tok.fit_on_texts(["<start> a b c d e f g <end>"] * 3)
    tok.install_pad()
    jcap = JCaptioner(jmodel, variables, tok, tmodel.units, T, batch_size=4,
                      input_width=C, use_fused=True)
    cap = Captioner(tmodel, tok, tmodel.units, T, batch_size=4,
                    device="cpu")
    assert cap.input_row_shape == (6, C) and cap.input_width == C
    want = jcap.caption_ids(rows)
    got = cap.caption_ids(rows)
    assert got.shape == (n, T)
    np.testing.assert_array_equal(got, want)
    assert cap.caption(rows) == jcap.caption(rows)
    with pytest.raises(ValueError, match="input width"):
        cap.caption_ids(rows[..., :-1])


def test_nic_refuses_unknown_cells_and_activations():
    with pytest.raises(ValueError, match="cell_type"):
        NIC(PatchDense(2, 4, EMB), units=8, cell_type="rnn")
    layout = GroupLayout(synthetic_groups(64, 4), 64)
    with pytest.raises(ValueError, match="head_activation"):
        LcNIC(layout, units=8, group_size=4, embedding_text=8,
              attn_units=4, vocab_size=20, head_activation="gelu")
