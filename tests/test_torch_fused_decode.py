"""The port's whole-decode path on the CPU (the kernel's plain PyTorch
version) against the JAX package's whole-decode kernel, which runs in Pallas
interpret mode on the CPU, and against the JAX XLA greedy decoder: the same
transplanted weights and numpy inputs give identical words and alphas within
1e-5 (fp32; only the summation order differs), also for the JAX package's
family cases (learned initial carry, frozen GloVe tables, learned-init
GRU)."""

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.synthetic import synthetic_groups
from masters_thesis_tpu.decode.greedy import make_greedy_decoder as j_greedy
from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops.fused_decode import (
    make_whole_fused_greedy_decoder as j_fused,
)
from masters_thesis_tpu.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.transplant import from_flax, to_flax

from torch_threads import one_thread  # noqa: F401

UNITS, T, START = 16, 6, 1
KW = dict(units=UNITS, group_size=4, embedding_text=8, attn_units=8,
          max_length=T)


def _pair(n_groups, vocab=40, true_vocab=0, b=6, n_voxels=256, seed=0):
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=seed),
                         n_voxels)
    kw = dict(KW, vocab_size=vocab, true_vocab=true_vocab)
    jmodel = JLcNIC(layout=layout, **kw)
    rng = np.random.default_rng(seed)
    betas = rng.standard_normal((b, n_voxels)).astype(np.float32)
    a0 = np.zeros((b, UNITS), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), betas, np.zeros((b, T), np.int32), a0, a0))
    # a wider embedding and head than the initialisers give, so greedy
    # words vary from step to step and row to row; values for the untrained
    # zero biases and BatchNorm statistics
    p = variables["params"]
    normal = lambda std, *shape: rng.normal(0, std, shape).astype(np.float32)  # noqa: E731
    p["embedding"] = p["embedding"] * 10.0
    p["dense_inter"]["kernel"] = normal(1.0, UNITS, 256)
    p["dense_out"]["kernel"] = normal(0.25, 256, vocab)
    p["dense_out"]["bias"] = normal(0.05, vocab)
    p["attention"]["V"]["bias"] = np.asarray([0.3], np.float32)
    bn = variables["batch_stats"]["encoder"]["input_bn"]
    bn["mean"] = rng.normal(0, 0.5, 4).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    tmodel = LcNIC(layout, **kw)
    tmodel.load_state_dict(from_flax(variables))
    return jmodel, variables, tmodel.eval(), betas


CASES = {
    "regions_6": dict(n_groups=6),
    "regions_5_not_a_multiple_of_8": dict(n_groups=5),
    "regions_11_padded_vocab": dict(n_groups=11, vocab=48, true_vocab=40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_kernel_and_xla_greedy(case):
    jmodel, variables, tmodel, betas = _pair(**CASES[case])
    words_k, alphas_k = j_fused(jmodel, UNITS, T)(variables, betas, START)
    words_x, _, alphas_x = j_greedy(jmodel, UNITS, T)(variables, betas, START)
    np.testing.assert_array_equal(np.asarray(words_k), np.asarray(words_x))

    words, alphas = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(betas), START)
    assert words.dtype == torch.int32 and words.shape == (len(betas), T)
    assert alphas.shape == np.asarray(alphas_k).shape       # (B, T, R)
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_k))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(alphas_k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(alphas_x),
                               rtol=1e-5, atol=1e-5)
    # the words are not one constant: the comparison has teeth
    assert len(np.unique(words.numpy())) > 2


def test_unfused_greedy_matches_jax_greedy():
    jmodel, variables, tmodel, betas = _pair(n_groups=7)
    words_x, logits_x, alphas_x = j_greedy(jmodel, UNITS, T)(
        variables, betas, START)
    words, logits, alphas = make_greedy_decoder(tmodel, T)(
        torch.from_numpy(betas), START)
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(alphas_x),
                               rtol=1e-5, atol=1e-5)


def test_padded_vocab_never_wins():
    """vocab 40 pads to 128 and the model's own padding starts at
    true_vocab 33: with a head bias that favours padded ids, the -1e30 pad
    bias must still keep every word below true_vocab."""
    _, _, tmodel, betas = _pair(n_groups=6, vocab=40, true_vocab=33)
    with torch.no_grad():
        tmodel.dense_out.bias[33:] = 1e6   # padded ids would win unmasked
    words, _ = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(betas), START)
    assert int(words.max()) < 33


def test_cpu_tensors_take_the_plain_version_without_counting():
    """On the CPU the wrapper runs the plain version: same result as calling
    it directly, no build, and the launch counter does not move."""
    _, _, tmodel, betas = _pair(n_groups=6)
    before = fused_decode.fused_greedy_decode.launches
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(betas), START)
    assert fused_decode.fused_greedy_decode.launches == before
    assert torch.isfinite(alphas).all()
    torch.testing.assert_close(alphas.sum(-1), torch.ones(len(betas), T))


def test_compare_with_reference_tells_near_ties_from_faults():
    """Row 0 agrees; row 1 takes another word at a near-tie and drifts
    after it; row 2 takes another word at a clear margin; row 3 agrees on
    words but its alphas are off; row 4 has a NaN alpha."""
    ref_words = torch.tensor([[3, 4, 5]] * 5, dtype=torch.int32)
    ref_alphas = torch.full((5, 3, 2), 0.5)
    margins = torch.full((5, 3), 0.5)
    margins[1, 1] = 1e-4
    words, alphas = ref_words.clone(), ref_alphas.clone()
    words[1, 1:] = torch.tensor([7, 8], dtype=torch.int32)
    alphas[1, 2] = torch.tensor([0.9, 0.1])      # after the tie: not held
    words[2, 2] = 9
    alphas[3, 0, 0] += 1e-3
    alphas[4, 2, 1] = float("nan")
    report = fused_decode.compare_with_reference(
        words, alphas, ref_words, ref_alphas, margins)
    assert report["bad_rows"] == [2, 3, 4]
    assert report["near_tie_rows"] == 1
    ok = fused_decode.compare_with_reference(
        words[:2], alphas[:2], ref_words[:2], ref_alphas[:2], margins[:2])
    assert ok == {"bad_rows": [], "near_tie_rows": 1, "max_abs_err": 0.0}


DECODE_ARGS = ("pre features w2 b2 v bv wx wh b wi bi wo bo emb_table emb0 "
               "h0 c0").split()


@pytest.mark.parametrize("dropped", ["b2", "b", "bi", "bo", "input_bn"])
def test_spread_weights_expose_a_dropped_parameter(dropped):
    """Under ``spread_for_check`` the greedy words vary, and a decode that
    lost one bias (or ran BatchNorm with its default statistics) disagrees
    with the plain version: the on-card check of the kernel, which uses
    these weights, would catch a kernel that drops it. ``bv`` is left out:
    softmax over regions cancels it exactly."""
    layout = GroupLayout(synthetic_groups(512, 8, seed=0), 512)
    gen = torch.Generator().manual_seed(0)
    model = LcNIC(layout, generator=gen, vocab_size=40, **KW).eval()
    fused_decode.spread_for_check(model, gen)
    betas = torch.randn(16, 512, generator=gen)
    with torch.inference_mode():
        args = list(fused_decode.decode_inputs(model, betas, START))
        words, alphas, margins = fused_decode.fused_greedy_decode_reference(
            *args, max_length=T, return_margins=True)
        assert len(torch.unique(words)) >= 12
        if dropped == "input_bn":
            bn = model.encoder.input_bn
            for t, default in ((bn.scale, 1.0), (bn.bias, 0.0),
                               (bn.mean, 0.0), (bn.var, 1.0)):
                t.fill_(default)
            args = fused_decode.decode_inputs(model, betas, START)
        else:
            i = DECODE_ARGS.index(dropped)
            args[i] = torch.where(args[i] > -1e29, 0.0, args[i])  # keep pads
        got = fused_decode.fused_greedy_decode_reference(*args, max_length=T)
    report = fused_decode.compare_with_reference(*got, words, alphas, margins)
    assert len(report["bad_rows"]) >= len(betas) // 8, report


def test_tensors_off_cpu_and_cuda_are_refused():
    """A tensor on neither the CPU nor CUDA (here 'meta') must not quietly
    run the plain version."""
    B, R, A, D, U, E, H, V = 2, 3, 4, 4, 8, 4, 8, 128
    z = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    args = (z(B, R, A), z(B, R, D), z(U, A), z(A), z(A), z(1),
            z(D + E, 4 * U), z(U, 4 * U), z(4 * U), z(U, H), z(H), z(H, V),
            z(V), z(V, E), z(E), z(B, U), z(B, U))
    with pytest.raises(ValueError, match="CUDA device"):
        fused_decode.fused_greedy_decode(*args, max_length=2)


# the JAX package's family cases (tests/test_fused_decode.py:88-163): the
# learned initial carry and a frozen GloVe table (also over a padded vocab)
# for K2, and the learned-init GRU in both zero-state modes for K3
VARIANTS = {
    "learned-init": dict(learned_init_state=True),
    "glove-frozen": dict(glove=True),
    "glove-frozen-padded-vocab": dict(glove=True, vocab=48, true_vocab=40),
    "gru-learned-init-zero-state": dict(learned_init_state=True,
                                        cell_type="gru",
                                        gru_zero_state=True),
    "gru-learned-init-carried": dict(learned_init_state=True,
                                     cell_type="gru", gru_zero_state=False),
}


def _variant_pair(case, b=6, n_voxels=256, seed=4):
    """Port model under ``spread_for_check`` and the flax model on the
    same weights (``to_flax``); a frozen table goes to flax spread as the
    port holds it."""
    kw = dict(VARIANTS[case])
    glove = kw.pop("glove", False)
    kw = dict(KW, vocab_size=kw.pop("vocab", 40), **kw)
    if kw.get("cell_type") == "gru":
        kw.update(head_activation="linear", attn_inner_activation="linear")
    layout = GroupLayout(synthetic_groups(n_voxels, 6, seed=seed), n_voxels)
    gen = torch.Generator().manual_seed(seed)
    if glove:
        tv = kw.get("true_vocab") or kw["vocab_size"]
        kw.update(pretrained_embedding=torch.randn(
            tv, KW["embedding_text"], generator=gen).numpy(),
            embedding_trainable=False)
    tmodel = LcNIC(layout, generator=gen, **kw)
    fused_decode.spread_for_check(tmodel, gen)
    if glove:
        kw["pretrained_embedding"] = tmodel.embedding[:tv].numpy()
    variables = to_flax(tmodel.state_dict())
    assert ("embedding" in variables["params"]) != glove
    rows = np.random.default_rng(seed).standard_normal(
        (b, n_voxels)).astype(np.float32)
    return JLcNIC(layout=layout, **kw), variables, tmodel.eval(), rows


@pytest.mark.parametrize("case", list(VARIANTS))
def test_variants_match_jax_kernel_and_xla_greedy(case):
    """K2's and K3's plain versions, through the model's own initial carry
    and its frozen table, against the JAX whole-decode kernel in interpret
    mode and the JAX XLA greedy decoder."""
    jmodel, variables, tmodel, rows = _variant_pair(case)
    words_k, alphas_k = j_fused(jmodel, UNITS, T)(variables, rows, START)
    words_x, _, alphas_x = j_greedy(jmodel, UNITS, T)(variables, rows, START)
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        torch.from_numpy(rows), START)
    for want_w, want_a in ((words_k, alphas_k), (words_x, alphas_x)):
        np.testing.assert_array_equal(words.numpy(), np.asarray(want_w))
        np.testing.assert_allclose(alphas.numpy(), np.asarray(want_a),
                                   rtol=1e-5, atol=1e-5)
    assert len(np.unique(words.numpy())) > 3
    if tmodel.learned_init_state:     # the learned carry, not zeros
        h0, _ = tmodel.init_carry(tmodel.encode(torch.from_numpy(rows)))
        assert h0.abs().min() > 0
    if "true_vocab" in VARIANTS[case]:
        assert int(words.max()) < 40
