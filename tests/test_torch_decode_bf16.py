"""The bf16-weight greedy decode of the port (K2's and K3's plain versions in
their bf16 mode) against the JAX package's whole-decode kernels as they run
on the TPU, on the CPU.

On its accelerator the JAX ``_fused_decode_call`` casts Wx, Wh, Wi, Wo and
the embedding table to bf16 (and, with ``feat_bf16``, pre and features);
off it, it decodes in fp32. Here the JAX kernels run in Pallas interpret
mode with ``jax.default_backend`` saying "tpu" (``_OnTheTPU``) and their
bf16 x bf16 = f32 dots lowered as the same dots of their operands widened
(``bf16_dots``, exact), both shared with ``test_torch_mixed_precision.py``;
the JAX package is not edited. The same weights and numpy rows give equal
words and alphas within ``ATOL`` (1e-5), and the fp32 plain version misses
the JAX kernel's alphas by more than ``CONTROL`` (4) times that in every
case, so the tolerance sees the bf16 roundings. The weights are the port's
seeded ones under ``spread_for_check``, handed to flax with ``to_flax``: the
flax initialisers leave the alphas too flat for such a control.

Also: the ``Captioner`` switch ``weights_bf16`` on the CPU, the dtype rule
of the wrappers and plain versions (a mixed set is refused before any work)
and the float64 run of the plain version on bf16 operands."""

import types

import numpy as np
import pytest
import torch
from test_torch_cnn_rnn import T as GRU_T
from test_torch_cnn_rnn import nic_pair
from test_torch_fused_decode import CASES, KW, START, UNITS, _variant_pair
from test_torch_fused_decode import T as LSTM_T
from test_torch_fused_decode_gru import GRU_CASES
from test_torch_mixed_precision import _OnTheTPU, bf16_dots  # noqa: F401

from masters_thesis_tpu.models.nic import LcNIC as JLcNIC
from masters_thesis_tpu.ops import fused_decode as jfd
from masters_thesis_tpu.serve import Captioner as JCaptioner
from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.models.nic import LcNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.serve import Captioner
from masters_thesis_tpu_torch.transplant import to_flax

ATOL = 1e-5
CONTROL = 4.0        # the fp32 control's distance over the tolerance


@pytest.fixture
def tpu_decoder(bf16_dots, monkeypatch):  # noqa: F811
    """The JAX ``make_whole_fused_greedy_decoder`` as it runs on the TPU:
    bf16 weights (and ``feat_bf16`` when asked), in interpret mode."""
    pallas_call = jfd.pl.pallas_call
    monkeypatch.setattr(jfd, "jax", _OnTheTPU())
    monkeypatch.setattr(jfd, "pl", types.SimpleNamespace(
        **{k: getattr(jfd.pl, k) for k in dir(jfd.pl)
           if not k.startswith("_") and k != "pallas_call"},
        pallas_call=lambda *a, **kw: pallas_call(*a, **{**kw,
                                                        "interpret": True})))
    return jfd.make_whole_fused_greedy_decoder


def _spread_pair(n_groups, vocab=40, true_vocab=0, b=6, n_voxels=256,
                 seed=0):
    """An LcNIC of ``CASES``' shapes under ``spread_for_check`` and the
    flax model on its weights."""
    kw = dict(KW, vocab_size=vocab, true_vocab=true_vocab)
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=seed),
                         n_voxels)
    gen = torch.Generator().manual_seed(seed)
    tmodel = LcNIC(layout, generator=gen, **kw)
    fused_decode.spread_for_check(tmodel, gen)
    rows = np.random.default_rng(seed).standard_normal(
        (b, n_voxels)).astype(np.float32)
    return (JLcNIC(layout=layout, **kw), to_flax(tmodel.state_dict()),
            tmodel.eval(), rows)


def _check(tpu_decoder, jmodel, variables, tmodel, rows, units, T,
           feat_bf16=False):
    """The port's bf16 decode against the JAX kernel on the TPU: words
    equal, alphas within ATOL; the fp32 plain version misses by more than
    CONTROL x ATOL."""
    jwords, jalphas = (np.asarray(x) for x in tpu_decoder(
        jmodel, units, T, feat_bf16=feat_bf16)(variables, rows, START))
    betas = torch.from_numpy(rows)
    words, alphas = fused_decode.make_whole_fused_greedy_decoder(
        tmodel, T, weights_bf16=True, feat_bf16=feat_bf16)(betas, START)
    _, alphas32 = fused_decode.make_whole_fused_greedy_decoder(tmodel, T)(
        betas, START)
    assert words.dtype == torch.int32 and alphas.dtype == torch.float32
    np.testing.assert_array_equal(words.numpy(), jwords)
    np.testing.assert_allclose(alphas.numpy(), jalphas, rtol=0, atol=ATOL)
    assert float(np.abs(alphas32.numpy() - jalphas).max()) > CONTROL * ATOL
    assert len(np.unique(jwords)) > 2        # not one constant word
    return words


@pytest.mark.parametrize("feat_bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_k2_matches_the_tpu_kernel(tpu_decoder, case, feat_bf16):
    jmodel, variables, tmodel, rows = _spread_pair(**CASES[case])
    words = _check(tpu_decoder, jmodel, variables, tmodel, rows, UNITS,
                   LSTM_T, feat_bf16)
    if CASES[case].get("true_vocab"):
        assert int(words.max()) < CASES[case]["true_vocab"]


@pytest.mark.parametrize("case", ["learned-init", "glove-frozen"])
def test_bf16_k2_variants_match_the_tpu_kernel(tpu_decoder, case):
    """A learned initial carry and a frozen GloVe table (a buffer, cast
    as the trainable table is)."""
    jmodel, variables, tmodel, rows = _variant_pair(case)
    _check(tpu_decoder, jmodel, variables, tmodel, rows, UNITS, LSTM_T)


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("case", list(GRU_CASES))
def test_bf16_k3_matches_the_tpu_kernel(tpu_decoder, case, zero_state):
    kw = GRU_CASES[case]
    jmodel, variables, tmodel, rows = nic_pair(zero_state, **kw)
    words = _check(tpu_decoder, jmodel, variables, tmodel, rows,
                   kw.get("units", tmodel.units), GRU_T)
    if "true_vocab" in kw:
        assert int(words.max()) < kw["true_vocab"]


def _tokenizer(num_words):
    tok = Tokenizer(num_words=num_words)
    tok.fit_on_texts(["<start> " + " ".join(f"w{i}" for i in range(
        num_words)) + " <end>"])
    tok.install_pad()
    return tok


def test_captioner_weights_bf16_serves_the_bf16_decode(tpu_decoder):
    """``Captioner(weights_bf16=True)`` gives the bf16 plain decode's
    words, and the JAX Captioner's on the TPU; the default gives the fp32
    plain decode's (today's words); 7 rows at a service batch of 4 pad the
    last chunk. The two settings differ on these rows."""
    jmodel, variables, tmodel, rows = _spread_pair(n_groups=5, b=7, seed=1)
    tok = _tokenizer(40)
    betas = torch.from_numpy(rows)
    want16 = fused_decode.make_whole_fused_greedy_decoder(
        tmodel, LSTM_T, weights_bf16=True)(betas, tok.start_id)[0].numpy()
    want32 = fused_decode.make_whole_fused_greedy_decoder(
        tmodel, LSTM_T)(betas, tok.start_id)[0].numpy()
    assert not np.array_equal(want16, want32)
    kw = dict(batch_size=4, device="cpu")
    got16 = Captioner(tmodel, tok, UNITS, LSTM_T, weights_bf16=True,
                      **kw).caption_ids(rows)
    got32 = Captioner(tmodel, tok, UNITS, LSTM_T, **kw).caption_ids(rows)
    np.testing.assert_array_equal(got16, want16)
    np.testing.assert_array_equal(got32, want32)
    jcap = JCaptioner(jmodel, variables, tok, UNITS, LSTM_T, batch_size=4,
                      input_width=rows.shape[1], use_fused=True)
    np.testing.assert_array_equal(got16, jcap.caption_ids(rows))


def test_captioner_refuses_weights_bf16_off_the_kernel_route():
    """``weights_bf16`` with the unfused greedy decoder would be ignored:
    it raises at construction."""
    _, _, tmodel, _ = _spread_pair(n_groups=6)
    with pytest.raises(ValueError, match="weights_bf16"):
        Captioner(tmodel, _tokenizer(40), UNITS, LSTM_T, use_fused=False,
                  weights_bf16=True, device="cpu")


def _inputs(cell="lstm", **cast):
    jmodel, variables, tmodel, rows = (
        _spread_pair(n_groups=6) if cell == "lstm" else nic_pair(True))
    with torch.inference_mode():
        args = fused_decode.decode_inputs(tmodel, torch.from_numpy(rows),
                                          START)
    return tmodel, fused_decode.cast_decode_inputs(cell, args, **cast)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mixed_dtypes_are_refused_before_any_work(cell):
    """Each weight of ``BF16_WEIGHTS`` alone in the other dtype, one of
    ``BF16_FEATURES`` alone in bf16, another tensor in bf16, fp16 weights,
    and bf16 features beside fp32 weights: the wrapper and the plain
    version raise, and no launch is counted."""
    tmodel, half = _inputs(cell, weights_bf16=True, feat_bf16=True)
    kernel, reference = fused_decode.decode_kernel(tmodel)
    opts = fused_decode.decode_options(tmodel)
    names = fused_decode.DECODE_ARGS[cell]
    bad = []
    for i, name in enumerate(names):
        args = list(half)
        args[i] = (args[i].float() if name in fused_decode.BF16_WEIGHTS
                   + fused_decode.BF16_FEATURES
                   else args[i].to(torch.bfloat16))
        bad.append(args)
    bad.append([t.half() if n in fused_decode.BF16_WEIGHTS else t.float()
                for n, t in zip(names, half)])
    bad.append([t.float() if n in fused_decode.BF16_WEIGHTS else t
                for n, t in zip(names, half)])
    before = (kernel.launches, kernel.launches_bf16)
    for args in bad:
        for fn in (kernel, reference):
            with pytest.raises(ValueError, match="bfloat16"), \
                    torch.inference_mode():
                fn(*args, max_length=2, **opts)
    assert (kernel.launches, kernel.launches_bf16) == before
    with pytest.raises(ValueError, match="feat_bf16"):
        fused_decode.make_whole_fused_greedy_decoder(tmodel, 2,
                                                     feat_bf16=True)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_plain_version_in_float64(cell):
    """The bf16 plain version with its fp32 tensors in float64 and its bf16
    ones as they are: the same decode summed in float64 (the card's second
    witness), within ``ATOL`` of the fp32-summed one, and on other numbers
    than the float64 decode of fp32 weights."""
    tmodel, half = _inputs(cell, weights_bf16=True)
    _, reference = fused_decode.decode_kernel(tmodel)
    opts = fused_decode.decode_options(tmodel)
    wide = [t.double() if t.dtype == torch.float32 else t for t in half]
    with torch.inference_mode():
        words, alphas = reference(*half, max_length=4, **opts)
        words64, alphas64 = reference(*wide, max_length=4, **opts)
    assert alphas64.dtype == torch.float64
    assert torch.equal(words, words64)
    assert float((alphas.double() - alphas64).abs().max()) <= ATOL
    _, fp32 = _inputs(cell)
    with torch.inference_mode():
        _, alphas64_fp32 = reference(*[t.double() for t in fp32],
                                     max_length=4, **opts)
    assert float((alphas64_fp32 - alphas64).abs().max()) > CONTROL * ATOL
