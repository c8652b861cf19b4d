"""The port's CUDA kernels against their plain PyTorch versions on the card:
the LSTM whole-decode kernel (K2) at a small shape and at flagship LcNIC
width, through the greedy decoders, with other activations and a wide
attention, and with the tile of each of its tile-kernel products forced at
shapes that cross the tiles' edges, and on the NIC variants (the learned
initial carry, a frozen GloVe table, also over a padded vocab); the GRU
whole-decode kernel (K3) in the cases of the CPU tests, with a learned
initial carry and at full CnnRnn width, and with each dense tile forced on
its head at shapes that cross the tiles' edges; the beam and the sampler on CUDA
tensors against the CPU; the store row gather (K1) at small and flagship
widths and through three train steps; the teacher-forced sequence forward
(K4) at odd and flagship widths, through the custom backward, and against
K2 on K2's own words, and with every tile of its tile kernel forced at
shapes that cross the tiles' edges; and K4's bf16-weight variant at every
K4 shape, step by step, its rounding of h, emb and ctx against torch's on
values at ties, and through the bf16 sequence's backward; and the
bf16-weight K2 and K3 at the shapes of the fp32 ones, on batches of 1 and
5 rows and at the tiles' edges, with feat_bf16, their rounding of ctx at
ties, the first index on an argmax tie and the refusal of mixed dtypes;
and their persistent kernel on batches past one row a block, bit for bit
from call to call, on forced plans of few blocks, and refusing plans it
cannot run; and the profiler's device spans of a gather and a decode,
against the decode's kernels by name; and the pixel CnnRnn (InceptionV3 in
its encoder) in fp32 with cuDNN's TF32 flag at PyTorch's default. A CUDA kernel has no CPU mode, so
every test here needs an NVIDIA Hopper GPU and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch.data.synthetic import synthetic_groups
from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder
from masters_thesis_tpu_torch.models.nic import CnnRnnNIC, LcNIC
from masters_thesis_tpu_torch.ops import fused_decode
from masters_thesis_tpu_torch.ops.group_layout import GroupLayout
from masters_thesis_tpu_torch.ops.tiles import (
    FEED_TMA,
    FEED_W16,
    FEED_X16,
    TILES,
    Plan,
)

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


# The small K2 and K3 cases below: seed and rows, and their floor on
# distinct greedy words. A small seeded model settles on a few ids, and
# which few depends on the draw: the same seed gives other weights under
# another PyTorch release (the CPU and the card of one machine agree), so
# the cases draw 32 rows, which take 11 or more distinct words under
# PyTorch 2.11 and 8 or more under 2.13.
SMALL_SEED, SMALL_ROWS, SMALL_MIN_DISTINCT = 1, 32, 8


def _check_decode(model, rows, min_distinct):
    """The model's decode kernel against its plain version on ``rows``.
    ``min_distinct`` floors the distinct greedy words, so that the
    comparison is not between a few constant ids."""
    kernel, reference = fused_decode.decode_kernel(model)
    opts = fused_decode.decode_options(model)
    T = model.max_length
    with torch.inference_mode():
        inputs = fused_decode.decode_inputs(model, rows, 1)
        before = kernel.launches
        words, alphas = kernel(*inputs, max_length=T, **opts)
        torch.cuda.synchronize()
        ref_words, ref_alphas, margins = reference(
            *inputs, max_length=T, return_margins=True, **opts)
    assert kernel.launches == before + 1
    assert words.shape == (len(rows), T)
    assert alphas.shape == (len(rows), T, inputs[0].shape[1])
    report = fused_decode.compare_with_reference(
        words, alphas, ref_words, ref_alphas, margins)
    assert report["bad_rows"] == [], report
    assert report["near_tie_rows"] <= len(rows) // 4, report
    assert len(torch.unique(ref_words)) >= min_distinct


@pytest.mark.parametrize("head,attn", [("linear", "linear"),
                                       ("relu", "leaky_relu"),
                                       ("relu", "linear")])
def test_lstm_kernel_with_other_activations_and_wide_attention(cuda, head,
                                                               attn):
    """K2 with head and attention slopes other than 0.2 and an attention
    of 512 columns, wider than a block's 256 threads."""
    layout = GroupLayout(synthetic_groups(512, 8, seed=0), 512)
    gen = torch.Generator().manual_seed(SMALL_SEED)
    model = LcNIC(layout, units=48, group_size=32, embedding_text=64,
                  attn_units=512, vocab_size=40, max_length=6,
                  head_activation=head, attn_inner_activation=attn,
                  generator=gen)
    fused_decode.spread_for_check(model, gen)
    rows = torch.randn(SMALL_ROWS, 512, generator=gen)
    _check_decode(model.to(cuda).eval(), rows.to(cuda), SMALL_MIN_DISTINCT)


# K2 on seeded inputs, (B, R, A, D, E, U, H, V), at the edges of the tile
# kernel's tiles (ops/tiles.py), as SEQ_SHAPES has them for K4: batches of
# 70, 130 and 9 (a multiple of no tile's rows), cells of 40, 300 and 13
# units and heads of 40, 300, 13 and 72 (300 and 13 cross a tile's units),
# a vocabulary padded from 300 and from 40, widths that are not a multiple
# of 4 (4-byte copies), and segment widths that are multiples of 32 at 130
# rows (the TMA cell tile, forced, with rows past B)
DECODE_SHAPES = {
    "b70-u40": (70, 11, 20, 12, 36, 40, 40, 300),
    "b130-u300": (130, 9, 40, 36, 28, 300, 300, 40),
    "unaligned": (9, 5, 9, 5, 3, 13, 13, 40),
    "tma": (130, 9, 40, 64, 32, 96, 72, 40),
}
DECODE_T = 5
DECODE_PRODUCTS = ("hW2", "cell", "Wi", "Wo")   # lstm_decode_plans' order


def _decode_case(device, B, R, A, D, E, U, H, V, seed=0):
    """K2's arguments, drawn with numpy (the same on every PyTorch release):
    weights at 1 / sqrt(fan-in), a head widened x4 so that the words vary,
    every bias live, the vocabulary padded to 128 with bias -1e30."""
    rng = np.random.default_rng(seed)
    Vp = -(-V // 128) * 128

    def rand(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.as_tensor(x).to(device)

    wo = torch.zeros(H, Vp, device=device)
    wo[:, :V] = rand(H, V, scale=4 / H ** 0.5)
    bo = torch.full((Vp,), fused_decode.PAD_NEG, device=device)
    bo[:V] = rand(V, scale=0.2)
    emb_table = rand(V, E)
    carry = torch.zeros(B, U, device=device)
    return (rand(B, R, A), rand(B, R, D), rand(U, A, scale=2 / U ** 0.5),
            rand(A, scale=0.5), rand(A, scale=3 / A ** 0.5), rand(1),
            rand(D + E, 4 * U, scale=1 / (D + E) ** 0.5),
            rand(U, 4 * U, scale=1 / U ** 0.5), rand(4 * U, scale=0.5),
            rand(U, H, scale=4 / U ** 0.5), rand(H, scale=0.5), wo, bo,
            emb_table, emb_table[1], carry, carry)


def _launch_decode(args, plans, cell="lstm", zero_state=False):
    return fused_decode._launch(cell, args, max_length=DECODE_T, slope=0.2,
                                attn_slope=0.2, zero_state=zero_state,
                                plans=plans)


def _gru_decode_case(device, B, R, A, D, E, U, H, V, seed=0):
    """K3's arguments, drawn as ``_decode_case`` draws K2's: Wx (D+E, 3U),
    Wh (U, 3U) and the input and recurrent biases in place of the LSTM's,
    no c0."""
    lstm = _decode_case(device, B, R, A, D, E, U, H, V, seed)
    rng = np.random.default_rng(seed + 1)

    def rand(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.as_tensor(x).to(device)

    return (*lstm[:6], rand(D + E, 3 * U, scale=1 / (D + E) ** 0.5),
            rand(U, 3 * U, scale=1 / U ** 0.5), rand(3 * U, scale=0.5),
            rand(3 * U, scale=0.5), *lstm[9:16])


@pytest.mark.parametrize("product, tile", [
    pytest.param(product, i, id=f"{DECODE_PRODUCTS[product]}-{t.name}")
    for product in range(4) for i, t in enumerate(TILES)
    if (t.gates == 4) == (product == 1)])
def test_every_tile_matches_plain_version_in_the_decode(cuda, product, tile):
    """K2 with the tile of one product (h W2, the cell, Wi or Wo) forced
    through ``lstm_decode_plans``, whatever ``pick_tile`` would take, at
    the shapes of DECODE_SHAPES that the tile's feed can take (the TMA cell
    tile only at "tma"): rows past B, units past N, a K tail, 4-byte
    copies. Words equal except at near-ties, alphas within 1e-6."""
    ran = 0
    for shape in DECODE_SHAPES.values():
        args = _decode_case(cuda, *shape)
        force = [None] * 4
        force[product] = tile
        try:
            plans = fused_decode.lstm_decode_plans(args, force=force)
        except ValueError:          # a feed that cannot take these shapes
            continue
        words, alphas = _launch_decode(args, plans)
        torch.cuda.synchronize()
        ref_words, ref_alphas, margins = (
            fused_decode.fused_greedy_decode_reference(
                *args, max_length=DECODE_T, return_margins=True))
        report = fused_decode.compare_with_reference(
            words, alphas, ref_words, ref_alphas, margins)
        assert report["bad_rows"] == [], (shape, report)
        assert report["near_tie_rows"] <= len(words) // 4, (shape, report)
        assert len(torch.unique(ref_words)) >= 4, shape
        ran += 1
    assert ran >= 1


@pytest.mark.parametrize("shape", ["b70-u40", "unaligned"])
def test_decode_kernel_refuses_plans_it_cannot_run(cuda, shape):
    """K2's C entry point returns an error for a plan of any of its four
    products that the tile kernel cannot run: an index past the table, a
    tile of the wrong kind, a feed the tile has not (TMA on a sliced tile,
    cp.async on the TMA tile, TMA where the widths are off its 32-row
    chunk, 16-byte copies of widths that are not a multiple of 4) and
    slices it has not. Nothing falls back to another kernel."""
    args = _decode_case(cuda, *DECODE_SHAPES[shape])
    good = fused_decode.lstm_decode_plans(args)
    hw, cell, wi, wo = good
    lstm, dense = cell.tile, hw.tile
    tma = next(i for i, t in enumerate(TILES) if t.tma)
    bad = {
        0: [Plan(len(TILES), hw.feed, 8), Plan(lstm, cell.feed, 8),
            Plan(dense, FEED_TMA, 8), Plan(dense, hw.feed, 0),
            Plan(dense, hw.feed, TILES[dense].ks + 1)],
        1: [Plan(-1, 0, 1), Plan(dense, hw.feed, 8),
            Plan(lstm, FEED_TMA, 8), Plan(tma, 0, 1), Plan(tma, FEED_TMA, 1),
            Plan(lstm, cell.feed, 0),
            Plan(lstm, cell.feed, TILES[lstm].ks + 1)],
        2: [Plan(lstm, cell.feed, 8), Plan(wi.tile, FEED_TMA, 8)],
        3: [Plan(lstm, cell.feed, 8), Plan(wo.tile, wo.feed, 0)],
    }
    if shape == "unaligned":        # D, E, U and H not a multiple of 4
        bad[1].append(Plan(lstm, FEED_X16, 8))
        bad[2].append(Plan(wi.tile, FEED_W16, 8))
        bad[3].append(Plan(wo.tile, FEED_X16, 8))
    for product, plans in bad.items():
        for p in plans:
            forced = list(good)
            forced[product] = p
            with pytest.raises(RuntimeError, match="CUDA error"):
                _launch_decode(args, forced)
    words, _ = _launch_decode(args, good)         # the good plans still run
    torch.cuda.synchronize()
    assert words.shape == (DECODE_SHAPES[shape][0], DECODE_T)

    # K3's entry point refuses bad plans of its three products in the same
    # way: h W2, Wi and Wo are dense tiles, as K2's are
    args = _gru_decode_case(cuda, *DECODE_SHAPES[shape])
    good = fused_decode.gru_decode_plans(args)
    _, wi, wo = good
    bad = {0: bad[0], 1: bad[2], 2: bad[3]}
    for product, plans in bad.items():
        for p in plans:
            forced = list(good)
            forced[product] = p
            with pytest.raises(RuntimeError, match="CUDA error"):
                _launch_decode(args, forced, "gru")
    words, _ = _launch_decode(args, good, "gru")
    torch.cuda.synchronize()
    assert words.shape == (DECODE_SHAPES[shape][0], DECODE_T)
    assert fused_decode.fused_greedy_decode_gru.plans == good


# K3 on seeded inputs at the edges of the tile kernel's tiles: DECODE_SHAPES
# less the TMA one (K3's products are dense), and CnnRnn's widths with the
# vocabulary of configs/cnn_rnn.yaml, where Wo takes the tile that holds
# the whole batch
GRU_DECODE_SHAPES = {
    **{k: v for k, v in DECODE_SHAPES.items() if k != "tma"},
    "cnn_rnn": (64, 64, 512, 256, 256, 512, 512, 5001),
}
GRU_DECODE_PRODUCTS = ("hW2", "Wi", "Wo")    # gru_decode_plans' order


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("product, tile", [
    pytest.param(product, i, id=f"{GRU_DECODE_PRODUCTS[product]}-{t.name}")
    for product in (1, 2) for i, t in enumerate(TILES) if t.gates == 1])
def test_every_tile_matches_plain_version_in_the_gru_decode(
        cuda, product, tile, zero_state):
    """K3 with the tile of one head product (Wi or Wo) forced through
    ``gru_decode_plans``, whatever ``pick_tile`` would take, at every shape
    of GRU_DECODE_SHAPES, in both zero-state modes: rows past B, units past
    N, a K tail, 4-byte copies. Words equal except at near-ties, alphas
    within 1e-6; the wrapper's record names the plans that ran."""
    for shape in GRU_DECODE_SHAPES.values():
        args = _gru_decode_case(cuda, *shape)
        force = [None] * 3
        force[product] = tile
        plans = fused_decode.gru_decode_plans(args, force=force)
        words, alphas = _launch_decode(args, plans, "gru", zero_state)
        torch.cuda.synchronize()
        assert fused_decode.fused_greedy_decode_gru.plans == plans
        ref_words, ref_alphas, margins = (
            fused_decode.fused_greedy_decode_gru_reference(
                *args, max_length=DECODE_T, slope=0.2, attn_slope=0.2,
                zero_state=zero_state, return_margins=True))
        report = fused_decode.compare_with_reference(
            words, alphas, ref_words, ref_alphas, margins)
        assert report["bad_rows"] == [], (shape, report)
        assert report["near_tie_rows"] <= len(words) // 4, (shape, report)
        assert len(torch.unique(ref_words)) >= 4, shape


# (n_patches, in_channels, units, vocab, true_vocab, batch): odd region
# counts, a padded vocab, an attention (= units) wider than a block, and
# the full CnnRnn width of configs/cnn_rnn.yaml
GRU_SHAPES = {
    "small-odd-regions": (7, 24, 16, 40, 0, SMALL_ROWS),
    "padded-vocab": (5, 24, 16, 48, 40, SMALL_ROWS),
    "attention-300": (9, 24, 300, 40, 0, SMALL_ROWS),
    "cnn_rnn": (64, 2048, 512, 5001, 0, 64),
}


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("shape", list(GRU_SHAPES))
def test_gru_kernel_matches_plain_version(cuda, shape, zero_state):
    """K3 against its plain version, both values of the zero-state quirk."""
    patches, channels, units, vocab, true_vocab, batch = GRU_SHAPES[shape]
    full = shape == "cnn_rnn"
    gen = torch.Generator().manual_seed(0 if full else SMALL_SEED)
    model = CnnRnnNIC(embed_dim=256 if full else 64, units=units,
                      vocab_size=vocab, true_vocab=true_vocab,
                      max_length=15 if full else 6, n_patches=patches,
                      in_channels=channels, gru_zero_state=zero_state,
                      generator=gen)
    fused_decode.spread_for_check(model, gen)
    rows = torch.randn(batch, patches, channels, generator=gen)
    _check_decode(model.to(cuda).eval(), rows.to(cuda),
                  16 if full else SMALL_MIN_DISTINCT)


def test_gru_padded_vocab_never_wins_on_the_card(cuda):
    gen = torch.Generator().manual_seed(0)
    model = CnnRnnNIC(embed_dim=12, units=16, vocab_size=40, true_vocab=33,
                      max_length=6, n_patches=5, in_channels=24,
                      generator=gen)
    fused_decode.spread_for_check(model, gen)
    with torch.no_grad():
        model.dense_out.bias[33:] = 1e6     # padded ids would win unmasked
    rows = torch.randn(6, 5, 24, generator=gen)
    words, _ = fused_decode.make_whole_fused_greedy_decoder(
        model.to(cuda).eval(), 6)(rows.to(cuda), 1)
    assert int(words.max()) < 33


# ---- the NIC variants, and the beam and the sampler on the card ----

# the JAX package's family cases for K2 (tests/test_fused_decode.py:88-163)
NIC_VARIANTS = {
    "learned-init": dict(learned_init_state=True),
    "glove-frozen": dict(glove=True),
    "glove-frozen-padded-vocab": dict(glove=True, vocab_size=48,
                                      true_vocab=40),
}


def _variant_model(variant):
    """A small LcNIC variant on the CPU under ``spread_for_check``, and
    ``SMALL_ROWS`` rows; a frozen table is seeded before the spread. How
    varied a small model's words are depends on its draw, which differs
    between PyTorch releases: the first of ten seeds from ``SMALL_SEED``
    whose plain greedy decode takes ``SMALL_MIN_DISTINCT`` words is used."""
    cfg = dict(SHAPES["small"])
    n_voxels, n_groups, _ = (cfg.pop(k) for k in
                             ("n_voxels", "n_groups", "batch"))
    kw = dict(NIC_VARIANTS[variant])
    glove = kw.pop("glove", False)
    cfg.update(kw)
    layout = GroupLayout(synthetic_groups(n_voxels, n_groups, seed=0),
                         n_voxels)
    for seed in range(SMALL_SEED, SMALL_SEED + 10):
        gen = torch.Generator().manual_seed(seed)
        if glove:
            true_vocab = cfg.get("true_vocab") or cfg["vocab_size"]
            cfg.update(pretrained_embedding=torch.randn(
                true_vocab, cfg["embedding_text"], generator=gen).numpy(),
                embedding_trainable=False)
        model = LcNIC(layout, generator=gen, **cfg).eval()
        fused_decode.spread_for_check(model, gen)
        rows = torch.randn(SMALL_ROWS, n_voxels, generator=gen)
        words = fused_decode.make_whole_fused_greedy_decoder(
            model, model.max_length)(rows, 1)[0]
        if len(torch.unique(words)) >= SMALL_MIN_DISTINCT:
            return model, rows
    raise AssertionError(f"no seed gives {SMALL_MIN_DISTINCT} words")


@pytest.mark.parametrize("variant", list(NIC_VARIANTS))
def test_lstm_kernel_on_the_nic_variants(cuda, variant):
    """K2 through the learned initial carry and a frozen GloVe table (a
    buffer, not a parameter), also over a padded vocab, against its plain
    version."""
    model, rows = _variant_model(variant)
    assert ("embedding" in dict(model.named_parameters())) == (
        "glove" not in variant)
    _check_decode(model.to(cuda), rows.to(cuda), SMALL_MIN_DISTINCT)


@pytest.mark.parametrize("zero_state", [True, False])
def test_gru_kernel_with_a_learned_initial_carry(cuda, zero_state):
    """K3 from the learned carry; the seed as ``_variant_model`` picks it."""
    for seed in range(SMALL_SEED, SMALL_SEED + 10):
        gen = torch.Generator().manual_seed(seed)
        model = CnnRnnNIC(embed_dim=64, units=16, vocab_size=40,
                          max_length=6, n_patches=7, in_channels=24,
                          gru_zero_state=zero_state, learned_init_state=True,
                          generator=gen).eval()
        fused_decode.spread_for_check(model, gen)
        rows = torch.randn(SMALL_ROWS, 7, 24, generator=gen)
        words = fused_decode.make_whole_fused_greedy_decoder(model, 6)(
            rows, 1)[0]
        if len(torch.unique(words)) >= SMALL_MIN_DISTINCT:
            break
    _check_decode(model.to(cuda), rows.to(cuda), SMALL_MIN_DISTINCT)


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_pixel_cnn_rnn_keeps_fp32_under_the_default_tf32_flag(cuda):
    """The pixel CnnRnn at the benchmark's configuration (InceptionV3 at
    299 x 299, the published widths) and weights' rule, with cuDNN's flag
    at PyTorch's default, which lets convolutions take TF32: its encoder
    gives what it gives with the flag off, within the fp32 summation-order
    tolerance of the CPU tests (5e-4 x max), while its backbone called
    bare under the flag lies over 20 times farther; its decode through K3
    is held to the fp32 reference within the cell's limits; and the flag
    is the caller's again."""
    import json
    from pathlib import Path

    from masters_thesis_tpu_torch.models.encoders import PatchDense
    from port_bench.harness import port
    from port_bench.programs import cnn_rnn_inception as program
    from port_bench.reference import cnn_rnn_inception as ref
    from port_bench.reference import compare

    bench = Path(__file__).resolve().parents[1] / "port_bench"
    cfg = json.loads((bench / "configs/cnn_rnn_inception_v3.json")
                     .read_text())
    limits = json.loads((bench / "limits/cnnrnn_inception_eval_greedy.json")
                        .read_text())
    B, start, tol = 16, cfg["tokens"]["start"], 5e-4
    w = ref.weights(cfg, 2**40 + 299, cuda)
    model = port.model(cfg, w, cuda).eval()
    rows = ref.draw_rows(cfg, B, torch.Generator(device=cuda).manual_seed(5),
                         cuda)
    stored = program.to_store(model, rows)
    decode = fused_decode.make_whole_fused_greedy_decoder(
        model, cfg["max_length"])
    with torch.inference_mode():
        fp32 = model.encoder(stored)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            guarded = model.encoder(stored)
            bare = PatchDense.forward(model.encoder, model.encoder.backbone(
                stored.view(B, *model.row_shape))["patches"])
        words, alphas = decode(stored, start)
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert _rel_gap(guarded, fp32) <= tol
    assert _rel_gap(bare, fp32) > 20 * tol
    assert len(torch.unique(words)) >= 3
    tokens = torch.cat([torch.full_like(words[:, :1], start),
                        words[:, :-1].long()], dim=1)
    with torch.no_grad():
        logits, want = ref.teacher_forced(w, cfg, rows, tokens)
    ok, readings = compare.verdict(
        compare.decode_readings(logits, want, words, alphas), limits)
    assert ok, readings


@pytest.mark.parametrize("decoder", ["beam-1", "beam-3", "beam-5",
                                     "sample"])
def test_beam_and_sampler_on_the_card_match_the_cpu(cuda, decoder):
    """The same decoder on CUDA tensors and on the CPU: the same words but
    in rows whose deciding margin on the CPU is a near-tie (< 1e-3); rows
    that differ stay a small minority. (A beam's margin, the smallest gap
    at the selection's edge over every step, is often under 1e-3 among
    W·V candidates, so many rows are excepted but few differ.) The two devices' generators draw different
    streams, so the sampler is held at ``top_k=1``, where it is greedy
    (near-ties from the greedy top-2 logit margins), and its draws at a
    temperature are held to valid, varied ids."""
    import copy

    from masters_thesis_tpu_torch.decode.beam import make_beam_decoder
    from masters_thesis_tpu_torch.decode.sampling import (
        make_sampling_decoder,
    )

    cpu_model, rows = _variant_model("learned-init")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    T = cpu_model.max_length
    if decoder == "sample":
        gens = (torch.Generator().manual_seed(3),
                torch.Generator(device=cuda).manual_seed(3))
        cpu_words = make_sampling_decoder(cpu_model, T, top_k=1)(
            rows, 1, gens[0])
        card_words = make_sampling_decoder(card_model, T, top_k=1)(
            rows.to(cuda), 1, gens[1]).cpu()
        with torch.inference_mode():
            _, _, margins = fused_decode.fused_greedy_decode_reference(
                *fused_decode.decode_inputs(cpu_model, rows, 1),
                max_length=T, return_margins=True)
        differs = (card_words != cpu_words).any(dim=1)
        near_tie = margins.amin(dim=1) < 1e-3
        assert not (differs & ~near_tie).any()
        assert int(differs.sum()) <= len(rows) // 4
        drawn = make_sampling_decoder(card_model, T, temperature=0.7,
                                      top_k=5)(rows.to(cuda), 1, gens[1])
        assert 0 <= int(drawn.min()) and int(drawn.max()) < 40
        assert len(torch.unique(drawn)) >= SMALL_MIN_DISTINCT
        return
    width = int(decoder.split("-")[1])
    # <end> is the commonest greedy word after the first step, so that
    # beams finish early and freeze
    greedy = fused_decode.make_whole_fused_greedy_decoder(cpu_model, T)(
        rows, 1)[0][:, 1:]
    end = int(torch.mode(greedy.flatten()).values)
    got = make_beam_decoder(card_model, T, beam_width=width)(rows.to(cuda),
                                                             1, end)
    want = make_beam_decoder(cpu_model, T, beam_width=width,
                             return_margins=True)(rows, 1, end)
    differs = (got[0].cpu() != want[0]).any(dim=1)
    near_tie = want[5] < 1e-3
    assert not (differs & ~near_tie).any(), (differs, want[5])
    assert int(differs.sum()) <= len(rows) // 4
    same = ~differs
    torch.testing.assert_close(got[1].cpu()[same], want[1][same],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2].cpu()[same], want[2][same],
                               rtol=1e-5, atol=1e-5)
    assert len(torch.unique(want[0])) >= 4
    assert (want[3][:, :, 1:] == end).any()


# ---- K1: the store row gather ----

GATHER_SHAPES = {
    # (store rows, row width, copied width): odd widths force narrow vectors
    "small": (37, 333, 333),
    "small-cut": (37, 333, 201),
    "flagship-raw": (40, 327_684, 327_684),
    "flagship-pregathered": (40, 472_576, 472_576),
    # the narrow stores' widths: ThinkAndTell's PCA pack, cnn_rnn's
    # (64, 2048) patches, img_nic's (196, 512) conv5 and LcNIC's
    # attempt_four.yaml row, pregathered
    "pca": (40, 512, 512),
    "cnn_rnn": (20, 131_072, 131_072),
    "img_nic": (20, 100_352, 100_352),
    "lc_nic": (20, 409_600, 409_600),
    # cnn_rnn on pixels: 299 x 299 x 3 values a row, 4-byte loads
    "pixels": (9, 268_203, 268_203),
    # gather_plan's edges, in fp32 columns: 1 and 3 columns (one 4-byte or
    # 12-byte row), a warp of 16-byte vectors and one vector past it, a
    # block of them (a vector a thread) and one past it, the last row a
    # block copies whole (1,023 vectors), one block's sweep (the first cut
    # into pieces), one vector past it (two pieces), the last row that
    # streams its loads and the first in half sweeps (1 MiB), and the cut
    # of a store whose pitch is not its width
    "one": (9, 1, 1),
    "three": (9, 3, 3),
    "warp": (21, 128, 128),
    "warp+1": (21, 132, 132),
    "block": (21, 1_024, 1_024),
    "block+1": (21, 1_028, 1_028),
    "block-whole": (21, 4_092, 4_092),
    "block-sweep": (21, 4_096, 4_096),
    "block-sweep+1": (21, 4_100, 4_100),
    "streamed": (9, 262_140, 262_140),
    "wide-row": (9, 262_144, 262_144),
    "odd-pitch-cut": (21, 4_099, 4_092),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_gather_kernel_matches_plain_version(cuda, shape, dtype, id_dtype):
    """Repeated ids, odd rows (a bf16 raw row is not a multiple of 16 B)
    and ids past both ends (clamped): equal to the plain version."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_reference,
    )

    n, w, width = GATHER_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(0)
    store = torch.randn(n, w, generator=gen, device=cuda).to(dtype)
    ids = torch.tensor([1, 3, 3, 0, n - 1, -5, n + 9, 7, 5, 5, 2 * n],
                       dtype=id_dtype, device=cuda)
    before = gather_rows.launches
    got = gather_rows(store, ids, width)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert got.shape == (len(ids), width) and got.is_contiguous()
    assert torch.equal(got, gather_rows_reference(store, ids, width))


@pytest.mark.parametrize("batch", [1, 9, 64, 257, 2_000])
@pytest.mark.parametrize("width", [512, 3, 100_352])
def test_gather_kernel_at_other_batch_sizes(cuda, batch, width):
    """B other than 64: rows that share a block (a warp each), rows of
    several pieces, and more rows than ids in range (clamped)."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_reference,
    )

    n = 300
    gen = torch.Generator(device=cuda).manual_seed(batch)
    store = torch.randn(n, width, generator=gen, device=cuda)
    ids = torch.randint(-5, n + 5, (batch,), generator=gen, device=cuda)
    got = gather_rows(store, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_reference(store, ids))


@pytest.mark.parametrize("row_cols", [3, 512, 4_100, 100_352])
def test_gather_kernel_under_forced_plans(cuda, row_cols):
    """Every plan the C side takes gives the same rows: other blocks, other
    cuts into pieces, both row loads; plans it cannot run are refused and
    not counted."""
    from masters_thesis_tpu_torch.ops import gather
    from masters_thesis_tpu_torch.ops.gather import GatherPlan

    gen = torch.Generator(device=cuda).manual_seed(0)
    store = torch.randn(50, row_cols, generator=gen, device=cuda)
    ids = torch.tensor([4, 4, -1, 49, 60, 7, 0, 33, 12, 12, 5],
                       device=cuda)
    want = gather.gather_rows_reference(store, ids)
    row = row_cols * 4
    vec = gather.vector_bytes(row)
    vecs = row // vec
    plans = [gather.gather_plan(row, vec)]
    for threads in (32, 96, 128, 256):
        for pieces in sorted({1, 2, min(vecs, 7), vecs}):
            piece = -(-vecs // pieces)
            if (pieces - 1) * piece < vecs and piece <= threads * 4:
                plans += [GatherPlan(vec, threads, pieces, piece, stream)
                          for stream in (0, 1)]
    for plan in plans:
        assert torch.equal(gather._gather(store, ids, None, plan), want), \
            plan
    torch.cuda.synchronize()
    good = plans[0]
    bad = [good._replace(vec_bytes=3), good._replace(threads=16),
           good._replace(threads=48), good._replace(threads=512),
           good._replace(pieces=0), good._replace(stream=2),
           good._replace(pieces=1, piece_vecs=vecs - 1),
           good._replace(pieces=2, piece_vecs=vecs)]
    if vec > 1:
        bad.append(good._replace(vec_bytes=2 * vec))
    if vecs > 128:
        bad.append(GatherPlan(vec, 32, 1, vecs, 1))  # over 4 vectors a thread
    before = gather.gather_rows.launches
    for plan in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            gather._gather(store, ids, None, plan)
    assert gather.gather_rows.launches == before


def test_gather_kernel_reads_a_strided_store_and_refuses_bad_input(cuda):
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_reference,
    )

    base = torch.randn(9, 130, device=cuda)
    store = base[1:, 3:100]              # row pitch 130, odd base offset
    ids = torch.tensor([7, 0, 3, 3], device=cuda)
    assert torch.equal(gather_rows(store, ids),
                       gather_rows_reference(store, ids))
    before = gather_rows.launches
    with pytest.raises(ValueError, match="store"):
        gather_rows(torch.zeros(2, 3, 4, device=cuda), ids)
    with pytest.raises(ValueError, match="idx"):
        gather_rows(base, ids.float())
    with pytest.raises(ValueError, match="width"):
        gather_rows(base, ids, 131)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(base, ids.cpu())
    assert gather_rows.launches == before


def test_scanned_steps_through_the_kernel_follow_the_plain_gather(cuda):
    """Three dropout-off steps gathering their batches by K1 against the
    same steps fed by the plain gather: within 1e-6 relative (the backward
    of the embedding may sum in another order on the card)."""
    import numpy as np

    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.data.store import permute_rows
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows,
        gather_rows_reference,
    )
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import init_model

    cfg = Config(batch_size=6, max_length=6, top_k=39, units=16,
                 attn_units=8, group_size=4, embedding_text=8, alpha=1e-3,
                 dropout_features=0.0, dropout_text=0.0, dropout_attn=0.0,
                 dropout_lstm=0.0, dropout_out=0.0)
    layout = GroupLayout(synthetic_groups(500, 8, seed=0), 500)
    gen = torch.Generator(device=cuda).manual_seed(0)
    store = permute_rows(torch.randn(20, 500, generator=gen, device=cuda),
                         layout)
    rng = np.random.default_rng(0)
    store_idx = torch.as_tensor(rng.integers(0, 20, 30), dtype=torch.int32,
                                device=cuda)
    tokens = torch.as_tensor(rng.integers(1, 40, (30, 6)), device=cuda)
    target = torch.roll(tokens, -1, 1)
    sel = torch.as_tensor(np.stack([rng.permutation(30)[:6]
                                    for _ in range(3)]), device=cuda)
    rules = lc_nic_l2_rules(cfg)
    a = init_model(cfg, layout, cuda, pregathered=True)
    b = init_model(cfg, layout, cuda, pregathered=True)
    before = gather_rows.launches
    a, ma = steps.make_scanned_train_steps_from_tables(cfg, rules)(
        a, store, store_idx, tokens, target, sel)
    assert gather_rows.launches == before + 3
    one = steps.make_train_step(cfg, rules)
    mb = []
    for p in sel:
        b, m = one(b, gather_rows_reference(store, store_idx[p]), tokens[p],
                   target[p])
        mb.append(m)
    for key in ma:
        want = torch.stack([m[key] for m in mb])
        assert torch.allclose(ma[key], want, rtol=1e-6, atol=0), key
    with torch.no_grad():
        diff = torch.stack([torch.linalg.vector_norm(pa - pb) for pa, pb in
                            zip(a.model.parameters(), b.model.parameters())])
        norm = torch.stack([torch.linalg.vector_norm(p)
                            for p in b.model.parameters()])
    assert torch.linalg.vector_norm(diff) <= 1e-6 * torch.linalg.vector_norm(
        norm)


# ---- K4: the teacher-forced sequence forward ----

# (B, R, A, D, E, U, T): regions that are not a multiple of 8, attention
# and feature widths above a block's 256 threads, and the flagship; then
# the edges of the tile kernel's tiles (ops/tiles.py): batches of 70 and
# 130 (a multiple of no tile's rows), 40 and 300 units (of neither LSTM
# tile's 32; 300 not of 8), K = D + E + U of 88 and 364 (of no 32-row
# chunk), widths that are not a multiple of 4 (4-byte copies in place of
# 16-byte ones), segment widths that are multiples of 32 at 130 rows (the
# TMA tile, forced, with rows past B), and the wide shape of
# scripts/fused_seq_probe.py at T 2; then two shapes on which the bf16
# K4's cell runs on wgmma (ops/fused_seq.py's wgmma_cell): rows past B in
# the second 128-row tile, and ctx filling the ring's first five stages
SEQ_SHAPES = {
    "small-odd": (6, 7, 8, 4, 16, 24, 7),
    "wide": (11, 13, 300, 260, 24, 40, 5),
    "flagship": (64, 360, 32, 32, 512, 512, 15),
    "b70-u40": (70, 11, 20, 12, 36, 40, 4),
    "b130-u300": (130, 9, 40, 36, 28, 300, 3),
    "unaligned": (9, 5, 7, 5, 3, 13, 3),
    "b130-tma": (130, 9, 40, 64, 32, 96, 3),
    "wide-t2": (256, 360, 256, 128, 1024, 2048, 2),
    "b130-wgmma": (130, 9, 40, 64, 64, 128, 3),
    "d320-wgmma": (200, 5, 16, 320, 64, 64, 2),
}
# the shapes at which every pair of tiles is forced
TILE_EDGE_SHAPES = ("b70-u40", "b130-u300", "unaligned", "b130-tma")
SEQ_ATOL = {"alphas": 1e-6, "other": 1e-5}


def _seq_inputs(device, B, R, A, D, E, U, T, seed=0):
    """Seeded inputs of K4 with weights at 1 / sqrt(fan-in) and every bias
    live."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *s, scale=1.0: (  # noqa: E731
        torch.randn(*s, generator=gen) * scale).to(device)
    return (rand(B, R, A), rand(B, R, D), rand(B, T, E),
            rand(U, A, scale=2 / U ** 0.5), rand(A, scale=0.5),
            rand(A, scale=3 / A ** 0.5), rand(1),
            rand(D + E, 4 * U, scale=1 / (D + E) ** 0.5),
            rand(U, 4 * U, scale=1 / U ** 0.5), rand(4 * U, scale=0.5))


@pytest.mark.parametrize("shape", list(SEQ_SHAPES))
def test_seq_kernel_matches_plain_version(cuda, shape):
    from masters_thesis_tpu_torch.ops import fused_seq

    B, R, A, D, E, U, T = SEQ_SHAPES[shape]
    inputs = _seq_inputs(cuda, B, R, A, D, E, U, T)
    before = fused_seq.fused_seq_forward.launches
    got = fused_seq.fused_seq_forward(*inputs, 0.2)
    torch.cuda.synchronize()
    assert fused_seq.fused_seq_forward.launches == before + 1
    _check_seq(got, fused_seq.fused_seq_forward_reference(*inputs, 0.2), B,
               R, A, U, T)
    assert torch.allclose(got[2].sum(-1), torch.ones(B, T, device=cuda),
                          atol=1e-5)


def _check_seq(got, want, B, R, A, U, T):
    names = ("hseq", "cseq", "alphas", "zs", "hwps")
    widths = (U, U, R, 4 * U, A)
    for name, g, w, width in zip(names, got, want, widths):
        assert g.shape == w.shape == (B, T, width), name
        atol = SEQ_ATOL["alphas" if name == "alphas" else "other"]
        assert torch.allclose(g, w, rtol=0, atol=atol), (
            name, float((g - w).abs().max()))


@pytest.mark.parametrize("hw_tile", [i for i, t in enumerate(TILES)
                                     if t.gates == 1])
@pytest.mark.parametrize("cell_tile", [i for i, t in enumerate(TILES)
                                       if t.gates == 4])
def test_every_tile_matches_plain_version(cuda, cell_tile, hw_tile):
    """K4 with each LSTM tile for its cell and each dense tile for h W2,
    whatever ``pick_tile`` would take, at the shapes of TILE_EDGE_SHAPES
    that the tiles' feeds can take (the TMA tile only b130-tma's): rows past
    B, units past N, a K tail, 4-byte copies."""
    from masters_thesis_tpu_torch.ops import fused_seq

    ran = 0
    for shape in TILE_EDGE_SHAPES:
        B, R, A, D, E, U, T = SEQ_SHAPES[shape]
        inputs = _seq_inputs(cuda, B, R, A, D, E, U, T)
        try:
            plans = fused_seq.seq_plans(inputs, force=(cell_tile, hw_tile))
        except ValueError:          # a feed that cannot take these shapes
            continue
        got = fused_seq._launch(inputs, 0.2, plans)
        torch.cuda.synchronize()
        _check_seq(got, fused_seq.fused_seq_forward_reference(*inputs, 0.2),
                   B, R, A, U, T)
        ran += 1
    assert ran >= 1


@pytest.mark.parametrize("shape", ["small-odd", "unaligned"])
def test_seq_kernel_refuses_plans_it_cannot_run(cuda, shape):
    """The C entry point returns an error, and launches nothing on the plan
    at fault, for an index past the table, a tile of the wrong kind (a
    dense tile for the cell, an LSTM one for h W2), a feed the tile has not
    (TMA on a sliced tile, cp.async on the TMA tile, TMA where the widths
    are off its 32-row chunk, 16-byte copies of widths that are not a
    multiple of 4) and slices it has not: nothing falls back to another
    kernel."""
    from masters_thesis_tpu_torch.ops import fused_seq

    inputs = _seq_inputs(cuda, *SEQ_SHAPES[shape])
    cell, hw = fused_seq.seq_plans(inputs)
    lstm = cell.tile
    tma = next(i for i, t in enumerate(TILES) if t.tma)
    bad = [(Plan(len(TILES), cell.feed, 8), hw), (cell, Plan(-1, 0, 1)),
           (hw, hw), (cell, cell),
           (Plan(lstm, FEED_TMA, 8), hw), (Plan(tma, 0, 1), hw),
           (Plan(tma, FEED_TMA, 1), hw),
           (Plan(lstm, cell.feed, TILES[lstm].ks + 1), hw),
           (Plan(lstm, cell.feed, 0), hw)]
    if shape == "unaligned":
        bad.append((Plan(lstm, FEED_X16, 8), hw))
    for plans in bad:
        with pytest.raises(RuntimeError, match="CUDA error"):
            fused_seq._launch(inputs, 0.2, plans)


def test_seq_kernel_refuses_wrong_shapes(cuda):
    from masters_thesis_tpu_torch.ops import fused_seq

    inputs = list(_seq_inputs(cuda, *SEQ_SHAPES["small-odd"]))
    inputs[7] = inputs[7][:-1]                       # wx one row short
    before = fused_seq.fused_seq_forward.launches
    with pytest.raises(ValueError, match="wx"):
        fused_seq.fused_seq_forward(*inputs, 0.2)
    inputs = list(_seq_inputs(cuda, *SEQ_SHAPES["small-odd"]))
    inputs[0] = inputs[0].cpu()
    with pytest.raises(ValueError, match="CUDA device"):
        fused_seq.fused_seq_forward(*inputs, 0.2)
    assert fused_seq.fused_seq_forward.launches == before


def test_custom_backward_with_the_kernel_matches_autograd(cuda):
    """Loss and every parameter's gradient through
    ``make_fused_forward_loss(backend="kernel")`` against autograd of the
    model's eval forward, within 2e-5 of the larger of 1 and the leaf's
    largest entry (the JAX package's criterion)."""
    from masters_thesis_tpu_torch.ops import fused_seq
    from masters_thesis_tpu_torch.train.losses import caption_loss

    model, betas = _model_and_betas(cuda, "small")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(1, 40, (len(betas), 6), generator=gen).to(cuda)
    target = torch.roll(tokens, -1, 1)
    names, params = zip(*model.named_parameters())
    a0 = torch.zeros(len(betas), model.units, device=cuda)
    ref = caption_loss(model(betas, tokens, a0, a0)[0], target)
    before = fused_seq.fused_seq_forward.launches
    loss = fused_seq.make_fused_forward_loss(model, None, "kernel")(
        betas, tokens, target)
    assert fused_seq.fused_seq_forward.launches == before + 1
    assert abs(loss.item() - ref.item()) < 1e-5
    for name, g, w in zip(names, torch.autograd.grad(loss, params),
                          torch.autograd.grad(ref, params)):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-5 * scale, name


@pytest.mark.parametrize("shape", list(SHAPES))
def test_seq_kernel_on_greedy_words_reproduces_the_decode(cuda, shape):
    """K4 teacher-forced on K2's own greedy words (the start id, then each
    step's word) computes K2's steps on the same inputs in the same order,
    so it gives K2's alphas exactly: its sliced tiles sum the cell's
    products in rows_kernel's 8 classes and h W2's in block_vecmat's (the
    plans of ops/tiles.py), and its attention is K2's code."""
    from masters_thesis_tpu_torch.ops import fused_seq

    model, betas = _model_and_betas(cuda, shape)
    T = model.max_length
    with torch.inference_mode():
        inputs = fused_decode.decode_inputs(model, betas, 1)
        words, alphas = fused_decode.fused_greedy_decode(*inputs,
                                                         max_length=T)
        tokens = torch.cat([torch.ones_like(words[:, :1]), words[:, :-1]], 1)
        sp = fused_seq.extract_seq_params(model)
        out = fused_seq.fused_seq_forward(
            inputs[0], inputs[1], model.embed(tokens.long()),
            *(sp[k] for k in fused_seq.W_KEYS), 0.2)
    assert torch.equal(out[2], alphas)


# ---- P1, P2, P3: the gather probe's kernels ----

# (store rows, row width, copied width, ids): a row of 1,332 B whose pitch
# is not a multiple of 16, a cut width, more ids than SMs, and the probe's
# raw rows (fp32 1,310,736 B; bf16 655,368 B, not a multiple of 16)
PROBE_SHAPES = {
    "small-odd": (37, 333, 333, 11),
    "small-cut": (37, 333, 201, 11),
    "many-ids": (37, 333, 333, 500),
    "probe-raw": (40, 327_684, 327_684, 11),
}
# P1's chunks in columns: one that divides no width here, the probe's
# s_block 8 and 856 (x 128 lanes), and more than a row
CHUNK_COLS = (100, 8 * 128, 856 * 128, 400_000)
BULK_STAGES = (1, 2, 4, 8, 16)


def _probe_case(device, shape, dtype, id_dtype):
    n, w, width, count = PROBE_SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(0)
    store = torch.randn(n, w, generator=gen, device=device).to(dtype)
    ids = torch.randint(0, n, (count,), generator=gen, device=device)
    ids[:8] = torch.tensor([1, 3, 3, 0, n - 1, -5, n + 9, 2 * n])
    return store, ids.to(id_dtype), width


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(PROBE_SHAPES))
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_probe_kernels_match_plain_version(cuda, shape, dtype, id_dtype):
    """P1 at every chunk and P2 at every stage count, on repeated ids and
    ids past both ends (clamped): equal to the plain version bit for bit."""
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows_bulk,
        gather_rows_chunked,
        gather_rows_reference,
    )

    store, ids, width = _probe_case(cuda, shape, dtype, id_dtype)
    want = gather_rows_reference(store, ids, width)
    for wrapper, key, settings in ((gather_rows_chunked, "chunk_cols",
                                    CHUNK_COLS),
                                   (gather_rows_bulk, "stages",
                                    BULK_STAGES)):
        for setting in settings:
            before = wrapper.launches
            got = wrapper(store, ids, width=width, **{key: setting})
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert got.shape == want.shape and got.is_contiguous()
            assert torch.equal(got, want), (wrapper.__name__, setting)


def test_probe_kernels_read_a_strided_store_and_refuse_bad_input(cuda):
    from masters_thesis_tpu_torch.ops.gather import (
        gather_rows_bulk,
        gather_rows_chunked,
        gather_rows_reference,
    )

    base = torch.randn(9, 132, device=cuda)
    ids = torch.tensor([7, 0, 3, 3, -1, 12], device=cuda)
    for store in (base[1:, :100], base[1:, 3:100]):  # pitch 528 B; odd base
        assert torch.equal(gather_rows_chunked(store, ids, 30),
                           gather_rows_reference(store, ids))
    assert torch.equal(gather_rows_bulk(base[1:, :100], ids, 3),
                       gather_rows_reference(base[1:, :100], ids))
    before = (gather_rows_chunked.launches, gather_rows_bulk.launches)
    with pytest.raises(ValueError, match="aligned"):
        gather_rows_bulk(base[1:, 3:100], ids, 4)
    for wrapper, setting in ((gather_rows_chunked, 128),
                             (gather_rows_bulk, 4)):
        with pytest.raises(ValueError, match="store"):
            wrapper(torch.zeros(2, 3, 4, device=cuda), ids, setting)
        with pytest.raises(ValueError, match="idx"):
            wrapper(base, ids.float(), setting)
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(base, ids.cpu(), setting)
    with pytest.raises(ValueError, match="stages"):
        gather_rows_bulk(base, ids, 0)
    with pytest.raises(ValueError, match="chunk_cols"):
        gather_rows_chunked(base, ids, 0)
    assert (gather_rows_chunked.launches, gather_rows_bulk.launches) == before


def test_probe_entry_point_on_the_card(cuda):
    """The probe at a small size on the card: every variant launches its
    kernel and P3 is exact."""
    from masters_thesis_tpu_torch.scripts import gather_probe as probe

    result = probe.run(rows=40, cols=5_000, batch=8, steps=3, device=cuda)
    assert result["exact"] and result["exact_launches"] == 1
    for line in result["variants"][1:]:
        assert line["launches"] >= 2 * 3, line


# ---- the bf16-weight K4 (the TPU kernel at compute dtype bf16) ----

# each step on the kernel's own carries: fp32 sums in another order (~1e-5),
# and now and then a rounding to bf16 that the last bit of an input flips,
# which moves the input by 2^-8 of itself and a whole row of z with it: at
# most BF16_FLIP_ROWS of a residual's (t, b) rows beyond BF16_STEP_ATOL, no
# entry beyond BF16_SEQ_ATOL (as chip_smoke.py)
BF16_STEP_ATOL, BF16_FLIP_ROWS, BF16_SEQ_ATOL = 1e-4, 0.02, 1e-2


def _bf16_weights(inputs):
    from masters_thesis_tpu_torch.ops import fused_seq

    return tuple(t.to(torch.bfloat16) if k in fused_seq.BF16_ARGS else t
                 for k, t in zip(fused_seq.SEQ_ARGS, inputs))


@pytest.mark.parametrize("shape", list(SEQ_SHAPES))
def test_bf16_seq_kernel_matches_plain_version_step_by_step(cuda, shape):
    """The bf16-weight K4 at every shape of the fp32 one: each step against
    the plain version started from the kernel's carries, within 1e-4 but
    for the few rows a flipped bf16 rounding moves; the
    whole sequence no farther from the plain version than the fp32 plain
    version is (the recurrence's rounding of h makes their last-bit
    differences bf16 ones); launches counted apart from the fp32 K4's."""
    from masters_thesis_tpu_torch.ops import fused_seq

    B, R, A, D, E, U, T = SEQ_SHAPES[shape]
    inputs = _seq_inputs(cuda, B, R, A, D, E, U, T)
    half = _bf16_weights(inputs)
    before = (fused_seq.fused_seq_forward.launches,
              fused_seq.fused_seq_forward.launches_bf16)
    got = fused_seq.fused_seq_forward(*half, 0.2)
    torch.cuda.synchronize()
    assert (fused_seq.fused_seq_forward.launches,
            fused_seq.fused_seq_forward.launches_bf16) == (
        before[0], before[1] + 1)
    stepped = fused_seq.fused_seq_forward_reference(
        *half, 0.2, carries=(got[0], got[1]))
    free = fused_seq.fused_seq_forward_reference(*half, 0.2)
    fp32 = fused_seq.fused_seq_forward_reference(*inputs, 0.2)
    for name, g, s, f, w in zip(("hseq", "cseq", "alphas", "zs", "hwps"),
                                got, stepped, free, fp32):
        assert g.shape == s.shape and g.dtype == torch.float32, name
        off = (g - s).abs()
        assert float(off.max()) <= BF16_SEQ_ATOL, name
        assert float((off > BF16_STEP_ATOL).any(-1).float().mean()) <= (
            BF16_FLIP_ROWS), name
        assert float((g - f).abs().max()) <= float((w - f).abs().max()), name


def test_bf16_seq_kernel_refuses_mixed_weight_dtypes(cuda):
    """W2, Wx and Wh all in bf16, or all in fp32, and the rest in fp32:
    anything else raises before a launch; the bf16 kernel takes no plans."""
    from masters_thesis_tpu_torch.ops import fused_seq

    inputs = _seq_inputs(cuda, *SEQ_SHAPES["small-odd"])
    half = list(_bf16_weights(inputs))
    before = fused_seq.fused_seq_forward.launches_bf16
    for i, k in enumerate(fused_seq.SEQ_ARGS):
        bad = list(half)
        bad[i] = (bad[i].float() if k in fused_seq.BF16_ARGS
                  else bad[i].to(torch.bfloat16))
        with pytest.raises(ValueError, match="float32, or w2, wx and wh"):
            fused_seq.fused_seq_forward(*bad, 0.2)
    with pytest.raises(ValueError, match="no tile plans"):
        fused_seq._launch(tuple(half), 0.2, fused_seq.seq_plans(inputs))
    assert fused_seq.fused_seq_forward.launches_bf16 == before


def test_bf16_seq_kernel_refuses_weights_of_another_dtype(cuda):
    """W2, Wx and Wh all in a dtype other than bf16 and fp32 (fp16) are
    refused before a launch: the kernel reads bf16 weights only."""
    from masters_thesis_tpu_torch.ops import fused_seq

    inputs = _seq_inputs(cuda, *SEQ_SHAPES["small-odd"])
    other = tuple(t.half() if k in fused_seq.BF16_ARGS else t
                  for k, t in zip(fused_seq.SEQ_ARGS, inputs))
    before = (fused_seq.fused_seq_forward.launches,
              fused_seq.fused_seq_forward.launches_bf16)
    with pytest.raises(ValueError, match="float32, or w2, wx and wh"):
        fused_seq.fused_seq_forward(*other, 0.2)
    assert (fused_seq.fused_seq_forward.launches,
            fused_seq.fused_seq_forward.launches_bf16) == before


def _ties(x: torch.Tensor) -> torch.Tensor:
    """Each entry moved to the midpoint between its bf16 rounding and the
    next bf16 away from zero: a tie, which rounds to the even neighbour."""
    bits = x.to(torch.bfloat16).float().view(torch.int32)
    return (bits | 0x8000).view(torch.float32)


@pytest.mark.parametrize("shape", ["aligned", "odd"])
def test_bf16_seq_kernel_rounds_its_inputs_as_torch_does(cuda, shape):
    """The bf16 K4 rounds ctx, emb and h to bf16 as ``.to(torch.bfloat16)``
    does, bit for bit, on values at rounding ties. One region makes alpha
    exactly 1 and ctx the features; Wx and Wh copy ctx, emb and h into
    columns of z one each (weights 0 or 1, biases 0), so that z shows the
    rounded inputs exactly: ctx and emb are ties, h is the kernel's own
    h of the step before. ``odd`` widths take the element-by-element
    staging, ``aligned`` the 16-byte copies."""
    from masters_thesis_tpu_torch.ops import fused_seq

    B, A, D, E, U, T = ((16, 8, 16, 32, 24, 3) if shape == "aligned"
                        else (9, 7, 5, 11, 17, 3))
    gen = torch.Generator().manual_seed(3)
    rand = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    features = _ties(rand(B, 1, D))
    emb = _ties(rand(B, T, E))
    emb[:, :, 0] = 1 + 2 ** -8         # rounds down, to even 1
    emb[:, :, 1] = 1 + 3 * 2 ** -8     # rounds up, to even 1 + 2^-6
    wx = torch.zeros(D + E, 4 * U)
    wh = torch.zeros(U, 4 * U)
    wx[torch.arange(D + E), torch.arange(D + E)] = 1
    wh[torch.arange(U), D + E + torch.arange(U)] = 1
    assert D + E + U <= 4 * U
    inputs = [t.to(cuda) for t in (
        rand(B, 1, A), features, emb, rand(U, A) / U ** 0.5, rand(A),
        rand(A), rand(1), wx, wh, torch.zeros(4 * U))]
    half = _bf16_weights(inputs)
    hseq, _, alphas, zs, _ = fused_seq.fused_seq_forward(*half, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(alphas, torch.ones_like(alphas))
    h_prev = torch.cat([torch.zeros_like(hseq[:, :1]), hseq[:, :-1]], 1)
    want = torch.cat([features.to(cuda).expand(B, T, D), emb.to(cuda),
                      h_prev], -1).to(torch.bfloat16).float()
    got = zs[..., :D + E + U]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        (got != want).nonzero()[:5].tolist())
    # the ties really were ties, and both ways of rounding were taken
    assert not torch.equal(want[..., :D + E], torch.cat(
        [features.to(cuda).expand(B, T, D), emb.to(cuda)], -1))
    assert bool((want[..., D] == 1).all()) and bool(
        (want[..., D + 1] == 1 + 2 ** -6).all())


def test_bf16_sequence_through_the_kernel_matches_the_scan_forward(cuda):
    """``make_fused_sequence(backend="kernel", compute_dtype=bf16)`` on the
    card: the bf16 K4 forward and the custom backward; its gradients
    against those of the same sequence with the plain version's forward
    (each gradient within 1e-2 of max(1, the leaf's largest entry): the
    two forwards' residuals differ by bf16 roundings)."""
    from masters_thesis_tpu_torch.ops import fused_seq

    inputs = _seq_inputs(cuda, *SEQ_SHAPES["small-odd"])
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        w = dict(zip(fused_seq.W_KEYS, leaves[3:]))
        seq = fused_seq.make_fused_sequence(0.2, "kernel",
                                            compute_dtype=torch.bfloat16)
        before = fused_seq.fused_seq_forward.launches_bf16
        if plain:
            real = fused_seq.plain_or_kernel
            fused_seq.plain_or_kernel = lambda name, args: True
        try:
            hseq, alphas = seq(w, *leaves[:3])
        finally:
            if plain:
                fused_seq.plain_or_kernel = real
        assert fused_seq.fused_seq_forward.launches_bf16 == before + (
            not plain)
        grads.append(torch.autograd.grad(
            hseq.square().sum() + alphas.sum(), leaves))
    for g, want in zip(*grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        scale = max(1.0, float(want.abs().max()))
        assert float((g - want).abs().max()) <= 1e-2 * scale


# ---- the bf16-weight K2 and K3 ----

# A one-step decode is held to the fp32 limits of compare_with_reference;
# over more steps the bf16 rounding of h turns summation-order differences
# into bf16 ones, so the alphas are held to BF16_DECODE_ATOL and a word may
# differ only where the plain version's top-2 margin is under
# BF16_DECODE_TIE (chip_smoke.py's BF16_ALPHA_ATOL and BF16_TIE_MARGIN).
BF16_DECODE_ATOL, BF16_DECODE_TIE = 1e-3, 1e-2


def _check_bf16_decode(cell, args, opts, T, min_distinct=0):
    """The bf16-weight kernel of ``cell`` against its bf16 plain version on
    ``args`` (already cast): T = 1 within the fp32 limits, T steps within
    the bf16 ones; each launch counted in ``launches_bf16`` alone."""
    kernel = (fused_decode.fused_greedy_decode_gru if cell == "gru"
              else fused_decode.fused_greedy_decode)
    reference = (fused_decode.fused_greedy_decode_gru_reference
                 if cell == "gru"
                 else fused_decode.fused_greedy_decode_reference)
    B, R = args[0].shape[:2]
    for steps, atol, tie in ((1, 1e-6, 1e-3),
                             (T, BF16_DECODE_ATOL, BF16_DECODE_TIE)):
        before = (kernel.launches, kernel.launches_bf16)
        with torch.inference_mode():
            words, alphas = kernel(*args, max_length=steps, **opts)
            torch.cuda.synchronize()
            ref_words, ref_alphas, margins = reference(
                *args, max_length=steps, return_margins=True, **opts)
        assert (kernel.launches, kernel.launches_bf16) == (before[0],
                                                           before[1] + 1)
        assert words.shape == (B, steps) and alphas.shape == (B, steps, R)
        assert alphas.dtype == torch.float32
        report = fused_decode.compare_with_reference(
            words, alphas, ref_words, ref_alphas, margins, alpha_atol=atol,
            tie_margin=tie)
        assert report["bad_rows"] == [], (steps, report)
    assert len(torch.unique(ref_words)) >= min_distinct
    return words


BF16_K2_CASES = {
    "small": ("small", None, False),
    "small-feat_bf16": ("small", None, True),
    "small-1-row": ("small", 1, False),
    "small-5-rows": ("small", 5, True),
    "flagship": ("flagship", None, False),
    "flagship-feat_bf16": ("flagship", None, True),
}


@pytest.mark.parametrize("case", list(BF16_K2_CASES))
def test_bf16_k2_matches_plain_version(cuda, case):
    """The bf16-weight K2 at the shapes of the fp32 one (and service
    batches of 1 and 5 rows, whose tiles are mostly rows past B), with
    feat_bf16 off and on."""
    shape, rows, feat = BF16_K2_CASES[case]
    model, betas = _model_and_betas(cuda, shape)
    betas = betas if rows is None else betas[:rows]
    with torch.inference_mode():
        args = fused_decode.cast_decode_inputs(
            "lstm", fused_decode.decode_inputs(model, betas, 1),
            weights_bf16=True, feat_bf16=feat)
    _check_bf16_decode("lstm", args, fused_decode.decode_options(model),
                       model.max_length,
                       MIN_DISTINCT[shape] if rows is None else 0)


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_bf16_k2_at_the_tiles_edges(cuda, shape):
    """The bf16-weight K2 on DECODE_SHAPES: batches and widths that are
    multiples of no tile (rows past B, units past N, a K tail), widths
    that are not a multiple of 8 (element-by-element staging)."""
    args = fused_decode.cast_decode_inputs(
        "lstm", _decode_case(cuda, *DECODE_SHAPES[shape]), weights_bf16=True)
    _check_bf16_decode("lstm", args, dict(slope=0.2, attn_slope=0.2),
                       DECODE_T, 4)


def _bf16_k3(cuda, shape, zero_state, rows=None):
    """The bf16-weight K3 against its plain version on a CnnRnn model of
    GRU_SHAPES' ``shape`` (its first ``rows`` rows, if given)."""
    patches, channels, units, vocab, true_vocab, batch = GRU_SHAPES[shape]
    full = shape == "cnn_rnn"
    gen = torch.Generator().manual_seed(0 if full else SMALL_SEED)
    model = CnnRnnNIC(embed_dim=256 if full else 64, units=units,
                      vocab_size=vocab, true_vocab=true_vocab,
                      max_length=15 if full else 6, n_patches=patches,
                      in_channels=channels, gru_zero_state=zero_state,
                      generator=gen)
    fused_decode.spread_for_check(model, gen)
    betas = torch.randn(batch, patches, channels, generator=gen)[:rows]
    model = model.to(cuda).eval()
    with torch.inference_mode():
        args = fused_decode.cast_decode_inputs(
            "gru", fused_decode.decode_inputs(model, betas.to(cuda), 1),
            weights_bf16=True)
    min_distinct = (0 if rows is not None
                    else 16 if full else SMALL_MIN_DISTINCT)
    words = _check_bf16_decode("gru", args,
                               fused_decode.decode_options(model),
                               model.max_length, min_distinct)
    if true_vocab:
        assert int(words.max()) < true_vocab


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("shape", list(GRU_SHAPES))
def test_bf16_k3_matches_plain_version(cuda, shape, zero_state):
    """The bf16-weight K3 at the shapes of the fp32 one, both values of the
    zero-state quirk."""
    _bf16_k3(cuda, shape, zero_state)


@pytest.mark.parametrize("rows", [1, 5])
def test_bf16_k3_at_service_batches(cuda, rows):
    """The bf16-weight K3, carried state, on batches of 1 and 5 rows:
    every row tile mostly rows past B."""
    _bf16_k3(cuda, "small-odd-regions", False, rows)


def _tie_case(device, B, D, E, U, H):
    """K2's arguments (T = 1) under which the word of row b says which way
    the kernel rounded ctx[b, 0] to bf16. One region makes alpha exactly 1
    and ctx the features; ctx[b, 0] is a tie x_b (the midpoint of two bf16
    values in [1, 2), 2^-7 apart) and ctx[b, 1] the lower one, l_b. The g
    gate of unit 0 is 2^7 (ctx0 - ctx1): 1 where x_b rounds up, 0 where it
    rounds down; its i and o gates are saturated, so h0' = tanh(sig(10)
    tanh(1)) sig(10) ~ 0.64 or 0; the logits are [h0', 0.3, ...], so the
    word is 0 (up) or 1 (down)."""
    gen = torch.Generator().manual_seed(5)
    j = torch.randint(0, 128, (B,), generator=gen).float()
    low = 1 + j * 2 ** -7
    features = torch.zeros(B, 1, D)
    features[:, 0, 0] = low + 2 ** -8
    features[:, 0, 1] = low
    wx = torch.zeros(D + E, 4 * U)
    wx[0, 2 * U] = 2.0 ** 7
    wx[1, 2 * U] = -2.0 ** 7
    b = torch.zeros(4 * U)
    b[0], b[3 * U] = 10.0, 10.0
    wi = torch.zeros(U, H)
    wi[0, 0] = 1.0
    wo = torch.zeros(H, 128)
    wo[0, 0] = 1.0
    bo = torch.full((128,), fused_decode.PAD_NEG)
    bo[:2] = torch.tensor([0.0, 0.3])
    emb_table = torch.randn(128, E, generator=gen)
    zeros = torch.zeros(B, U)
    args = (torch.randn(B, 1, 8, generator=gen), features,
            torch.randn(U, 8, generator=gen), torch.randn(8, generator=gen),
            torch.randn(8, generator=gen), torch.randn(1, generator=gen), wx,
            torch.zeros(U, 4 * U), b, wi, torch.zeros(H), wo, bo, emb_table,
            emb_table[1], zeros, zeros)
    up = features[:, 0, 0].to(torch.bfloat16).float() > low
    return [t.to(device) for t in args], up


@pytest.mark.parametrize("shape", ["aligned", "odd"])
def test_bf16_k2_rounds_at_ties_as_torch_does(cuda, shape):
    """The bf16-weight K2 rounds ctx to bf16 as ``.to(torch.bfloat16)``
    does (to nearest even) at ties, both ways (``_tie_case``); ``aligned``
    widths take the 16-byte staging, ``odd`` the element-by-element one.
    Its words equal the plain version's."""
    B, D, E, U, H = ((32, 16, 32, 24, 16) if shape == "aligned"
                     else (9, 5, 11, 17, 13))
    args, up = _tie_case(cuda, B, D, E, U, H)
    args = fused_decode.cast_decode_inputs("lstm", args, weights_bf16=True)
    words, _ = fused_decode.fused_greedy_decode(*args, max_length=1)
    torch.cuda.synchronize()
    want = torch.where(up.to(cuda), 0, 1).to(torch.int32)
    assert 0 < int(up.sum()) < B        # both ways are taken
    assert torch.equal(words[:, 0], want)
    ref, _ = fused_decode.fused_greedy_decode_reference(*args, max_length=1)
    assert torch.equal(ref, words)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_argmax_takes_the_first_index_on_a_tie(cuda, cell):
    """Logits that tie at ids 3 and 7 (Wo zero, the bias equal there): the
    bf16-weight kernel takes 3 at every step, as torch.argmax does."""
    if cell == "lstm":
        args = list(_decode_case(cuda, *DECODE_SHAPES["b70-u40"]))
    else:
        args = list(_decode_case(cuda, *DECODE_SHAPES["b70-u40"]))
        U = args[7].shape[0]
        gen = torch.Generator().manual_seed(1)
        args[6] = args[6][:, :3 * U].contiguous()
        args[7] = args[7][:, :3 * U].contiguous()
        args[8:9] = [torch.randn(3 * U, generator=gen).to(cuda),
                     torch.randn(3 * U, generator=gen).to(cuda)]
        del args[-1]                                      # no c0
    names = fused_decode.DECODE_ARGS[cell]
    wo, bo = names.index("wo"), names.index("bo")
    args[wo] = torch.zeros_like(args[wo])
    args[bo] = torch.full_like(args[bo], -1.0)
    args[bo][[3, 7]] = 2.0
    args = fused_decode.cast_decode_inputs(cell, args, weights_bf16=True)
    kernel = (fused_decode.fused_greedy_decode_gru if cell == "gru"
              else fused_decode.fused_greedy_decode)
    words, _ = kernel(*args, max_length=DECODE_T)
    torch.cuda.synchronize()
    assert bool((words == 3).all())


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_decode_refuses_mixed_dtypes_before_a_launch(cuda, cell):
    """Each weight of BF16_WEIGHTS alone in fp32, one of BF16_FEATURES
    alone in bf16, an fp32-only tensor in bf16, fp16 weights, bf16 features
    beside fp32 weights: a ValueError before any launch, ``launches_bf16``
    unmoved; the bf16-weight decode takes no tile plans."""
    model, betas = _model_and_betas(cuda, "small")
    if cell == "gru":
        gen = torch.Generator().manual_seed(0)
        model = CnnRnnNIC(embed_dim=64, units=16, vocab_size=40,
                          max_length=6, n_patches=7, in_channels=24,
                          generator=gen).to(cuda).eval()
        betas = torch.randn(6, 7, 24, generator=gen).to(cuda)
    kernel, _ = fused_decode.decode_kernel(model)
    opts = fused_decode.decode_options(model)
    names = fused_decode.DECODE_ARGS[cell]
    with torch.inference_mode():
        fp32 = fused_decode.decode_inputs(model, betas, 1)
    half = fused_decode.cast_decode_inputs(cell, fp32, weights_bf16=True,
                                           feat_bf16=True)
    bad = []
    for i, name in enumerate(names):
        args = list(half)
        args[i] = (args[i].float() if name in fused_decode.BF16_WEIGHTS
                   + fused_decode.BF16_FEATURES
                   else args[i].to(torch.bfloat16))
        bad.append(args)
    bad.append([t.half() if n in fused_decode.BF16_WEIGHTS else t
                for n, t in zip(names, fp32)])
    bad.append([t.to(torch.bfloat16) if n in fused_decode.BF16_FEATURES
                else t for n, t in zip(names, fp32)])
    before = (kernel.launches, kernel.launches_bf16)
    for args in bad:
        with pytest.raises(ValueError, match="bfloat16"):
            kernel(*args, max_length=2, **opts)
    if cell == "lstm":
        with pytest.raises(ValueError, match="no tile plans"):
            fused_decode._launch("lstm", half, max_length=2, slope=0.2,
                                 attn_slope=0.2,
                                 plans=fused_decode.lstm_decode_plans(fp32))
    assert (kernel.launches, kernel.launches_bf16) == before


# ---- the persistent bf16-weight decode's plans ----

@pytest.mark.parametrize("rows", [65, 130, 256])
def test_bf16_k2_at_batches_past_one_row_a_block(cuda, rows):
    """The bf16-weight K2 at flagship widths on 65, 130 and 256 rows:
    more rows than a 64-row pass of a product, and at 256 more rows than
    blocks (two attention rows a block, streamed)."""
    model, _ = _model_and_betas(cuda, "flagship")
    gen = torch.Generator().manual_seed(rows)
    betas = torch.randn(rows, 327_684, generator=gen).to(cuda)
    with torch.inference_mode():
        args = fused_decode.cast_decode_inputs(
            "lstm", fused_decode.decode_inputs(model, betas, 1),
            weights_bf16=True)
    _check_bf16_decode("lstm", args, fused_decode.decode_options(model),
                       model.max_length, MIN_DISTINCT["flagship"])


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_decode_is_the_same_bit_for_bit_from_call_to_call(cuda, cell):
    """No sum of the persistent kernel depends on timing: two calls on the
    same inputs give the same words and alphas, bit for bit."""
    if cell == "lstm":
        model, betas = _model_and_betas(cuda, "flagship")
    else:
        gen = torch.Generator().manual_seed(0)
        model = CnnRnnNIC(embed_dim=256, units=512, vocab_size=5001,
                          max_length=15, n_patches=64, in_channels=2048,
                          gru_zero_state=False, generator=gen)
        fused_decode.spread_for_check(model, gen)
        betas = torch.randn(64, 64, 2048, generator=gen)
        model, betas = model.to(cuda).eval(), betas.to(cuda)
    kernel, _ = fused_decode.decode_kernel(model)
    opts = fused_decode.decode_options(model)
    with torch.inference_mode():
        args = fused_decode.cast_decode_inputs(
            cell, fused_decode.decode_inputs(model, betas, 1),
            weights_bf16=True)
        first = kernel(*args, max_length=model.max_length, **opts)
        second = kernel(*args, max_length=model.max_length, **opts)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("sms, shape, cell", [
    (3, "b130-u300", "lstm"), (3, "b70-u40", "lstm"), (8, "tma", "lstm"),
    (4, "b130-u300", "gru"), (3, "b70-u40", "gru")])
def test_bf16_decode_on_plans_of_few_blocks(cuda, sms, shape, cell):
    """Plans of a few blocks, forced: a block then owns several unit panels
    (more than 16 units), several vocab panels (more than 64 ids), several
    attention rows and a tall h W2 tile, as on a card of few SMs."""
    from masters_thesis_tpu_torch.ops.decode_plan import decode_plan

    B, R, A, D, E, U, H, V = DECODE_SHAPES[shape]
    args = list(_decode_case(cuda, B, R, A, D, E, U, H, V))
    opts = dict(slope=0.2, attn_slope=0.2)
    if cell == "gru":
        gen = torch.Generator().manual_seed(1)
        args[6] = args[6][:, :3 * U].contiguous()
        args[7] = args[7][:, :3 * U].contiguous()
        args[8:9] = [torch.randn(3 * U, generator=gen).to(cuda),
                     torch.randn(3 * U, generator=gen).to(cuda)]
        del args[-1]
        opts["zero_state"] = False
    args = fused_decode.cast_decode_inputs(cell, args, weights_bf16=True)
    reference = (fused_decode.fused_greedy_decode_gru_reference
                 if cell == "gru"
                 else fused_decode.fused_greedy_decode_reference)
    Vp = args[fused_decode.DECODE_ARGS[cell].index("wo")].shape[1]
    for T, atol, tie in ((1, 1e-6, 1e-3), (DECODE_T, 1e-3, 1e-2)):
        plan = decode_plan(cell, B, R, A, D, E, U, H, Vp, T, sms=sms)
        assert plan.header["blocks"] == sms
        with torch.inference_mode():
            words, alphas = fused_decode._launch(
                cell, args, max_length=T, plan=plan, **opts)
            torch.cuda.synchronize()
            ref = reference(*args, max_length=T, return_margins=True,
                            **opts)
        report = fused_decode.compare_with_reference(
            words, alphas, *ref, alpha_atol=atol, tie_margin=tie)
        assert report["bad_rows"] == [], (T, report)


def _forged(plan, header=None, block=None, at=0):
    """``plan`` with some header fields, and some fields of block ``at``,
    replaced."""
    from masters_thesis_tpu_torch.ops.decode_plan import DecodePlan

    blocks = [dict(b) for b in plan.blocks]
    blocks[at].update(block or {})
    return DecodePlan({**plan.header, **(header or {})}, tuple(blocks))


def test_bf16_decode_refuses_plans_it_cannot_run(cuda):
    """The C side refuses, before anything runs: more blocks than can all
    be resident at once (a cooperative launch), a block over the card's
    shared memory, a layout whose regions overlap or overrun the block's
    bytes, units or vocab ids cut out of order or left without an owner,
    h W2 tiles that overlap, and attention rows that do not match the
    grid. The good plan still runs. Nothing falls back."""
    from masters_thesis_tpu_torch.ops.decode_plan import decode_plan

    model, betas = _model_and_betas(cuda, "flagship")
    with torch.inference_mode():
        args = fused_decode.cast_decode_inputs(
            "lstm", fused_decode.decode_inputs(model, betas, 1),
            weights_bf16=True)
    T = 3
    B, R, A = args[0].shape
    D, U, E = args[1].shape[2], args[2].shape[0], args[13].shape[1]
    H, V = args[11].shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    good = decode_plan("lstm", B, R, A, D, E, U, H, V, T, sms=sms)
    b0, b1 = good.blocks[0], good.blocks[1]
    # two blocks that hold h W2 tiles
    t0, t1 = [j for j, b in enumerate(good.blocks) if b["a1"] > b["a0"]][:2]
    last = good.header["smem"] - good.header["scratch"]
    bad = {
        "blocks past co-residency": decode_plan(
            "lstm", B, R, A, D, E, U, H, V, T, sms=2 * sms),
        "over the card's shared memory": _forged(
            good, header={"smem": 232_449}),
        "a block past its bytes": _forged(
            good, header={"smem": good.header["smem"] - 16}),
        "overlapping regions": _forged(
            good, block={"off_wo": b0["off_wi"]}),
        "units out of order": _forged(
            good, block={"u0": b1["u0"] + 2}, at=1),
        "a vocab id without an owner": _forged(
            good, block={"o1": b0["o1"] - 8, "o0": b0["o0"]}),
        "overlapping h W2 tiles": _forged(
            good, at=t0, block={k: good.blocks[t1][k]
                                for k in ("r0", "r1", "a0", "a1")}),
        "attention rows off the grid": _forged(
            good, block={"rows": b0["rows"] + 1}),
        "a ring too deep": _forged(good, header={"stages": 17}),
    }
    past = bad["blocks past co-residency"].header
    assert past["blocks"] == 2 * sms and past["smem"] > 232_448 // 2
    assert last > 0
    for what, plan in bad.items():
        try:
            fused_decode._launch("lstm", args, max_length=T, slope=0.2,
                                 attn_slope=0.2, plan=plan)
        except RuntimeError as err:
            assert "CUDA error" in str(err), (what, err)
        else:
            pytest.fail(f"{what}: the plan ran")
    words, _ = fused_decode._launch("lstm", args, max_length=T, slope=0.2,
                                    attn_slope=0.2, plan=good)
    torch.cuda.synchronize()
    assert words.shape == (B, T)


# K2's and K3's kernels by name, as the benchmark's roofline readers match
# them (either tile feed, the attention, the row kernel, the argmax)
DECODE_KERNELS = {"lstm": ("::tile_kernel", "::attention_kernel<",
                           "::argmax_embed_kernel("),
                  "gru": ("::tile_kernel", "::attention_kernel<",
                          "::rows_kernel<", "::argmax_embed_kernel(")}


@pytest.mark.parametrize("cell", list(DECODE_KERNELS))
def test_device_spans_time_the_decode(cuda, cell, tmp_path):
    """Under the profiler a gather and a decode at flagship width and the
    benchmark cells' batches (LcNIC's 256 rows for K2, CnnRnn's 64 for K3)
    keep one event pair for each span, in order, and the same words;
    ``decode.kernel``'s extent, which also holds the gaps between the
    chain's launches, lies within 10% of the decode's kernels by name in
    the same trace. A sleep ahead of them keeps the card busy while the
    host enqueues, so the extent holds no wait for the host."""
    from torch.autograd import DeviceType

    from masters_thesis_tpu_torch.ops.gather import gather_rows
    from masters_thesis_tpu_torch.utils import profiling

    if cell == "lstm":
        model, betas = _model_and_betas(cuda, "flagship")
        store = betas.repeat(4, 1)
        shape = (len(store), store.shape[1])
    else:
        gen = torch.Generator().manual_seed(0)
        model = CnnRnnNIC(gru_zero_state=True, generator=gen).eval()
        fused_decode.spread_for_check(model, gen)
        model = model.to(cuda)
        store = torch.randn(64, 64 * 2048, generator=gen).to(cuda)
        shape = (64, 64, 2048)
    decode = fused_decode.make_whole_fused_greedy_decoder(model, 15)
    ids = torch.arange(len(store), device=cuda).flip(0)

    def run():
        return decode(gather_rows(store, ids).view(shape), 1)

    words, alphas = run()
    torch.cuda.synchronize()
    prof = profiling.start_trace(str(tmp_path), cuda)
    try:
        torch.cuda._sleep(200_000_000)
        traced_words, traced_alphas = run()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    assert torch.equal(words, traced_words)
    assert torch.equal(alphas, traced_alphas)
    spans = profiling.device_spans()
    assert [s[0] for s in spans] == ["gather", "decode.inputs",
                                     "decode.kernel"]
    extent = spans[2][1].elapsed_time(spans[2][2])
    by_name = sum(e.time_range.end - e.time_range.start
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(p in e.name for p in DECODE_KERNELS[cell])) / 1e3
    assert by_name > 0
    assert abs(extent - by_name) <= 0.1 * by_name, (extent, by_name)
