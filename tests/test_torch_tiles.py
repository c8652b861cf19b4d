"""The plans of the pipelined tile kernel (``ops/tiles.py``), on the CPU.

The CUDA kernel cannot run here, so what surrounds it is held here: the
Python table and constants are the kernel's own (read from
``csrc/tile_kernels.cuh`` and ``csrc/step_kernels.cuh``), and for every
shape that ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``
launch, the tile that ``pick_tile`` gives is instantiated, of the right
kind, fits the shared memory of a block, covers every row and unit, and
fills a wave of the card wherever B x N allows; its plan has a feed the
tile can take and the slices of the kernel K2 ran for the same product
before K2 itself ran on the tile kernel (``ops.fused_decode
.lstm_decode_plans``: h W2, the cell, Wi and Wo), and K3's head the
slices of the row kernel it ran on before (``ops.fused_decode
.gru_decode_plans``: h W2, Wi and Wo).
"""

import math
import re
from pathlib import Path

import pytest
import torch

from masters_thesis_tpu_torch.ops.fused_decode import (
    gru_decode_plans,
    lstm_decode_plans,
)
from masters_thesis_tpu_torch.ops.tiles import (
    FEED_TMA,
    FEED_W16,
    FEED_X16,
    MAX_GRID_Y,
    MAX_THREADS,
    ROW_SLICES,
    SMEM_LIMIT,
    TILES,
    VECMAT_THREADS,
    WAVE_FILL,
    Plan,
    pick_tile,
    plan,
)

from torch_threads import one_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "masters_thesis_tpu_torch" / "csrc"

# (B, N, K's segment widths, gates, the tile the main path must get or
# None). The main path: K4's cell (N = U over [ctx | emb | h], widths
# (D, E, U)) and h W2 (N = A over h, widths (U,)) at flagship and at the
# wide shape, K2's head at LcNIC width (its h W2 and cell are K4's
# flagship ones), and K3's h W2 and head at CnnRnn width; then the CUDA
# tests' K4 shapes (SEQ_SHAPES (B, R, A, D, E, U, T), the LcNIC "small"
# model of the greedy-words test) and K3's h W2 (GRU_SHAPES: A = U =
# units).
CASES = {
    "k4-flagship-cell": (64, 512, (32, 512, 512), 4, "l32x8"),
    "k4-flagship-hw": (64, 32, (512,), 1, "d16x8"),
    "k4-wide-cell": (256, 2048, (128, 1024, 2048), 4, "l128x32"),
    "k4-wide-hw": (256, 256, (2048,), 1, "d32x16"),
    "k2-lcnic-wi": (64, 256, (512,), 1, "d16x8"),
    "k2-lcnic-wo": (64, 5120, (256,), 1, "d64x40"),
    "k2-lcnic-wo-b256": (256, 5120, (256,), 1, "d64x40"),
    "k3-cnn_rnn-hw": (64, 512, (512,), 1, "d16x8"),
    "k3-cnn_rnn-wi": (64, 512, (512,), 1, "d16x8"),
    "k3-cnn_rnn-wo": (64, 5120, (512,), 1, "d64x40"),
    "seq-small-odd-cell": (6, 24, (4, 16, 24), 4, None),
    "seq-small-odd-hw": (6, 8, (24,), 1, None),
    "seq-wide-cell": (11, 40, (260, 24, 40), 4, None),
    "seq-wide-hw": (11, 300, (40,), 1, None),
    "seq-b70-u40-cell": (70, 40, (12, 36, 40), 4, None),
    "seq-b70-u40-hw": (70, 20, (40,), 1, None),
    "seq-b130-u300-cell": (130, 300, (36, 28, 300), 4, None),
    "seq-b130-u300-hw": (130, 40, (300,), 1, None),
    "seq-unaligned-cell": (9, 13, (5, 3, 13), 4, None),
    "seq-unaligned-hw": (9, 7, (13,), 1, None),
    "seq-b130-tma-cell": (130, 96, (64, 32, 96), 4, None),
    "seq-b130-tma-hw": (130, 40, (96,), 1, None),
    "seq-b130-wgmma-cell": (130, 128, (64, 64, 128), 4, None),
    "seq-b130-wgmma-hw": (130, 40, (128,), 1, None),
    "seq-d320-wgmma-cell": (200, 64, (320, 64, 64), 4, None),
    "seq-d320-wgmma-hw": (200, 16, (64,), 1, None),
    "lcnic-small-cell": (6, 16, (4, 8, 16), 4, "l32x8"),
    "lcnic-small-hw": (6, 8, (16,), 1, None),
    "gru-small-hw": (32, 16, (16,), 1, None),
    "gru-attention-300-hw": (32, 300, (300,), 1, None),
    "gru-padded-vocab-test-hw": (6, 16, (16,), 1, None),
}


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_python_table_is_the_kernels():
    """TILES lists the header's kTiles, in its order, with each tile's feed,
    its template arguments <G, BM, BN, TM, TN, BK, STAGES> and, for a sliced
    tile, its most slices KS; and the feeds' bits are the header's."""
    text = (CSRC / "tile_kernels.cuh").read_text()
    table = text[text.index("const TileConfig kTiles[]"):]
    table = table[:table.index("};")]
    found = re.findall(r"(tma|sliced)_tile<([\d,\s]+)>\(\),\s*//\s*(\w+)",
                       table)
    assert [(name, kind == "tma", *map(int, args.split(",")))
            for kind, args, name in found] == [
        (t.name, t.tma, t.gates, t.bm, t.bn, t.tm, t.tn, t.bk, t.stages,
         *(() if t.tma else (t.ks,))) for t in TILES]
    assert [_constant(text, k) for k in ("kFeedW16", "kFeedX16", "kFeedTMA")
            ] == [FEED_W16, FEED_X16, FEED_TMA]


def test_slice_rules_are_the_step_kernels():
    """The slices that make K4's sums K2's are the row kernel's K slices
    and the attention's block, as step_kernels.cuh has them."""
    text = (CSRC / "step_kernels.cuh").read_text()
    assert _constant(text, "kKSlices") == ROW_SLICES
    assert _constant(text, "kThreads") == VECMAT_THREADS


@pytest.mark.parametrize("tile", TILES, ids=lambda t: t.name)
def test_every_tile_launches_as_declared(tile):
    """Its shared memory fits a block, its threads fill whole warps within
    a block's limit at its most slices, and its shape is one the kernel's
    static_asserts and shared-memory vectors take (the TMA kernel reads a
    thread's units as one vector; the sliced one, float by float, any
    number)."""
    assert tile.smem_bytes <= SMEM_LIMIT
    assert tile.threads(tile.ks) % 32 == 0
    assert tile.threads(tile.ks) <= MAX_THREADS
    assert tile.bm % tile.tm == 0 and tile.bn % tile.tn == 0
    assert tile.bk % 4 == 0 and tile.bn % 4 == 0
    assert tile.gates in (1, 4)
    if tile.tma:
        assert tile.ks == 1 and tile.tn in (1, 2, 4)
    else:
        # every slice whole warps; the slices' sums reuse the ring
        assert tile.slice_threads % 32 == 0
        assert 4 * tile.ks * tile.bm * tile.bn * tile.gates \
            <= tile.smem_bytes


@pytest.mark.parametrize("case", list(CASES))
def test_pick_tile(case):
    B, N, widths, gates, expected = CASES[case]
    index = pick_tile(B, N, widths, gates)
    assert 0 <= index < len(TILES)
    tile = TILES[index]
    assert tile.gates == gates
    assert tile.smem_bytes <= SMEM_LIMIT
    assert tile.takes(N, widths, True)
    gx, gy = tile.grid(B, N)
    assert gx * tile.bn >= N > (gx - 1) * tile.bn
    assert gy * tile.bm >= B > (gy - 1) * tile.bm
    assert gy <= MAX_GRID_Y
    same_kind = [t for t in TILES
                 if t.gates == gates and t.takes(N, widths, True)]
    if max(t.blocks(B, N) for t in same_kind) >= WAVE_FILL:
        assert tile.blocks(B, N) >= WAVE_FILL
    else:                   # too small to fill a wave: the most blocks
        assert tile.blocks(B, N) == max(t.blocks(B, N) for t in same_kind)
    if expected is not None:
        assert tile.name == expected


@pytest.mark.parametrize("case", list(CASES))
def test_plan(case):
    """The plan's feed is one its tile has and the shapes allow, and its
    slices fill whole warps within a block's limit and leave the kernel a
    chunk of K that starts on class 0 and on 16 bytes."""
    B, N, widths, gates, _ = CASES[case]
    p = plan(B, N, widths, gates)
    tile = TILES[p.tile]
    assert p.tile == pick_tile(B, N, widths, gates)
    if tile.tma:
        assert (p.feed, p.slices) == (FEED_TMA, 1)
        assert N % 4 == 0 and all(w % tile.bk == 0 for w in widths)
    else:
        assert p.feed == ((FEED_W16 if N % 4 == 0 else 0)
                          | (FEED_X16 if all(w % 4 == 0 for w in widths)
                             else 0))
        assert 1 <= p.slices <= tile.ks
        assert tile.threads(p.slices) % 32 == 0
        assert tile.threads(p.slices) <= MAX_THREADS
        # tile_launch's chunk, bk less bk mod lcm(S, 4), is not empty
        assert math.lcm(p.slices, 4) <= tile.bk
    assert TILES[p.tile].name in p.describe()


@pytest.mark.parametrize("case", ["lcnic-small", "k4-flagship"])
def test_sliced_plans_sum_as_k2_does(case):
    """At the LcNIC shapes of the greedy-words test, K4's cell takes a
    sliced tile in rows_kernel's 8 classes, and h W2 one in block_vecmat's
    256 // A (32 at A 8, 8 at A 32): K4's sums are then K2's, term for
    term, which the CUDA test holds to the bit."""
    cell = plan(*CASES[f"{case}-cell"][:4])
    hw = plan(*CASES[f"{case}-hw"][:4])
    A = CASES[f"{case}-hw"][1]
    assert not TILES[cell.tile].tma and cell.slices == ROW_SLICES
    assert not TILES[hw.tile].tma and hw.slices == VECMAT_THREADS // A


@pytest.mark.parametrize("A, slices", [(8, 32), (20, 12), (32, 8), (40, 6),
                                       (128, 2), (129, 8), (256, 8),
                                       (512, 8)])
def test_dense_slices_are_block_vecmats(A, slices):
    """block_vecmat gives a column 256 // A threads where A is narrower
    than its 256-thread block: the dense tile's slices where that is at
    least 2; else rows_kernel's 8, as a single chain is latency-bound."""
    hw = plan(64, A, (512,), 1)
    assert hw.slices == slices


def test_pick_tile_prefers_the_largest_tile_that_fills_a_wave():
    """At K4's wide shape the 128 x 32 tile fills 128 SMs and streams the
    weights twice a step; every smaller tile would stream them more."""
    widths = (128, 1024, 2048)
    wide = TILES[pick_tile(256, 2048, widths, 4)]
    assert wide.blocks(256, 2048) == 128
    for t in TILES:
        if t.gates == 4 and t is not wide:
            assert t.bm * t.bn < wide.bm * wide.bn
            assert t.staged_bytes(256, 2048, 3200) > wide.staged_bytes(
                256, 2048, 3200)


@pytest.mark.parametrize("widths, N, aligned", [
    ((100, 1024, 2048), 2048, True),    # a width off the 32-row chunk
    ((128, 1024, 2048), 2046, True),    # N not a multiple of 4
    ((128, 1024, 2048), 2048, False),   # a base off 16 bytes
])
def test_the_tma_tile_only_where_its_feed_takes_the_shapes(widths, N,
                                                           aligned):
    """Where TMA cannot fill the wide tile's ring, the wide shape takes the
    sliced LSTM tile instead, and forcing the TMA tile raises: no launch
    ever changes feed behind the caller's back."""
    tma = next(i for i, t in enumerate(TILES) if t.tma)
    p = plan(256, N, widths, 4, aligned)
    assert not TILES[p.tile].tma and p.slices == ROW_SLICES
    with pytest.raises(ValueError):
        plan(256, N, widths, 4, aligned, tile=tma)
    assert plan(256, 2048, (128, 1024, 2048), 4, True,
                tile=tma) == Plan(tma, FEED_TMA, 1)


def test_a_forced_tile_of_the_wrong_kind_raises():
    dense = next(i for i, t in enumerate(TILES) if t.gates == 1)
    with pytest.raises(ValueError):
        plan(64, 512, (32, 512, 512), 4, tile=dense)


@pytest.mark.parametrize("shape", [
    (64, 512, (512,), 3),                  # the GRU cell: no tile of 3 gates
    (0, 512, (512,), 1), (64, 0, (512,), 4), (64, 512, (0,), 4),
    (128 * MAX_GRID_Y + 1, 512, (512,), 4),  # more row tiles than a grid has
])
def test_pick_tile_raises_for_a_shape_no_tile_takes(shape):
    with pytest.raises(ValueError):
        pick_tile(*shape)


# K2's shapes (B, R, A, D, E, U, H, Vp): flagship LcNIC, and the K2 cases
# of tests/test_torch_kernels_cuda.py (the LcNIC "small" model, the wide
# attention of the activations test, DECODE_SHAPES with the vocabulary
# padded to 128)
K2_SHAPES = {
    "flagship": (64, 360, 32, 32, 512, 512, 256, 5120),
    "small": (6, 8, 8, 4, 8, 16, 256, 128),
    "wide-attention": (32, 8, 512, 32, 64, 48, 256, 128),
    "b70-u40": (70, 11, 20, 12, 36, 40, 40, 384),
    "b130-u300": (130, 9, 40, 36, 28, 300, 300, 128),
    "unaligned": (9, 5, 9, 5, 3, 13, 13, 128),
    "tma": (130, 9, 40, 64, 32, 96, 72, 128),
}
K2_PRODUCTS = ("h W2", "cell", "Wi", "Wo")


def _k2_args(B, R, A, D, E, U, H, Vp):
    """``fused_greedy_decode``'s tensors at these shapes (uninitialised:
    the plans read shapes and bases only)."""
    e = torch.empty
    return (e(B, R, A), e(B, R, D), e(U, A), e(A), e(A), e(1),
            e(D + E, 4 * U), e(U, 4 * U), e(4 * U), e(U, H), e(H), e(H, Vp),
            e(Vp), e(Vp, E), e(E), e(B, U), e(B, U))


@pytest.mark.parametrize("product, tile, blocks", [
    ("h W2", "d16x8", 4 * 4), ("cell", "l32x8", 64 * 2),
    ("Wi", "d16x8", 32 * 4), ("Wo", "d64x40", 128 * 1)])
def test_lstm_decode_plans_at_lcnic_widths(product, tile, blocks):
    """Flagship LcNIC's greedy decode (B 64, U 512, A 32, E 512, H 256, Vp
    5,120): every product on a sliced tile fed by 16-byte copies, in 8
    slices, and the head's two filling a wave of the card (128 and 128
    blocks, where rows_kernel had 64 and 1,280); the logits on the tile
    that holds the whole batch, which an H100 timed at 11.3 us a step
    against 17.2 on 32 x 16 tiles."""
    B, R, A, D, E, U, H, Vp = K2_SHAPES["flagship"]
    plans = dict(zip(K2_PRODUCTS, lstm_decode_plans(_k2_args(*K2_SHAPES[
        "flagship"]))))
    p = plans[product]
    N = {"h W2": A, "cell": U, "Wi": H, "Wo": Vp}[product]
    assert TILES[p.tile].name == tile
    assert (p.feed, p.slices) == (FEED_W16 | FEED_X16, ROW_SLICES)
    assert TILES[p.tile].blocks(B, N) == blocks


@pytest.mark.parametrize("shape", list(K2_SHAPES))
def test_lstm_decode_plans_sum_as_k2s_kernels_did(shape):
    """At every shape K2 is launched at, each product takes a sliced tile
    whose slices are the classes K2's own kernels summed it in before it
    ran on the tile kernel: rows_kernel's 8 for the cell and the head,
    block_vecmat's 256 // A for h W2 where that splits a column (else 8),
    so that K2's words and alphas stay what they were."""
    B, R, A = K2_SHAPES[shape][:3]
    hw, cell, wi, wo = lstm_decode_plans(_k2_args(*K2_SHAPES[shape]))
    for p in (hw, cell, wi, wo):
        assert not TILES[p.tile].tma
    assert cell.slices == wi.slices == wo.slices == ROW_SLICES
    split = VECMAT_THREADS // A
    assert hw.slices == (split if split >= 2 else ROW_SLICES)


@pytest.mark.parametrize("product", range(len(K2_PRODUCTS)),
                         ids=K2_PRODUCTS)
def test_a_forced_tile_of_the_wrong_kind_raises_in_k2s_plans(product):
    """An LSTM tile forced on a dense product, or a dense one on the cell,
    raises; so does the TMA tile on a cell whose widths it cannot take."""
    args = _k2_args(*K2_SHAPES["flagship"])
    wrong = next(i for i, t in enumerate(TILES)
                 if (t.gates == 4) != (product == 1))
    force = [None] * 4
    force[product] = wrong
    with pytest.raises(ValueError):
        lstm_decode_plans(args, force=force)
    if product == 1:
        tma = next(i for i, t in enumerate(TILES) if t.tma)
        lstm_decode_plans(_k2_args(*K2_SHAPES["tma"]),
                          force=(None, tma, None, None))
        with pytest.raises(ValueError):
            lstm_decode_plans(_k2_args(*K2_SHAPES["b70-u40"]),
                              force=(None, tma, None, None))


def test_plan_order_names_a_k2_kernel():
    with pytest.raises(ValueError):
        plan(64, 32, (512,), 1, order="columns")


# K3's shapes (B, R, A, D, E, U, H, Vp): CnnRnn at configs/cnn_rnn.yaml's
# widths, the GRU_SHAPES of tests/test_torch_kernels_cuda.py (embedding 64,
# A = U = H = units, the vocabulary padded to 128), and its
# GRU_DECODE_SHAPES, at the tiles' edges (vocabularies of 300, 40 and 5,001
# padded to 384, 128 and 5,120)
K3_SHAPES = {
    "cnn_rnn": (64, 64, 512, 256, 256, 512, 512, 5120),
    "small-odd-regions": (32, 7, 16, 64, 64, 16, 16, 128),
    "padded-vocab": (32, 5, 16, 64, 64, 16, 16, 128),
    "attention-300": (32, 9, 300, 64, 64, 300, 300, 128),
    "b70-u40": (70, 11, 20, 12, 36, 40, 40, 384),
    "b130-u300": (130, 9, 40, 36, 28, 300, 300, 128),
    "unaligned": (9, 5, 9, 5, 3, 13, 13, 128),
}
K3_PRODUCTS = ("h W2", "Wi", "Wo")


def _k3_args(B, R, A, D, E, U, H, Vp):
    """``fused_greedy_decode_gru``'s tensors at these shapes
    (uninitialised: the plans read shapes and bases only)."""
    e = torch.empty
    return (e(B, R, A), e(B, R, D), e(U, A), e(A), e(A), e(1),
            e(D + E, 3 * U), e(U, 3 * U), e(3 * U), e(3 * U), e(U, H), e(H),
            e(H, Vp), e(Vp), e(Vp, E), e(E), e(B, U))


@pytest.mark.parametrize("product, tile, blocks", [
    ("h W2", "d16x8", 64 * 4), ("Wi", "d16x8", 64 * 4),
    ("Wo", "d64x40", 128 * 1)])
def test_gru_decode_plans_at_cnn_rnn_widths(product, tile, blocks):
    """CnnRnn's greedy decode (B 64, U 512, A 512, H 512, Vp 5,120): every
    product on a sliced tile fed by 16-byte copies, in 8 slices, each grid
    filling a wave of the card; the logits on the tile that holds the whole
    batch, so that each column of Wo streams from L2 once a step, where
    rows_kernel's 8-row blocks read it 8 times."""
    B, R, A, D, E, U, H, Vp = K3_SHAPES["cnn_rnn"]
    plans = dict(zip(K3_PRODUCTS, gru_decode_plans(_k3_args(
        *K3_SHAPES["cnn_rnn"]))))
    p = plans[product]
    N = {"h W2": A, "Wi": H, "Wo": Vp}[product]
    t = TILES[p.tile]
    assert t.name == tile
    assert (p.feed, p.slices) == (FEED_W16 | FEED_X16, ROW_SLICES)
    assert t.blocks(B, N) == blocks >= WAVE_FILL
    if product == "Wo":
        assert t.grid(B, N)[1] == 1


@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_gru_decode_plans_sum_as_the_row_kernel_did(shape):
    """At every shape K3 is launched at, the head takes a sliced tile in
    rows_kernel's 8 classes, the order K3 summed it in before it ran on the
    tile kernel, so that K3's words and alphas stay what they were; h W2
    keeps the plan it had (block_vecmat's 256 // A where that splits a
    column, else 8)."""
    B, R, A, D, E, U, H, Vp = K3_SHAPES[shape]
    hw, wi, wo = gru_decode_plans(_k3_args(*K3_SHAPES[shape]))
    for p in (hw, wi, wo):
        assert not TILES[p.tile].tma
    assert wi.slices == wo.slices == ROW_SLICES
    assert hw == plan(B, A, (U,), 1)
    assert (wi, wo) == (plan(B, H, (U,), 1, order="rows"),
                        plan(B, Vp, (H,), 1, order="rows"))


@pytest.mark.parametrize("product", range(len(K3_PRODUCTS)),
                         ids=K3_PRODUCTS)
def test_a_forced_tile_of_the_wrong_kind_raises_in_k3s_plans(product):
    """An LSTM tile forced on any of K3's products raises; every dense tile
    forced there is taken, with the slices of its order."""
    args = _k3_args(*K3_SHAPES["cnn_rnn"])
    lstm = next(i for i, t in enumerate(TILES) if t.gates == 4)
    force = [None] * 3
    force[product] = lstm
    with pytest.raises(ValueError):
        gru_decode_plans(args, force=force)
    for i, t in enumerate(TILES):
        if t.gates == 1:
            force[product] = i
            p = gru_decode_plans(args, force=force)[product]
            assert p.tile == i and p.slices == ROW_SLICES
