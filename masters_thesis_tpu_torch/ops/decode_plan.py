"""The plan of the bf16-weight greedy decode's persistent kernel
(``csrc/decode_bf16.cu``): which block of the one cooperative launch does
what, and what it keeps in shared memory for the whole decode.

From the shapes and the card's SM count, ``decode_plan`` gives each block
(one an SM):

- a range of units, all G gates of each (4 for the LSTM, 3 for the GRU), so
  that the cell's epilogue stays in the block; the ranges cut [0, U) in
  block order, in steps of 2 units;
- a range of Wi's H columns and of Wo's V (padded vocab) columns, each cut
  in block order in steps of 8 (an n8 tensor-core tile);
- a tile of h W2's (B, A) output, rows x columns, chosen so that the tiles
  cover it once with the fewest rows plus columns a tile, on the blocks
  that hold no Wi columns where there are enough of them;
- the attention of rows: blocks come in groups of ``asplit`` (as many as
  the grid has blocks a row, up to D / 8), group g takes rows g, g +
  groups, ..., and each block of a group the scores of its rows and its
  share of their context's D columns (the group's first also the words,
  the embedding and the alphas);

and, per operand (the attention's pre and features, the cell's weights,
Wi, Wo, W2), whether every block holds its share in shared memory for the
whole decode or streams it from L2 every step: resident where it fits,
the operands demoted to streamed in the order attention, W2, Wi, Wo, cell
until the largest block fits in ``SMEM_LIMIT``. Each block's shared memory
is laid out in that order (cell panels, Wi panels, Wo panels, W2 slice,
attention rows, scratch). The sizes are the ones the C side recomputes when
it checks a record; it refuses any record whose ranges, tiles or layout do
not match them.

``DecodePlan.record`` is the launch record (a header, then a row a block,
in the order of ``HEADER`` and ``BLOCK``), passed to C as one int32 array.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

# csrc/decode_bf16.cu: threads a block, rows a product pass, columns a
# panel, K a chunk, x chunks in flight, a stage row, units a cell panel
THREADS, MG, PW, BK, XS, CELL_UNITS = 256, 64, 64, 64, 72, 16
# the ring of a product's x chunks: at least 3 stages, at most 16, as many
# as the shared memory left beside the resident operands holds
MIN_STAGES, MAX_STAGES = 3, 16
# an H100 block's shared memory, less a KB for the kernel's static arrays
SMEM_LIMIT = 232_448 - 1_024
CELLS = {"lstm": 1, "gru": 2}
GATES = {"lstm": 4, "gru": 3}
HEADER = ("cell", "B", "R", "A", "D", "E", "U", "H", "V", "T", "feat_bf16",
          "zero_state", "blocks", "smem", "o_emb", "o_h", "kx", "hp",
          "res_attn", "res_cell", "res_wi", "res_wo", "res_w2", "ps", "lpr",
          "stages", "asplit", "scratch")
BLOCK = ("u0", "u1", "i0", "i1", "o0", "o1", "r0", "r1", "a0", "a1", "rows",
         "off_cell", "off_wi", "off_wo", "off_w2", "off_attn", "off_scratch")
# what is demoted from resident to streamed first, when a block overflows
DEMOTE = ("attn", "w2", "wi", "wo", "cell")


def _ru(n: int, m: int) -> int:
    return -(-n // m) * m


def _panels(c0: int, c1: int, width: int):
    """The (start, count) of each panel of ``width`` over [c0, c1)."""
    return [(c, min(width, c1 - c)) for c in range(c0, c1, width)]


def cell_bytes(gates: int, u0: int, u1: int, kc: int) -> int:
    """A block's resident cell panels: ``kc`` rows of G x n columns (rounded
    to 8) a panel of n <= CELL_UNITS units, bf16."""
    return sum(kc * _ru(gates * n, 8) * 2
               for _, n in _panels(u0, u1, CELL_UNITS))


def w2_pitch(U: int) -> int:
    """The pitch, in floats, of a resident W2 column (the slice is held
    transposed) and of a staged row of h: U rounded to 4, plus 4."""
    return _ru(U, 4) + 4


def dense_bytes(c0: int, c1: int, k: int) -> int:
    """A block's resident panels of a dense weight, columns [c0, c1), ``k``
    rows, bf16."""
    return sum(k * _ru(n, 8) * 2 for _, n in _panels(c0, c1, PW))


def pre_pitch(A: int, feat_bf16: bool) -> int:
    """The row pitch, in elements, of a resident row's ``pre``: an odd
    number of 4-byte words, so that the lanes of a warp reading one element
    of each of 32 regions fall in 32 banks."""
    if not feat_bf16:
        return A | 1
    words = -(-A // 2)
    return 2 * (words | 1)


def lanes_per_region(R: int, A: int) -> int:
    """The lanes that share a region's score (a power of 2 up to 32): the
    fewest serial tanh a thread, counting the butterfly's steps."""
    def cost(lpr):
        return (-(-R // (THREADS // lpr))
                * (-(-A // lpr) + int(math.log2(lpr))))
    return min((1 << i for i in range(6)), key=cost)


def scratch_bytes(cell: str, zero_state: bool, R: int, A: int, U: int,
                  streamed: bool, pwc: int, pwi: int, pwo: int, rmax: int,
                  stages: int) -> int:
    """The scratch every block shares between phases: the attention's
    (h W2, v, scores, a reduction, the context's slices), a product's (the
    ring of ``stages`` x chunks, a streamed weight chunk, its fp32 output,
    twice for the GRU's input and recurrent sums) or h W2's (its slices'
    sums and the ``rmax`` rows of h of the tallest tile, at the pitch
    ``w2_pitch``)."""
    attn = 4 * (2 * A + R + 32 + THREADS)
    carried = cell == "gru" and not zero_state
    zcols = max(pwc * (2 if carried else 1), pwi, pwo)
    prod = (2 * stages * MG * XS + (2 * BK * PW if streamed else 0)
            + 4 * MG * zcols)
    return _ru(max(attn, prod, 4 * (THREADS + rmax * w2_pitch(U))), 16)


def attn_row_bytes(R: int, dw: int, ps: int, feat_bf16: bool) -> int:
    """A resident row's attention inputs: pre at pitch ``ps``, then the
    block's ``dw`` columns of the features."""
    size = 2 if feat_bf16 else 4
    return _ru(R * ps * size, 16) + _ru(R * dw * size, 16)


def attn_share(D: int, asplit: int, j: int) -> tuple[int, int]:
    """The context columns [d0, d1) of block ``j`` in a group of
    ``asplit``."""
    per = -(-D // asplit)
    d0 = min(D, j % asplit * per)
    return d0, min(D, d0 + per)


def attn_width(D: int, asplit: int, j: int) -> int:
    d0, d1 = attn_share(D, asplit, j)
    return d1 - d0


def _cut(n: int, blocks: int, step: int) -> list[tuple[int, int]]:
    """[0, n) cut in block order into ranges of a multiple of ``step``."""
    per = _ru(-(-n // blocks), step)
    return [(min(n, j * per), min(n, (j + 1) * per)) for j in range(blocks)]


def _hw_tiles(B: int, A: int, blocks: int) -> list[tuple[int, int, int, int]]:
    """h W2's (B, A) output cut into at most ``blocks`` tiles (r0, r1, a0,
    a1) of rg rows x ag columns with the least rg + ag (the rows of h and
    the columns of W2 a tile reads)."""
    best = None
    for rg in range(1, B + 1):
        groups = -(-B // rg)
        if groups > blocks:
            continue
        ag = -(-A // (blocks // groups))
        if best is None or rg + ag < best[0] + best[1]:
            best = (rg, ag)
    rg, ag = best
    return [(r, min(B, r + rg), a, min(A, a + ag))
            for r in range(0, B, rg) for a in range(0, A, ag)]


@dataclass(frozen=True, eq=False)
class DecodePlan:
    """A plan of the persistent decode: ``header`` (the names of
    ``HEADER``) and one dict a block (the names of ``BLOCK``). Plans are
    told apart by identity: ``decode_plan`` makes one a shape."""
    header: dict
    blocks: tuple

    @property
    def record(self) -> list[int]:
        """The launch record: the header, then a row a block."""
        return ([self.header[k] for k in HEADER]
                + [b[k] for b in self.blocks for k in BLOCK])

    def describe(self) -> dict:
        """What a report says of the plan: blocks, each operand resident or
        streamed, and the largest block's shared memory."""
        h = self.header
        return {"blocks": h["blocks"], "smem_bytes": h["smem"],
                **{name: "resident" if h[f"res_{name}"] else "streamed"
                   for name in ("attn", "cell", "wi", "wo", "w2")}}


@functools.lru_cache(maxsize=256)
def decode_plan(cell: str, B: int, R: int, A: int, D: int, E: int, U: int,
                H: int, V: int, T: int, *, feat_bf16: bool = False,
                zero_state: bool = False, sms: int = 132) -> DecodePlan:
    """The plan for a decode of ``cell`` ("lstm" or "gru") at these sizes
    (V the padded vocab) on a card of ``sms`` SMs: one block an SM, or as
    many as there is work for (rows, unit pairs, 8-column tiles of the
    head). Raises ValueError where even with every operand streamed a block
    needs more than ``SMEM_LIMIT`` bytes of shared memory (an attention of
    tens of thousands of regions)."""
    if cell not in CELLS or (zero_state and cell != "gru"):
        raise ValueError(f"no persistent decode for cell {cell!r} "
                         f"(zero_state {zero_state})")
    G = GATES[cell]
    carried = not (cell == "gru" and zero_state)
    o_emb = _ru(D, 16)
    o_h = o_emb + _ru(E, 16)
    kx = o_h + _ru(U, 16)
    hp = _ru(H, 16)
    kc = kx if carried else o_h
    blocks = min(sms, max(B, -(-U // 2), -(-H // 8), -(-V // 8)))
    units, wi, wo = _cut(U, blocks, 2), _cut(H, blocks, 8), _cut(V, blocks, 8)
    # h W2 shares phase C with Wi: its tiles go to the blocks that hold no
    # Wi columns, where there are at least half of them, so that the phase
    # costs the longer of the two and not their sum
    free = [j for j in range(blocks) if wi[j][0] == wi[j][1]]
    hosts = free if 2 * len(free) >= blocks else list(range(blocks))
    tiles = [(0, 0, 0, 0)] * blocks
    for j, tile in zip(hosts, _hw_tiles(B, A, len(hosts))):
        tiles[j] = tile
    asplit = max(1, min(blocks // B, D // 8))
    groups = blocks // asplit
    rows = [-(-(B - j // asplit) // groups)
            if j // asplit < min(groups, B) else 0 for j in range(blocks)]
    ps = pre_pitch(A, feat_bf16)

    # the widest panel of each product: its first
    pwc = max((_ru(G * min(CELL_UNITS, u1 - u0), 8) for u0, u1 in units
               if u1 > u0), default=0)
    pwi, pwo = (max((_ru(min(PW, c1 - c0), 8) for c0, c1 in ranges
                     if c1 > c0), default=0) for ranges in (wi, wo))
    rmax = max(r1 - r0 for r0, r1, a0, a1 in tiles if a1 > a0)
    resident = dict.fromkeys(DEMOTE, True)

    def layout(stages):
        streamed = not (resident["cell"] and resident["wi"]
                        and resident["wo"])
        scratch = scratch_bytes(cell, zero_state, R, A, U, streamed, pwc,
                                pwi, pwo, rmax, stages)
        out = []
        for j in range(blocks):
            (u0, u1), (i0, i1), (o0, o1) = units[j], wi[j], wo[j]
            r0, r1, a0, a1 = tiles[j]
            sizes = {
                "cell": cell_bytes(G, u0, u1, kc) if resident["cell"] else 0,
                "wi": dense_bytes(i0, i1, _ru(U, 16)) if resident["wi"]
                else 0,
                "wo": dense_bytes(o0, o1, hp) if resident["wo"] else 0,
                "w2": 4 * w2_pitch(U) * (a1 - a0) if resident["w2"] else 0,
                "attn": (rows[j] * attn_row_bytes(
                    R, attn_width(D, asplit, j), ps, feat_bf16)
                    if resident["attn"] else 0)}
            off, block = 0, dict(u0=u0, u1=u1, i0=i0, i1=i1, o0=o0, o1=o1,
                                 r0=r0, r1=r1, a0=a0, a1=a1, rows=rows[j])
            for name in ("cell", "wi", "wo", "w2", "attn"):
                block[f"off_{name}"] = off
                off += sizes[name]
            block["off_scratch"] = off
            out.append(block)
        return out, scratch, max(b["off_scratch"] for b in out) + scratch

    demoted = iter(DEMOTE)
    stages = MIN_STAGES
    per_block, scratch, smem = layout(stages)
    while smem > SMEM_LIMIT:
        name = next(demoted, None)
        if name is None:
            raise ValueError(
                f"the persistent decode needs {smem} bytes of shared memory "
                f"a block at B={B} R={R} A={A} D={D} U={U}, over "
                f"{SMEM_LIMIT}")
        resident[name] = False
        per_block, scratch, smem = layout(stages)
    # then the deepest ring that still fits, up to one stage past the
    # longest product's chunks
    chunks = -(-max(kx, hp) // BK)
    while stages < min(MAX_STAGES, chunks + 1):
        deeper = layout(stages + 1)
        if deeper[2] > SMEM_LIMIT:
            break
        stages += 1
        per_block, scratch, smem = deeper
    header = dict(cell=CELLS[cell], B=B, R=R, A=A, D=D, E=E, U=U, H=H, V=V,
                  T=T, feat_bf16=int(feat_bf16), zero_state=int(zero_state),
                  blocks=blocks, smem=smem, o_emb=o_emb, o_h=o_h, kx=kx,
                  hp=hp, ps=ps, lpr=lanes_per_region(R, A), stages=stages,
                  asplit=asplit, scratch=scratch,
                  **{f"res_{k}": int(v) for k, v in resident.items()})
    return DecodePlan(header, tuple(per_block))
