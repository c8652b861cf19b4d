"""The block tiles of the pipelined tile kernel (``csrc/tile_kernels.cuh``)
and the plan of each launch: its tile, the feed that fills the tile's ring,
and the slices its sums fall into.

The kernel computes ``Y = [in0 | in1 | in2] W + bias`` for a block of
``bm`` batch rows x ``bn`` units, with either the LSTM cell applied in its
epilogue (``gates`` 4: W's columns gate-interleaved, gate g of unit n at
column g N + n) or a dense layer's activation (``gates`` 1). K is staged a
chunk at a time through a ring of ``stages`` shared-memory stages, and each
thread owns ``tm`` rows x ``tn`` units (x ``gates``) in registers. Each tile
has one feed:

- the TMA tile (``tma``, one slice): one thread fills the ring by bulk
  tensor copies, chunks of ``bk``; it needs every segment width of K to be
  a multiple of ``bk``, N a multiple of 4 and 16-byte bases, so
  ``pick_tile`` gives it only shapes that allow that;
- the sliced tiles: every thread copies its share by ``cp.async``, 16 bytes
  where widths and bases allow (``FEED_W16``, ``FEED_X16``), else 4; S
  slices of the block (at most ``ks``) split K by class, k mod S, and their
  sums meet in shared memory in slice order. S is that of the kernel K2
  ran for the same product before it ran on this one, where that kernel
  split K (``slices``): K2's words and alphas are then those it gave, and
  K4's sums are K2's.

Shapes and layouts stay here, in Python the CPU tests reach: the wrappers
of K2, K3 and K4 call ``plan`` and pass the plan to the C entry points, which
refuse a tile they do not know or of the wrong kind, a feed or slices the
tile cannot take, and TMA maps that cannot be encoded. Nothing falls back.
``TILES`` is the kernel's own table, in its order
(``tests/test_torch_tiles.py`` reads the header and holds the two equal).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

NUM_SMS = 132               # H100 SXM
SMEM_LIMIT = 232_448        # dynamic shared memory a block may have, bytes
WAVE_FILL = -(-NUM_SMS * 95 // 100)     # blocks that fill a wave: 126
MAX_GRID_Y = 65_535         # row tiles a grid may have
MAX_THREADS = 1024          # threads a block may have
ROW_SLICES = 8              # step_kernels.cuh's kKSlices (rows_kernel)
VECMAT_THREADS = 256        # step_kernels.cuh's kThreads (block_vecmat)

FEED_W16, FEED_X16, FEED_TMA = 1, 2, 4  # tile_kernels.cuh's kFeed*
ORDERS = ("rows", "vecmat")     # the K2 kernel whose sums a plan keeps


@dataclass(frozen=True)
class Tile:
    name: str
    gates: int      # 4: the LSTM cell's epilogue; 1: dense
    bm: int         # batch rows a block
    bn: int         # units a block
    tm: int         # rows a thread
    tn: int         # units a thread
    bk: int         # K rows a stage
    stages: int     # shared-memory stages in the ring
    ks: int         # most slices of the threads splitting K (1: TMA)
    tma: bool       # the ring filled by TMA, else by cp.async

    @property
    def slice_threads(self) -> int:
        return (self.bm // self.tm) * (self.bn // self.tn)

    def threads(self, slices: int) -> int:
        return slices * self.slice_threads

    @property
    def smem_bytes(self) -> int:
        """The ring: a stage holds the X chunk (bm rows of bk floats, padded
        to bk + 4 for cp.async) and the W chunk (bk rows of gates x bn
        floats); TMA adds an 8-byte mbarrier a stage. The slices' sums reuse
        the ring."""
        if self.tma:
            return (4 * self.stages * (self.bm * self.bk
                                       + self.bk * self.gates * self.bn)
                    + 8 * self.stages)
        return 4 * self.stages * (self.bm * (self.bk + 4)
                                  + self.bk * self.gates * self.bn)

    def grid(self, B: int, N: int) -> tuple[int, int]:
        """(unit tiles, row tiles): the kernel's grid for B rows, N units."""
        return -(-N // self.bn), -(-B // self.bm)

    def blocks(self, B: int, N: int) -> int:
        x, y = self.grid(B, N)
        return x * y

    def staged_bytes(self, B: int, N: int, K: int) -> int:
        """Bytes the grid stages from L2 over K: every block reads its
        rows of X and its columns of W once."""
        return 4 * self.blocks(B, N) * K * (self.bm + self.gates * self.bn)

    def takes(self, N: int, widths: tuple[int, ...], aligned: bool) -> bool:
        """Whether the tile's feed can fill its ring for N units over K
        segments of these widths, with 16-byte bases where ``aligned``."""
        return not self.tma or (aligned and N % 4 == 0 and
                                all(w % self.bk == 0 for w in widths))

    def slices(self, N: int, order: str) -> int:
        """S, the classes k mod S its sums fall into, as many as the tile
        has: one for the TMA tile; for a sliced one those of the kernel K2
        ran for the same product before it ran on the tile kernel:
        ``"rows"``, rows_kernel's ``ROW_SLICES`` (the cell, the head), or
        ``"vecmat"``, block_vecmat's ``VECMAT_THREADS // N`` (h W2) where
        that splits a column (N up to half its block). Where block_vecmat
        gives a column one thread, one chain over all of K left the dense
        tile latency-bound (PERF.md §6), so there it takes
        ``ROW_SLICES`` too."""
        if order not in ORDERS:
            raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
        if self.tma:
            return 1
        split = VECMAT_THREADS // N
        if order == "rows" or split < 2:
            return min(ROW_SLICES, self.ks)
        return min(split, self.ks)


# csrc/tile_kernels.cuh's kTiles, in order: for each kind, the tile of
# the wide shape (B 256) and the one of flagship and CnnRnn (B 64); then
# the dense tile that holds a batch of 64 whole, for the logits (one wave
# of 128 blocks at Vp 5,120, each column of Wo staged once a step)
TILES = (
    Tile("l128x32", 4, 128, 32, 8, 2, 32, 3, 1, tma=True),
    Tile("l32x8", 4, 32, 8, 2, 4, 128, 3, 8, tma=False),
    Tile("d32x16", 1, 32, 16, 2, 4, 128, 3, 16, tma=False),
    Tile("d16x8", 1, 16, 8, 1, 4, 128, 3, 32, tma=False),
    Tile("d64x40", 1, 64, 40, 8, 5, 128, 3, 8, tma=False),
)


@dataclass(frozen=True)
class Plan:
    """A launch of the tile kernel: its tile (index in ``TILES``), its feed
    (``FEED_*`` bits) and its slices, as the C entry points take them."""
    tile: int
    feed: int
    slices: int

    @property
    def args(self) -> tuple[int, int, int]:
        return self.tile, self.feed, self.slices

    def describe(self) -> str:
        if self.feed == FEED_TMA:
            feed = "TMA"
        else:
            feed = "cp.async, " + ", ".join(
                f"{part} by {16 if self.feed & bit else 4} B"
                for part, bit in (("X", FEED_X16), ("W", FEED_W16)))
        return f"{TILES[self.tile].name} ({feed}; {self.slices} slices)"


def pick_tile(B: int, N: int, widths: tuple[int, ...], gates: int,
              aligned: bool = True) -> int:
    """Index in ``TILES`` of the tile for a (B, K) x (K, gates N) product
    whose K is the segments ``widths``, with 16-byte bases where
    ``aligned``.

    Among the tiles of this kind whose feed can take the shapes, the
    largest (outputs a block) whose grid fills a wave of the card
    (``WAVE_FILL`` blocks); where B x N is too small for any to, the one
    with the most blocks. Ties go to the tile that stages fewer bytes.
    Raises ValueError for a shape no tile can take: no tile of this kind, a
    size below 1, or more row tiles than a grid may have."""
    K = sum(widths)
    if min(B, N, K) < 1 or min(widths) < 0:
        raise ValueError(f"sizes must be positive: B={B}, N={N}, "
                         f"widths={widths}")
    kind = [i for i, t in enumerate(TILES)
            if t.gates == gates and t.smem_bytes <= SMEM_LIMIT
            and t.grid(B, N)[1] <= MAX_GRID_Y and t.takes(N, widths, aligned)]
    if not kind:
        raise ValueError(f"no tile takes gates={gates} at B={B}, N={N} "
                         f"(instantiated: "
                         f"{sorted({t.gates for t in TILES})} gates)")
    full = [i for i in kind if TILES[i].blocks(B, N) >= WAVE_FILL]
    if full:
        return min(full, key=lambda i: (-TILES[i].bm * TILES[i].bn,
                                        TILES[i].staged_bytes(B, N, K)))
    return min(kind, key=lambda i: (-TILES[i].blocks(B, N),
                                    TILES[i].staged_bytes(B, N, K)))


@functools.lru_cache(maxsize=256)
def plan(B: int, N: int, widths: tuple[int, ...], gates: int,
         aligned: bool = True, tile: int | None = None,
         order: str | None = None) -> Plan:
    """The plan of a (B, K) x (K, gates N) product over K segments of
    ``widths``: ``pick_tile``'s tile, or ``tile`` where given (a test's
    forced one: ValueError if it cannot take the shapes), its feed (TMA, or
    cp.async with 16-byte copies of W where N is a multiple of 4 and of X
    where every width is, on 16-byte bases) and its slices in ``order``
    (``Tile.slices``; by default ``"rows"`` for the cell and ``"vecmat"``
    for a dense product, h W2's). Cached: a decode plans its products on
    every call, and the plan depends on nothing but these arguments."""
    if tile is None:
        tile = pick_tile(B, N, widths, gates, aligned)
    t = TILES[tile]
    if t.gates != gates or not t.takes(N, widths, aligned):
        raise ValueError(f"tile {t.name} cannot take gates={gates}, N={N}, "
                         f"widths={widths}, aligned={aligned}")
    if t.tma:
        feed = FEED_TMA
    else:
        feed = ((FEED_W16 if aligned and N % 4 == 0 else 0)
                | (FEED_X16 if aligned and all(w % 4 == 0 for w in widths)
                   else 0))
    if order is None:
        order = "rows" if gates == 4 else "vecmat"
    return Plan(tile, feed, t.slices(N, order))


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
