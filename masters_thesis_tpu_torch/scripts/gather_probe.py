"""Isolate the betas row gather on the card: ``index_select`` against the
ports of the JAX probe's two Pallas gathers (``scripts/gather_probe.py``).

    python -m masters_thesis_tpu_torch.scripts.gather_probe [--device cpu]
        [--rows N --cols V --batch B --steps K]

Each timed function is the JAX probe's loop of K steps, each gathering B rows
by a fresh row of ids and adding ``rows.sum()`` to a running sum, and each
line has the JAX probe's tag and GB/s, ``K·B·V·4 / seconds``, so that the
TPU's lines can be set beside the card's:

- ``index_select`` (in place of ``XLA take(axis=0)``) on the raw store;
- ``pallas gather s_block=8, 24, 856, 2568``: ``ops.gather.gather_rows_chunked``
  (P1), one block per chunk of ``s_block`` x 128 columns of the store padded
  to a multiple of 1024 columns (a chunk that does not divide the width
  leaves a shorter last one);
- ``dma hbm2hbm 2D nb=2, 4, 8, 16``: ``ops.gather.gather_rows_bulk`` (P2) on
  the raw store, ``nb`` stages of bulk copies in flight in each block;

then ``dma gather exact``: P3, the bulk gather at 4 stages, against
``index_select`` on the first step's ids. Beside its GB/s each line gives the
µs of one B-row gather alone and its bound (every row read and written once
at 3.35 TB/s), with the card's name and power limit. A failed variant raises.

The defaults are the JAX probe's sizes: 1,024 rows of 327,684 fp32 (1.34 GB),
64 ids a step, 32 steps. The store is drawn on the device from seed 0, the
ids ``(K, B)`` from ``np.random.default_rng(0)``. Times come from CUDA events
on the card; ``--device cpu`` (at small sizes, for a test) runs the plain
versions and times them by the host clock, which says nothing of a device.
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from masters_thesis_tpu_torch.device import card_line, resolve_device
from masters_thesis_tpu_torch.ops.gather import (
    gather_rows_bulk,
    gather_rows_chunked,
)

N, V, B, K = 1024, 327_684, 64, 32      # gather_probe.py:15
LANES, PAD = 128, 1024                  # the TPU's lane and padding
S_BLOCKS = (8, 24, 856, 2568)           # gather_probe.py:71
STAGES = (2, 4, 8, 16)                  # gather_probe.py:130
EXACT_STAGES = 4                        # gather_probe.py:146
REPS = 3                                # timed calls after one warm call
HBM_BYTES_PER_S = 3.35e12               # H100 SXM datasheet


def padded_cols(cols: int) -> int:
    return -(-cols // PAD) * PAD


def make_store(rows: int, cols: int, device, seed: int = 0) -> torch.Tensor:
    """A (rows, cols) fp32 store of standard normals drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, cols, generator=gen, device=device)


def pad_store(store: torch.Tensor) -> torch.Tensor:
    """The store with zero columns up to a multiple of 1024, as P1 reads it
    (the JAX probe's ``store3`` before its reshape to (N, S, 128))."""
    cols = store.shape[1]
    return torch.nn.functional.pad(store, (0, padded_cols(cols) - cols))


def make_ids(rows: int, batch: int, steps: int, seed: int = 0) -> np.ndarray:
    """(steps, batch) int32 row ids in [0, rows)."""
    return np.random.default_rng(seed).integers(
        0, rows, (steps, batch)).astype(np.int32)


def variants() -> list[tuple]:
    """(tag, the kernel's wrapper or None, its setting, which store, the
    gather) for every timed line, in the JAX probe's order."""
    out = [("index_select", None, None, "raw",
            lambda st, i: st.index_select(0, i))]
    out += [(f"pallas gather s_block={sb}", gather_rows_chunked, sb, "padded",
             functools.partial(gather_rows_chunked, chunk_cols=sb * LANES))
            for sb in S_BLOCKS]
    out += [(f"dma hbm2hbm 2D nb={nb}", gather_rows_bulk, nb, "raw",
             functools.partial(gather_rows_bulk, stages=nb))
            for nb in STAGES]
    return out


def k_step_sum(gather, store: torch.Tensor, idx: torch.Tensor):
    """The JAX probe's timed function: for each row of ids, gather and add
    ``rows.sum()`` to a float32 running sum."""
    c = torch.zeros((), dtype=torch.float32, device=store.device)
    for i in idx:
        c = c + gather(store, i).sum()
    return c


def exact_check(store: torch.Tensor, ids: torch.Tensor) -> bool:
    """P3: the bulk gather at 4 stages equals ``index_select``."""
    rows = gather_rows_bulk(store, ids, EXACT_STAGES)
    return bool(torch.equal(rows, store.index_select(0, ids)))


def elapsed_ms(fn, device: torch.device, reps: int = REPS) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(rows: int = N, cols: int = V, batch: int = B, steps: int = K,
        device=None) -> dict:
    """Time every variant and check P3; print one line each. Returns the
    card line, one dict a variant (tag, wrapper name, setting, GB/s, ms per
    K steps, µs per gather, bound µs, launches) and P3's verdict and
    launches."""
    device = resolve_device(device)
    card = card_line(device)
    raw = make_store(rows, cols, device)
    stores = {"raw": raw, "padded": pad_store(raw)}
    idx = torch.as_tensor(make_ids(rows, batch, steps), device=device)
    print(f"store {rows} x {cols} fp32, {raw.numel() * 4 / 1e9:.2f} GB "
          f"(padded to {padded_cols(cols)} columns for s_block), {steps} "
          f"steps of {batch} ids, on {device} [{card}]", flush=True)
    lines = []
    for tag, wrapper, setting, which, gather in variants():
        store = stores[which]
        before = wrapper.launches if wrapper else 0
        ms = elapsed_ms(lambda: k_step_sum(gather, store, idx), device)
        us = elapsed_ms(lambda: [gather(store, i) for i in idx],
                        device) / steps * 1e3
        row_bytes = store.shape[1] * store.element_size()
        bound_us = (2 * batch * row_bytes + idx[0].numel()
                    * idx.element_size()) / HBM_BYTES_PER_S * 1e6
        gb = steps * batch * cols * 4 / 1e9
        print(f"{tag:26s}: {gb / (ms / 1e3):7.1f} GB/s  ({ms:.1f} ms per "
              f"{steps}-step chunk); {us:.2f} us per {batch}-row gather "
              f"alone, bound {bound_us:.2f} us [{card}]", flush=True)
        lines.append({
            "tag": tag, "wrapper": wrapper.__name__ if wrapper else None,
            "setting": setting, "gb_per_s": gb / (ms / 1e3),
            "ms_per_chunk": ms, "us_per_gather": us, "bound_us": bound_us,
            "launches": (wrapper.launches - before) if wrapper else 0})
    before = gather_rows_bulk.launches
    exact = exact_check(raw, idx[0])
    print("dma gather exact:", exact, flush=True)
    return {"card": card, "variants": lines, "exact": exact,
            "exact_launches": gather_rows_bulk.launches - before}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--cols", type=int, default=V)
    parser.add_argument("--batch", type=int, default=B)
    parser.add_argument("--steps", type=int, default=K)
    args = parser.parse_args(argv)
    run(args.rows, args.cols, args.batch, args.steps, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
