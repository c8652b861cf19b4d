"""Time the store row gather (K1, ``ops.gather.gather_rows``) beside
``index_select`` on the stores the port gathers from, with the host's and
the device's parts of a call apart.

    python -m masters_thesis_tpu_torch.scripts.gather_timing
        [--stores pca,cnn_rnn,img_nic,lc_nic,flagship] [--batch 64]
        [--turns 7] [--plans] [--device cpu]

For each store (rows x fp32 columns, drawn on the device from seed 0) and
``--batch`` ids in range (int32 for K1, as the train steps give them; int64
for ``index_select``), after K1 is held bit for bit to its plain version on
ids with repeats and ids -3, N and N + 1000:

- ``device``: µs of kernel time a call by ``torch.profiler`` over 50 calls,
  which leaves out the host (and the kernels' names; each kernel's mean a
  launch);
- ``host``: µs a call of the host loop alone, by ``time.perf_counter`` over
  1,000 calls before the one synchronise at the end, and ``wall``, with it;
- ``events``: µs a call by CUDA events over 50 back-to-back calls, in
  ``--turns`` turns, K1 and ``index_select`` alternately; medians, min and
  max.

On the first store it also times each host step a K1 launch can take
(``host_parts``), and with ``--plans`` K1's device µs under the plans
around its own (``candidate_plans``), on the same ids every call and on
fresh ids every call, as a training epoch gives them.

Where the host part of a call is longer than its kernel, the events measure
the host; a K1 kernel under ``index_select``'s then still loses by events.
Each line carries the bound (each row read and written once at 3.35 TB/s)
and the card's name and power limit. ``--device cpu`` (``--stores pca``, or
small stores through ``run``) times the plain versions by the host clock
alone: it gives no device time.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import time

import numpy as np
import torch

from masters_thesis_tpu_torch.device import card_line, resolve_device
from masters_thesis_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_reference,
)

# name -> (rows, fp32 columns, whose store)
STORES = {
    "pca": (1_200, 512, "ThinkAndTell's PCA pack"),
    "cnn_rnn": (256, 131_072, "cnn_rnn, InceptionV3 (64, 2048) patches"),
    "img_nic": (256, 100_352, "img_nic, VGG16 conv5 (196, 512)"),
    "lc_nic": (1_200, 409_600, "LcNIC on attempt_four.yaml, pregathered"),
    "flagship": (2_571, 472_576, "the flagship training store"),
}
BATCH = 64
TURNS = 7                               # as chip_smoke.py times P3
EVENT_REPS, PROFILE_REPS, HOST_REPS = 50, 50, 1_000
HBM_BYTES_PER_S = 3.35e12               # H100 SXM datasheet


def make_store(rows: int, cols: int, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, cols, generator=gen, device=device)


def edge_ids(n: int, batch: int, device, seed: int = 0) -> torch.Tensor:
    """``batch`` int32 ids in [0, n) with a repeat and -3, n, n + 1000."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, n, (batch,), generator=gen, device=device,
                        dtype=torch.int32)
    ids[1] = ids[0]
    ids[2], ids[3], ids[4] = -3, n, n + 1000
    return ids


def bound_us(store: torch.Tensor, ids: torch.Tensor) -> float:
    """Each of the rows read and written once, and the ids read once."""
    moved = 2 * len(ids) * store.shape[1] * store.element_size()
    return (moved + ids.numel() * ids.element_size()) / HBM_BYTES_PER_S * 1e6


def event_us(fn, reps: int = EVENT_REPS, warmup: int = 5) -> float:
    """µs a call of ``fn`` by CUDA events around ``reps`` back-to-back
    calls (no synchronise inside)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def host_us(fn, reps: int = HOST_REPS, cuda: bool = True) -> tuple:
    """(µs a call to issue ``reps`` calls, µs a call until they are done):
    ``time.perf_counter`` around the loop, then around it and one
    synchronise."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / reps * 1e6, (t2 - t0) / reps * 1e6


def device_us(fn, reps: int = PROFILE_REPS) -> tuple:
    """(µs of kernel time a call, {kernel name: µs a launch}, the kernel
    launches recorded a call) by ``torch.profiler`` over ``reps`` calls,
    each of which launches each of its kernels once: each kernel's mean over
    the launches the profile recorded, summed. A profile in a process that has run many can drop
    records (``chip_smoke.py``'s later phases recorded fewer launches than
    calls); a mean a launch does not count the dropped ones as zero."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = {e.key: e.self_device_time_total / e.count for e in events}
    return (sum(kernels.values()), kernels,
            sum(e.count for e in events) / reps)


def split(fn, cuda: bool = True) -> dict:
    """``fn``'s device µs (and kernels), host and wall µs a call."""
    out = {}
    if cuda:
        out["device_us"], out["kernels"], out["recorded"] = device_us(fn)
    out["host_us"], out["wall_us"] = host_us(fn, cuda=cuda)
    return out


def in_turns(fns: dict, turns: int = TURNS, cuda: bool = True) -> dict:
    """µs a call of each of ``fns`` in ``turns`` turns, taken alternately:
    by CUDA events (``event_us``), or on the CPU by the host clock."""
    out = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            out[name].append(event_us(fn) if cuda else
                             host_us(fn, EVENT_REPS, cuda=False)[1])
    return out


def compare(store: torch.Tensor, ids: torch.Tensor,
            turns: int = TURNS) -> dict:
    """K1 (int32 ``ids``) and ``index_select`` (the same ids as int64) on
    ``store``: ``split`` of each, then both in turns (``in_turns``).
    Returns {"K1": {...}, "index_select": {...}, "bound_us": ...}, each
    entry with its ``events_us`` list and their ``median_us``."""
    cuda = store.device.type == "cuda"
    ids_long = ids.long()
    fns = {"K1": lambda: gather_rows(store, ids),
           "index_select": lambda: store.index_select(0, ids_long)}
    out = {name: split(fn, cuda) for name, fn in fns.items()}
    for name, ts in in_turns(fns, turns, cuda).items():
        out[name]["events_us"] = ts
        out[name]["median_us"] = float(np.median(ts))
    out["bound_us"] = bound_us(store, ids)
    return out


def host_parts(store: torch.Tensor, ids: torch.Tensor,
               reps: int = 10_000) -> dict:
    """µs a call of each host step a K1 launch can take, by
    ``time.perf_counter`` over ``reps`` calls: the output's allocation two
    ways, the stream as a ``Stream`` object and as a raw handle, the library
    and symbol lookup, a ctypes call of one argument, and where K1's entry
    point takes a launch record, K1's argument checks and the ctypes call of
    its C entry point with no rows (which returns before it launches)."""
    from masters_thesis_tpu_torch.ops import _build

    device = store.device
    index = store.get_device()
    lib = _build.load_library()
    shape = (len(ids), store.shape[1])
    steps = {
        "torch.empty": lambda: torch.empty(shape, dtype=store.dtype,
                                           device=device),
        "store.new_empty": lambda: store.new_empty(shape),
        "torch.empty(B, W, ...)": lambda: torch.empty(
            *shape, dtype=store.dtype, device=device),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "load_library() + getattr":
            lambda: getattr(_build.load_library(), "mtt_gather_rows"),
        "ctypes call of 1 argument": lambda: lib.mtt_error_string(0),
    }
    fn = lib.mtt_gather_rows
    if len(fn.argtypes) == 5:
        from masters_thesis_tpu_torch.ops.gather import (
            _checked,
            _pack,
            gather_plan,
        )

        steps["K1's checks"] = lambda: _checked("gather_rows", store, ids,
                                                None)
        row = store.shape[1] * store.element_size()
        record = _pack(store.shape[0], row, row, 0, ids.element_size(),
                       index, gather_plan(row, 16))
        args = (store.data_ptr(), ids.data_ptr(), store.data_ptr(),
                ctypes.addressof(record),
                torch._C._cuda_getCurrentRawStream(index))
        steps["ctypes call of K1, 0 rows"] = lambda: fn(*args)
    out = {}
    for name, step in steps.items():
        step()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def candidate_plans(store: torch.Tensor) -> dict:
    """K1's plan for ``store``'s rows and the plans around it: the other
    row loads; a row under a sweep for blocks of a quarter, half, twice and
    four times the threads (within a warp and 256, and at most 4 vectors a
    thread); any row in 2 and 4 times as many pieces, and in half as
    many."""
    from masters_thesis_tpu_torch.ops.gather import (
        THREADS,
        UNROLL,
        WARP,
        gather_plan,
        vector_bytes,
    )

    row = store.shape[1] * store.element_size()
    plan = gather_plan(row, vector_bytes(row))
    vecs = row // plan.vec_bytes
    out = {"plan": plan,
           f"stream {1 - plan.stream}": plan._replace(
               stream=1 - plan.stream)}
    if plan.pieces == 1:
        for threads in (plan.threads // 4, plan.threads // 2,
                        plan.threads * 2, plan.threads * 4):
            if WARP <= threads <= THREADS and threads * UNROLL >= vecs:
                out[f"{threads} threads"] = plan._replace(threads=threads)
    longest = plan.threads * UNROLL
    for name, piece in (("pieces x0.5", min(2 * plan.piece_vecs, longest)),
                        ("pieces x2", -(-plan.piece_vecs // 2)),
                        ("pieces x4", -(-plan.piece_vecs // 4))):
        pieces = -(-vecs // piece)
        if pieces != plan.pieces:
            out[name] = plan._replace(pieces=pieces,
                                      piece_vecs=-(-vecs // pieces))
    return out


def sweep_plans(store: torch.Tensor, ids: torch.Tensor, fresh: int = 16,
                turns: int = 3) -> dict:
    """Device µs (profiler) of K1 under each of ``candidate_plans``, each
    first held bit for bit to the plain version, and of ``index_select``:
    on ``ids`` every call, and on ``fresh`` draws of ids taken in turn
    (rows not left in L2 by the call before, as in an epoch); ``turns``
    turns, taken alternately, and their medians."""
    from masters_thesis_tpu_torch.ops.gather import _gather

    gen = torch.Generator(device=store.device).manual_seed(2)
    draws = [torch.randint(0, store.shape[0], ids.shape, generator=gen,
                           device=store.device, dtype=ids.dtype)
             for _ in range(fresh)]
    longs = [d.long() for d in draws]
    want = gather_rows_reference(store, ids)
    fns = {}
    for name, plan in candidate_plans(store).items():
        fns[name] = (functools.partial(_gather, store, ids, None, plan),
                     lambda ids, plan=plan: _gather(store, ids, None, plan),
                     draws)
        if not torch.equal(fns[name][0](), want):
            raise RuntimeError(f"K1 under {plan} differs from its plain "
                               f"version")
    ids_long = ids.long()
    fns["index_select"] = (lambda: store.index_select(0, ids_long),
                           lambda ids: store.index_select(0, ids), longs)
    out = {name: {"same_us": [], "fresh_us": []} for name in fns}
    for _ in range(turns):
        for name, (same, one, ids_set) in fns.items():
            turn = itertools.cycle(ids_set)
            out[name]["same_us"].append(device_us(same)[0])
            out[name]["fresh_us"].append(
                device_us(lambda: one(next(turn)))[0])
    for name, r in out.items():
        r["same_median_us"] = float(np.median(r["same_us"]))
        r["fresh_median_us"] = float(np.median(r["fresh_us"]))
    return out


def line(label: str, result: dict, card: str) -> str:
    """One printed line of ``compare``'s result."""
    parts = []
    for name in ("K1", "index_select"):
        r = result[name]
        text = (f"{name} host {r['host_us']:.2f} us, wall "
                f"{r['wall_us']:.2f} us, events median {r['median_us']:.2f} "
                f"us (" + "/".join(f"{t:.2f}" for t in r["events_us"]) + ")")
        if "device_us" in r:
            text = (f"{name} device {r['device_us']:.2f} us ("
                    + ", ".join(f"{k[:48]} {v:.2f}"
                                for k, v in r["kernels"].items())
                    + f"; {r['recorded']:.2f} launches recorded a call), "
                    + text[len(name) + 1:])
        parts.append(text)
    return (f"{label}: " + "; ".join(parts)
            + f"; bound {result['bound_us']:.2f} us [{card}]")


def check(store: torch.Tensor, batch: int) -> None:
    """K1 bit for bit against its plain version on ``edge_ids``."""
    ids = edge_ids(store.shape[0], batch, store.device)
    got = gather_rows(store, ids)
    want = gather_rows_reference(store, ids)
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"K1 differs from its plain version on the "
                           f"{tuple(store.shape)} store")


def run(names=tuple(STORES), batch: int = BATCH, turns: int = TURNS,
        device=None, stores: dict | None = None,
        plans: bool = False) -> dict:
    """``check`` and ``compare`` on each named store (``stores`` overrides
    a name's (rows, cols)), and with ``plans`` ``sweep_plans``; prints a
    line a store and returns the results by name."""
    device = resolve_device(device)
    card = card_line(device)
    sizes = {**{k: v[:2] for k, v in STORES.items()}, **(stores or {})}
    results = {}
    for name in names:
        rows, cols = sizes[name]
        store = make_store(rows, cols, device)
        check(store, batch)
        gen = torch.Generator(device=device).manual_seed(1)
        ids = torch.randint(0, rows, (batch,), generator=gen, device=device,
                            dtype=torch.int32)
        results[name] = compare(store, ids, turns)
        print(line(f"{name} ({rows} x {cols} fp32, {batch} ids; K1 "
                   f"identical to its plain version)", results[name], card),
              flush=True)
        if device.type == "cuda" and name == names[0]:
            parts = host_parts(store, ids)
            results[name]["host_parts_us"] = parts
            print("host steps of a K1 launch, us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in parts.items()) + f" [{card}]",
                flush=True)
        if device.type == "cuda" and plans:
            sweep = sweep_plans(store, ids)
            results[name]["plans"] = sweep
            print(f"{name} K1 by plan, device us, medians on the same / "
                  f"fresh ids: " + ", ".join(
                      f"{k} {v['same_median_us']:.2f} / "
                      f"{v['fresh_median_us']:.2f}"
                      for k, v in sweep.items()) + f" [{card}]", flush=True)
        del store
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stores", default=",".join(STORES))
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--turns", type=int, default=TURNS)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--plans", action="store_true",
                        help="also time K1 under the plans around its own")
    args = parser.parse_args(argv)
    run(args.stores.split(","), args.batch, args.turns, args.device,
        plans=args.plans)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
