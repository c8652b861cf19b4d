"""Driver ``greedy_eval``: greedy captions of test keys from the device
store, as ``experiment.run_eval`` makes them: each request's rows
gathered by ``ops.gather.row_gather`` (K1), decoded by
``ops.fused_decode.make_whole_fused_greedy_decoder`` (K2 for an LSTM, K3
for a GRU), words and alphas copied to the host.

One client keeps ``in_flight`` requests in flight: it enqueues request
i + 1 before it waits for request i's words, each request's copies queued
right behind its decode. A request's latency runs from the moment its
enqueue begins to the moment its words are on the host. Set-up ends after
``warmup_requests``; the window then runs until ``--seconds`` have passed,
and closes when the last request begun within it has its words. A sample
of the finished requests, drawn from the seed (reservoir sampling over the
order they finish in), is held against the plain reference after the
program is freed: the reference teacher-forces each sampled row on its
served words and reads how far each served word's logit lies under its
best, and the gap of the served alphas from its own.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from port_bench.harness import device as dv
from port_bench.harness import port, traffic
from port_bench.harness.trace import traced
from port_bench.reference import compare, family

MIN_REQUEST_S = 0.0005   # requests are drawn for decodes this fast
REF_ROWS = 512           # rows the reference runs at once


def run(b) -> dict:
    from masters_thesis_tpu_torch.ops.fused_decode import (
        make_whole_fused_greedy_decoder,
    )
    from masters_thesis_tpu_torch.ops.gather import row_gather

    cfg, tr, dev, seed = b.config, b.traffic, b.device, b.seed
    B, F, T, V = tr["batch"], tr["in_flight"], cfg["max_length"], \
        cfg["vocab_size"]
    b.mark("imports and the card")
    ref = family(cfg)
    weights = ref.weights(cfg, traffic.subseed(seed, "weights"), dev)
    model = port.model(cfg, weights, dev).eval()
    del weights
    b.mark("model")
    store = port.store(cfg, seed, dev, model)
    data = store.device_array()
    b.mark("store")
    decode = b.hook(make_whole_fused_greedy_decoder(model, T))
    gather = row_gather(True)
    n = (int(b.seconds / MIN_REQUEST_S) + tr["warmup_requests"]
         + tr["trace_requests"])
    order = traffic.request_batches(traffic.split(cfg)[1], B, n, seed, dev)
    keys = order.cpu().numpy()
    words_h = dv.host_buffer((F, B, T), torch.int32, dev)
    alphas_h = dv.host_buffer((F, B, T, ref.regions(cfg)), torch.float32,
                              dev)
    done_at = [dv.Done(dev) for _ in range(F)]
    rng = np.random.Generator(np.random.PCG64(traffic.subseed(seed,
                                                              "sample")))
    state = {"next": 0, "finished": 0}
    kept: dict[int, tuple] = {}

    def submit(i: int, flight: deque) -> None:
        slot = i % F
        t = time.perf_counter()
        with b.spans("enqueue"):
            words, alphas = decode(gather(data, order[i]),
                                   cfg["tokens"]["start"])
            words_h[slot].copy_(words, non_blocking=True)
            alphas_h[slot].copy_(alphas, non_blocking=True)
            done_at[slot].record()
        flight.append((i, slot, t))

    def serve(more, keep: bool) -> tuple[list, int]:
        """Closed loop until ``more()`` is false: latencies, bad requests."""
        flight: deque = deque()
        latency, bad = [], 0
        while len(flight) < F and more():
            submit(state["next"], flight)
            state["next"] += 1
        while flight:
            i, slot, t = flight.popleft()
            with b.spans("wait"):
                done_at[slot].wait()
            latency.append(time.perf_counter() - t)
            w = words_h[slot].numpy()
            bad += int(((w < 0) | (w >= V)).any())
            if keep:
                sample(i, slot)
            if more():
                submit(state["next"], flight)
                state["next"] += 1
        return latency, bad

    def sample(i: int, slot: int) -> None:
        c = state["finished"]
        state["finished"] += 1
        k = tr["check_requests"]
        at = c if c < k else int(rng.integers(0, c + 1))
        if at < k:
            kept[at] = (i, words_h[slot].numpy().copy(),
                        alphas_h[slot].numpy().copy())

    def count(m: int):
        stop = state["next"] + m
        return lambda: state["next"] < stop

    serve(count(tr["warmup_requests"]), keep=False)
    dv.sync(dev)
    b.mark("warm-up")
    setup_s = time.perf_counter() - b.t0
    b.spans.seconds.clear()

    first = state["next"]
    t0 = time.perf_counter()
    latency, bad = serve(lambda: time.perf_counter() - t0 < b.seconds
                         and state["next"] < n, keep=True)
    window_s = time.perf_counter() - t0
    attempted = state["next"] - first
    enqueue = b.spans.seconds["enqueue"]
    b.log(f"window: {attempted} requests of {B} rows in {window_s:.3f} s; "
          f"p95 over {len(latency)} latencies (p50 "
          f"{1e3 * float(np.median(latency)):.3f}, max "
          f"{1e3 * max(latency):.3f} ms); enqueue {1e3 * np.mean(enqueue):.3f}"
          f" ms a request; set-up {setup_s:.3f} s ({b.setup_phases()})")
    info = dv.info(dev)
    trace = None
    if b.trace:
        counters = {"decodes": tr["trace_requests"], "batch": B,
                    "captions_per_s": attempted * B / window_s,
                    "host_ms_per_batch": 1e3 * float(np.mean(enqueue))}
        trace = traced(lambda: serve(count(tr["trace_requests"]), False),
                       b.spans, counters)
    del model, store, data, decode, order
    dv.free(dev)

    sampled = [kept[j] for j in sorted(kept)]
    t = time.perf_counter()
    readings = reference(cfg, seed, dev, sampled, keys)
    b.log(f"reference: {len(sampled) * B} sampled rows in "
          f"{time.perf_counter() - t:.3f} s")
    correct, rows = compare.verdict(readings, b.limits)
    return {"correct": correct and bad == 0, "attempted": attempted,
            "failed": bad + attempted - len(latency), "device": info,
            "checks": rows, "readings": readings, "trace": trace,
            "sampled": (sampled, keys),
            "end_to_end": {
                "captions_per_s": len(latency) * B / window_s,
                "caption_batch_p95_ms": 1e3 * float(np.percentile(latency,
                                                                  95)),
                "setup_s": setup_s}}


@torch.no_grad()
def reference(cfg: dict, seed: int, dev, kept: list, keys: np.ndarray,
              control: bool = False) -> dict:
    """The worst readings over the sampled requests, the reference run in
    blocks of ``REF_ROWS`` rows on weights and rows drawn again from the
    seed, each row teacher-forced on its served words. ``control``: the
    reference computed in TF32 stands in for the program, its words the
    ones TF32 puts first at each position of the same rows and tokens."""
    ref = family(cfg)
    weights = ref.weights(cfg, traffic.subseed(seed, "weights"), dev)
    rows = np.concatenate([keys[i] for i, _, _ in kept])
    served = np.concatenate([w for _, w, _ in kept])
    served_alphas = np.concatenate([a for _, _, a in kept])
    worst = {"logit_gap": 0.0, "alpha_err": 0.0}
    for lo in range(0, len(rows), REF_ROWS):
        at = slice(lo, lo + REF_ROWS)
        x = traffic.rows_for(cfg, seed, rows[at], dev)
        words = torch.as_tensor(served[at], device=dev)
        alphas = torch.as_tensor(served_alphas[at], device=dev)
        tokens = torch.cat([torch.full_like(words[:, :1],
                                            cfg["tokens"]["start"]),
                            words[:, :-1]], dim=1)
        logits, ref_alphas = ref.teacher_forced(weights, cfg, x, tokens)
        if control:
            with compare.lower_precision():
                low, alphas = ref.teacher_forced(weights, cfg, x, tokens)
            words = low.argmax(dim=-1)
        r = compare.decode_readings(logits, ref_alphas, words, alphas)
        worst = {k: max(worst[k], r[k]) for k in worst}
        del x, logits, ref_alphas
    return worst
