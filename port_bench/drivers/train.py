"""Driver ``train``: scanned train steps of an LcNIC from the device store
and tables, as ``Trainer.use_scanned_steps(..., tables=True)`` runs them.

Set-up builds one train state, drives it from the seed through the
traffic's first ``check_steps`` steps (every row a distinct key), through
the window's own call, and reads what the reference follows: each step's
loss, the first gradient as Adam got it (its first moment over 1 -
beta_1) and the parameters' change. One call of the window's shape warms
up; then calls of ``steps_per_call`` steps run until ``--seconds`` have
passed, each call's losses fetched to the host as the trainer fetches
them. The window closes at the fetch that ends the last call begun
within it. After the window (and the traced calls, in a traced run) the
program is freed and the reference follows the first steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import device as dv
from port_bench import programs
from port_bench.harness import port, traffic
from port_bench.harness.trace import traced
from port_bench.reference import compare, family

MIN_STEP_S = 0.002       # the window's batches are drawn for steps this fast


def leaf_norms(cfg: dict, model, tensors) -> dict:
    """{leaf key: norm} of tensors aligned with ``model.parameters()``,
    keyed as the family keys its clipped tensors (``leaf_key``)."""
    key = programs.family(cfg).leaf_key
    return {key(model, name): float(torch.linalg.vector_norm(t))
            for (name, _), t in zip(model.named_parameters(), tensors)}


def run(b) -> dict:
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.train.losses import lc_nic_l2_rules
    from masters_thesis_tpu_torch.train.state import new_state

    cfg, tr, dev, seed = b.config, b.traffic, b.device, b.seed
    B, K = tr["batch"], tr["steps_per_call"]
    b.mark("imports and the card")
    weights = family(cfg).weights(cfg, traffic.subseed(seed, "weights"),
                                  dev)
    model = port.model(cfg, weights, dev)
    del weights
    b.mark("model")
    store = port.store(cfg, seed, dev, model)
    b.mark("store")
    tokens = traffic.captions(cfg, tr, seed)
    target = traffic.targets(tokens)
    n_pairs = len(tokens)
    pair_key = np.arange(n_pairs) // cfg["store"]["captions_per_key"]
    tables = (torch.as_tensor(pair_key, device=dev),
              torch.as_tensor(tokens, device=dev),
              torch.as_tensor(target, device=dev))
    pcfg = programs.family(cfg).train_config(cfg, seed)
    state = new_state(model, pcfg, dev, seed=seed)
    program = b.hook(steps.make_scanned_train_steps_from_tables(
        pcfg, lc_nic_l2_rules(pcfg)))
    data = store.device_array()
    b.mark("captions and state")

    # the first steps, through the window's call: what the reference checks
    check = traffic.check_batches(cfg, B, tr["check_steps"], seed)
    sel = torch.as_tensor(check, device=dev)
    start = [p.detach().clone() for p in model.parameters()]
    state, m = program(state, data, *tables, sel[:1])
    losses = m["loss"].tolist()
    b1 = cfg["optimizer"]["beta_1"]
    got = {"grad": leaf_norms(cfg, model,
                              [mu / (1 - b1) for mu in state.tx.mu])}
    state, m = program(state, data, *tables, sel[1:])
    got["loss"] = losses + m["loss"].tolist()
    got["change"] = leaf_norms(cfg, model, [
        p.detach() - p0 for p, p0 in zip(model.parameters(), start)])
    del start
    b.mark("checked steps")

    n_steps = K * (int(b.seconds / MIN_STEP_S / K) + 2 + tr["trace_calls"])
    order = traffic.epoch_batches(n_pairs, B, n_steps, seed, dev)
    at = 0

    def call():
        nonlocal state, at
        with b.spans("train_call"):
            state, m = program(state, data, *tables,
                               order[at % n_steps:at % n_steps + K])
        at += K
        with b.spans("fetch_loss"):
            return m["loss"].cpu()

    for _ in range(tr["warmup_calls"]):
        call()
    dv.sync(dev)
    b.mark("warm-up")
    setup_s = time.perf_counter() - b.t0
    b.spans.seconds.clear()

    calls = failed = 0
    t0 = time.perf_counter()
    while True:
        failed += int(not torch.isfinite(call()).all())
        calls += 1
        if time.perf_counter() - t0 >= b.seconds:
            break
    window_s = time.perf_counter() - t0
    samples = calls * K * B
    took = sorted(b.spans.seconds["train_call"])
    b.log(f"window: {calls} calls of {K} steps at batch {B} in "
          f"{window_s:.3f} s (a call's enqueue: min {took[0]:.4f}, median "
          f"{took[len(took) // 2]:.4f}, max {took[-1]:.4f} s); set-up "
          f"{setup_s:.3f} s ({b.setup_phases()})")
    info = dv.info(dev)
    trace = None
    if b.trace:
        counters = {"steps": K * tr["trace_calls"], "batch": B,
                    "samples_per_s": samples / window_s}
        trace = traced(lambda: [call() for _ in range(tr["trace_calls"])],
                       b.spans, counters)
    del state, model, store, data, tables, program, order
    dv.free(dev)

    ref = reference(cfg, tr, seed, dev)
    readings = compare.train_readings(got, ref)
    b.log("widest leaves: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {v:.3g}" for k, v in worst)
        for name, worst in compare.worst_leaves(got, ref).items()))
    correct, rows = compare.verdict(readings, b.limits)
    return {"correct": correct and failed == 0, "attempted": calls * K,
            "failed": failed * K, "device": info, "checks": rows,
            "readings": readings, "trace": trace,
            "end_to_end": {"train_samples_per_s": samples / window_s,
                           "setup_s": setup_s}}


def reference(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The plain reference's first steps on the same rows, captions and
    weights, drawn again from the seed."""
    ref = family(cfg)
    weights = ref.weights(cfg, traffic.subseed(seed, "weights"), dev)
    tokens = traffic.captions(cfg, tr, seed)
    target = traffic.targets(tokens)
    check = traffic.check_batches(cfg, tr["batch"], tr["check_steps"], seed)
    keys = check // cfg["store"]["captions_per_key"]
    batches = [(traffic.rows_for(cfg, seed, k, dev),
                torch.as_tensor(tokens[c], device=dev),
                torch.as_tensor(target[c], device=dev))
               for k, c in zip(keys, check)]
    return ref.train_steps(weights, cfg, batches, seed)


def control(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The readings of the reference computed in TF32 standing in for the
    program."""
    with compare.lower_precision():
        low = reference(cfg, tr, seed, dev)
    return compare.train_readings(low, reference(cfg, tr, seed, dev))
