"""A copy of the benchmark at a tiny size, for the CPU tests: the manifest
and the files under ``port_bench/``, every configuration and traffic mix
cut down so that a cell runs in seconds through the program's plain
paths, and the queued train cell added."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from port_bench.harness.bench import ROOT, run_cell

CONFIGS = {
    "lcnic_flagship": dict(n_voxels=3000, n_groups=10, group_size=8,
                           attn_units=8, units=16, embedding_text=16,
                           head_dim=16, vocab_size=60, max_length=6),
    "cnn_rnn": dict(n_patches=5, in_channels=12, embed_dim=8, units=16,
                    vocab_size=60, max_length=6),
}
STORES = {"lcnic_flagship": dict(keys=60, train_keys=48, test_keys=12),
          "cnn_rnn": dict(keys=40, train_keys=30, test_keys=10)}
TRAFFIC = {"train_b512": dict(batch=8, steps_per_call=2,
                             caption_words=[2, 4]),
           "greedy_b64": dict(batch=4, warmup_requests=2),
           "greedy_b256": dict(batch=6, warmup_requests=2)}
SEED = 2**31 + 12345          # past 32 signed bits, as the driver's are
# the train cell that waits for its bound (PERF.md, Open questions): the
# tiny copy adds it, so that its driver, traffic and reference stay held
QUEUED = {
    "workload": {"name": "lcnic_train_b512", "config": "lcnic_flagship",
                 "traffic": "train_b512", "chips": 1,
                 "why": "scanned train steps at batch 512"},
    "end_to_end": {"name": "train_samples_per_s", "unit": "samples/s",
                   "better": "higher", "bound": 0.25, "source": "host_clock",
                   "workloads": ["lcnic_train_b512"]},
    "limits": {"loss": 5e-6, "grad": 2e-3, "change": 1e-2},
}


def edit(path: Path, changes: dict, store: dict | None = None) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    if store:
        data["store"].update(store)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path) -> Path:
    """A checkout of the benchmark alone (the manifest and
    ``port_bench/``) at the tiny sizes."""
    root = tmp / "bench"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, changes in CONFIGS.items():
        edit(root / "port_bench" / "configs" / f"{name}.json", changes,
             STORES[name])
    for name, changes in TRAFFIC.items():
        edit(root / "port_bench" / "traffic" / f"{name}.json", changes)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append(QUEUED["workload"])
    man["end_to_end"].insert(0, QUEUED["end_to_end"])
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "port_bench" / "limits" / "lcnic_train_b512.json").write_text(
        json.dumps(QUEUED["limits"]))
    return root


def run(root: Path, cell: str, seconds: float = 0.3, hook=None,
        seed: int = SEED) -> dict:
    """One run of ``cell`` of the copy at ``root`` on the CPU."""
    return run_cell(root, cell, seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), hook)


def cells(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in json.loads(
        (root / "BENCHMARK.json").read_text())["workloads"]]


# the cells of the tiny copy: the manifest's and the queued one
CELLS = cells() + [QUEUED["workload"]["name"]]
