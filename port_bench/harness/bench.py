"""One run of one cell: find the cell's files by name, hand them to its
driver, and print the result line.

The manifest (``BENCHMARK.json``) names each cell's configuration and
traffic mix; the harness finds, under ``port_bench/``,
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``limits/<cell>.json``, by the
configuration's ``model`` the family's ``reference/<model>.py`` and
``programs/<model>.py`` and, in a traced run, ``metrics/<metric>.py`` for
each per-layer metric the manifest gives the cell. Adding a
configuration, a model family, a cell or a metric adds files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from port_bench.harness.trace import Spans

ROOT = Path(__file__).resolve().parents[2]          # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "masters_thesis_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "port_bench" / kind / f"{name}.json")
                      .read_text())


def cell_metrics(man: dict, cell: str, kind: str) -> list[dict]:
    """The manifest's ``kind`` metrics that cell ``cell`` reports: those
    that list it, and those that list no cells but move, or are, an
    end-to-end metric that the cell reports."""
    e2e = [m["name"] for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in man[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_module(path: Path):
    """A module from its file, by path: a driver or a metric reader, whose
    name may hold dots (``mfu.train.py``)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """What a driver gets: the cell's configuration and traffic, the run's
    seed, window and trace flag, the device, a clock started with the
    process, and the spans it records. ``hook`` lets a test put a broken
    program in the timed path's place."""

    def __init__(self, cell: str, config: dict, traffic: dict, limits: dict,
                 seed: int, seconds: float, trace: bool, device, t0: float,
                 hook=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits, self.seed, self.seconds = limits, seed, seconds
        self.trace, self.device, self.t0 = trace, device, t0
        self.hook = hook or (lambda program: program)
        self.spans = Spans()
        self.marks = [("process start", t0)]

    def log(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)

    def mark(self, done: str) -> None:
        """Close a phase of the set-up, named by what it did."""
        self.marks.append((done, time.perf_counter()))

    def setup_phases(self) -> str:
        """Seconds of each phase of the set-up, in order."""
        return ", ".join(f"{name} {t - self.marks[i][1]:.3f} s" for i, (
            name, t) in enumerate(self.marks[1:]))


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device, t0: float, hook=None) -> dict:
    """Run cell ``cell`` and return the result object of the contract
    (its ``checks`` key last)."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no cell {cell!r} in BENCHMARK.json")
    traffic = read_json("traffic", entry["traffic"], root)
    bench = Bench(cell, read_json("configs", entry["config"], root), traffic,
                  read_json("limits", cell, root), seed, seconds, trace,
                  device, t0, hook)
    files = root / "port_bench"
    out = load_module(files / "drivers" / f"{traffic['driver']}.py").run(
        bench)
    if trace:
        metrics = {}
        for m in cell_metrics(man, cell, "per_layer"):
            value = load_module(files / "metrics" / f"{m['name']}.py").read(
                out["trace"], bench)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell_metrics(man, cell, "end_to_end")}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace:
        t = out["trace"]
        result["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_device_ops(),
                               "idle_gaps": t.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out["checks"]}
    return result


def finite(x):
    """JSON has no infinity: a number that is not finite prints as null."""
    return x if isinstance(x, (int, str)) or math.isfinite(x) else None
