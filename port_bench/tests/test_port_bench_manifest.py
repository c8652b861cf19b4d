"""The manifest and every file it names, held to the benchmark's contract:
names, units, bounds, the cells' metrics, and the files the harness finds
by name."""

import json
import re

import pytest

from port_bench.harness.bench import ROOT, cell_metrics, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|units|"
                   r"size|width|heads?_|expansion|per_tok)")
BUDGET_S, CELLS_MAX = 43200, 24


@pytest.fixture(scope="module")
def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for path in man["paths"]:
        assert PATH.match(path) and not path.endswith("_torch")
        assert (ROOT / path).is_dir()
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
        if (ROOT / word).is_file():
            assert any(word.startswith(p + "/") for p in man["paths"])
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * CELLS_MAX
    assert runs * (rs + 60) + CELLS_MAX * 180 + 1200 <= BUDGET_S


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(man, kind):
    entries = man[kind]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24,
                                 "end_to_end": 16, "per_layer": 128}[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metric_names_and_metrics_of_cells(man):
    all_names = [e["name"] for k in ("end_to_end", "per_layer")
                 for e in man[k]]
    assert len(set(all_names)) == len(all_names)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "_roofline" in m["name"] or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert callable(load_module(ROOT / "port_bench" / "metrics"
                                    / f"{m['name']}.py").read)
    assert all(len(v) == 1 for v in layers.values()), layers
    cells = [w["name"] for w in man["workloads"]]
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells)
    for cell in cells:
        reported = {m["name"] for m in cell_metrics(man, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        per_layer = cell_metrics(man, cell, "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in reported, (cell, m["name"])


def test_configs(man):
    used = {w["config"] for w in man["workloads"]}
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    for c in man["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert c["file"] == f"port_bench/configs/{c['name']}.json"


def test_cells(man):
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(pairs) // 4)
    root = ROOT / "port_bench"
    for w in man["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (root / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((root / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v > 0 for v in limits.values())


def test_file_names():
    for path in (ROOT / "port_bench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.match(str(path.relative_to(ROOT))), path
