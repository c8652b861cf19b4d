"""Every cell of the manifest, run at a tiny size on the CPU through the
program's plain paths, gives a result of the contract's shape and holds
to its limits; a cell, a configuration and a metric are added as files
and manifest entries alone."""

import hashlib
import json
import shutil

import pytest

from port_bench.harness.bench import cell_metrics, manifest
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_runs_and_holds(root, cell):
    result = tiny.run(root, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"]: m["unit"]
            for m in cell_metrics(manifest(root), cell, "end_to_end")}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    line = json.dumps(result)
    assert "\n" not in line and json.loads(line) == result


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_config_and_metric_added_as_files(tmp_path):
    root = tiny.tiny_root(tmp_path)
    bench = root / "port_bench"
    before = digest(bench)
    config = json.loads((bench / "configs" / "cnn_rnn.json").read_text())
    config.update(name="dummy_rnn", units=8, vocab_size=40)
    (bench / "configs" / "dummy_rnn.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "greedy_b64.json").read_text())
    traffic.update(batch=2, in_flight=3)
    (bench / "traffic" / "greedy_b2.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "cnnrnn_eval_greedy.json",
                bench / "limits" / "dummy_rnn_eval.json")
    (bench / "metrics" / "dummy_count.decode.py").write_text(
        "def read(trace, bench):\n    return 1.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_rnn", "source": "a test",
                           "file": "port_bench/configs/dummy_rnn.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy_rnn_eval", "config": "dummy_rnn",
                             "traffic": "greedy_b2", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] in ("captions_per_s", "caption_batch_p95_ms"):
            m["workloads"].append("dummy_rnn_eval")
    man["per_layer"].append({"name": "dummy_count.decode", "unit": "1",
                             "better": "lower", "source": "program_counter",
                             "layer": "test", "moves": "captions_per_s",
                             "workloads": ["dummy_rnn_eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    result = tiny.run(root, "dummy_rnn_eval")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"captions_per_s",
                                      "caption_batch_p95_ms", "setup_s"}
    assert [m["name"] for m in cell_metrics(man, "dummy_rnn_eval",
                                            "per_layer")] == \
        ["dummy_count.decode"]
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
