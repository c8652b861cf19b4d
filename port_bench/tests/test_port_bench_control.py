"""The control, the plain reference computed in TF32 in the program's
place, comes out as not correct against every cell's limits, on three
seeds, on the card at a size a test run can hold (the cells' widths, a
smaller store and train batch). Run on the card with
``python -m pytest port_bench/tests -m cuda``."""

import time

import pytest
import torch

from port_bench.drivers import greedy_eval, train
from port_bench.harness.bench import Bench, manifest, read_json
from port_bench.reference import compare
from port_bench.tests import tiny

STORE = dict(keys=1600, train_keys=1000, test_keys=600)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.cells())
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = next(w for w in manifest()["workloads"] if w["name"] == cell)
    cfg = read_json("configs", entry["config"])
    cfg["store"].update(STORE)
    tr = read_json("traffic", entry["traffic"])
    limits = read_json("limits", cell)
    dev = torch.device("cuda")
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        if tr["driver"] == "train":
            tr["batch"] = 128
            low = train.control(cfg, tr, seed, dev)
        else:
            out = greedy_eval.run(Bench(cell, cfg, tr, limits, seed, 0.5,
                                        False, dev, time.perf_counter()))
            assert out["correct"]
            low = greedy_eval.reference(cfg, seed, dev, *out["sampled"],
                                        control=True)
        assert compare.verdict(low, limits)[0] is False, (seed, low)
