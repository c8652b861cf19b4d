"""The readings a cell's limits are set from, on the card, in one process:
the program's over many seeds, the control's (the reference computed in
TF32 in the program's place) and, for a train cell, a planted fault's
(half of each batch left out, the mean taken over the rest).

    python3 port_bench/calibrate.py --workload <cell> --seed <first> \
        --seeds 12 --controls 3 --faults 3 --seconds 1

Prints one JSON line a reading. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch(program):
    """The train step with half of each batch left out."""
    def broken(state, store, store_idx, tokens, target, pair_idx):
        half = pair_idx[:, :pair_idx.shape[1] // 2]
        return program(state, store, store_idx, tokens, target, half)
    return broken


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.drivers import greedy_eval, train
    from port_bench.harness.bench import Bench, manifest, read_json

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = next(w for w in manifest(ROOT)["workloads"]
                 if w["name"] == args.workload)
    cfg = read_json("configs", entry["config"])
    tr = read_json("traffic", entry["traffic"])
    # a cell whose limits are still to be set has no file yet
    limits = (read_json("limits", args.workload)
              if (ROOT / "port_bench" / "limits" /
                  f"{args.workload}.json").is_file() else {})
    dev = torch.device("cuda")
    driver = {"train": train, "greedy_eval": greedy_eval}[tr["driver"]]

    def show(kind, seed, readings, **extra):
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                          "readings": readings, **extra}), flush=True)

    for i in range(args.seeds):
        seed = args.seed + i
        b = Bench(args.workload, cfg, tr, limits, seed, args.seconds, False,
                  dev, time.perf_counter())
        out = driver.run(b)
        show("program", seed, out["readings"], correct=out["correct"],
             end_to_end=out["end_to_end"])
        if i < args.controls:
            if tr["driver"] == "train":
                low = train.control(cfg, tr, seed, dev)
            else:
                low = greedy_eval.reference(cfg, seed, dev, *out["sampled"],
                                            control=True)
            show("control", seed, low)
        del out
        if i < args.faults and tr["driver"] == "train":
            b = Bench(args.workload, cfg, tr, limits, seed, args.seconds,
                      False, dev, time.perf_counter(), hook=half_batch)
            show("half_batch", seed, driver.run(b)["readings"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
