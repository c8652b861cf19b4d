"""Run one cell of the port's benchmark on the card this process starts on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's inputs and weights from the seed, sets up the program
(``masters_thesis_tpu_torch``), warms up the cell's own shapes, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, read from a profiler trace of a few units after the
window). The numbers compared, each beside its limit, are the last lines
of standard error and the result's last key. Exits non-zero, printing no
result, without a CUDA card or with one module of JAX or of the JAX
package loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.bench import finite, loaded_forbidden, run_cell

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"port_bench: needs {chips} CUDA card(s), found {cards}; no "
              f"result", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), T0)
    found = loaded_forbidden()
    if found:
        print(f"port_bench: modules of JAX or of the JAX package are "
              f"loaded: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"no_jax: none of jax, jaxlib, flax, optax, masters_thesis_tpu "
          f"among {len(sys.modules)} loaded modules", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    for c in result["checks"].values():
        c["value"] = finite(c["value"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
