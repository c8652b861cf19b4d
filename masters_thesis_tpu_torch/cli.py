"""Command-line interface of the port: ``python -m masters_thesis_tpu_torch``.

The JAX package's ``mtt`` commands of the training product, with its flags
and its last-line JSON:

  python -m masters_thesis_tpu_torch train   --config c.yaml   (main.py)
  python -m masters_thesis_tpu_torch eval    --config c.yaml   (eval.py)
  python -m masters_thesis_tpu_torch metrics --config c.yaml   (metric_suit.py)
  python -m masters_thesis_tpu_torch caption --run DIR --betas x.npy
      [--decoder greedy|beam|sample] [--subject a|b]

Each runs on the card unless it is given ``--device cpu``. A flag of the
JAX CLI that the port does not honour yet exits non-zero with a message
that names the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import json
import sys

# (flag's attribute, the value that needs no port, what ports the rest)
_REFUSED = {
    "train": (("processes", 1, "--processes (multi-process training) is "
               "ported with parallel/ (ROADMAP M13)"),
              ("devices_per_process", 4, "--devices-per-process (the devices "
               "of a multi-process mesh) is ported with parallel/ (ROADMAP "
               "M13)")),
    "caption": (("shard", 0, "--shard (a data-parallel serving mesh) is "
                 "ported with parallel/ (ROADMAP M13)"),
                ("pre", None, "--pre (a preprocess run's transform chain) is "
                 "ported with data/preprocess (ROADMAP M19)")),
}


def _add_common(p):
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--smoke-keys", type=int, default=48,
                   help="synthetic dataset size when no real data mounted")
    p.add_argument("--resume", action="store_true",
                   help="restore the run dir's latest checkpoint before "
                   "training/decoding (`eval --resume --epochs 0` decodes a "
                   "finished run without retraining)")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                   "kernels' plain versions)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("masters_thesis_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model from a config")
    _add_common(t)
    t.add_argument("--processes", type=int, default=1,
                   help="not ported: multi-process training")
    t.add_argument("--devices-per-process", type=int, default=4,
                   help="not ported: devices per process")

    for name, what in (("eval", "train (or restore) then decode test set"),
                       ("metrics", "train+eval+score in one go")):
        e = sub.add_parser(name, help=what)
        _add_common(e)
        e.add_argument("--decoder", choices=["greedy", "beam"],
                       default="greedy")
        e.add_argument("--beam-width", type=int, default=5,
                       help="not ported: beam search")
        e.add_argument("--subject", choices=["a", "b"], default="a")

    cp = sub.add_parser("caption",
                        help="caption betas with a trained run directory")
    cp.add_argument("--run", required=True, help="training run directory")
    cp.add_argument("--betas", required=True,
                    help=".npy of (N, voxels) betas")
    cp.add_argument("--decoder", choices=["greedy", "beam", "sample"],
                    default="greedy")
    cp.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature (--decoder sample)")
    cp.add_argument("--sample-top-k", type=int, default=0,
                    help="sample from the top k logits (0: all)")
    cp.add_argument("--seed", type=int, default=0,
                    help="the sampler's seed")
    cp.add_argument("--out", default=None,
                    help="write captions here (one line per row) instead "
                    "of stdout")
    cp.add_argument("--subject", choices=["a", "b"], default="a")
    cp.add_argument("--shard", type=int, default=0)
    cp.add_argument("--pre", default=None)
    _add_device(cp)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    for attr, ported, message in _REFUSED.get(args.cmd, ()):
        if getattr(args, attr) != ported:
            raise SystemExit(f"masters_thesis_tpu_torch {args.cmd}: "
                             f"{message}")

    if args.cmd == "caption":
        import numpy as np

        from masters_thesis_tpu_torch.serve import Captioner

        cap = Captioner.from_run_dir(
            args.run, device=args.device, subject=args.subject,
            temperature=args.temperature, sample_top_k=args.sample_top_k,
            seed=args.seed)
        texts = cap.caption(np.load(args.betas), decoder=args.decoder)
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(texts) + "\n")
            print(json.dumps({"n": len(texts), "out": args.out}))
        else:
            for t in texts:
                print(t)
        return 0

    from masters_thesis_tpu_torch.config import Config
    from masters_thesis_tpu_torch.experiment import (
        run_eval,
        run_metrics,
        run_training,
    )

    cfg = Config.load(args.config)
    run_path, logs, bundle = run_training(
        cfg, args.epochs, args.smoke_keys, resume=args.resume,
        device=args.device)
    if args.cmd == "train":
        print(json.dumps({"run_path": run_path,
                          **{k: float(v) for k, v in logs.items()}}))
        return 0
    out = run_eval(bundle, run_path, decoder=args.decoder,
                   beam_width=args.beam_width, ms2_subject=args.subject)
    result = {"run_path": run_path, "n_captions": len(out["texts"])}
    if args.cmd == "metrics":
        scores = run_metrics(bundle, out)
        result.update({k: v for k, v in scores.items() if v is not None})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
