#!/usr/bin/env python3
"""Time the PyTorch port's bf16-weight greedy decode (K2 and K3 with bf16
weights) in two or more checkouts of the repository, in turns on one card,
and split each decode by part.

    python3 scripts/port_decode_ab.py TREE [TREE ...] [--profile]

Each TREE is the root of a checkout (for a comparison with the parent
commit: ``git archive HEAD~1 | tar -x -C _parent``, then ``_parent . .
_parent``). For each TREE in the order given, a child process with the
tree as its working directory builds that tree's kernels and, on
``chip_smoke.py``'s seeded inputs at batch 64, casts them as
``Captioner(weights_bf16=True)`` does and times the bf16-weight decode with
CUDA events (``chip_smoke.cuda_ms``, 10 calls after 2): the flagship LcNIC
(K2) with ``feat_bf16`` off and on, and CnnRnn (K3) with ``gru_zero_state``
on and off. With ``--profile`` it also splits each decode: a tree whose
decode is the six-launch chain by kernel name (``chip_smoke.step_split``
with ``CHAIN_PARTS``: us a step of h W2, the attention, the cell, Wi, Wo
and the argmax, and the launch gaps: the event time a step less the
kernels' device time), a tree whose decode is the persistent kernel by its
phase stamps (``chip_smoke.phase_split``). Each child prints one line
``AB {json}``: the tree, the card and its power limit, and per case the
ms, the bound and the split. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the bf16-weight chain's six launches a step, in order, by the names the
# profiler gives them (the tree before the persistent kernel: h W2 on the
# fp32 tile kernel, the attention, the cell, Wi and Wo on the bf16
# tensor-core tile, the argmax with the re-embedding)
CHAIN_PARTS = {
    cell: (("h W2", ("tile_kernel<1,",)),
           ("attention", ("attention_kernel",)),
           ("cell", (f"mma_tile_kernel<{gates},",)),
           ("Wi", ("mma_tile_kernel<1, 1, 1,",)),
           ("Wo", ("mma_tile_kernel<1, 2, 2,",)),
           ("argmax and embed", ("argmax_embed_kernel",)))
    for cell, gates in (("lstm", 4), ("gru", 3))}


def child(profile: bool) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from masters_thesis_tpu_torch.device import card_line
    from masters_thesis_tpu_torch.models.nic import CnnRnnNIC
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line(device)
    cs.build_kernels()
    persistent = hasattr(cs, "phase_split")
    cases = {}

    @torch.inference_mode()
    def case(name, model, rows, feat_bf16=False):
        T, V = model.max_length, model.vocab_size
        kernel, _ = fd.decode_kernel(model)
        opts = fd.decode_options(model)
        half = fd.cast_decode_inputs(
            model.cell_type, fd.decode_inputs(model, rows, 1),
            weights_bf16=True, feat_bf16=feat_bf16)
        ms = cs.cuda_ms(lambda: kernel(*half, max_length=T, **opts))
        out = {"ms": ms, **cs.decode_bound(model.cell_type, half, opts, T,
                                           V)}
        if profile and persistent:
            out["phases"] = cs.phase_split(model.cell_type, half, opts, T,
                                           name, card)
        elif profile:
            split = cs.step_split(
                lambda: kernel(*half, max_length=T, **opts), name, T,
                CHAIN_PARTS[model.cell_type], card)
            split["launch gaps"] = (ms * 1e3 / T
                                    - sum(v or 0.0 for v in split.values()))
            out["us_a_step"] = split
        print(f"{name}: {ms:.4f} ms a decode, bound {out['bound_ms']:.4f} "
              f"ms [{card}]", flush=True)
        cases[name] = out

    model = cs.flagship_model(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    betas = torch.randn(cs.BATCH, cs.N_VOXELS, generator=gen, device=device)
    case("bf16 K2", model, betas)
    case("bf16 K2 (feat_bf16)", model, betas, feat_bf16=True)
    del model, betas
    cs.release()
    gen = torch.Generator().manual_seed(cs.SEED)
    model = CnnRnnNIC(generator=gen, **cs.CNN_RNN_WIDTHS)
    fd.spread_for_check(model, gen)
    model = model.to(device).eval()
    dev_gen = torch.Generator(device=device).manual_seed(cs.SEED)
    rows = torch.randn(cs.BATCH, *model.encoder.row_shape, generator=dev_gen,
                       device=device)
    for zero in (True, False):
        model.gru_zero_state = zero
        case(f"bf16 K3 ({'zero' if zero else 'carried'} state)", model, rows)
    print("AB " + json.dumps({"tree": os.getcwd(), "persistent": persistent,
                              "card": card, "cases": cases}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.profile)
        return 0
    code = 0
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = {**os.environ, "PYTHONPATH": root}
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"]
            + (["--profile"] if args.profile else []),
            cwd=root, env=env)
        code = code or run.returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
