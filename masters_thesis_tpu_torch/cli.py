"""Command-line interface of the port: ``python -m masters_thesis_tpu_torch``.

The JAX package's ``mtt`` commands of the training product and of the
input side, with their flags and their last-line JSON:

  python -m masters_thesis_tpu_torch train   --config c.yaml   (main.py)
      [--processes P --devices-per-process D]   (P x D ranks, parallel/)
  python -m masters_thesis_tpu_torch eval    --config c.yaml   (eval.py)
  python -m masters_thesis_tpu_torch metrics --config c.yaml   (metric_suit.py)
  python -m masters_thesis_tpu_torch caption --run DIR --betas x.npy
      [--decoder greedy|beam|sample] [--subject a|b] [--pre PREDIR]
      [--shard N]
  python -m masters_thesis_tpu_torch serve   --run DIR | --export A.mttx
      [--pre PREDIR] [--decoder ...] [--max-batch N] [--max-wait-ms T]
      [--host H --port P] [--shard N]
  python -m masters_thesis_tpu_torch dryrun  --devices N [--flagship]
      (one sharded train step over N ranks; the flagship's census)
  python -m masters_thesis_tpu_torch export  --run DIR --out A.mttx
      [--decoder greedy|beam] [--batch-size N] [--beam-width W]
      [--platforms cpu,cuda] [--subject a|b] [--pre PREDIR]
  python -m masters_thesis_tpu_torch analyze --run DIR [--out DIR]
      [--atlas-lh L --atlas-rh R] [--betas X.npy [--top-verts N]
      [--guse G.npy]] [--responses R.tsv] [--nearest-guse DIR] ...
      (Eval/; needs matplotlib)
  python -m masters_thesis_tpu_torch preprocess --config c.yaml --out DIR
      [--from-sessions DIR --behavior B.csv --captions-json C.json]
      [--vc-parcels 1,2 --normalize --pca K]   (nsd_get_data, SVD/svd.py)
  python -m masters_thesis_tpu_torch transform --pre DIR --betas x.npy
      --out y.npy
  python -m masters_thesis_tpu_torch features --backbone vgg16 --images
      imgs.npy --out f.npy [--keys k.npy --pack] [--weights w.npz]
      (CNN/feature_extractor*.py)
  python -m masters_thesis_tpu_torch stimuli --hdf5 nsd_stimuli.hdf5
      --out-dir DIR [--format png|npy]
  python -m masters_thesis_tpu_torch guse --config c.yaml --out DIR
      [--no-per-key]   (get_guse.py)
  python -m masters_thesis_tpu_torch score --captions captions_{e}.txt
      --references DIR|refs.json [--tokenizer t.json --keys k.txt]
      [--bleu-table]   (Eval/one_shot.py + evaluate.py)
  python -m masters_thesis_tpu_torch tune --config c.yaml [--num-samples N
      | --grid] [--smoke-test] [--processes N] [--queue DIR [--worker]
      [--stale-claim S] [--resume-queue]]   (tune.py, gridsearch_train.py)

Each runs on the card unless it is given ``--device cpu`` (``transform``
and ``stimuli`` run on the host; ``guse`` and ``score`` run the USE
encoder on the device when a weight bundle is found, and otherwise embed
on the host; ``analyze`` draws on the host and uses the device only for
its PCA front end and the USE encoder; ``export`` traces one program for
each of ``--platforms``, by default the platform of ``--device``).
``train --processes`` starts one process a rank (``parallel.multiprocess``;
ranks on one card share it under gloo), ``caption``/``serve --shard N``
serve N replicas, one a device, and ``dryrun`` runs one sharded step over
N ranks (``parallel.dryrun``). A ``tpu:`` knob that the port does not
honour yet makes a run exit non-zero naming the ROADMAP item that ports
it (``config.unsupported_knobs``).
"""

from __future__ import annotations

import argparse
import json
import sys

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
                   help="train across P x D ranks, one process a rank, "
                   "grouped as P hosts of --devices-per-process ranks "
                   "(the config's tpu.mesh_* lay them out; a 1 x 1 mesh "
                   "becomes data-parallel over every rank)")
    t.add_argument("--devices-per-process", type=int, default=4,
                   help="ranks (one device each) of each of --processes "
                   "hosts")

    for name, what in (("eval", "train (or restore) then decode test set"),
                       ("metrics", "train+eval+score in one go")):
        e = sub.add_parser(name, help=what)
        _add_common(e)
        e.add_argument("--decoder", choices=["greedy", "beam"],
                       default="greedy")
        e.add_argument("--beam-width", type=int, default=5)
        e.add_argument("--subject", choices=["a", "b"], default="a")

    pp = sub.add_parser("preprocess",
                        help="pack betas, stats, vc/normalize/PCA views, "
                        "tokenizer")
    pp.add_argument("--config", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--pca", type=int, default=0,
                    help="PCA components (fitted and applied on --device)")
    pp.add_argument("--from-sessions", default=None, metavar="DIR",
                    help="ingest lh/rh.betas_session{NN}.{npy,mgh} session "
                    "files first (my_get_betas stage, nsd_get_data.py:174-281)")
    pp.add_argument("--behavior", default=None,
                    help="behavior CSV/TSV (or dir of behav_session{NN}.csv) "
                    "with SUBJECT,SESSION,RUN,TRIAL,73KID columns")
    pp.add_argument("--captions-json", default=None,
                    help="JSON of {73KID: [caption, ...]}")
    pp.add_argument("--n-sessions", type=int, default=40)
    pp.add_argument("--vc-parcels", default=None,
                    help="visual-cortex parcel labels (comma list, or the "
                    "reference's VISUAL_MASK CSV) -> betas_pack_vc/ (needs "
                    "dataset.nsd_dir atlases)")
    pp.add_argument("--normalize", action="store_true",
                    help="per-voxel (x-mean)/std over the current view -> "
                    "betas_pack_norm/; chains after --vc-parcels and before "
                    "--pca")
    _add_device(pp)

    tf = sub.add_parser("transform",
                        help="replay a preprocess run's transform chain "
                        "(vc mask -> normalize -> pca) on a betas .npy")
    tf.add_argument("--pre", required=True,
                    help="a `preprocess` output directory")
    tf.add_argument("--betas", required=True, help="(N, V) .npy to transform")
    tf.add_argument("--out", required=True, help="output .npy")

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
    cp.add_argument("--shard", type=int, default=0,
                    help="data-parallel serving over N devices (0: one "
                    "device): N replicas decode equal shares of each batch")
    cp.add_argument("--pre", default=None,
                    help="a `preprocess` output dir: replay its transform "
                    "chain on the raw betas before decoding")
    _add_device(cp)

    sv = sub.add_parser("serve",
                        help="HTTP captioning service with dynamic "
                        "micro-batching: POST /caption (betas .npy or JSON) "
                        "-> captions")
    sv.add_argument("--run", default=None, help="training run directory")
    sv.add_argument("--export", default=None, dest="export_path",
                    help="serve from an `export` artifact instead of a run "
                    "dir (no model code or checkpoint needed; the "
                    "artifact's frozen decoder is the only one served)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (printed on startup)")
    sv.add_argument("--decoder", choices=["greedy", "beam", "sample"],
                    default=None, help="default decoder (greedy unless "
                    "--export, whose frozen decoder is the default; per "
                    "request: POST /caption?decoder=beam)")
    sv.add_argument("--max-batch", type=int, default=64,
                    help="max rows coalesced into one device call")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="how long to hold the first request for "
                    "co-batchable work")
    sv.add_argument("--subject", choices=["a", "b"], default="a",
                    help="ms2_nic runs: which per-subject encoder serves")
    sv.add_argument("--shard", type=int, default=0,
                    help="data-parallel serving over N devices")
    sv.add_argument("--pre", default=None,
                    help="a `preprocess` output dir: every request's raw "
                    "betas replay its transform chain before decoding")
    _add_device(sv)

    dr = sub.add_parser("dryrun",
                        help="one sharded train step over N ranks at tiny "
                        "shapes, then the flagship's sharding census")
    dr.add_argument("--devices", type=int, default=8,
                    help="ranks, one process each (on one card they share "
                    "it under gloo)")
    dr.add_argument("--flagship", action="store_true",
                    help="only the census of the reference-dimension model "
                    "(327,684 voxels / 360 groups / vocab 5001 padded / "
                    "units 512), built on the meta device: no array is "
                    "allocated")
    _add_device(dr)

    fe = sub.add_parser("features",
                        help="batched CNN feature extraction (the "
                        "reference's CNN/feature_extractor*.py)")
    fe.add_argument("--backbone", default="vgg16",
                    choices=["vgg16", "inception_v3", "efficientnet_b3",
                             "resnet50"])
    fe.add_argument("--images", required=True,
                    help=".npy of (N, H, W, 3) RGB images, or the NSD "
                    "stimuli .hdf5 (imgBrick read directly)")
    fe.add_argument("--keys", default=None,
                    help=".npy of 1-based NSD keys selecting rows")
    fe.add_argument("--out", required=True, help="output .npy path")
    fe.add_argument("--weights", default=None,
                    help="npz of pretrained params ('/'-joined flax paths)")
    fe.add_argument("--head", default=None,
                    help="feature head (vgg16: fc2|conv5; others: "
                    "patches|pooled); default per backbone")
    fe.add_argument("--batch-size", type=int, default=64)
    fe.add_argument("--pack", action="store_true",
                    help="write --out as a key-addressed pack dir (needs "
                    "--keys): the dataset.betas_path layout")
    _add_device(fe)

    st = sub.add_parser("stimuli",
                        help="export NSD stimulus pictures from "
                        "nsd_stimuli.hdf5 as KID{key} files")
    st.add_argument("--hdf5", required=True, help="nsd_stimuli.hdf5 path")
    st.add_argument("--keys", default=None,
                    help=".npy of 1-based NSD keys (default: all)")
    st.add_argument("--out-dir", required=True)
    st.add_argument("--format", default="png", choices=["png", "npy"])

    ex = sub.add_parser("export",
                        help="freeze a trained run's decode program and "
                        "weights into one artifact (torch.export) that "
                        "serves without model code; load with "
                        "export.load_exported")
    ex.add_argument("--run", required=True, help="training run directory")
    ex.add_argument("--out", required=True, help="artifact path (zip)")
    ex.add_argument("--decoder", choices=["greedy", "beam"],
                    default="greedy")
    ex.add_argument("--batch-size", type=int, default=64,
                    help="the artifact's static batch shape")
    ex.add_argument("--beam-width", type=int, default=5)
    ex.add_argument("--platforms", default="",
                    help="comma-separated targets of cpu and cuda, e.g. "
                    "cpu,cuda (default: the platform of --device)")
    ex.add_argument("--subject", choices=["a", "b"], default="a",
                    help="ms2_nic runs: which per-subject encoder the "
                    "artifact freezes (one artifact per subject)")
    ex.add_argument("--pre", default=None,
                    help="a `preprocess` output dir: bake its transform "
                    "chain (vc mask/normalize/pca) into the program, so the "
                    "artifact takes the raw betas the pipeline started from")
    _add_device(ex)

    an = sub.add_parser("analyze",
                        help="post-hoc run analysis: loss plot, caption POS "
                        "stats, region-attention figures (the reference's "
                        "Eval/ suite); needs matplotlib")
    an.add_argument("--run", required=True, help="run directory")
    an.add_argument("--out", default=None,
                    help="output dir (default: <run>/analysis)")
    an.add_argument("--atlas-lh", default=None,
                    help="lh.HCP_MMP1 label vector (.npy/.mgz): vertex-space "
                    "attention maps")
    an.add_argument("--atlas-rh", default=None)
    an.add_argument("--flat-coords", default=None,
                    help="npz of lh/rh (V, 2) flat-surface vertex coords "
                    "for a true flatmap scatter")
    an.add_argument("--compare-run", default=None, metavar="DIR",
                    help="another run dir: cross-run caption n-gram hit "
                    "rate + Jaccard on shared keys per epoch")
    an.add_argument("--word-map", type=int, default=None, metavar="IDX",
                    help="render trial IDX's (word x region) attention map")
    an.add_argument("--betas", default=None, metavar="NPY",
                    help="(N, V) betas: trial-average + L1-norm vertex maps "
                    "and a t-SNE scatter")
    an.add_argument("--betas-b", default=None, metavar="NPY",
                    help="second (N, V) betas split for --top-verts overlap")
    an.add_argument("--top-verts", type=int, default=None, metavar="N",
                    help="rank the N most active vertices by mean |beta| of "
                    "--betas -> most_active_vert.txt")
    an.add_argument("--guse", default=None, metavar="NPY",
                    help="(N, 512) or (N, C, 512) caption embeddings "
                    "row-aligned with --betas: semantic-vs-neural "
                    "similarity -> betas_guse_similarity.png")
    an.add_argument("--sim-targets", default=None, metavar="I,J,...",
                    help="target trial rows for --guse (default: the "
                    "reference's row 100)")
    an.add_argument("--region-names", default=None, metavar="CSV",
                    help="override the built-in HCP-MMP1.0 parcel names")
    an.add_argument("--responses", default=None, metavar="TSV",
                    help="NSD behav/responses.tsv: BLEU vs behavioral hit "
                    "rate boxplots -> bleu_hit_rate_{e}.png")
    an.add_argument("--nearest-guse", default=None, metavar="DIR",
                    help="`guse` output dir: rank training captions by "
                    "embedding distance to each eval caption -> "
                    "nearest_guse_{e}.tsv")
    an.add_argument("--images", default=None,
                    help="KID{key} stimulus-picture dir (`stimuli` output) "
                    "for the caption sample grids")
    _add_device(an)

    tu = sub.add_parser("tune", help="random-search + ASHA over L2 regs")
    _add_common(tu)
    tu.add_argument("--num-samples", type=int, default=8)
    tu.add_argument("--smoke-test", action="store_true")
    tu.add_argument("--grid", action="store_true",
                    help="grid search over the L2 space instead of random "
                    "(gridsearch_train.py / kerastuner equivalent)")
    tu.add_argument("--processes", type=int, default=1,
                    help="parallel trial processes (spawned; on one card "
                    "they share it)")
    tu.add_argument("--queue", default=None, metavar="DIR",
                    help="shared-filesystem trial queue for multi-host "
                    "dispatch (the ray.init(address=...) analogue, "
                    "tune.py:215-228); coordinator enqueues + works inline")
    tu.add_argument("--worker", action="store_true",
                    help="with --queue: join as a worker host instead of "
                    "coordinating")
    tu.add_argument("--stale-claim", type=float, default=60.0,
                    help="with --queue: seconds without a heartbeat before "
                    "a dead worker's running trial is re-queued")
    tu.add_argument("--resume-queue", action="store_true",
                    help="with --queue: continue an interrupted "
                    "experiment's queue dir — keep done/ results, enqueue "
                    "only missing trials (search space must reproduce "
                    "exactly: same config seed and search flags)")

    so = sub.add_parser("score",
                        help="score a saved captions file against references "
                        "— no run/config needed (Eval/one_shot.py + "
                        "evaluate.py)")
    so.add_argument("--captions", required=True,
                    help="captions_{e}.txt (key\\ttext lines) or "
                    "output_captions_{e}.npy token ids")
    so.add_argument("--tokenizer", default=None,
                    help="tokenizer.json — required for .npy ids")
    so.add_argument("--keys", default=None,
                    help="text file of NSD keys, one per .npy row — "
                    "required for .npy")
    so.add_argument("--references", required=True,
                    help="KID{key}.txt captions dir, or a JSON "
                    "{key: [caption, ...]} annotations dict")
    so.add_argument("--bleu-table", action="store_true",
                    help="also emit the 8-weight NLTK BLEU table "
                    "(evaluate.py:178-226)")
    _add_device(so)

    gu = sub.add_parser("guse",
                        help="precompute sentence embeddings for every "
                        "caption (get_guse.py): flat (N, C, 512) brick + "
                        "per-key averaged vectors for guse_nic training")
    gu.add_argument("--config", required=True)
    gu.add_argument("--out", required=True, help="output directory")
    gu.add_argument("--no-per-key", action="store_true",
                    help="skip the guse_averaged/ per-key files")
    _add_device(gu)
    return ap


# ---------------------------------------------------------------- features

def _backbone_for(args, image_hw, generator):
    """(model, head, preprocess) of a features run; VGG16's fc1 is sized
    from the images' (H, W), as flax sizes it from its input."""
    if args.backbone == "vgg16":
        from masters_thesis_tpu_torch.models import backbones

        head = args.head or "fc2"
        return (backbones.VGG16(include_top=head == "fc2",
                                image_size=image_hw, generator=generator),
                head, backbones.preprocess)
    if args.backbone == "inception_v3":
        from masters_thesis_tpu_torch.models import inception

        return (inception.InceptionV3(generator=generator),
                args.head or "patches", inception.preprocess)
    if args.backbone == "resnet50":
        from masters_thesis_tpu_torch.models import resnet

        return (resnet.resnet("resnet50", generator=generator),
                args.head or "pooled", resnet.preprocess)
    from masters_thesis_tpu_torch.models import efficientnet

    model, _ = efficientnet.efficientnet("b3", generator=generator)
    return model, args.head or "pooled", efficientnet.preprocess


def _image_chunks(args, chunk: int):
    """Yield (N<=chunk, H, W, 3) image arrays from a .npy file or the NSD
    stimuli HDF5 (imgBrick), optionally restricted to --keys (1-based NSD
    keys; row key-1 in either source)."""
    import numpy as np

    keys = None
    if getattr(args, "keys", None):
        keys = np.load(args.keys).reshape(-1).astype(np.int64)
    if args.images.endswith((".hdf5", ".h5")):
        from masters_thesis_tpu_torch.data.nsd_images import (
            iter_stimuli_chunks,
        )

        for _, imgs in iter_stimuli_chunks(args.images, keys, chunk=chunk):
            yield imgs
        return
    images = np.load(args.images, mmap_mode="r")
    if keys is None:
        rows = np.arange(len(images))
    else:
        if keys.min() < 1 or keys.max() > len(images):
            raise ValueError(
                f"--keys are 1-based NSD keys in [1, {len(images)}]; "
                f"got [{keys.min()}, {keys.max()}]")
        rows = keys - 1
    for i in range(0, len(rows), chunk):
        yield np.asarray(images[rows[i:i + chunk]])


def _features_row_count(args) -> int:
    import numpy as np

    if getattr(args, "keys", None):
        return len(np.load(args.keys).reshape(-1))
    if args.images.endswith((".hdf5", ".h5")):
        import h5py

        from masters_thesis_tpu_torch.data.nsd_images import DATASET

        with h5py.File(args.images, "r") as f:
            return f[DATASET].shape[0]
    return len(np.load(args.images, mmap_mode="r"))


def _run_features(args) -> dict:
    """Offline image-feature dump (feature_extractor.py:67-84 semantics:
    per-key CNN features written once, consumed by the training data), on
    ``--device``. Chunked input AND memmap-streamed output, so neither the
    73k-image NSD brick nor its feature matrix (~38 GB for inception
    patches) ever materialises in memory. Without ``--weights`` the
    backbone's weights are random, from seed 0."""
    import numpy as np
    import torch

    from masters_thesis_tpu_torch.device import resolve_device
    from masters_thesis_tpu_torch.models import backbones

    device = resolve_device(args.device)
    n_rows = _features_row_count(args)
    model = head = None

    def feature_chunks():
        nonlocal model, head
        for imgs in _image_chunks(args, chunk=max(args.batch_size, 64) * 4):
            if model is None:
                model, head, prep = _backbone_for(
                    args, imgs.shape[1:3], torch.Generator().manual_seed(0))
                if args.weights:
                    # merges params AND BatchNorm moving stats ('stats/')
                    backbones.load_npz_variables(model, args.weights)
                model = model.to(device).eval()
            x = prep(np.asarray(imgs, np.float32))
            yield backbones.extract_features(
                model, x, batch_size=args.batch_size, head=head)

    if args.pack:
        # a key-addressed pack dir instead of one flat npy: the layout
        # dataset.betas_path reads, so img_nic/cnn_rnn configs train on it
        if not args.keys:
            raise SystemExit("--pack needs --keys (the pack's key order)")
        keys = np.load(args.keys).reshape(-1).astype(np.int64)
        from masters_thesis_tpu_torch.data.pack import write_pack

        def keyed_rows():
            row = 0
            for feats in feature_chunks():
                for r in feats:
                    yield int(keys[row]), r
                    row += 1

        meta = write_pack(args.out, None, keyed_rows())
        return {"out": args.out, "pack": meta,
                "backbone": args.backbone, "head": head,
                "pretrained": bool(args.weights)}

    out = None
    row = 0
    for feats in feature_chunks():
        if out is None:
            out = np.lib.format.open_memmap(
                args.out, mode="w+", dtype=feats.dtype,
                shape=(n_rows,) + feats.shape[1:])
        out[row:row + len(feats)] = feats
        row += len(feats)
    if out is None or row != n_rows:
        raise RuntimeError(f"wrote {row} feature rows of {n_rows}")
    out.flush()
    shape = list(out.shape)
    del out
    return {"out": args.out, "shape": shape,
            "backbone": args.backbone, "head": head,
            "pretrained": bool(args.weights)}


def _run_stimuli(args) -> dict:
    """Export NSD stimulus pictures as KID{key}.(png|npy) files — the
    NSDAccess.read_images path (metric_suit.py:75-80)."""
    import numpy as np

    from masters_thesis_tpu_torch.data.nsd_images import export_images

    keys = None
    if args.keys:
        keys = np.load(args.keys).reshape(-1).astype(np.int64)
    n = export_images(args.hdf5, keys, args.out_dir, fmt=args.format)
    return {"out_dir": args.out_dir, "exported": n, "format": args.format}


def _run_score(args) -> dict:
    """Standalone caption scoring (Eval/one_shot.py + evaluate.py): a saved
    captions file vs references, without rebuilding a run. Accepts the
    run artifacts directly — ``captions_{e}.txt`` (key\\ttext) or the
    reference-format ``output_captions_{e}.npy`` token-id matrix (with its
    ``tokenizer.json`` and a key list). GUSE scores come from the USE
    encoder on ``--device`` when ``MTT_GUSE_WEIGHTS`` names a bundle."""
    import os

    import numpy as np

    from masters_thesis_tpu_torch.evalsuite.guse_sim import (
        labelled_guse_scores,
    )
    from masters_thesis_tpu_torch.evalsuite.metric_suite import (
        bleu_table,
        clean_references,
        evaluate_captions,
    )

    # --- candidates ---
    keys: list[int] = []
    texts: list[str] = []
    if args.captions.endswith(".npy"):
        if not (args.tokenizer and args.keys):
            raise SystemExit(
                "scoring an .npy id matrix needs --tokenizer tokenizer.json "
                "and --keys <file> (one NSD key per row)")
        from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
        from masters_thesis_tpu_torch.evalsuite.tokens import ids_to_caption

        ids = np.load(args.captions)
        if ids.ndim == 3 and ids.shape[-1] == 1:
            ids = ids[..., 0]  # the reference saves (N, T, 1) (one_shot.py)
        tok = Tokenizer.load(args.tokenizer)
        with open(args.keys) as f:
            keys = [int(ln.split()[0]) for ln in f if ln.strip()]
        if len(keys) != len(ids):
            raise SystemExit(
                f"--keys has {len(keys)} rows but the id matrix has "
                f"{len(ids)}")
        texts = [ids_to_caption(row, tok) for row in ids]
    else:
        with open(args.captions) as f:
            for ln in f:
                if "\t" in ln:
                    k, t = ln.rstrip("\n").split("\t", 1)
                    keys.append(int(k))
                    texts.append(t)
        if not keys:
            raise SystemExit(
                f"{args.captions} has no key\\ttext lines")

    # --- references ---
    if os.path.isdir(args.references):
        from masters_thesis_tpu_torch.data.captions import load_captions_dir

        refs_by_key = load_captions_dir(args.references, keys=keys)
    else:
        with open(args.references) as f:
            payload = json.load(f)
        refs_by_key = {int(k): list(v) for k, v in payload.items()}

    scored_keys, cands, refs = [], [], []
    for k, t in zip(keys, texts):
        r = refs_by_key.get(int(k))
        if r:
            scored_keys.append(int(k))
            cands.append(t)
            # raw COCO reference text never matches tokenizer output — the
            # same normalisation every in-run scoring path applies
            refs.append(clean_references(r))
    if not cands:
        raise SystemExit("no candidate key has references")

    report = {
        "n_candidates": len(keys),
        "n_scored": len(cands),
        "n_missing_refs": len(keys) - len(cands),
        "scores": evaluate_captions(cands, refs),
    }
    report["scores"].update(labelled_guse_scores(cands, refs,
                                                 device=args.device))
    if args.bleu_table:
        report["bleu_table"] = bleu_table(cands, refs)
    return report


def _run_analyze(args) -> dict:
    """Post-hoc analysis over a finished run dir (the Eval/ scripts'
    artifacts: loss curves, caption word-class stats, attention figures),
    the JAX ``analyze``'s report and files. It draws with matplotlib: where
    that is missing (the card's machine has none) it exits non-zero before
    it writes anything. ``--device`` runs the PCA front end of the t-SNE
    and the USE encoder of ``--nearest-guse``."""
    import glob
    import importlib.util
    import os

    import numpy as np

    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit(
            "masters_thesis_tpu_torch analyze: the figures need matplotlib, "
            "which is not installed here; run analyze where it is")

    from masters_thesis_tpu_torch.evalsuite.analysis import (
        attention_to_vertices,
        caption_pos_stats,
        plot_loss,
        plot_region_attention,
        plot_vertex_attention,
    )

    run = args.run
    out_dir = args.out or os.path.join(run, "analysis")
    os.makedirs(out_dir, exist_ok=True)
    report: dict = {"run": run, "out": out_dir, "artifacts": []}

    # the run's config, loaded once: groups_to_remove (region-index maps)
    # and dataset.captions_path (reference captions) both come from it
    run_cfg = None
    cfg_path = os.path.join(run, "config.yaml")
    if os.path.exists(cfg_path):
        from masters_thesis_tpu_torch.config import Config

        run_cfg = Config.load(cfg_path)

    lh = os.path.join(run, "loss_history.csv")
    if os.path.exists(lh):
        png = os.path.join(out_dir, "loss.png")
        plot_loss(lh, png)
        report["artifacts"].append(png)

    prev = os.path.join(run, "caption_previews.txt")
    if os.path.exists(prev):
        caps = [ln.strip() for ln in open(prev)
                if ln.strip() and not ln.startswith("===")]
        report["pos_stats"] = caption_pos_stats(caps)

    # original group indices per attention column (LH first): identity
    # unless the run removed regions, in which case the kept ids preserve
    # hemisphere positions for the heat grid
    region_ids = n_total = None
    if run_cfg is not None and run_cfg.groups_to_remove:
        removed = set(run_cfg.groups_to_remove)
        n_total = 360
        region_ids = np.asarray(
            [i for i in range(n_total) if i not in removed], np.int64)

    atlas_groups = n_vertices = n_lh = None
    if args.atlas_lh and args.atlas_rh:
        from masters_thesis_tpu_torch.data.preprocess.glasser import (
            groups_from_atlas,
            load_atlas_vector,
            select_groups,
        )

        lh_labels = load_atlas_vector(args.atlas_lh)
        rh_labels = load_atlas_vector(args.atlas_rh)
        n_lh = len(lh_labels)
        n_vertices = n_lh + len(rh_labels)
        atlas_groups = groups_from_atlas(lh_labels, rh_labels)
        if run_cfg is not None and run_cfg.groups_to_remove:
            atlas_groups = select_groups(
                atlas_groups, list(run_cfg.groups_to_remove))
    coords = None
    if args.flat_coords:
        flat = np.load(args.flat_coords)
        coords = {"lh": flat["lh"], "rh": flat["rh"]}

    # human-readable parcel names (Eval/list_regions.py's tables): the
    # canonical HCP-MMP1.0 order, or a user CSV via --region-names
    from masters_thesis_tpu_torch.data.preprocess.hcp_regions import region_names

    full_names = region_names(names_csv=args.region_names)  # 360, LH first
    if region_ids is not None and len(full_names) < (n_total or 0):
        # a short --region-names CSV can't cover the original 0..n_total-1
        # ids of a removed-region run — drop to index labels, don't crash
        report["region_names_warning"] = (
            f"--region-names covers {len(full_names)} regions but the run's "
            f"group space is {n_total}; using index labels")
        full_names = [f"region_{i}" for i in range(n_total)]

    for attn_path in sorted(glob.glob(os.path.join(run, "attention_scores_*.npy"))):
        e = os.path.basename(attn_path).split("_")[-1].split(".")[0]
        attn = np.load(attn_path)
        if attn.shape[-1] <= 1:
            # attention-free families (ShowTell/ThinkAndTell/guse) write a
            # (B, T, 1) placeholder — region figures would be meaningless
            # region_0/0.0 noise, so say so instead of emitting them
            report.setdefault(
                "attention_note",
                "attention-free model: no region-attention artifacts")
            continue
        mean_attn = np.asarray(attn).mean(axis=tuple(range(attn.ndim - 1)))
        png = os.path.join(out_dir, f"region_attention_{e}.png")
        col_names = None  # names aligned with the attention columns
        if region_ids is not None and len(region_ids) == len(mean_attn):
            # plot expands values to the full 360 grid -> full names apply
            plot_region_attention(mean_attn, png, region_ids=region_ids,
                                  n_total=n_total, region_names=full_names)
            col_names = [full_names[i] for i in region_ids]
        elif len(mean_attn) == len(full_names):
            plot_region_attention(mean_attn, png, region_names=full_names)
            col_names = full_names
        else:
            plot_region_attention(mean_attn, png)
        report["artifacts"].append(png)
        if col_names is not None:
            order = np.argsort(mean_attn)[::-1][:20]
            report[f"region_ranking_{e}"] = [
                {"region": col_names[i], "index": int(i),
                 "mean_attention": float(mean_attn[i])}
                for i in order
            ]

        # temporal-attention analyses (eval_output.py): per-step mean maps,
        # word-class deviation maps, optional per-trial word map
        if attn.ndim == 3:
            from masters_thesis_tpu_torch.evalsuite.analysis import (
                attention_by_tag,
                attention_over_time,
                plot_attention_by_tag,
                plot_attention_over_time,
                plot_attention_word_map,
            )

            ot = attention_over_time(attn)
            opng = os.path.join(out_dir, f"attention_over_time_{e}.png")
            plot_attention_over_time(ot["per_step"], opng,
                                     region_names=col_names)
            report["artifacts"].append(opng)
            report[f"top_region_per_step_{e}"] = [
                {"step": t,
                 "region": (col_names[top[0]["index"]] if col_names
                            else f"region_{top[0]['index']}"),
                 **top[0]}
                for t, top in enumerate(ot["top_regions"])
            ]

            cap_file = os.path.join(run, f"captions_{e}.txt")
            etexts = []
            if os.path.exists(cap_file):
                etexts = [ln.rstrip("\n").split("\t", 1)[1]
                          for ln in open(cap_file) if "\t" in ln]
            if etexts:
                bt = attention_by_tag(etexts, attn)
                tpng = os.path.join(out_dir, f"attention_by_tag_{e}.png")
                plot_attention_by_tag(bt, tpng)
                if any(v["n_words"] for v in bt["tags"].values()):
                    report["artifacts"].append(tpng)
                if (args.word_map is not None
                        and args.word_map < min(len(attn), len(etexts))):
                    wpng = os.path.join(
                        out_dir, f"attention_word_map_{e}_{args.word_map}.png")
                    plot_attention_word_map(
                        etexts[args.word_map], attn[args.word_map], wpng)
                    report["artifacts"].append(wpng)
        if atlas_groups is not None and len(mean_attn) == len(atlas_groups):
            vertex_vals = attention_to_vertices(
                mean_attn, atlas_groups, n_vertices)
            vpng = os.path.join(out_dir, f"vertex_attention_{e}.png")
            plot_vertex_attention(vertex_vals, vpng, n_lh, coords=coords)
            report["artifacts"].append(vpng)

    # caption/image sample grids (Eval/sample_captions.py): BLEU-sorted
    # best+worst panels over the eval captions, stimulus pictures from
    # --images (a KID{key} dir, e.g. exported by `stimuli`)
    from masters_thesis_tpu_torch.evalsuite.analysis import (
        caption_grid_entries,
        plot_caption_grid,
    )

    references = None
    if (run_cfg is not None and run_cfg.dataset.captions_path
            and os.path.isdir(run_cfg.dataset.captions_path)):
        from masters_thesis_tpu_torch.data.captions import load_captions_dir

        references = load_captions_dir(run_cfg.dataset.captions_path)

    # raw-betas inspection (visualize_betas.py / tsne.py): trial-average and
    # per-vertex L1-norm maps, plus a t-SNE scatter of the trial vectors
    if args.betas:
        from masters_thesis_tpu_torch.evalsuite.analysis import (
            attention_tsne,
            plot_tsne,
            plot_vertex_attention,
        )

        from masters_thesis_tpu_torch.evalsuite.analysis import (
            streamed_betas_stats,
        )

        # keep the memmap: every consumer below streams or row-indexes, so
        # a reference-scale (10k, 327k) store never materialises in RAM
        betas = np.load(args.betas, mmap_mode="r")
        if betas.ndim == 1:
            betas = np.asarray(betas, np.float32)[None]
        n_lh_b = betas.shape[1] // 2
        stats = streamed_betas_stats(betas)
        for tag in ("mean", "l1norm"):
            bpng = os.path.join(out_dir, f"betas_{tag}.png")
            plot_vertex_attention(stats[tag], bpng, n_lh_b, coords=coords)
            report["artifacts"].append(bpng)
        if len(betas) > 2:
            x = betas
            if x.shape[1] > 50:  # PCA front end keeps t-SNE tractable at
                #                  full-cortex width (tsne.py pairs the two)
                from masters_thesis_tpu_torch.data.preprocess.pca import fit_pca

                x = fit_pca(x, n_components=50,
                            device=args.device).transform(x)
            tcoords = attention_tsne(x)
            tpng = os.path.join(out_dir, "betas_tsne.png")
            plot_tsne(tcoords, tpng, title="betas t-SNE")
            report["artifacts"].append(tpng)

        # top-N most-active-vertex ranking (+ split-stability overlap)
        if args.top_verts:
            from masters_thesis_tpu_torch.evalsuite.analysis import (
                most_active_vertices,
            )

            betas_b = (np.load(args.betas_b, mmap_mode="r")
                       if args.betas_b else None)
            mav = most_active_vertices(betas, betas_b, top_n=args.top_verts)
            txt = os.path.join(out_dir, "most_active_vert.txt")
            with open(txt, "w") as f:  # reference file shape: one index/line
                for i in mav["indices"]:
                    f.write(f"{i}\n")
            report["artifacts"].append(txt)
            report["most_active_vertices"] = {
                k: mav[k] for k in ("top_n", "overlap", "overlap_fraction")
                if k in mav}

        # semantic-vs-neural similarity (betas_sim.py): needs row-aligned
        # caption embeddings for the same trials
        if args.guse:
            from masters_thesis_tpu_torch.evalsuite.analysis import (
                betas_semantic_similarity,
                plot_betas_similarity,
            )

            guse = np.load(args.guse)
            targets = None
            if args.sim_targets:
                targets = [int(s) for s in args.sim_targets.split(",") if s]
            sim = betas_semantic_similarity(betas, guse, targets=targets)
            spng = os.path.join(out_dir, "betas_guse_similarity.png")
            plot_betas_similarity(sim, spng)
            report["artifacts"].append(spng)
            report["betas_guse_similarity"] = {
                "mse_similar_mean": sim["mse_similar_mean"],
                "mse_random_mean": sim["mse_random_mean"],
                "mse_ratio": sim["mse_ratio"],
                "spearman_sem_vs_negmse": sim["spearman_sem_vs_negmse"],
                "targets": [{k: p[k] for k in
                             ("target", "most_similar", "max_cosine",
                              "mse_similar_mean", "mse_random_mean")}
                            for p in sim["targets"]],
            }

    if (args.top_verts or args.guse) and not args.betas:
        report["betas_analysis_error"] = (
            "--top-verts/--guse need --betas (the (N, V) trial array)")

    if args.responses and not references:
        report["bleu_hit_rate_error"] = (
            "--responses needs reference captions: the run config's "
            "dataset.captions_path is unset or not a directory")

    # loop-invariant inputs for the per-epoch caption analyses, loaded once:
    # the ~30k-row behavior TSV, and the GUSE table + embedder (the table is
    # (N, C, 512) — hundreds of MB at reference scale)
    behavior_hits = None
    if args.responses and references:
        from masters_thesis_tpu_torch.evalsuite.analysis import load_behavior_hits

        behavior_hits = load_behavior_hits(args.responses)
    nearest_ctx = None
    if args.nearest_guse:
        nearest_ctx = _load_nearest_guse(
            args.nearest_guse, references, run_cfg, report, args.device)

    def _image_loader(key: int):
        if not args.images:
            return None
        from masters_thesis_tpu_torch.train.callbacks import load_stimulus_images

        got = load_stimulus_images(args.images, [key], max_images=1)
        return None if got is None else got[0]

    for cap_path in sorted(glob.glob(os.path.join(run, "captions_*.txt"))):
        e = os.path.basename(cap_path).split("_")[-1].split(".")[0]
        if not e.isdigit():
            continue
        keys, texts = [], []
        for ln in open(cap_path):
            if "\t" in ln:
                k, t = ln.rstrip("\n").split("\t", 1)
                keys.append(int(k))
                texts.append(t)
        if not keys:
            continue
        entries = caption_grid_entries(
            keys, texts, image_loader=_image_loader, references=references)
        gpng = os.path.join(out_dir, f"caption_grid_{e}.png")
        plot_caption_grid(entries, gpng)
        report["artifacts"].append(gpng)

        # behavioral hit rate vs BLEU (Eval/hit_rate.py main()): group each
        # eval caption's BLEU-1/BLEU-4 by how often the subject recognised
        # the image (ISCORRECT summed per 73KID, 0..3) -> boxplot panels
        if behavior_hits is not None:
            from masters_thesis_tpu_torch.evalsuite.analysis import (
                bleu_by_hit_rate,
                plot_bleu_hit_rate,
            )

            groups = bleu_by_hit_rate(
                dict(zip(keys, texts)), references, behavior_hits)
            hpng = os.path.join(out_dir, f"bleu_hit_rate_{e}.png")
            plot_bleu_hit_rate(groups, hpng)
            report["artifacts"].append(hpng)
            report[f"bleu_hit_rate_{e}"] = {
                "n_scored": groups["n_scored"],
                **{label: {str(h): (float(np.mean(v)) if v else None)
                           for h, v in by_hit.items()}
                   for label, by_hit in groups.items()
                   if label.startswith("BLEU-")},
            }

        # cross-run caption agreement: n-gram hit rate + Jaccard between this
        # run's captions and another run's for the shared keys (the
        # cross-subject comparison Eval/hit_rate.py circles around)
        if args.compare_run:
            other = os.path.join(args.compare_run, f"captions_{e}.txt")
            if os.path.exists(other):
                from masters_thesis_tpu_torch.evalsuite.analysis import hit_rate

                caps_b = {}
                for ln in open(other):
                    if "\t" in ln:
                        k, t = ln.rstrip("\n").split("\t", 1)
                        caps_b[int(k)] = t
                report[f"cross_run_hit_rate_{e}"] = hit_rate(
                    dict(zip(keys, texts)), caps_b)

        # nearest-training-caption retrieval (guse_comparison.py): rank every
        # (trial, cid) training caption by cosine distance to each eval
        # caption's sentence embedding, dump top-3 + farthest per candidate
        if nearest_ctx is not None:
            tsv = _write_nearest_guse_tsv(
                nearest_ctx, texts, keys,
                os.path.join(out_dir, f"nearest_guse_{e}.tsv"))
            report["artifacts"].append(tsv)
    return report


def _load_nearest_guse(guse_dir, references, run_cfg, report, device):
    """Load the `guse` table/keys + resolve the embedder ONCE for the
    per-epoch nearest-caption reports (guse_comparison.py). Returns None
    (with a report error) when the dir lacks the precompute artifacts."""
    import json as _json
    import os

    import numpy as np

    from masters_thesis_tpu_torch.evalsuite.guse_sim import default_embedder

    table_path = os.path.join(guse_dir, "guse_pre_processed.npy")
    keys_path = os.path.join(guse_dir, "keys.npy")
    if not (os.path.exists(table_path) and os.path.exists(keys_path)):
        report["nearest_guse_error"] = (
            f"{guse_dir!r} lacks guse_pre_processed.npy/keys.npy "
            "(run `guse` first)")
        return None
    table = np.load(table_path)
    train_keys = np.load(keys_path)
    train_caps = None
    if references:
        train_caps = [references.get(int(k)) for k in train_keys]
        # every table key must be covered AND carry exactly the table's C
        # captions — a mismatched dir would mis-attribute (or IndexError on)
        # the caption text behind each (trial, cid)
        if any(c is None or len(c) != table.shape[1] for c in train_caps):
            train_caps = None
    # resolve the candidate embedder exactly like run_metrics /
    # run_guse_precompute: the run config's guse_path bundle, then the
    # MTT_GUSE_WEIGHTS env, then the hash fallback — so candidates and the
    # table come from the same encoder in the config-driven flow
    bundle = None
    if run_cfg is not None and run_cfg.dataset.guse_path:
        cand = os.path.join(run_cfg.dataset.guse_path, "use_dan.npz")
        if os.path.exists(cand):
            bundle = cand
    embedder = default_embedder(bundle, device)
    # distances are only meaningful when candidates are embedded by the same
    # model that built the table — surface a mismatch instead of hiding it
    meta_path = os.path.join(guse_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            built_with = _json.load(f).get("embedder")
        using = getattr(embedder, "name", type(embedder).__name__)
        if built_with and built_with != using:
            report["nearest_guse_warning"] = (
                f"table built with {built_with!r} but candidates embedded "
                f"with {using!r}")
    return {"table": table, "train_keys": train_keys,
            "train_caps": train_caps, "embedder": embedder}


def _write_nearest_guse_tsv(ctx, texts, keys, out_tsv) -> str:
    """Rank training captions by embedding distance for each eval caption
    (guse_comparison.py:44-64 prints top-3 nearest + the farthest)."""
    from masters_thesis_tpu_torch.evalsuite.guse_sim import nearest_training_captions

    train_keys = ctx["train_keys"]
    results = nearest_training_captions(
        texts, ctx["table"], train_captions=ctx["train_caps"],
        embedder=ctx["embedder"])
    with open(out_tsv, "w") as f:
        f.write("key\tcandidate\trank\tdistance\ttrain_key\tcid\tcaption\n")
        for key, text, res in zip(keys, texts, results):
            rows = [(i + 1, n) for i, n in enumerate(res["nearest"])]
            if res["farthest"] is not None:
                rows.append((-1, res["farthest"]))  # rank -1 = farthest
            for rank, n in rows:
                cap = n.get("caption", "")
                f.write(f"{key}\t{text}\t{rank}\t{n['distance']:.4f}\t"
                        f"{int(train_keys[n['trial']])}\t{n['cid']}\t{cap}\n")
    return out_tsv


def _tune_trial(cfg, epochs, smoke_keys, tc, report, device=None):
    """Module-level trial body so --processes > 1 can pickle it
    (ProcessPoolExecutor ships the partial to spawned worker processes).

    Trains the trial's config with the port's ``run_training`` on
    ``device`` (default ``cuda``). Reports val_loss to the scheduler EVERY
    epoch via a Trainer callback and stops training when the scheduler says
    'stop' — the TuneReportCallback flow (AttemptFour/tune.py:146-153) that
    lets ASHA actually prune."""
    import dataclasses
    import hashlib

    from masters_thesis_tpu_torch.experiment import run_training
    from masters_thesis_tpu_torch.train.callbacks import Callback

    # unique, deterministic run dir per trial config — parallel workers
    # (and sequential trials' artifacts) must not collide
    tag = hashlib.sha1(repr(sorted(tc.items())).encode()).hexdigest()[:8]
    tcfg = dataclasses.replace(
        cfg,
        run=f"{cfg.run}_trial_{tag}",
        input_reg=tc["input_reg"],
        attn_reg=tc["attn_reg"],
        lstm_reg=tc["lstm_reg"],
        output_reg=tc["output_reg"],
    )

    class TuneReport(Callback):
        def on_epoch_end(self, trainer, epoch, logs):
            val = logs.get("val_loss", logs.get("loss", 0.0))
            decision = report(epoch + 1, {"val_loss": float(val)})
            if decision == "stop":
                trainer.stop_training = True

    _, logs, _ = run_training(
        tcfg, epochs, smoke_keys, extra_callbacks=[TuneReport()],
        device=device)
    return logs.get("val_loss", logs.get("loss", 0.0))


def _run_tune(args, cfg) -> dict:
    """Random or grid search over the L2 regularisers with ASHA, as the JAX
    CLI's ``tune``: trials in this process, in ``--processes`` spawned
    processes, or through a ``--queue`` directory (coordinator, or a
    ``--worker`` that joins one). Returns the last-line JSON."""
    import functools

    from masters_thesis_tpu_torch.tune.asha import ASHAScheduler
    from masters_thesis_tpu_torch.tune.runner import run_experiment
    from masters_thesis_tpu_torch.tune.search import (
        GridSearch,
        LogUniform,
        RandomSearch,
    )

    num = 2 if args.smoke_test else args.num_samples
    epochs = args.epochs or (2 if args.smoke_test else cfg.epochs)
    trial = functools.partial(_tune_trial, cfg, epochs, args.smoke_keys,
                              device=args.device)
    if args.grid:
        # kerastuner-style grid (ThinkAndTell gridsearch_train.py:318)
        search = GridSearch({
            "input_reg": [1e-4, 1e-2],
            "attn_reg": [1e-4, 1e-2],
            "lstm_reg": [1e-6, 1e-4],
            "output_reg": [1e-6],
        })
    else:
        # the reference's loguniform L2 search space (tune.py:194-197)
        space = {
            "input_reg": LogUniform(1e-5, 1e-1),
            "attn_reg": LogUniform(1e-5, 1e-1),
            "lstm_reg": LogUniform(1e-7, 1e-3),
            "output_reg": LogUniform(1e-7, 1e-3),
        }
        search = RandomSearch(space, num, seed=cfg.seed)
    sched = ASHAScheduler(max_t=epochs, grace_period=max(1, epochs // 4))
    if args.queue and args.worker:
        # join an existing multi-host queue (ray.init(address=...) flow,
        # tune.py:215-228): work trials until the coordinator writes STOP
        from masters_thesis_tpu_torch.tune.dispatch import run_worker

        n_done = run_worker(args.queue, trial, sched,
                            stale_claim_s=args.stale_claim)
        return {"worker_trials": n_done, "queue": args.queue}
    if args.queue:
        from masters_thesis_tpu_torch.tune.dispatch import (
            run_distributed_experiment,
        )

        res = run_distributed_experiment(
            trial, search, sched, queue_dir=args.queue,
            stale_claim_s=args.stale_claim, resume=args.resume_queue)
    else:
        res = run_experiment(trial, search, sched, log_dir=cfg.log,
                             processes=args.processes)
    return {"best": res.best()["config"],
            "best_metric": res.best()["final_metric"],
            "n_trials": len(res.trials)}


def make_server(args):
    """The ``serve`` command's HTTP server, built and not started: a
    ``Captioner`` of ``--run`` on ``--device``, or the program of an
    ``--export`` artifact there (behind ``--pre``'s chain either way), and
    the port's caption server. Sets ``args.decoder`` to the decoder it
    serves by default."""
    from masters_thesis_tpu_torch.serve import (
        Captioner,
        PreTransformCaptioner,
    )
    from masters_thesis_tpu_torch.server import make_caption_server

    if bool(args.run) == bool(args.export_path):
        raise SystemExit("serve needs exactly one of --run / --export")
    if args.export_path:
        from masters_thesis_tpu_torch.export import load_exported

        if args.subject != "a":
            raise SystemExit(
                "--subject does not apply to --export serving: the "
                "artifact's subject was frozen at export time (export "
                "--subject)")
        cap = load_exported(args.export_path, device=args.device)
        # the artifact freezes ONE decoder, served by default; a
        # contradictory --decoder is the user's error, not overridden
        frozen = cap.meta["decoder"]
        if args.decoder is not None and args.decoder != frozen:
            raise SystemExit(
                f"this artifact freezes the {frozen!r} decoder; "
                f"--decoder {args.decoder} cannot be served from it")
        args.decoder = frozen
    else:
        args.decoder = args.decoder or "greedy"
        cap = Captioner.from_run_dir(args.run, device=args.device,
                                     subject=args.subject, shard=args.shard)
    if args.pre:
        cap = PreTransformCaptioner(cap, args.pre)
    return make_caption_server(
        cap, host=args.host, port=args.port,
        default_decoder=args.decoder, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cmd == "dryrun":
        from masters_thesis_tpu_torch.parallel.dryrun import dryrun_multichip

        dryrun_multichip(args.devices, flagship_only=args.flagship,
                         device=args.device)
        return 0

    if args.cmd == "features":
        print(json.dumps(_run_features(args)))
        return 0
    if args.cmd == "stimuli":
        print(json.dumps(_run_stimuli(args)))
        return 0
    if args.cmd == "score":
        print(json.dumps(_run_score(args)))
        return 0
    if args.cmd == "transform":
        import numpy as np

        from masters_thesis_tpu_torch.experiment import (
            apply_preprocess_chain,
        )

        out_rows = apply_preprocess_chain(args.pre, np.load(args.betas))
        np.save(args.out, out_rows)
        print(json.dumps({"out": args.out, "shape": list(out_rows.shape)}))
        return 0
    if args.cmd == "analyze":
        print(json.dumps(_run_analyze(args)))
        return 0
    if args.cmd == "export":
        import torch

        from masters_thesis_tpu_torch.export import export_run

        platforms = ([p.strip() for p in args.platforms.split(",")
                      if p.strip()] or [torch.device(args.device).type])
        meta = export_run(args.run, args.out, decoder=args.decoder,
                          batch_size=args.batch_size,
                          beam_width=args.beam_width, platforms=platforms,
                          subject=args.subject, pre=args.pre)
        print(json.dumps({"out": args.out, **meta}))
        return 0
    if args.cmd == "serve":
        from masters_thesis_tpu_torch.server import serve_forever

        server = make_server(args)
        host, port = server.server_address[:2]
        print(json.dumps({"serving": f"http://{host}:{port}",
                          "decoder": args.decoder,
                          "max_batch": args.max_batch}), flush=True)
        serve_forever(server)
        return 0
    if args.cmd == "caption":
        import numpy as np

        from masters_thesis_tpu_torch.serve import Captioner

        cap = Captioner.from_run_dir(
            args.run, device=args.device, subject=args.subject,
            temperature=args.temperature, sample_top_k=args.sample_top_k,
            seed=args.seed, shard=args.shard)
        rows = np.load(args.betas)
        if args.pre:
            from masters_thesis_tpu_torch.experiment import (
                apply_preprocess_chain,
            )

            rows = apply_preprocess_chain(args.pre, rows)
        texts = cap.caption(rows, decoder=args.decoder)
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
        run_guse_precompute,
        run_metrics,
        run_preprocess,
        run_training,
    )

    cfg = Config.load(args.config)
    if args.cmd == "guse":
        report = run_guse_precompute(cfg, args.out,
                                     per_key=not args.no_per_key,
                                     device=args.device)
        print(json.dumps(report))
        return 0
    if args.cmd == "tune":
        print(json.dumps(_run_tune(args, cfg)))
        return 0
    if args.cmd == "preprocess":
        report = run_preprocess(
            cfg, args.out, pca_components=args.pca,
            from_sessions=args.from_sessions, behavior=args.behavior,
            captions_json=args.captions_json, n_sessions=args.n_sessions,
            vc_parcels=args.vc_parcels, normalize=args.normalize,
            device=args.device)
        print(json.dumps(report))
        return 0
    if args.cmd == "train" and args.processes > 1:
        from masters_thesis_tpu_torch.parallel.multiprocess import (
            launch_cli_train,
        )

        print(json.dumps(launch_cli_train(
            args.config, n_processes=args.processes,
            devices_per_process=args.devices_per_process,
            epochs=args.epochs, smoke_keys=args.smoke_keys,
            resume=args.resume, device=args.device)))
        return 0
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
