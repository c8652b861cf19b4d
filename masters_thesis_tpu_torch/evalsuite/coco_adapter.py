"""COCO-format adapters for the metric suite.

The reference scores captions against MS-COCO annotations by mapping NSD keys
to COCO image ids via NSDAccess stimuli info and feeding pycocoevalcap
(AttemptFour/metric_suit.py:75-109). NSDAccess needs the NSD stimuli HDF5;
here the mapping comes from a CSV (columns ``nsd_key,coco_id`` — one-time
export from nsd_stim_info_merged.csv), and results/annotations use the
standard COCO JSON schemas so they interoperate with the official toolchain.

The port's copy of ``masters_thesis_tpu/evalsuite/coco_adapter.py``,
framework-free, held against the original by
``tests/test_torch_coco_adapter.py``.
"""

from __future__ import annotations

import csv
import json


def load_nsd_coco_map(csv_path: str) -> dict[int, int]:
    """{nsd_key: coco_image_id} from a two-column CSV."""
    out: dict[int, int] = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            out[int(row["nsd_key"])] = int(row["coco_id"])
    return out


def load_stim_info(path: str) -> dict[int, dict]:
    """Read the NSD stimuli-description file directly.

    NSDAccess backs ``read_image_coco_info`` with
    ``nsd_stim_info_merged.csv/.pkl`` (nsd_access.py: ``stim_descriptions``),
    whose rows are 0-based ``nsdId`` with ``cocoId``/``cocoSplit`` columns.
    NSD keys used throughout the reference are 1-based (metric_suit.py:76
    passes ``nsd_key - 1``), so the returned dict is keyed by
    ``nsdId + 1``: {nsd_key: {"coco_id": int, "coco_split": str}}.

    ``.csv`` loads with the stdlib; ``.pkl`` needs pandas (guarded).
    """
    if path.endswith(".pkl"):
        try:
            import pandas as pd  # optional
        except ImportError as e:  # pragma: no cover - env without pandas
            raise ImportError(
                "pandas is required for the .pkl stimuli file; use the .csv"
            ) from e
        df = pd.read_pickle(path)
        rows = df.to_dict("records")
    else:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    out: dict[int, dict] = {}
    for row in rows:
        nsd_id = int(float(row["nsdId"]))
        out[nsd_id + 1] = {
            "coco_id": int(float(row["cocoId"])),
            "coco_split": str(row.get("cocoSplit", "")),
        }
    return out


def nsd_coco_map_from_stim_info(stim_info: dict[int, dict]) -> dict[int, int]:
    """Collapse ``load_stim_info`` output to the {nsd_key: coco_id} map the
    scoring helpers take (the pre-built CSV becomes optional)."""
    return {k: v["coco_id"] for k, v in stim_info.items()}


def export_nsd_coco_csv(stim_path: str, csv_path: str) -> int:
    """One-time export: stimuli file -> the two-column nsd_key,coco_id CSV."""
    mapping = nsd_coco_map_from_stim_info(load_stim_info(stim_path))
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["nsd_key", "coco_id"])
        for k in sorted(mapping):
            w.writerow([k, mapping[k]])
    return len(mapping)


def write_coco_results(path: str, keys, captions, nsd_to_coco=None) -> list[dict]:
    """COCO results format: [{"image_id": id, "caption": text}, ...]
    (what metric_suit.py feeds COCOEvalCap)."""
    results = []
    for key, cap in zip(keys, captions):
        image_id = int(key) if nsd_to_coco is None else nsd_to_coco[int(key)]
        results.append({"image_id": image_id, "caption": cap})
    with open(path, "w") as f:
        json.dump(results, f)
    return results


def load_coco_annotations(captions_json: str) -> dict[int, list[str]]:
    """captions_train2017.json-style file -> {image_id: [caption, ...]}."""
    with open(captions_json) as f:
        raw = json.load(f)
    out: dict[int, list[str]] = {}
    for ann in raw["annotations"]:
        out.setdefault(int(ann["image_id"]), []).append(ann["caption"])
    return out


def score_against_coco(
    keys, captions, nsd_to_coco: dict[int, int], coco_annotations: dict[int, list[str]]
) -> dict:
    """Run the in-repo metric suite against COCO ground-truth captions."""
    from masters_thesis_tpu_torch.evalsuite.metric_suite import evaluate_captions

    refs = [coco_annotations[nsd_to_coco[int(k)]] for k in keys]
    refs = [[r.lower().replace(".", " ").strip() for r in rr] for rr in refs]
    return evaluate_captions([c.lower() for c in captions], refs)
