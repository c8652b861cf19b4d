"""Session-level betas ingestion — the FIRST stage of the offline pipeline.

Reference (AttemptFour/ian_code/nsd_get_data.py:174-281, ``my_get_betas``):
for each NSD session, load ``lh/rh.betas_session{NN}.mgh`` (fsaverage
vertices x trials per hemisphere), vstack LH over RH, z-score each vertex
across the session's trials (:243-246), then write ONE ``.npy`` per trial
named ``betas_SUB{s}_S{ses}_R{run}_T{trial}_KID{kid}.npy`` plus a caption
text file ``SUB{s}_KID{kid}.txt`` holding up to five COCO captions in
``{beta_path}#{i}\\t{caption}`` lines (:250-275).

This module reproduces that contract from offline inputs:

- session beta files: ``lh.betas_session{NN}.npy`` / ``.mgh`` / ``.mgz``
  (``.mgh``/``.mgz`` via the pure-numpy FreeSurfer reader in ``mgh.py``;
  no nibabel needed). Each file
  is (V, T) vertices x trials, exactly the reference's ``get_data().squeeze``
  layout.
- behavior: one CSV/TSV per session (``behav_session{NN}.csv``) or a single
  ``behavior.csv`` for all sessions, with columns SUBJECT, SESSION, RUN,
  TRIAL, 73KID — the columns ``my_get_betas`` reads from
  ``nsda.read_behavior`` (:211-216). Column order is free; header required.
- captions: optional JSON mapping ``str(73KID) -> [caption, ...]`` — the
  offline stand-in for ``nsda.read_image_coco_info`` (:263), which needs the
  COCO annotation archive.

Missing sessions are skipped, matching the reference's ``if valid_trials``
guard (:218-221) for subjects with fewer than 40 sessions.

Output feeds ``experiment.run_preprocess`` (which globs ``*_KID*.npy``)
unchanged, completing the betas path end-to-end: sessions -> per-trial npy ->
pack -> per-voxel stats / PCA / tokenizer.

The port's own copy of ``masters_thesis_tpu/data/preprocess/sessions.py``,
with the same names and meaning (``tests/test_torch_ingest.py`` holds the
two together, their files byte for byte); it only writes each trial from a
contiguous row.
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np

from masters_thesis_tpu_torch.data.preprocess.zscore import session_zscore

BEHAV_COLS = ("SUBJECT", "SESSION", "RUN", "TRIAL", "73KID")


def load_hemi(path: str) -> np.ndarray:
    """Load one hemisphere's session betas as (V, T).

    ``.npy`` loads directly; ``.mgh``/``.mgz`` go through the pure-numpy
    reader in ``mgh.py`` (same (V, 1, 1, T) array nibabel's
    nb.load().get_fdata() returns in nsd_get_data.py:228-241 — no nibabel
    dependency needed)."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 1:           # single-trial session stored as (V,)
            arr = arr[:, None]
    else:
        from masters_thesis_tpu_torch.data.preprocess.mgh import read_mgh

        # (V, 1, 1, T) -> (V, T); indexing (not squeeze) so a single-trial
        # session keeps its T=1 axis
        arr = read_mgh(path)
        # data validation, not an internal invariant: must survive python -O
        # (a stripped assert would let a malformed file slice wrong)
        if arr.shape[1:3] != (1, 1):
            raise ValueError(
                f"{path}: expected surface betas (V, 1, 1, T), got "
                f"{arr.shape}")
        arr = arr[:, 0, 0, :]
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected (V, T), got {arr.shape}")
    return arr


def find_session_files(data_dir: str, session_index: int) -> tuple[str, str] | None:
    """Locate lh/rh.betas_session{NN}.* for one session; None if absent."""
    si = str(session_index).zfill(2)
    for ext in (".npy", ".mgh", ".mgz"):
        lh = os.path.join(data_dir, f"lh.betas_session{si}{ext}")
        rh = os.path.join(data_dir, f"rh.betas_session{si}{ext}")
        if os.path.exists(lh) and os.path.exists(rh):
            return lh, rh
    return None


def read_behavior(path: str, session_index: int | None = None) -> list[dict]:
    """Rows of {SUBJECT, SESSION, RUN, TRIAL, 73KID} as ints, in file order.

    Accepts comma- or tab-separated files. When ``session_index`` is given,
    rows are filtered to that session (the single-file layout).
    """
    with open(path, newline="") as f:
        sample = f.read(4096)
        if not sample.strip():
            return []  # empty/truncated behavior file: session cleanly skipped
        f.seek(0)
        delim = "\t" if "\t" in sample.splitlines()[0] else ","
        rows = []
        for rec in csv.DictReader(f, delimiter=delim):
            missing = [c for c in BEHAV_COLS if c not in rec]
            if missing:
                raise ValueError(
                    f"{path}: behavior file missing columns {missing}")
            row = {c: int(float(rec[c])) for c in BEHAV_COLS}
            if session_index is None or row["SESSION"] == session_index:
                rows.append(row)
    return rows


def session_behavior(behavior_path: str, session_index: int) -> list[dict]:
    """Resolve behavior rows for one session from either layout."""
    if os.path.isdir(behavior_path):
        si = str(session_index).zfill(2)
        for name in (f"behav_session{si}.csv", f"behav_session{si}.tsv"):
            p = os.path.join(behavior_path, name)
            if os.path.exists(p):
                return read_behavior(p)
        return []
    return read_behavior(behavior_path, session_index)


def ingest_sessions(
    data_dir: str,
    behavior_path: str,
    out_dir: str,
    n_sessions: int = 40,
    zscore_data: bool = True,
    captions_json: str | None = None,
) -> dict:
    """The ``my_get_betas`` recipe: per-session z-score + per-trial write.

    Returns a report: sessions ingested/skipped, trials written, caption
    files written, and the per-subject output directories (``subj_{s}/betas``
    and ``subj_{s}/captions``, the reference's layout, :251-252 and :270-272).
    """
    captions: dict[str, list[str]] = {}
    if captions_json:
        with open(captions_json) as f:
            captions = json.load(f)

    report: dict = {"sessions": 0, "skipped": [], "trials": 0,
                    "caption_files": 0, "subjects": {}}
    for ses_i in range(1, n_sessions + 1):
        files = find_session_files(data_dir, ses_i)
        rows = session_behavior(behavior_path, ses_i)
        if files is None or not rows:
            # reference skips sessions a subject never saw (:218-221)
            report["skipped"].append(ses_i)
            continue
        lh, rh = files
        all_verts = np.vstack([load_hemi(lh), load_hemi(rh)])  # (V, T)
        if all_verts.shape[1] != len(rows):
            # ValueError, not assert: under python -O an assert vanishes
            # and zip() below would silently truncate — betas after the
            # first missing behavior row would be written under the WRONG
            # (RUN, TRIAL, KID) filenames
            raise ValueError(
                f"session {ses_i}: {all_verts.shape[1]} trials in betas vs "
                f"{len(rows)} behavior rows"
            )
        # beta column t pairs with the session's t-th PRESENTATION — a
        # behavior file exported in any other order (e.g. sorted by 73KID)
        # would silently mislabel every trial. (RUN, TRIAL) is the
        # presentation order within a session.
        rows = sorted(rows, key=lambda r: (int(r["RUN"]), int(r["TRIAL"])))
        if zscore_data:
            # reference z-scores the (V, T) array across trials (axis=1);
            # session_zscore takes (T, V) with axis=0 — same math transposed
            trials = session_zscore(all_verts.T, axis=0)
        else:
            trials = all_verts.T.astype(np.float32)
        # one transposing copy, so that each trial below is written from a
        # contiguous row (a strided row is gathered element by element, ten
        # times slower at 327,684 vertices); the files are the same bytes
        trials = np.ascontiguousarray(trials)

        for beta, row in zip(trials, rows):
            sub = row["SUBJECT"]
            subj_dir = os.path.join(out_dir, f"subj_{sub}")
            betas_dir = os.path.join(subj_dir, "betas")
            os.makedirs(betas_dir, exist_ok=True)
            name = (f"betas_SUB{sub}_S{row['SESSION']}_R{row['RUN']}"
                    f"_T{row['TRIAL']}_KID{row['73KID']}.npy")
            beta_path = os.path.join(betas_dir, name)
            np.save(beta_path, beta)
            report["trials"] += 1
            report["subjects"].setdefault(str(sub), {
                "betas": betas_dir,
                "captions": os.path.join(subj_dir, "captions"),
            })

            caps = captions.get(str(row["73KID"]), [])
            if caps:
                cap_dir = os.path.join(subj_dir, "captions")
                os.makedirs(cap_dir, exist_ok=True)
                # strip every line-structure character from the caption:
                # newlines would split the file's rows, tabs would corrupt
                # the '{path}#{i}\t{caption}' format that load_captions_dir
                # parses with rsplit('\t', 1)
                def _clean(c: str) -> str:
                    return (c.replace("\n", " ").replace("\r", " ")
                            .replace("\t", " "))

                lines = "".join(
                    f"{beta_path}#{i}\t{_clean(c)}\n"
                    for i, c in enumerate(caps[:5])
                )
                # mode "w" on every presentation — the reference's exact
                # semantics (nsd_get_data.py:271-278): a repeated KID's file
                # ends up referencing the LAST repeat's beta path
                cap_file = os.path.join(
                    cap_dir, f"SUB{sub}_KID{row['73KID']}.txt")
                new_file = not os.path.exists(cap_file)
                with open(cap_file, "w") as f:
                    f.write(lines)
                if new_file:
                    report["caption_files"] += 1
        report["sessions"] += 1
    return report


def averaged_rows(betas_dir: str):
    """Yield (kid, averaged_beta) over per-trial files, repeats averaged.

    The reference averages repeated presentations of the same NSD image after
    loading (``average_over_conditions``, nsd_get_data.py:527 via
    load_avg_betas.py); here the average happens at pack time so the packed
    store holds one row per unique KID, in first-appearance order (of the
    sorted per-trial file list).

    Streaming: trials are grouped by KID from the file NAMES first, then each
    group is loaded and averaged one KID at a time — O(one row) of memory,
    not O(dataset) (30k trials x 1.3 MB would need ~26 GB of accumulators).
    """
    import re

    paths = sorted(glob.glob(os.path.join(betas_dir, "*_KID*.npy")))
    assert paths, f"no *_KID*.npy under {betas_dir}"
    order: list[int] = []
    by_kid: dict[int, list[str]] = {}
    for p in paths:
        # basename only: an ancestor directory named KID<digits> must not
        # shadow every file's own key
        kid = int(re.search(r"KID(\d+)", os.path.basename(p)).group(1))
        if kid not in by_kid:
            order.append(kid)
            by_kid[kid] = []
        by_kid[kid].append(p)
    for kid in order:
        group = by_kid[kid]
        acc = np.load(group[0]).astype(np.float64)
        for p in group[1:]:
            acc += np.load(p)
        yield kid, (acc / len(group)).astype(np.float32)
