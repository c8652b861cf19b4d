"""Post-hoc analysis suite — the reference's ``AttemptFour/Eval/`` thesis
analyses, headless and data-driven (SURVEY.md §2.1):

- caption_table: BLEU-sorted caption/reference table (+ per-caption
  perplexity), cf. Eval/sample_captions.py (BLEU sort :1-100, perplexity
  :283-386);
- perplexity: 2^(-mean log2 p(token)) over emitted tokens from decoder
  logits;
- load_behavior_hits / bleu_by_hit_rate / plot_bleu_hit_rate: the reference's
  Eval/hit_rate.py main() — NSD behavioral hit rate (ISCORRECT summed per
  73KID over the 3 presentations, responses.tsv) vs the decoded caption's
  BLEU, as per-hit-rate boxplots;
- hit_rate: cross-subject caption "hits" — how often two subjects' decoded
  captions for the same NSD key share n-grams (companion analysis to
  Eval/hit_rate.py's compare_subjects(), which contrasts subjects'
  behavioral totals);
- attention_by_region: mean attention weight per Glasser region across the
  eval set + top-k region ranking (Eval/compare_attention.py /
  list_regions.py — flatmap rendering needs pycortex, so this exports the
  per-region values those plots consume);
- loss_curves: parse loss_history.csv into arrays and optionally render a
  PNG (Eval/plot_loss.py).

The port's copy of ``masters_thesis_tpu/evalsuite/analysis.py``, whole in
meaning and framework-free, over the port's ``bleu``, ``guse_sim`` and
``spice``; held against the original by ``tests/test_torch_analysis.py``.
matplotlib and sklearn are imported inside the functions that draw or embed.
"""

from __future__ import annotations

import csv

import numpy as np

from masters_thesis_tpu_torch.evalsuite.bleu import sentence_bleu
from masters_thesis_tpu_torch.evalsuite.guse_sim import guse_clean


def perplexity(logits: np.ndarray, token_ids: np.ndarray,
               pad_id: int = 0) -> np.ndarray:
    """Per-caption perplexity from decode logits (B, T, V) over the emitted
    ids (B, T), ignoring <pad>."""
    logits = np.asarray(logits, np.float64)
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    tok_logp = np.take_along_axis(logp, token_ids[..., None], axis=-1)[..., 0]
    mask = token_ids != pad_id
    n = np.maximum(mask.sum(-1), 1)
    mean_lp = (tok_logp * mask).sum(-1) / n
    return np.exp(-mean_lp)


def caption_table(
    candidates: list[str],
    references_list: list[list[str]],
    keys=None,
    logits: np.ndarray | None = None,
    token_ids: np.ndarray | None = None,
) -> list[dict]:
    """Rows sorted by BLEU-1 desc (sample_captions.py ordering)."""
    rows = []
    ppl = (
        perplexity(logits, token_ids)
        if logits is not None and token_ids is not None
        else [None] * len(candidates)
    )
    for i, (cand, refs) in enumerate(zip(candidates, references_list)):
        # references get the reference cleanup (lowercase, strip
        # punctuation) — raw COCO text ('A horse.') never matches the
        # lowercased tokenizer output, deflating every score; and an
        # empty reference list must score 0.0, not method1's smoothing
        # floor (which ranked unreferenced captions above real zeros)
        b1 = sentence_bleu(
            [guse_clean(r).split() for r in refs], cand.split(),
            weights=(1, 0, 0, 0), smoothing="method1",
        ) if refs else 0.0
        rows.append(
            {
                "key": None if keys is None else int(keys[i]),
                "caption": cand,
                "bleu1": b1,
                "perplexity": None if ppl[i] is None else float(ppl[i]),
                "references": refs,
            }
        )
    rows.sort(key=lambda r: r["bleu1"], reverse=True)
    return rows


def load_behavior_hits(responses_tsv: str) -> dict[int, int]:
    """NSD behavioral responses -> {73KID: summed ISCORRECT}.

    The reference reads nsddata/ppdata/subjNN/behav/responses.tsv and
    groupby-sums ISCORRECT per 73KID (Eval/hit_rate.py:105-110) — each key
    was shown 3 times, so the per-key hit rate is an integer 0..3."""
    hits: dict[int, int] = {}
    with open(responses_tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            key = int(float(row["73KID"]))
            raw = (row.get("ISCORRECT") or "").strip()
            val = float(raw) if raw else float("nan")
            # no-response trials carry NaN ISCORRECT; pandas groupby().sum()
            # treats them as 0 and so does this parser
            hits[key] = hits.get(key, 0) + (0 if val != val else int(val))
    return hits


_BLEU1_W = (1.0, 0.0, 0.0, 0.0)
_BLEU4_W = (0.25, 0.25, 0.25, 0.25)


def bleu_by_hit_rate(
    captions_by_key: dict[int, str],
    references_by_key: dict[int, list[str]],
    hits: dict[int, int],
    weights=(_BLEU1_W, _BLEU4_W),
    max_hits: int = 3,
) -> dict:
    """Group per-caption sentence BLEU by the key's behavioral hit rate
    (Eval/hit_rate.py main(): boxplots of BLEU per hit-rate 0..3, method0
    smoothing). Returns {"BLEU-n": {hit_value: [scores...]}}.

    Note the reference's figure computes weight sets [0] and [1] (BLEU-1 and
    BLEU-2) while labelling the panels BLEU-1/BLEU-4 (hit_rate.py:141-144);
    here the weights match the labels."""
    out: dict[str, dict[int, list[float]]] = {}
    keys = [k for k in captions_by_key if k in hits and k in references_by_key]
    # tokenise once: references get the reference's caption cleanup
    # (lowercase, '.'/',' -> space — hit_rate.py:88-92); hypotheses come
    # from the tokenizer already lowercased, minus <pad>/<end> (:52-55)
    tokenized = {
        k: ([guse_clean(r).split() for r in references_by_key[k]],
            [t for t in captions_by_key[k].split()
             if t not in ("<pad>", "<end>")])
        for k in keys
    }
    for w in weights:
        # label by the HIGHEST n-gram order the set touches, marking
        # individual sets — counting non-zero weights labelled the
        # individual 4-gram set (0,0,0,1) "BLEU-1" and let it silently
        # overwrite the real BLEU-1 panel
        nz = [i for i, x in enumerate(w) if x > 0]
        label = f"BLEU-{nz[-1] + 1}" if nz else "BLEU-0"
        if len(nz) == 1 and nz[0] > 0:
            label += "-ind"
        while label in out:
            label += "'"
        groups: dict[int, list[float]] = {h: [] for h in range(max_hits + 1)}
        for k in keys:
            refs, hyp = tokenized[k]
            score = sentence_bleu(refs, hyp, weights=w, smoothing="none")
            groups.setdefault(min(hits[k], max_hits), []).append(float(score))
        out[label] = groups
    out["n_scored"] = len(keys)
    return out


def plot_bleu_hit_rate(groups: dict, out_png: str) -> None:  # pragma: no cover
    """Two-panel boxplot, BLEU vs hit rate (hit_rate.py:138-155)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    labels = [k for k in groups if k.startswith("BLEU-")]
    fig, axes = plt.subplots(1, len(labels), figsize=(8 * len(labels), 9),
                             squeeze=False)
    for ax, label in zip(axes[0], labels):
        hit_values = sorted(groups[label])
        data = [groups[label][h] for h in hit_values]
        # empty groups stay empty slots (no fake 0.0 box); the tick label
        # carries each group's n so "no data" reads as n=0
        ax.boxplot(data, notch=False)
        ax.set_title(label)
        ax.set_ylabel("BLEU score")
        ax.set_xticklabels(
            [f"{h}\n(n={len(groups[label][h])})" for h in hit_values])
        ax.set_xlabel("hit rate")
    plt.suptitle("Hit rate vs. BLEU score")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)


def hit_rate(
    captions_a: dict[int, str], captions_b: dict[int, str], n: int = 1
) -> dict:
    """Cross-subject n-gram hit rate on shared keys: fraction of shared keys
    whose two decoded captions share >=1 n-gram, plus the mean Jaccard
    overlap. A caption-level companion to Eval/hit_rate.py's
    compare_subjects() (which contrasts subjects' behavioral ISCORRECT
    totals, :160-172)."""
    shared = sorted(set(captions_a) & set(captions_b))
    hits, jaccards = 0, []
    for k in shared:
        a = captions_a[k].split()
        b = captions_b[k].split()
        nga = {tuple(a[i : i + n]) for i in range(len(a) - n + 1)}
        ngb = {tuple(b[i : i + n]) for i in range(len(b) - n + 1)}
        inter = nga & ngb
        union = nga | ngb
        if inter:
            hits += 1
        jaccards.append(len(inter) / len(union) if union else 0.0)
    return {
        "n_shared": len(shared),
        "hit_rate": hits / len(shared) if shared else 0.0,
        "mean_jaccard": float(np.mean(jaccards)) if jaccards else 0.0,
    }


def attention_by_region(
    attention: np.ndarray, region_names: list[str] | None = None,
    top_k: int = 20,
) -> dict:
    """attention: (B, T, R) decode attention scores. Returns per-region mean
    (averaged over batch and time) and the top-k ranking
    (compare_attention.py / list_regions.py export)."""
    mean_r = np.asarray(attention).mean(axis=(0, 1))       # (R,)
    order = np.argsort(mean_r)[::-1]
    names = region_names or [f"region_{i}" for i in range(len(mean_r))]
    return {
        "mean": mean_r,
        "ranking": [
            {"region": names[i], "index": int(i), "mean_attention": float(mean_r[i])}
            for i in order[:top_k]
        ],
    }


def loss_curves(loss_history_csv: str) -> dict[str, np.ndarray]:
    """Parse loss_history.csv (train/callbacks.LossHistory schema)."""
    with open(loss_history_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    out: dict[str, list[float]] = {}
    for row in rows:
        for k, v in row.items():
            # NaN placeholder for empty cells: dropping them would desync
            # a sparse column (e.g. intermittent val_loss) from the epoch
            # axis — matplotlib simply breaks the line at NaNs
            out.setdefault(k, []).append(
                float(v) if v not in ("", None) else float("nan"))
    return {k: np.asarray(v) for k, v in out.items()}


def plot_loss(loss_history_csv: str, out_png: str) -> None:  # pragma: no cover
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = loss_curves(loss_history_csv)
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in ("loss", "val_loss"):
        if k in curves:
            ax.plot(curves["epoch"], curves[k], label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_region_attention(
    mean_attention: np.ndarray, out_png: str,
    region_names: list[str] | None = None, top_k: int = 12,
    region_ids: np.ndarray | None = None, n_total: int | None = None,
):  # pragma: no cover - thin matplotlib shim over attention_by_region
    """Hemisphere heat-grid of per-Glasser-region attention.

    The reference renders these values on pycortex flatmaps
    (Eval/compare_attention.py); surface geometry isn't shippable here, so
    the figure is a (2, 180) LH/RH parcel grid with the top regions
    annotated — same data, headless rendering.

    ``region_ids`` gives each value's ORIGINAL group index (0..n_total-1,
    LH first) for runs trained with ``groups_to_remove`` — without it a
    plain half-split would misassign every parcel after the first removed
    one to the wrong hemisphere. Removed parcels render as gaps (NaN).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vals = np.asarray(mean_attention, np.float64).reshape(-1)
    if region_ids is not None:
        region_ids = np.asarray(region_ids, np.int64).reshape(-1)
        assert len(region_ids) == len(vals), (len(region_ids), len(vals))
        total = int(n_total if n_total is not None else region_ids.max() + 1)
        full = np.full((total,), np.nan)
        full[region_ids] = vals
        vals = full
    n = len(vals)
    half = n // 2
    width = max(1, half, n - half)
    grid = np.full((2, width), np.nan)
    grid[0, :half] = vals[:half]
    grid[1, : n - half] = vals[half:]

    fig, (ax, axr) = plt.subplots(
        2, 1, figsize=(12, 5), gridspec_kw={"height_ratios": [1, 2]}
    )
    im = ax.imshow(grid, aspect="auto", cmap="viridis",
                   interpolation="nearest")
    ax.set_yticks([0, 1], ["LH", "RH"])
    ax.set_xlabel("Glasser parcel index (within hemisphere)")
    fig.colorbar(im, ax=ax, label="mean attention")

    # NaN marks removed parcels — they must not win the top-k (argsort
    # places NaN last ascending, i.e. FIRST after the [::-1] reversal)
    order = np.argsort(np.nan_to_num(vals, nan=-np.inf))[::-1][:top_k]
    order = order[np.isfinite(vals[order])]
    names = region_names or [f"region_{i}" for i in range(n)]
    axr.barh(range(len(order))[::-1], vals[order], color="#3b6ea5")
    axr.set_yticks(range(len(order))[::-1], [names[i] for i in order])
    axr.set_xlabel("mean attention")
    axr.set_title(f"top {len(order)} regions")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def attention_to_vertices(
    region_values: np.ndarray, groups: list, n_vertices: int
) -> np.ndarray:
    """Project per-region attention back onto the full vertex vector.

    The reference's flatmap scripts do exactly this before pycortex rendering
    (Eval/compare_attention.py:84-92: fill an NaN vector, write each group's
    value into its vertex indices). ``groups`` is the (possibly
    ``select_groups``-filtered) Glasser group list the model trained on, in
    attention-axis order; unlabeled / removed-region vertices stay NaN.
    """
    values = np.asarray(region_values, np.float64).reshape(-1)
    assert len(values) == len(groups), (
        f"{len(values)} attention regions vs {len(groups)} atlas groups"
    )
    out = np.full(n_vertices, np.nan, np.float32)
    for v, idx in zip(values, groups):
        out[np.asarray(idx)] = v
    return out


def plot_vertex_attention(
    vertex_values: np.ndarray, out_png: str, n_lh: int,
    coords: dict | None = None,
):  # pragma: no cover - matplotlib rendering shim
    """Vertex-level LH/RH attention maps.

    With ``coords`` (``{"lh": (V_lh, 2), "rh": (V_rh, 2)}`` — flat-surface
    vertex positions exported offline from pycortex/FreeSurfer by
    ``scripts/export_flat_coords.py``) this is a true flatmap scatter — the
    stand-in for cortex.quickflat (Eval/compare_attention.py:68-71). Without
    coords it rasters each hemisphere's vertex vector in atlas order
    (vertex-level values, non-anatomical layout).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = np.asarray(vertex_values, np.float64).reshape(-1)
    hemis = [("LH", v[:n_lh]), ("RH", v[n_lh:])]
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    for ax, (name, hv) in zip(axes, hemis):
        if coords is not None:
            xy = np.asarray(coords[name.lower()])
            assert len(xy) == len(hv), (name, xy.shape, hv.shape)
            ok = ~np.isnan(hv)
            sc = ax.scatter(xy[ok, 0], xy[ok, 1], c=hv[ok], s=0.5,
                            cmap="viridis", rasterized=True)
            ax.set_aspect("equal")
        else:
            width = int(np.ceil(np.sqrt(len(hv))))
            grid = np.full(width * width, np.nan)
            grid[: len(hv)] = hv
            sc = ax.imshow(grid.reshape(width, width), cmap="viridis",
                           interpolation="nearest")
            ax.set_xlabel("vertex index (atlas order, row-major)")
        ax.set_title(name)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(sc, ax=axes, label="attention", shrink=0.8)
    fig.suptitle("Per-vertex attention"
                 + ("" if coords is not None else " (non-anatomical raster)"))
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def attention_tsne(
    attention: np.ndarray, labels=None, perplexity: float = 20.0,
    seed: int = 42,
) -> np.ndarray:
    """2-D t-SNE embedding of per-sample attention vectors
    (Eval/tsne_attn.py's analysis): attention (B, T, R) or (B, R) ->
    (B, 2) coordinates; pair with ``plot_tsne`` for the figure."""
    from sklearn.manifold import TSNE

    a = np.asarray(attention)
    if a.ndim == 3:
        a = a.mean(axis=1)
    perplexity = min(perplexity, max(1.0, (len(a) - 1) / 3))
    return TSNE(n_components=2, perplexity=perplexity, random_state=seed,
                init="pca").fit_transform(a)


def plot_tsne(coords: np.ndarray, out_png: str, labels=None,
              title: str = "attention t-SNE"):  # pragma: no cover - matplotlib shim
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    coords = np.asarray(coords)
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(coords[:, 0], coords[:, 1], s=14,
                    c=None if labels is None else np.asarray(labels),
                    cmap="tab10", alpha=0.8)
    if labels is not None:
        fig.colorbar(sc, ax=ax, label="label")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


_SPECIAL_TOKENS = ("<start>", "<end>", "<pad>", "<unk>")


def pos_tag_word(w: str) -> str:
    """Rule-based word-class tag using the caption-grammar lexicons from
    spice.py (no nltk data offline): noun / verb / adjective / preposition /
    determiner / other."""
    from masters_thesis_tpu_torch.evalsuite.spice import (
        _COPULAS,
        _DETERMINERS,
        _PREPOSITIONS,
        _is_adjective,
        _is_verb,
    )

    w = w.lower()
    if w in _DETERMINERS:
        return "determiner"
    if w in _PREPOSITIONS:
        return "preposition"
    if w in _COPULAS or _is_verb(w):
        return "verb"
    if _is_adjective(w):
        return "adjective"
    if w.isalpha():
        return "noun"
    return "other"


def attention_over_time(attention: np.ndarray, top_k: int = 3) -> dict:
    """Average attention per decode timestep across trials
    (eval_output.py::avg_attention_across_trials :229-283): attention
    (N, T, R) -> per_step (T, R) means plus each step's top-k region
    indices/values (the reference annotates each flatmap panel with the top
    region's name)."""
    a = np.asarray(attention, np.float64)
    assert a.ndim == 3, f"(N, T, R) attention expected, got {a.shape}"
    per_step = a.mean(axis=0)                                # (T, R)
    tops = []
    for t in range(per_step.shape[0]):
        order = np.argsort(per_step[t])[::-1][:top_k]
        tops.append([{"index": int(i), "mean_attention": float(per_step[t, i])}
                     for i in order])
    return {"per_step": per_step, "top_regions": tops}


def attention_by_tag(
    captions: list[str], attention: np.ndarray,
    tags=("noun", "verb", "adjective"),
) -> dict:
    """Mean attention vector per word class, relative to the overall mean
    (eval_output.py::attention_by_tag :490-551: collect attention[i, j] for
    every word j of caption i carrying the tag, average, subtract the
    all-step mean). Word j of ``captions[i].split()`` aligns with
    ``attention[i, j]`` (run_eval writes both in decode order)."""
    a = np.asarray(attention, np.float64)
    assert a.ndim == 3, f"(N, T, R) attention expected, got {a.shape}"
    overall = a.mean(axis=(0, 1))                            # (R,)
    rows: dict[str, list[np.ndarray]] = {t: [] for t in tags}
    for i, cap in enumerate(captions[: len(a)]):
        for j, w in enumerate(cap.split()[: a.shape[1]]):
            if w in _SPECIAL_TOKENS:
                continue
            tag = pos_tag_word(w)
            if tag in rows:
                rows[tag].append(a[i, j])
    out = {"overall_mean": overall, "tags": {}}
    for t in tags:
        if rows[t]:
            mean = np.mean(rows[t], axis=0)
            out["tags"][t] = {"n_words": len(rows[t]), "mean": mean,
                              "deviation": mean - overall}
        else:
            out["tags"][t] = {"n_words": 0, "mean": None, "deviation": None}
    return out


def plot_attention_over_time(
    per_step: np.ndarray, out_png: str,
    region_names: list[str] | None = None,
):  # pragma: no cover - matplotlib shim
    """(T, R) heatmap + each step's winning region, the headless analog of
    the reference's avg_attn_at_t flatmap grid / attn_over_time lines."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    per_step = np.asarray(per_step, np.float64)
    t_steps, n_regions = per_step.shape
    fig, ax = plt.subplots(figsize=(12, max(3, 0.45 * t_steps)))
    im = ax.pcolormesh(per_step, cmap="viridis")
    ax.set_xlabel("region")
    ax.set_ylabel("decode step")
    winners = np.argmax(per_step, axis=1)
    labels = []
    for t, w in enumerate(winners):
        name = region_names[w] if region_names else f"region_{w}"
        labels.append(f"t{t}: {name}")
    ax.set_yticks(np.arange(t_steps) + 0.5, labels, fontsize=8)
    fig.colorbar(im, ax=ax, label="mean attention")
    ax.set_title("Average attention at time t across trials")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_attention_by_tag(
    by_tag: dict, out_png: str,
):  # pragma: no cover - matplotlib shim
    """Per-tag deviation-from-mean LH/RH parcel rows (the reference renders
    these on flatmaps, eval_output.py:522-551)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tags = [t for t, v in by_tag["tags"].items() if v["deviation"] is not None]
    if not tags:
        return
    fig, axes = plt.subplots(len(tags), 1,
                             figsize=(12, 2.2 * len(tags)), squeeze=False)
    for ax, tag in zip(axes[:, 0], tags):
        dev = np.asarray(by_tag["tags"][tag]["deviation"])
        half = len(dev) // 2
        width = max(1, half, len(dev) - half)
        grid = np.full((2, width), np.nan)
        grid[0, :half] = dev[:half]
        grid[1, : len(dev) - half] = dev[half:]
        im = ax.imshow(grid, aspect="auto", cmap="RdBu_r",
                       interpolation="nearest")
        ax.set_yticks([0, 1], ["LH", "RH"])
        ax.set_title(f"Average attention for: {tag.upper()} "
                     f"(n={by_tag['tags'][tag]['n_words']}, vs overall mean)")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_attention_word_map(
    caption: str, attention_trial: np.ndarray, out_png: str,
    fold_hemispheres: bool = True,
):  # pragma: no cover - matplotlib shim
    """One trial's (word x region) attention map with word yticks
    (eval_output.py::attention_against_word :554-571; LH+RH folded like the
    reference's attn[:, :180] + attn[:, 180:])."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(attention_trial, np.float64)
    words = caption.split()
    if fold_hemispheres and a.shape[1] % 2 == 0:
        half = a.shape[1] // 2
        a = a[:, :half] + a[:, half:]
    a = a[: max(1, len(words))]
    fig, ax = plt.subplots(figsize=(10, max(3, 0.4 * len(a))))
    im = ax.pcolormesh(a, cmap="viridis")
    ax.set_title("Attention map", loc="left")
    ax.set_xlabel("Region")
    ax.set_ylabel("Word")
    ax.set_yticks(np.arange(len(a)) + 0.5,
                  (words + ["?"] * len(a))[: len(a)], fontsize=8)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def caption_pos_stats(captions: list[str]) -> dict:
    """Word-class composition of generated captions (eval_output.py's
    POS-tag statistics, 661 LoC of thesis figure code distilled to the
    numbers): share of nouns/verbs/adjectives/function words, type-token
    ratio, mean length. Uses the caption-grammar lexicons from spice.py in
    place of an external POS tagger (no nltk data offline)."""
    counts = {"noun": 0, "verb": 0, "adjective": 0, "preposition": 0,
              "determiner": 0, "other": 0}
    total = 0
    vocab: set = set()
    lengths = []
    for cap in captions:
        toks = [t.lower() for t in cap.split()
                if t not in _SPECIAL_TOKENS]
        lengths.append(len(toks))
        for w in toks:
            total += 1
            vocab.add(w)
            counts[pos_tag_word(w)] += 1
    return {
        "n_captions": len(captions),
        "mean_length": float(np.mean(lengths)) if lengths else 0.0,
        "vocab_size": len(vocab),
        "type_token_ratio": len(vocab) / total if total else 0.0,
        "fractions": {k: v / total if total else 0.0
                      for k, v in counts.items()},
        "counts": counts,
    }


def plot_caption_grid(entries, out_png: str, cols: int = 3) -> None:
    """Caption/image sample grid (Eval/sample_captions.py's BLEU-sorted
    figure): each panel shows the stimulus picture (blank when absent)
    titled with the generated caption; the subtitle carries the BLEU-4
    score and best reference when available.

    ``entries``: list of (image|None, caption, subtitle|None)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(entries)
    rows = max(1, -(-n // cols))
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3.6 * rows),
                             squeeze=False)
    for i, ax in enumerate(axes.flat):
        ax.axis("off")
        if i >= n:
            continue
        img, caption, subtitle = entries[i]
        if img is not None:
            ax.imshow(np.asarray(img).astype(np.uint8))
        ax.set_title(caption, fontsize=8, wrap=True)
        if subtitle:
            ax.text(0.5, -0.06, subtitle, fontsize=7, wrap=True,
                    ha="center", va="top", transform=ax.transAxes)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)


def caption_grid_entries(keys, texts, image_loader=None, references=None,
                         n: int = 12):
    """Build grid entries: when references exist, sentence-BLEU-4-sort and
    show the best n/2 and worst n/2 (sample_captions.py shows both tails);
    otherwise the first n in eval order. ``image_loader(key) -> img|None``
    is called only for the selected rows."""
    rows = list(range(len(keys)))
    scores = None
    if references is not None:
        scores = []
        for i in rows:
            refs = references.get(int(keys[i]), [])
            # same reference cleanup as bleu_by_hit_rate: raw COCO case/
            # punctuation never matches tokenizer output, so every BLEU-4
            # was ~0 and the best/worst split degenerated to input order
            refs_tok = [guse_clean(r).split() for r in refs]
            scores.append(
                sentence_bleu(refs_tok, texts[i].split()) if refs else 0.0)
        order = sorted(rows, key=lambda i: -scores[i])
        half = max(1, n // 2)
        rows = order[:half] + order[-half:] if len(order) > n else order
    else:
        rows = rows[:n]
    entries = []
    for i in rows:
        img = None if image_loader is None else image_loader(int(keys[i]))
        sub = None
        if scores is not None:
            refs = references.get(int(keys[i]), [])
            sub = f"BLEU-4 {scores[i]:.3f}"
            if refs:
                sub += f" | ref: {refs[0]}"
        entries.append((img, f"{keys[i]}: {texts[i]}", sub))
    return entries


def most_active_vertices(betas: np.ndarray, betas_b: np.ndarray | None = None,
                         top_n: int = 4096, chunk: int = 512) -> dict:
    """Top-N most active vertices by mean |beta| over trials
    (DataLoaders/most_active_vert.py:63-89): the reference averages
    ``np.abs`` over the 9000-unique split, argsorts, keeps the top 4096,
    and counts the overlap with the 1000-shared split's top set to check
    the ranking is stable across splits. Streamed in row chunks so a
    memmapped (9000, 327684) store never materialises (the reference
    loads all 11 GB up front).

    Returns ``indices`` (descending activity), ``mean_abs`` (full per-vertex
    vector), and — when ``betas_b`` is given — ``indices_b``/``overlap``/
    ``overlap_fraction`` of the two top-N sets."""

    def _mean_abs(x) -> np.ndarray:
        n, v = x.shape
        acc = np.zeros(v, np.float64)
        for s in range(0, n, chunk):
            acc += np.abs(np.asarray(x[s:s + chunk], np.float64)).sum(axis=0)
        return (acc / max(n, 1)).astype(np.float32)

    mean_a = _mean_abs(betas)
    top_n = min(top_n, mean_a.shape[0])
    # stable DESCENDING sort (argsort(-x)) so tied activities rank
    # lowest-index-first, the repo's tie convention; reversing an ascending
    # stable sort would anti-stabilize ties
    idx_a = np.argsort(-mean_a, kind="stable")[:top_n]
    out = {"top_n": int(top_n), "indices": idx_a,
           "mean_abs": mean_a}
    if betas_b is not None:
        mean_b = _mean_abs(betas_b)
        idx_b = np.argsort(-mean_b, kind="stable")[:top_n]
        overlap = np.intersect1d(idx_a, idx_b)
        out.update(indices_b=idx_b, overlap=int(overlap.size),
                   overlap_fraction=float(overlap.size / max(top_n, 1)))
    return out


def streamed_betas_stats(betas, chunk: int = 512) -> dict:
    """Per-vertex trial-average and L1-norm (visualize_betas.py's maps),
    accumulated in row chunks so a memmapped reference-scale store never
    materialises in RAM."""
    n, v = betas.shape
    mean = np.zeros(v, np.float64)
    l1 = np.zeros(v, np.float64)
    for s in range(0, n, chunk):
        x = np.asarray(betas[s:s + chunk], np.float64)
        mean += x.sum(axis=0)
        l1 += np.abs(x).sum(axis=0)
    return {"mean": (mean / max(n, 1)).astype(np.float32),
            "l1norm": l1.astype(np.float32)}


def betas_semantic_similarity(
    betas: np.ndarray,
    guse: np.ndarray,
    targets: list[int] | None = None,
    n_similar: int = 100,
    n_random: int = 100,
    seed: int = 4,
) -> dict:
    """Do semantically similar stimuli evoke similar brain responses?
    (DataLoaders/betas_sim.py:55-106.) For each target trial the reference
    ranks every other trial by GUSE cosine similarity of the (averaged)
    caption embeddings, then compares the betas-space MSE of the top-100
    most-similar trials against 100 random trials. Beyond the reference's
    eyeballed dot plot, this also reports a Spearman rank correlation
    between semantic similarity and -MSE over the sampled pairs (the
    RSA-style summary number).

    ``guse``: (N, 512) per-trial embeddings row-aligned with ``betas``
    (an (N, C, 512) caption table is averaged over C first). ``betas`` may
    be a memmap — only the target/similar/random rows are ever read
    (~200 rows per target, <1% of a reference-scale store)."""
    guse = np.asarray(guse, np.float32)
    if guse.ndim == 3:
        guse = guse.mean(axis=1)
    n = len(betas)
    if len(guse) != n:
        raise ValueError(f"betas rows ({n}) != guse rows ({len(guse)})")
    gn = guse / np.maximum(np.linalg.norm(guse, axis=1, keepdims=True), 1e-12)
    rng = np.random.default_rng(seed)
    if targets is None:
        targets = [100 if n > 100 else 0]  # the reference's target index

    per_target = []
    sem_all: list[float] = []
    neg_mse_all: list[float] = []
    for t in targets:
        cos = gn @ gn[t]
        cos[t] = -np.inf  # never pick the target itself
        # cap at n-1: with n <= n_similar the -inf target would re-enter
        # the tail of the "similar" pool as a degenerate MSE-0 point
        sim_idx = np.argsort(-cos, kind="stable")[:min(n_similar, n - 1)]
        rand_idx = rng.integers(0, n, size=min(n_random, n))
        bt = np.asarray(betas[t], np.float32)

        def _mse(idx) -> np.ndarray:
            rows = np.asarray(betas[np.asarray(idx, np.int64)], np.float32)
            d = rows - bt
            return np.mean(np.square(d, d), axis=1)

        # never draw the target itself (the reference's randint can, putting
        # a degenerate MSE-0 point in the "random" pool): remap t -> n-1
        rand_idx = np.where(rand_idx == t, (t + 1) % n, rand_idx)

        mse_sim = _mse(sim_idx)
        mse_rand = _mse(rand_idx)
        for idx, mses in ((sim_idx, mse_sim), (rand_idx, mse_rand)):
            sem_all.extend(float(cos[i]) for i in idx)
            neg_mse_all.extend(-float(v) for v in mses)
        per_target.append({
            "target": int(t),
            "most_similar": int(sim_idx[0]),
            "max_cosine": float(cos[sim_idx[0]]),
            "mse_similar_mean": float(mse_sim.mean()),
            "mse_random_mean": float(mse_rand.mean()),
            "mse_similar": mse_sim,
            "mse_random": mse_rand,
        })

    sim_means = [p["mse_similar_mean"] for p in per_target]
    rand_means = [p["mse_random_mean"] for p in per_target]
    return {
        "targets": per_target,
        "mse_similar_mean": float(np.mean(sim_means)),
        "mse_random_mean": float(np.mean(rand_means)),
        # < 1 means semantically-similar stimuli sit closer in betas space
        "mse_ratio": float(np.mean(sim_means) / max(np.mean(rand_means),
                                                    1e-12)),
        "spearman_sem_vs_negmse": _spearman(np.asarray(sem_all),
                                            np.asarray(neg_mse_all)),
    }


def _spearman(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    if len(x) < 2:
        return 0.0

    def _rank(v: np.ndarray) -> np.ndarray:
        order = np.argsort(v, kind="stable")
        ranks = np.empty(len(v), np.float64)
        ranks[order] = np.arange(len(v), dtype=np.float64)
        # average tied ranks so exact duplicates don't bias the correlation
        uniq, inv, counts = np.unique(v, return_inverse=True,
                                      return_counts=True)
        sums = np.zeros(len(uniq), np.float64)
        np.add.at(sums, inv, ranks)
        return sums[inv] / counts[inv]

    rx, ry = _rank(x), _rank(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    return float((rx * ry).sum() / denom) if denom > 0 else 0.0


def plot_betas_similarity(result: dict, out_png: str) -> None:  # pragma: no cover
    """The betas_sim.py comparison figure: per-target strip of betas-MSE
    for GUSE-similar vs random trials."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for k, p in enumerate(result["targets"]):
        x = k + 1
        ax.plot([x] * len(p["mse_similar"]), p["mse_similar"], "go",
                alpha=0.4, markersize=4,
                label="GUSE-similar" if k == 0 else None)
        ax.plot([x + 0.25] * len(p["mse_random"]), p["mse_random"], "ro",
                alpha=0.4, markersize=4, label="random" if k == 0 else None)
    ax.set_xticks([k + 1 for k in range(len(result["targets"]))])
    ax.set_xticklabels([str(p["target"]) for p in result["targets"]])
    ax.set_xlabel("target trial")
    ax.set_ylabel("betas MSE to target")
    ax.set_title(
        f"semantic vs neural similarity — MSE ratio "
        f"{result['mse_ratio']:.3f}, Spearman "
        f"{result['spearman_sem_vs_negmse']:.3f}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
