#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``masters_thesis_tpu_torch/csrc``, holds
the whole-decode kernel (K2) against its plain PyTorch version at flagship
LcNIC width, serves three HTTP caption requests through the port's
``Captioner`` and the shared caption server, and times the kernel, the plain
version, the unfused greedy decoder and captions per second. Every number is
printed beside the card's name and power limit. ``--profile`` adds a
``torch.profiler`` table of device time by kernel for one served batch.

The weights are random, made from a seed, and spread by
``ops.fused_decode.spread_for_check`` so that every bias and BatchNorm
statistic is live and the greedy words vary; the run fails if they do not.
The flagship layout is the synthetic 360-group one of ``bench.py``. The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches during serving, its error against the plain version and both
times. Any failed phase raises, and the script then exits non-zero without
those lines. It needs CUDA and the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# flagship LcNIC (lc_NIC.py widths) at the service batch, fp32, eval mode
N_VOXELS, N_GROUPS = 327_684, 360
WIDTHS = dict(units=512, group_size=32, embedding_text=512, attn_units=32,
              vocab_size=5001, max_length=15)
BATCH = 64
SEED = 0
ALPHA_ATOL = 1e-6   # fp32, summation order only (measured ~3e-7)
TIE_MARGIN = 1e-3   # a top-2 logit margin below this is a near-tie
MIN_DISTINCT_WORDS = 16     # over the B x T greedy words of the check
MIN_NONEMPTY_SHARE = 0.9    # of the served captions
REQUEST_ROWS = (1, 5, 64)   # .npy, JSON, .npy
THROUGHPUT_ROWS = 4 * BATCH
WINDOWS, WINDOW_S = 5, 2.0  # captions/s: repeated timing windows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_kernels() -> None:
    from masters_thesis_tpu_torch.ops import _build

    out = _build.library_path()
    seconds = _build.build(out) if not out.exists() else 0.0
    _build.load_library()
    print(f"build: {out.name} in {seconds:.1f} s (nvcc, sm_90a)")
    for line in out.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def flagship_model(device):
    from masters_thesis_tpu.data.synthetic import synthetic_groups
    from masters_thesis_tpu.ops.group_layout import GroupLayout
    from masters_thesis_tpu_torch.models.nic import LcNIC
    from masters_thesis_tpu_torch.ops.fused_decode import spread_for_check

    layout = GroupLayout(synthetic_groups(N_VOXELS, N_GROUPS, seed=SEED),
                         N_VOXELS)
    gen = torch.Generator().manual_seed(SEED)
    model = LcNIC(layout, generator=gen, **WIDTHS)
    spread_for_check(model, gen)
    return model.to(device).eval()


@torch.inference_mode()
def check_kernel(model, betas, card: str) -> dict:
    """K2 against its plain version on the same inputs, on the card."""
    from masters_thesis_tpu_torch.ops import fused_decode as fd

    T = model.max_length
    inputs = fd.decode_inputs(model, betas, 1)
    words, alphas = fd.fused_greedy_decode(*inputs, max_length=T)
    torch.cuda.synchronize()
    ref_words, ref_alphas, margins = fd.fused_greedy_decode_reference(
        *inputs, max_length=T, return_margins=True)
    B, R = len(betas), inputs[0].shape[1]
    if words.shape != (B, T) or alphas.shape != (B, T, R):
        raise RuntimeError(f"kernel output shapes {tuple(words.shape)}, "
                           f"{tuple(alphas.shape)}; expected {(B, T)}, "
                           f"{(B, T, R)}")
    if not (0 <= int(words.min()) and int(words.max()) < WIDTHS["vocab_size"]):
        raise RuntimeError("kernel produced an id outside the vocabulary")
    sums = alphas.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise RuntimeError("kernel alphas do not sum to 1 over regions")
    report = fd.compare_with_reference(
        words, alphas, ref_words, ref_alphas, margins,
        alpha_atol=ALPHA_ATOL, tie_margin=TIE_MARGIN)
    distinct = len(torch.unique(ref_words))
    print(f"K2 vs plain at B={B} R={R} T={T} V={WIDTHS['vocab_size']}: "
          f"max |alpha err| {report['max_abs_err']:.3e} (limit {ALPHA_ATOL}), "
          f"rows identical {B - report['near_tie_rows']}/{B}, near-tie rows "
          f"{report['near_tie_rows']} (margin < {TIE_MARGIN}), distinct "
          f"words {distinct} (floor {MIN_DISTINCT_WORDS}), smallest top-2 "
          f"margin {float(margins.min()):.3e}, largest alpha "
          f"{float(ref_alphas.max()):.3f} [{card}]")
    if report["bad_rows"]:
        raise RuntimeError(f"kernel disagrees with its plain version on rows "
                           f"{report['bad_rows']}: {report}")
    if distinct < MIN_DISTINCT_WORDS:
        raise RuntimeError(f"the check's greedy words are degenerate: "
                           f"{distinct} distinct < {MIN_DISTINCT_WORDS}")

    ms = cuda_ms(lambda: fd.fused_greedy_decode(*inputs, max_length=T))
    plain_ms = cuda_ms(lambda: fd.fused_greedy_decode_reference(
        *inputs, max_length=T))
    fused = fd.make_whole_fused_greedy_decoder(model, T)
    from masters_thesis_tpu_torch.decode.greedy import make_greedy_decoder

    unfused = make_greedy_decoder(model, T)
    fused_e2e = cuda_ms(lambda: fused(betas, 1))
    unfused_e2e = cuda_ms(lambda: unfused(betas, 1))
    print(f"decode loop at B={B}, T={T}: K2 kernel {ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms [{card}]")
    print(f"greedy decode with encoder at B={B}: fused (K2) {fused_e2e:.4f} ms,"
          f" unfused decode/greedy.py {unfused_e2e:.4f} ms [{card}]")
    return {"max_abs_err": report["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms}


def _post(url: str, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise RuntimeError(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read().decode())


def _npy(rows: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, rows)
    return buf.getvalue()


def serve(captioner, rows: np.ndarray, card: str) -> list[str]:
    """Three POST /caption requests through the shared HTTP server; returns
    the captions, one per row, in row order."""
    from masters_thesis_tpu.server import make_caption_server

    server = make_caption_server(captioner, port=0)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bounds = np.cumsum((0,) + REQUEST_ROWS)
        answers = []
        for i, n in enumerate(REQUEST_ROWS):
            part = rows[bounds[i]:bounds[i + 1]]
            t0 = time.perf_counter()
            if i == 1:
                out = _post(f"{base}/caption",
                            json.dumps({"betas": part.tolist()}).encode(),
                            "application/json")
            else:
                out = _post(f"{base}/caption", _npy(part),
                            "application/octet-stream")
            caps = out["captions"]
            if len(caps) != n or not all(isinstance(c, str) for c in caps):
                raise RuntimeError(f"request of {n} rows got {len(caps)} "
                                   f"captions")
            answers.extend(caps)
            print(f"POST /caption {n} rows ({'json' if i == 1 else 'npy'}): "
                  f"200, {len(caps)} captions, "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms host [{card}]")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read().decode())
        print(f"GET /stats: {stats}")
        if (stats["requests"] != len(REQUEST_ROWS)
                or stats["rows"] != sum(REQUEST_ROWS)):
            raise RuntimeError(f"/stats does not count the requests: {stats}")
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    return answers


def throughput(captioner, rows: np.ndarray, card: str) -> float:
    """Captions/s over ``WINDOWS`` windows of at least ``WINDOW_S`` s of
    ``caption`` calls; prints the median and the spread across windows."""
    captioner.caption(rows[:BATCH])                      # warm
    rates = []
    for _ in range(WINDOWS):
        n, t0 = 0, time.perf_counter()
        while (seconds := time.perf_counter() - t0) < WINDOW_S:
            captioner.caption(rows)
            n += len(rows)
        rates.append(n / seconds)
    median = float(np.median(rates))
    print(f"greedy captions/s through Captioner (batch {BATCH}, "
          f"{len(rows)} host rows a call, fp32): median {median:.1f} over "
          f"{WINDOWS} windows of >= {WINDOW_S} s, min {min(rates):.1f}, max "
          f"{max(rates):.1f}, spread {(max(rates) - min(rates)) / median:.1%}"
          f" [{card}]")
    return median


def profile(captioner, rows: np.ndarray) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        captioner.caption(rows[:BATCH])
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="print device time by kernel for one batch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    from masters_thesis_tpu.data.pairs import clean_caption
    from masters_thesis_tpu.data.synthetic import synthetic_captions
    from masters_thesis_tpu.data.tokenizer import Tokenizer
    from masters_thesis_tpu_torch.ops import fused_decode as fd
    from masters_thesis_tpu_torch.serve import Captioner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")

    build_kernels()
    model = flagship_model(device)
    enc_mb = sum(p.numel() * p.element_size()
                 for p in model.encoder.parameters()) / 1e6
    print(f"flagship LcNIC: {N_VOXELS} voxels in {N_GROUPS} groups, "
          f"{len(model.encoder.layout.buckets)} buckets, encoder "
          f"{enc_mb:.1f} MB fp32")

    gen = torch.Generator(device=device).manual_seed(SEED)
    betas = torch.randn(BATCH, N_VOXELS, generator=gen, device=device)
    k2 = check_kernel(model, betas, card)

    # synthetic captions plus a made-up lexicon, so every id of the
    # vocabulary names a word and the served captions are not empty
    tok = Tokenizer(num_words=WIDTHS["vocab_size"])
    tok.fit_on_texts([clean_caption(c)
                      for lines in synthetic_captions(range(200)).values()
                      for c in lines]
                     + [" ".join(f"w{i}" for i in range(WIDTHS["vocab_size"]))])
    tok.install_pad()
    captioner = Captioner(model, tok, WIDTHS["units"], WIDTHS["max_length"],
                          batch_size=BATCH)
    rows = np.random.default_rng(SEED).standard_normal(
        (THROUGHPUT_ROWS, N_VOXELS), dtype=np.float32)

    fd.fused_greedy_decode.launches = 0
    served = serve(captioner, rows, card)
    launches = fd.fused_greedy_decode.launches
    print(f"K2 launches while serving: {launches}")
    if launches < 1:
        raise RuntimeError("serving never launched the decode kernel")
    if served != captioner.caption(rows[:len(served)]):
        raise RuntimeError("served captions differ from Captioner.caption "
                           "on the same rows")
    nonempty = sum(map(bool, served)) / len(served)
    print(f"served captions equal Captioner.caption on the same rows; "
          f"{nonempty:.1%} non-empty (floor {MIN_NONEMPTY_SHARE:.0%}), "
          f"{len(set(served))} distinct of {len(served)}, e.g. {served[-1]!r}")
    if nonempty < MIN_NONEMPTY_SHARE:
        raise RuntimeError(f"only {nonempty:.1%} of the served captions are "
                           f"non-empty")

    throughput(captioner, rows, card)
    if args.profile:
        profile(captioner, rows)

    print(json.dumps({"kernels": [{
        "name": "fused_greedy_decode", "route": "cuda",
        "source": "masters_thesis_tpu_torch/csrc/fused_decode.cu",
        "replaces": "masters_thesis_tpu/ops/fused_decode.py:211",
        "launches": launches, **k2}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
