"""The ``cnn_rnn_inception`` family (Show, Attend and Tell from pixels) at a
tiny size on the CPU: its frozen arithmetic pinned to the figures of its
layer table, its reference against the program, its cell's faults, its
three readers on a canned trace, and a configuration of it added to a copy
as files alone."""

import ast
import json
import shutil
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from torch.autograd import DeviceType

from port_bench import programs
from port_bench.harness import port, traffic
from port_bench.harness.bench import ROOT, load_module, read_json
from port_bench.harness.trace import WINDOW, Trace
from port_bench.reference import cnn_rnn, cnn_rnn_inception, compare, family
from port_bench.tests import tiny, tiny_sizes
from port_bench.tests.test_port_bench_drivers import digest
from port_bench.tests.test_port_bench_faults import (
    decode_unchanged,
    half_decode_batch,
    word_altered,
)

CELL, CONFIG = "cnnrnn_inception_eval_greedy", "cnn_rnn_inception_v3"
FULL = read_json("configs", CONFIG)
NEW_FILES = ["reference/cnn_rnn_inception.py",
             "programs/cnn_rnn_inception.py",
             "metrics/backbone_device_ms.decode.py",
             "metrics/backbone_launches.decode.py",
             "metrics/backbone_roofline.py"]


def tiny_config() -> dict:
    cfg = read_json("configs", CONFIG)
    cfg.update(tiny_sizes.CONFIGS[CONFIG])
    cfg["store"].update(tiny_sizes.STORES[CONFIG])
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def test_layer_table_and_flops():
    """94 convolutions in the stem and 11 mixed blocks, 21.77 M parameters
    with the BatchNorm shifts (the program's backbone has as many), 5.711 G
    multiply-adds an image at 299 x 299 (11.42 GFLOP), so 64 images take at
    least 10.9 ms at the fp32 peak."""
    layers = cnn_rnn_inception.LAYERS
    assert len(layers) == 94
    assert len({n.split(".")[0] for n, *_ in layers} - {
        "stem1", "stem2", "stem3", "stem4", "stem5"}) == 11
    assert sum(o * (i * kh * kw + 1) for _, i, o, kh, kw, *_ in layers) \
        == 21_768_352
    assert cnn_rnn_inception.backbone_flops(FULL) == pytest.approx(
        11.42e9, rel=1e-3)
    b = cnn_rnn_inception.backbone_bound(FULL, 64)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(10.91, abs=5e-3)
    assert cnn_rnn_inception.caption_flops(FULL) == pytest.approx(
        cnn_rnn_inception.backbone_flops(FULL)
        + cnn_rnn.caption_flops(read_json("configs", "cnn_rnn")), rel=1e-12)
    assert cnn_rnn_inception.row_width(FULL) == 268_203
    assert cnn_rnn_inception.regions(FULL) == 64


@pytest.mark.parametrize("size", [75, 107, 299])
def test_flops_follow_the_forward(size, monkeypatch):
    """The count from the table equals the multiply-adds of every
    ``F.conv2d`` the reference's forward calls, on the meta device."""
    side = cnn_rnn_inception.sides(size)["s7"]
    cfg = dict(FULL, image_size=[size, size], n_patches=side * side)
    meta = torch.device("meta")
    w = {}
    for name, i, o, kh, kw, *_ in cnn_rnn_inception.LAYERS:
        w[f"{name}.w"] = torch.empty(o, i, kh, kw, device=meta)
        for part in ("beta", "mean", "var"):
            w[f"{name}.{part}"] = torch.empty(o, device=meta)
    macs = []
    conv2d = torch.nn.functional.conv2d

    def counted(x, k, **kw):
        y = conv2d(x, k, **kw)
        macs.append(y[0].numel() * k[0].numel())
        return y

    monkeypatch.setattr(cnn_rnn_inception.F, "conv2d", counted)
    out = cnn_rnn_inception.backbone(w, torch.empty(1, 3, size, size,
                                                    device=meta))
    assert tuple(out.shape) == (1, 2048, side, side)
    assert len(macs) == 94
    assert cnn_rnn_inception.backbone_flops(cfg) == 2.0 * sum(macs)


def test_configuration_states_its_patches():
    with pytest.raises(ValueError, match="patches"):
        cnn_rnn_inception.regions(dict(FULL, n_patches=49))


def test_weights_keep_the_patches_like_drawn_patch_rows():
    """Under the weights' rule the mixed10 patches are post-ReLU with a
    mean in 0.2-2, as ``cnn_rnn``'s drawn rows, and differ image to image
    (the rule's statistics); the same seed draws the same weights."""
    cfg = tiny_config()
    dev = torch.device("cpu")
    w = cnn_rnn_inception.weights(cfg, 2**40 + 3, dev)
    again = cnn_rnn_inception.weights(cfg, 2**40 + 3, dev)
    assert all(torch.equal(w[k], again[k]) for k in w)
    x = cnn_rnn_inception.draw_rows(cfg, 4, torch.Generator().manual_seed(1),
                                    dev)
    assert x.min() >= 0 and x.max() <= 255 and torch.equal(x, x.round())
    with torch.no_grad():
        p = cnn_rnn_inception.encode_patches(w, cfg, x)
    assert p.min() == 0 and 0.2 <= float(p.mean()) <= 2.0
    assert float(p.std(dim=0).mean() / p.std()) > 0.3


def test_decode_agrees_with_the_program():
    from masters_thesis_tpu_torch.ops.fused_decode import (
        make_whole_fused_greedy_decoder,
    )

    cfg = tiny_config()
    dev = torch.device("cpu")
    ref = family(cfg)
    w = ref.weights(cfg, 7, dev)
    model = port.model(cfg, w, dev).eval()
    x = traffic.rows_for(cfg, 3, [1, 5, 9, 30], dev)
    rows = programs.family(cfg).to_store(model, x)
    words, alphas = make_whole_fused_greedy_decoder(model, cfg["max_length"])(
        rows, cfg["tokens"]["start"])
    tokens = torch.cat([torch.full_like(words[:, :1], cfg["tokens"]["start"]),
                        words[:, :-1]], dim=1)
    with torch.no_grad():
        logits, ref_alphas = ref.teacher_forced(w, cfg, x, tokens)
    r = compare.decode_readings(logits, ref_alphas, words, alphas)
    # the program's channels-last convolutions on the CPU round ~1e-4 of
    # the patches away from the reference's, which the alphas carry
    assert r["logit_gap"] <= 1e-3 and r["alpha_err"] <= 1e-3, r
    assert len(set(words.flatten().tolist())) >= 3


def pool_branches_zeroed(decode):
    """Every average-pool branch of InceptionV3 reads zeros."""
    from masters_thesis_tpu_torch.models import inception

    def broken(betas, start_id):
        with mock.patch.object(inception, "_avg_pool_same",
                               torch.zeros_like):
            return decode(betas, start_id)
    return broken


@pytest.mark.parametrize("fault", [pool_branches_zeroed, word_altered,
                                   half_decode_batch, decode_unchanged],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, fault):
    result = tiny.run(root, CELL, hook=fault)
    assert result["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())


def event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class Stamp:
    """A CUDA event that completed at ``ms``."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def read(name, trace, config=CONFIG):
    bench = SimpleNamespace(config=read_json("configs", config))
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py").read(
        trace, bench)


@pytest.fixture
def trace(monkeypatch):
    """Two requests of 64 images: their backbones' host ranges inside the
    inputs' with 3 and 5 launches (one more in the inputs, one outside),
    and device extents of 40 and 25 ms."""
    from masters_thesis_tpu_torch.utils import profiling

    events = [
        event(WINDOW, 0, 1000),
        event("span:decode.inputs", 10, 400),
        event("span:encode.backbone", 20, 300),
        event("span:decode.inputs", 500, 900),
        event("span:encode.backbone", 510, 800),
        *[event("cudaLaunchKernel", t, t + 1)
          for t in (30, 100, 200, 520, 600, 650, 700, 790)],
        event("cudaLaunchKernel", 350, 351),        # the projection
        event("cuLaunchKernel", 950, 951),          # K3, outside
    ]
    pairs = [("decode.inputs", Stamp(0.0), Stamp(45.0)),
             ("encode.backbone", Stamp(1.0), Stamp(41.0)),
             ("encode.backbone", Stamp(50.0), Stamp(75.0))]
    monkeypatch.setattr(profiling, "device_spans", lambda: list(pairs))
    return Trace(events, {"decodes": 2, "batch": 64})


def test_readers(trace):
    assert read("backbone_device_ms.decode", trace) == pytest.approx(25.0)
    assert read("backbone_launches.decode", trace) == pytest.approx(4.0)
    least = cnn_rnn_inception.backbone_bound(FULL, 64)["bound_ms"]
    assert read("backbone_roofline", trace) == pytest.approx(
        100 * least / 25.0)
    assert 40 < read("backbone_roofline", trace) < 50     # 10.91 of 25 ms


def test_readers_find_nothing(monkeypatch):
    """A program without the span, and a family without a backbone."""
    from masters_thesis_tpu_torch.utils import profiling

    empty = Trace([event(WINDOW, 0, 1000),
                   event("cudaLaunchKernel", 70, 72)], {"batch": 64})
    monkeypatch.setattr(profiling, "device_spans", lambda: [])
    for name in ("backbone_device_ms.decode", "backbone_launches.decode",
                 "backbone_roofline"):
        assert read(name, empty) is None, name
    monkeypatch.setattr(profiling, "device_spans", lambda: [
        ("encode.backbone", Stamp(0.0), Stamp(2.0))])
    assert read("backbone_roofline", empty, "cnn_rnn") is None


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_files_import_no_jax(path):
    """The family's files import nothing of JAX or of the JAX package (the
    reference nothing of the program either, held for every reference by
    ``test_port_bench_nojax.py``)."""
    for node in ast.walk(ast.parse((ROOT / "port_bench" / path)
                                   .read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in (
                "masters_thesis_tpu", "jax", "flax", "optax", "jaxlib"), (
                    path, name)


def test_pixel_configuration_added_as_files(tmp_path):
    """Another configuration of the family, a traffic mix, limits and a
    cell, added to a copy as files and manifest entries, run; no file that
    was there changes."""
    root = tiny.tiny_root(tmp_path)
    bench = root / "port_bench"
    before = digest(bench)
    config = json.loads((bench / "configs" / f"{CONFIG}.json").read_text())
    config.update(name="dummy_pixels", image_size=[75, 75], n_patches=1,
                  units=8, vocab_size=40)
    (bench / "configs" / "dummy_pixels.json").write_text(json.dumps(config))
    traffic_mix = json.loads((bench / "traffic" / "greedy_b64.json")
                             .read_text())
    traffic_mix.update(batch=3, in_flight=1)
    (bench / "traffic" / "greedy_b3.json").write_text(json.dumps(traffic_mix))
    shutil.copy(bench / "limits" / f"{CELL}.json",
                bench / "limits" / "dummy_pixels_eval.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_pixels", "source": "a test",
                           "file": "port_bench/configs/dummy_pixels.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy_pixels_eval",
                             "config": "dummy_pixels", "traffic": "greedy_b3",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("dummy_pixels_eval")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    result = tiny.run(root, "dummy_pixels_eval")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"captions_per_s",
                                      "caption_batch_p95_ms", "setup_s"}
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
