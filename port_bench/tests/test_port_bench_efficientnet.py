"""The ``cnn_rnn_efficientnet`` family (Show, Attend and Tell from pixels on
EfficientNet-B3) at a tiny size on the CPU: its frozen arithmetic pinned
to the figures of its layer table and held against the port's module, its
reference against the program, its cell's faults, its three readers on a
canned trace and on nothing, its tiny size registered from a file of its
own, and a configuration of it added to a copy as files alone."""

import ast
import json
import shutil
from types import ModuleType, SimpleNamespace
from unittest import mock

import pytest
import torch

from port_bench import conftest as sizes
from port_bench import programs
from port_bench.harness import port, traffic
from port_bench.harness.bench import ROOT, load_module, read_json
from port_bench.harness.trace import WINDOW, Trace
from port_bench.reference import cnn_rnn, compare, family
from port_bench.reference import cnn_rnn_efficientnet as ref
from port_bench.tests import tiny, tiny_sizes
from port_bench.tests.test_port_bench_drivers import digest
from port_bench.tests.test_port_bench_faults import (
    decode_unchanged,
    half_decode_batch,
    word_altered,
)
from port_bench.tests.test_port_bench_inception import Stamp, event

CELL, CONFIG = "cnnrnn_effnetb3_eval_greedy", "cnn_rnn_efficientnet_b3"
FULL = read_json("configs", CONFIG)
NEW_FILES = ["conftest.py", "reference/cnn_rnn_efficientnet.py",
             "programs/cnn_rnn_efficientnet.py", "harness/nested_spans.py",
             "metrics/depthwise_se_device_ms.decode.py",
             "metrics/depthwise_se_launches.decode.py",
             "metrics/depthwise_se_roofline.py"]
READERS = ("depthwise_se_device_ms.decode", "depthwise_se_launches.decode",
           "depthwise_se_roofline")


def tiny_config() -> dict:
    cfg = read_json("configs", CONFIG)
    cfg.update(sizes.CONFIGS[CONFIG])
    cfg["store"].update(sizes.STORES[CONFIG])
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def test_layer_table_and_flops():
    """130 convolutions: the stem, 26 MBConv blocks in 7 stages (repeats
    2, 3, 3, 5, 5, 6, 2; widths 24 to 384) and the 1,536-wide head;
    10.78 M weights with the BatchNorm vectors and biases; 1.826 G
    multiply-adds an image at 300 x 300 (3.65 GFLOP), the depthwise
    0.133 G of them, so 64 images take at least 3.49 ms at the fp32 peak;
    the depthwise and squeeze-and-excitation part moves 5.57 GB for 64
    images, 1.66 ms at the HBM peak."""
    assert len(ref.LAYERS) == 130 and len(ref.BLOCKS) == 26
    stages = [name[5] for name, *_ in ref.BLOCKS]
    assert [stages.count(s) for s in "1234567"] == [2, 3, 3, 5, 5, 6, 2]
    assert sorted({cout for _, _, cout, *_ in ref.BLOCKS}) == [
        24, 32, 48, 96, 136, 232, 384]
    assert ref._weights_n(ref.CONV) == 10_783_528
    macs = ref.layer_macs(FULL)
    assert sum(macs.values()) == pytest.approx(1.8256e9, rel=1e-4)
    assert sum(v for k, v in macs.items() if k.endswith("_dwconv")) \
        == pytest.approx(0.13326e9, rel=1e-4)
    assert ref.backbone_flops(FULL) == pytest.approx(3.6512e9, rel=1e-4)
    b = ref.backbone_bound(FULL, 64)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(3.488, abs=1e-3)
    d = ref.depthwise_se_bound(FULL, 64)
    assert d["bound_by"] == "bytes"
    assert d["bound_ms"] == pytest.approx(1.664, abs=1e-3)
    assert ref.caption_flops(FULL) == pytest.approx(
        ref.backbone_flops(FULL) + cnn_rnn.caption_flops(FULL), rel=1e-12)
    assert ref.row_width(FULL) == 270_000
    assert ref.regions(FULL) == 100


@pytest.mark.parametrize("size", [64, 96, 300])
def test_flops_follow_the_reference_forward(size, monkeypatch):
    """The count from the table equals the multiply-adds of every
    ``F.conv2d`` the reference's forward calls, on the meta device, and
    the top map is as ``top_side`` says."""
    side = ref.top_side(size)
    cfg = dict(FULL, image_size=[size, size], n_patches=side * side)
    meta = torch.device("meta")
    w = {}
    for name, cin, cout, k, _, groups, kind in ref.LAYERS:
        w[f"{name}.w"] = torch.empty(cout, cin // groups, k, k, device=meta)
        parts = ("b",) if kind == "se" else ("gamma", "beta", "mean", "var")
        for part in parts:
            w[f"{name}.{part}"] = torch.empty(cout, device=meta)
    macs = []
    conv2d = torch.nn.functional.conv2d

    def counted(x, k, *args, **kw):
        y = conv2d(x, k, *args, **kw)
        macs.append(y[0].numel() * k[0].numel())
        return y

    monkeypatch.setattr(ref.F, "conv2d", counted)
    out = ref.backbone(w, torch.empty(1, 3, size, size, device=meta))
    assert tuple(out.shape) == (1, 1536, side, side)
    assert len(macs) == 130
    assert ref.backbone_flops(cfg) == 2.0 * sum(macs)


@pytest.mark.parametrize("size", [64, 300])
def test_table_and_flops_follow_the_port_module(size):
    """A forward of the port's ``efficientnet("b3")`` on the meta device,
    hooked at every convolution: the layers in the table's order, each
    one's multiply-adds as ``layer_macs`` counts them."""
    from masters_thesis_tpu_torch.models import efficientnet
    from masters_thesis_tpu_torch.models.backbones import Conv

    side = ref.top_side(size)
    cfg = dict(FULL, image_size=[size, size], n_patches=side * side)
    net, _ = efficientnet.efficientnet("b3")
    net = net.to("meta")
    seen = []

    def hook(module, inputs, out):
        k = module.kernel
        seen.append(out[0].numel() * k.shape[0] * k.shape[1] * k.shape[2])

    for m in net.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(hook)
    out = net(torch.empty(1, size, size, 3, device="meta"))
    assert tuple(out["patches"].shape) == (1, side * side, 1536)
    assert seen == list(ref.layer_macs(cfg).values())
    assert ref.backbone_flops(cfg) == 2.0 * sum(seen)


def test_configuration_states_its_patches():
    with pytest.raises(ValueError, match="patches"):
        ref.regions(dict(FULL, n_patches=64))
    with pytest.raises(ValueError, match="channels"):
        ref.regions(dict(FULL, in_channels=2048))


def test_weights_keep_the_patches_like_drawn_patch_rows():
    """At the configuration's 300 x 300, under the weights' rule (BatchNorm
    statistics of 8 seeded images): post-swish patches with a mean in
    0.1-2, as ``cnn_rnn``'s drawn rows, that differ image to image."""
    dev = torch.device("cpu")
    assert ref.calibration_images(FULL) == ref.CALIBRATION == 8
    w = ref.weights(FULL, 2**40 + 5, dev)
    x = ref.draw_rows(FULL, 3, torch.Generator().manual_seed(1), dev)
    assert x.min() >= 0 and x.max() <= 255 and torch.equal(x, x.round())
    with torch.no_grad():
        p = ref.encode_patches(w, FULL, x)
    assert tuple(p.shape) == (3, 100, 1536)
    assert float(p.min()) >= -0.2785 and 0.1 <= float(p.mean()) <= 2.0
    assert float(p.std(dim=0).mean() / p.std()) > 0.3


def test_correct_pad_is_tf_same_at_stride_2():
    """Keras' ``correct_pad`` and a "valid" stride-2 convolution give TF's
    "SAME" output side, ``ceil(side / 2)``, at both parities."""
    for side in (7, 8, 75, 150, 300):
        for k in (3, 5):
            top, bottom = ref.correct_pad(side, k)
            assert (side + top + bottom - k) // 2 + 1 == -(-side // 2)


def test_decode_agrees_with_the_program():
    from masters_thesis_tpu_torch.ops.fused_decode import (
        make_whole_fused_greedy_decoder,
    )

    cfg = tiny_config()
    dev = torch.device("cpu")
    w = family(cfg).weights(cfg, 7, dev)
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
    # the program's channels-last convolutions on the CPU round ~1e-5 of
    # the patches away from the reference's, which the alphas carry
    assert r["logit_gap"] <= 1e-4 and r["alpha_err"] <= 1e-4, r
    assert len(set(words.flatten().tolist())) >= 3


def se_gates_left_out(decode):
    """Every block's squeeze-and-excitation gate is left out: the
    depthwise output goes to the projection ungated."""
    from masters_thesis_tpu_torch.models import efficientnet

    def ungated(block, x):
        inp = x
        if block.expand is not None:
            x = block.expand(x)
        x = block.project(block.depthwise(x))
        return x + inp if block.skip else x

    def broken(betas, start_id):
        with mock.patch.object(efficientnet.MBConv, "forward", ungated):
            return decode(betas, start_id)
    return broken


@pytest.mark.parametrize("fault", [se_gates_left_out, word_altered,
                                   half_decode_batch, decode_unchanged],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, fault):
    result = tiny.run(root, CELL, hook=fault)
    assert result["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())


def read(name, trace, config=CONFIG):
    bench = SimpleNamespace(config=read_json("configs", config))
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py").read(
        trace, bench)


@pytest.fixture
def trace(monkeypatch):
    """Two requests of 64 images: in each backbone's host range two
    depthwise ranges (launches 2 + 1 in the first, 3 + 0 in the second;
    one more launch in each backbone outside them, one in a depthwise
    range of no backbone); device extents of 3 + 4 ms and 2 + 2.5 ms
    inside the backbones, and a pair outside any."""
    from masters_thesis_tpu_torch.utils import profiling

    events = [
        event(WINDOW, 0, 1000),
        event("span:encode.backbone", 20, 300),
        event("span:encode.depthwise_se", 30, 60),
        event("span:encode.depthwise_se", 100, 150),
        event("span:encode.backbone", 510, 800),
        event("span:encode.depthwise_se", 520, 600),
        event("span:encode.depthwise_se", 700, 750),
        event("span:encode.depthwise_se", 900, 950),
        *[event("cudaLaunchKernel", t, t + 1)
          for t in (35, 50, 120, 530, 550, 590)],
        event("cudaLaunchKernel", 200, 201),       # a projection
        event("cudaLaunchKernel", 650, 651),
        event("cuLaunchKernel", 920, 921),         # in no backbone
    ]
    pairs = [("encode.depthwise_se", Stamp(2.0), Stamp(5.0)),
             ("encode.depthwise_se", Stamp(10.0), Stamp(14.0)),
             ("encode.backbone", Stamp(1.0), Stamp(41.0)),
             ("encode.depthwise_se", Stamp(51.0), Stamp(53.0)),
             ("encode.depthwise_se", Stamp(60.0), Stamp(62.5)),
             ("encode.backbone", Stamp(50.0), Stamp(75.0)),
             ("encode.depthwise_se", Stamp(90.0), Stamp(99.0))]
    monkeypatch.setattr(profiling, "device_spans", lambda: list(pairs))
    return Trace(events, {"decodes": 2, "batch": 64})


def test_readers(trace):
    assert read("depthwise_se_device_ms.decode", trace) == pytest.approx(4.5)
    assert read("depthwise_se_launches.decode", trace) == pytest.approx(3.0)
    least = ref.depthwise_se_bound(FULL, 64)["bound_ms"]
    assert read("depthwise_se_roofline", trace) == pytest.approx(
        100 * least / 4.5)
    assert 35 < read("depthwise_se_roofline", trace) < 40   # 1.66 of 4.5


def test_readers_find_nothing(monkeypatch):
    """A program without the spans (the parent's, or InceptionV3's), and a
    family without the bound."""
    from masters_thesis_tpu_torch.utils import profiling

    empty = Trace([event(WINDOW, 0, 1000),
                   event("span:encode.backbone", 20, 300),
                   event("cudaLaunchKernel", 70, 72)], {"batch": 64})
    monkeypatch.setattr(profiling, "device_spans", lambda: [
        ("encode.backbone", Stamp(0.0), Stamp(30.0))])
    for name in READERS:
        assert read(name, empty) is None, name
    monkeypatch.setattr(profiling, "device_spans", lambda: [
        ("encode.depthwise_se", Stamp(1.0), Stamp(2.0)),
        ("encode.backbone", Stamp(0.0), Stamp(30.0))])
    assert read("depthwise_se_device_ms.decode", empty) == pytest.approx(1.0)
    assert read("depthwise_se_roofline", empty,
                "cnn_rnn_inception_v3") is None
    assert read("depthwise_se_roofline", empty, "cnn_rnn") is None


def test_tiny_size_is_registered_from_its_own_file():
    """The tiny size lives in ``port_bench/conftest.py``, not in the
    accepted benchmark's ``tiny.py`` or ``tiny_sizes.py``, and reaches
    ``tiny.CONFIGS``; its collection hook splices the registration into
    a script like the nojax test's, right after it imports ``tiny``, once."""
    from port_bench.tests import test_port_bench_nojax

    assert CONFIG not in tiny_sizes.CONFIGS
    assert "efficientnet" not in (ROOT / "port_bench" / "tests" / "tiny.py"
                                  ).read_text()
    assert tiny.CONFIGS[CONFIG] == sizes.CONFIGS[CONFIG]
    assert tiny.STORES[CONFIG] == sizes.STORES[CONFIG]
    script = test_port_bench_nojax.RUN_TINY.replace(sizes.REGISTER, "")
    module = ModuleType("a_script_of_tiny_runs")
    module.RUN_TINY = script
    for _ in range(2):
        sizes.pytest_collection_modifyitems([SimpleNamespace(module=module)])
    assert module.RUN_TINY.count(sizes.REGISTER) == 1
    assert sizes.IMPORT_TINY + sizes.REGISTER in module.RUN_TINY
    assert tiny_config()["image_size"] == [64, 64]
    assert ref.patches(tiny_config()) == 4


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


def test_configuration_added_as_files(tmp_path):
    """Another configuration of the family (EfficientNet-B3 on 33 x 33
    images, one patch), a traffic mix, limits and a cell, added to a copy
    as files and manifest entries, run; no file that was there
    changes."""
    root = tiny.tiny_root(tmp_path)
    bench = root / "port_bench"
    before = digest(bench)
    config = json.loads((bench / "configs" / f"{CONFIG}.json").read_text())
    config.update(name="dummy_effnet", image_size=[33, 33], n_patches=4,
                  units=8, vocab_size=40)
    (bench / "configs" / "dummy_effnet.json").write_text(json.dumps(config))
    traffic_mix = json.loads((bench / "traffic" / "greedy_b64.json")
                             .read_text())
    traffic_mix.update(batch=3, in_flight=1)
    (bench / "traffic" / "greedy_b3.json").write_text(json.dumps(traffic_mix))
    shutil.copy(bench / "limits" / f"{CELL}.json",
                bench / "limits" / "dummy_effnet_eval.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_effnet", "source": "a test",
                           "file": "port_bench/configs/dummy_effnet.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy_effnet_eval",
                             "config": "dummy_effnet", "traffic": "greedy_b3",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("dummy_effnet_eval")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    result = tiny.run(root, "dummy_effnet_eval")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"captions_per_s",
                                      "caption_batch_p95_ms", "setup_s"}
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
