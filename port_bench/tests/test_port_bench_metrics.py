"""The per-layer metric readers on a small canned trace, against values
worked out by hand."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench.harness.bench import ROOT, load_module, read_json
from port_bench.harness.trace import WINDOW, Trace
from port_bench.reference import cnn_rnn, lc_nic

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def event(name, start, end, device=CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.fixture(scope="module")
def trace():
    events = [
        event(WINDOW, 0, 1000),
        event("span:traced_window", 0, 1000, CUDA),    # a host range's shadow
        event("void (anonymous namespace)::gather_rows_kernel<uint4, long>",
              100, 180, CUDA),
        event("void (anonymous namespace)::tile_kernel<1, 32>", 300, 350,
              CUDA),
        event("void (anonymous namespace)::attention_kernel<false>", 340,
              420, CUDA),
        event("sm80_xmma_gemm_f32f32", 500, 600, CUDA),
        # the tile step's TMA feed, a kernel of K2 and K3 alike
        event("void (anonymous namespace)::tile_kernel_tma<4, 64, 2>", 700,
              730, CUDA),
        event("cudaLaunchKernel", 90, 95), event("cudaLaunchKernel", 290, 295),
        event("cuLaunchKernel", 330, 335), event("cudaLaunchKernel", 490, 495),
        event("cudaLaunchKernel", 1100, 1105),          # after the window
        event("span:enqueue", 0, 450), event("aten::einsum", 410, 480),
    ]
    return Trace(events, {"steps": 2, "batch": 64, "decodes": 1,
                          "samples_per_s": 1000.0, "captions_per_s": 1000.0,
                          "host_ms_per_batch": 1.5})


def read(name, trace, config):
    bench = SimpleNamespace(config=read_json("configs", config))
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py").read(
        trace, bench)


def test_trace_reductions(trace):
    assert trace.window_s == pytest.approx(1e-3)
    assert trace.busy_s() == pytest.approx(330e-6)
    assert trace.launch_count() == 4
    gaps = trace.idle_gaps()
    assert [round(s * 1e6) for _, s in gaps] == [270, 120, 100, 100, 80]
    assert [name for name, _ in gaps] == [
        "no host operation", "span:enqueue", "no host operation",
        "span:enqueue", "aten::einsum"]
    assert trace.top_device_ops(2)[0][1] == pytest.approx(100e-6)


@pytest.mark.parametrize("name,config,want", [
    ("device_idle_share.train", "lcnic_flagship", 67.0),
    ("device_idle_share.decode", "cnn_rnn", 67.0),
    ("host_launches_per_step.train", "lcnic_flagship", 2.0),
    ("host_ms_per_batch.decode", "cnn_rnn", 1.5),
    # 64 rows of 472,576 fp32 read and written at 3.35 TB/s: 72.2265 us
    ("k1_roofline.train", "lcnic_flagship", 100 * 72.22654 / 80),
    # 6.9378 GFLOP at 67 TFLOP/s: 103.549 us over 160 us of K2's kernels,
    # both tile feeds in
    ("k2_roofline", "lcnic_flagship", 100 * 103.54932 / 160),
    # K3's patterns take the same three kernels, not K1's gather: 160 us
    ("k3_roofline", "cnn_rnn", 100 * 112.34533 / 160),
    ("mfu.train", "lcnic_flagship",
     100 * lc_nic.train_flops_per_sample(
         read_json("configs", "lcnic_flagship")) * 1000 / 67e12),
    ("mfu.decode", "cnn_rnn", 100 * cnn_rnn.caption_flops(
        read_json("configs", "cnn_rnn")) * 1000 / 67e12),
])
def test_reader(trace, name, config, want):
    assert read(name, trace, config) == pytest.approx(want, rel=1e-5)


def test_reader_finds_nothing():
    empty = Trace([event(WINDOW, 0, 1000)], {"steps": 1, "batch": 64,
                                             "decodes": 1})
    for name, config in (("k1_roofline.train", "lcnic_flagship"),
                         ("k2_roofline", "lcnic_flagship"),
                         ("k3_roofline", "cnn_rnn"),
                         ("host_launches_per_step.train", "lcnic_flagship"),
                         ("device_idle_share.train", "lcnic_flagship")):
        assert read(name, empty, config) is None
