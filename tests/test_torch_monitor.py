"""The port's ``utils/monitor.py`` (``torch.cuda``) against the JAX
package's (PJRT memory stats), on the CPU: a CPU device has no stats in
either, so the fraction is 0.0 and the wait returns at once; the card's
stats carry PJRT's key names, read here through stand-ins for the three
``torch.cuda`` calls (on the card from the card itself:
``tests/test_torch_monitor_cuda.py``)."""

import jax
import pytest
import torch

from masters_thesis_tpu.utils import monitor as jmonitor
from masters_thesis_tpu_torch.utils import monitor

from torch_threads import one_thread  # noqa: F401


def test_cpu_device_has_no_stats_as_in_jax():
    cpu = jax.devices("cpu")[0]
    assert monitor.device_memory_stats("cpu") == {} == \
        jmonitor.device_memory_stats(cpu)
    assert monitor.memory_fraction_used("cpu") == 0.0 == \
        jmonitor.memory_fraction_used(cpu)


@pytest.mark.parametrize("max_fraction,timeout_s,want", [
    (0.5, 1.0, True), (0.0, 1.0, True), (-1.0, 0.0, False)])
def test_wait_for_device_on_the_cpu_as_in_jax(max_fraction, timeout_s, want):
    kw = dict(max_fraction=max_fraction, wait_s=0.0, timeout_s=timeout_s)
    assert monitor.wait_for_device(device="cpu", **kw) is want
    assert jmonitor.wait_for_device(device=jax.devices("cpu")[0],
                                    **kw) is want


@pytest.fixture()
def fake_card(monkeypatch):
    """torch.cuda's three memory readings, as a card would give them."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (60 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 20 << 30)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 30 << 30)


def test_cuda_stats_carry_the_pjrt_keys(fake_card):
    stats = monitor.device_memory_stats("cuda:0")
    assert stats == {"bytes_in_use": 20 << 30,
                     "peak_bytes_in_use": 30 << 30,
                     "bytes_limit": 80 << 30}
    assert monitor.memory_fraction_used("cuda") == 0.25
    assert monitor.wait_for_device(0.3, wait_s=0.0, timeout_s=1.0,
                                   device="cuda")
    assert not monitor.wait_for_device(0.2, wait_s=0.0, timeout_s=0.0,
                                       device="cuda")
