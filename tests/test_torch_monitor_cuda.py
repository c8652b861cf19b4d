"""``utils/monitor.py`` on the card: the stats of a CUDA device under
PJRT's key names, read from ``torch.cuda`` (marker ``cuda``: skips without
a card). No JAX here: the card's machine has none."""

import pytest
import torch

from masters_thesis_tpu_torch.utils import monitor


@pytest.mark.cuda
def test_cuda_stats_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.reset_peak_memory_stats()
    x = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    stats = monitor.device_memory_stats()
    assert stats["bytes_in_use"] >= x.numel()
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert 0.0 < monitor.memory_fraction_used() < 1.0
