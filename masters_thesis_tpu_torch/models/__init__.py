from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.lstm import KerasLSTMCell
from masters_thesis_tpu_torch.models.nic import NIC, LcNIC

__all__ = ["BahdanauAttention", "KerasLSTMCell", "LcNIC", "LocallyDense", "NIC"]
