from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.encoders import PatchDense
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.lstm import KerasGRUCell, KerasLSTMCell
from masters_thesis_tpu_torch.models.nic import NIC, CnnRnnNIC, LcNIC

__all__ = ["BahdanauAttention", "CnnRnnNIC", "KerasGRUCell", "KerasLSTMCell",
           "LcNIC", "LocallyDense", "NIC", "PatchDense"]
