from masters_thesis_tpu_torch.models.attention import BahdanauAttention
from masters_thesis_tpu_torch.models.encoders import (
    ConcatLocallyDense,
    DeepLocallyDense,
    FullyConnectedEncoder,
    PatchDense,
)
from masters_thesis_tpu_torch.models.locally_dense import LocallyDense
from masters_thesis_tpu_torch.models.lstm import KerasGRUCell, KerasLSTMCell
from masters_thesis_tpu_torch.models.multisubject import (
    DualSubjectEncoder,
    Ms2NIC,
)
from masters_thesis_tpu_torch.models.nic import (
    NIC,
    CnnRnnNIC,
    GloveNIC,
    ImgNIC,
    LcNIC,
)
from masters_thesis_tpu_torch.models.showtell import GuseNIC, ShowTell

__all__ = ["BahdanauAttention", "CnnRnnNIC", "ConcatLocallyDense",
           "DeepLocallyDense", "DualSubjectEncoder", "FullyConnectedEncoder",
           "GloveNIC", "GuseNIC", "ImgNIC", "KerasGRUCell", "KerasLSTMCell",
           "LcNIC", "LocallyDense", "Ms2NIC", "NIC", "PatchDense", "ShowTell"]
