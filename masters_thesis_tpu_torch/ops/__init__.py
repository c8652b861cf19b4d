from masters_thesis_tpu_torch.ops.group_layout import GroupLayout

__all__ = ["GroupLayout"]
