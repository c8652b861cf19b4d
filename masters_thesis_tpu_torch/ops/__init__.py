# the bucketed group layout is framework-free: shared with the JAX package
from masters_thesis_tpu.ops.group_layout import GroupLayout

__all__ = ["GroupLayout"]
