"""Offline preprocessing of betas: session ingestion, z-scoring and repeat
averaging, Glasser groups, the visual-cortex mask and PCA (the port's
counterpart of ``masters_thesis_tpu/data/preprocess``)."""

from masters_thesis_tpu_torch.data.preprocess.zscore import (
    average_over_repeats,
    session_zscore,
    voxelwise_stats,
)
from masters_thesis_tpu_torch.data.preprocess.glasser import (
    groups_from_atlas,
    load_atlas_vector,
    visual_cortex_mask,
)
from masters_thesis_tpu_torch.data.preprocess.pca import PCAModel, fit_pca

__all__ = [
    "average_over_repeats",
    "session_zscore",
    "voxelwise_stats",
    "groups_from_atlas",
    "load_atlas_vector",
    "visual_cortex_mask",
    "PCAModel",
    "fit_pca",
]
