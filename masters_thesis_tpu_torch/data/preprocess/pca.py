"""PCA / randomized-SVD dimensionality reduction of betas, in PyTorch.

Reference (ThinkAndTell/SVD/svd.py:64-93): sklearn PCA(n_components=5000,
svd_solver='randomized') fit on the unique-trial split, then applied to all
splits. Counterpart of ``masters_thesis_tpu/data/preprocess/pca.py``: the
same ``PCAModel`` (its ``.npz`` keys, and ``transform`` as numpy for the
transform chain's replay) and the same recipe (Halko et al.'s randomized
range finder with power iterations, then the SVD of the projected matrix,
here taken through the QR of its transpose), run by ``fit_pca`` with
``torch.linalg`` on ``device`` (by default ``cuda``; cuSOLVER's QR and SVD
and cuBLAS's products on the card).

There is no fallback: a fit runs on the device it is given or raises. The
Gaussian test matrix is drawn from ``np.random.default_rng(seed)`` exactly
as the JAX package's numpy fit (``use_jax=False``) draws it, on every
device, so a fit is a function of the rows and the seed alone, and a fit on
the CPU follows that numpy fit to float tolerance (QR and SVD signs aside).
``projector`` gives ``PCAModel.transform`` on a device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from masters_thesis_tpu_torch.data.store import upload_rows
from masters_thesis_tpu_torch.device import resolve_device


@dataclass
class PCAModel:
    mean: np.ndarray          # (V,)
    components: np.ndarray    # (k, V)
    explained_variance: np.ndarray  # (k,)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) - self.mean) @ self.components.T

    def inverse_transform(self, z: np.ndarray) -> np.ndarray:
        return np.asarray(z) @ self.components + self.mean

    def save(self, path: str) -> None:
        np.savez(
            path, mean=self.mean, components=self.components,
            explained_variance=self.explained_variance,
        )

    @classmethod
    def load(cls, path: str) -> "PCAModel":
        z = np.load(path)
        return cls(z["mean"], z["components"], z["explained_variance"])


def fit_pca(x, n_components: int, n_oversample: int = 10, n_iter: int = 4,
            seed: int = 0, device=None) -> PCAModel:
    """Randomized PCA (Halko) of the (N, V) rows ``x`` (numpy, or a tensor)
    on ``device`` (by default ``cuda``): range-find with ``n_iter`` power
    iterations over ``n_components + n_oversample`` columns, then the SVD
    of the projected matrix, in float32 but for the SVD of its small
    triangular factor.

    The fit never holds both the rows and the centred rows: numpy rows
    are copied to the device once and centred there; a float32 tensor
    already on the device is centred IN PLACE (the caller's rows are
    consumed), any other tensor is copied first."""
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        xc = x.to(device, torch.float32)
    else:
        xc = upload_rows(x, device, torch.float32)
    n, v = xc.shape
    k = min(n_components, n, v)
    mean = xc.mean(dim=0)
    xc.sub_(mean)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(
        (v, min(k + n_oversample, n))).astype(np.float32)).to(device)
    y = xc @ q
    del q
    for _ in range(n_iter):
        y, _ = torch.linalg.qr(y)
        y = xc @ (xc.T @ y)
    qy, _ = torch.linalg.qr(y)
    del y
    b = qy.T @ xc                      # (k + p, V)
    del qy, xc
    # the SVD of the wide b through the QR of its transpose: b = R^T Q^T,
    # and R^T = U S W^T gives b = U S (Q W)^T, so the right singular
    # vectors are W^T Q^T. The (k + p)^2 SVD runs in float64: with
    # cuSOLVER's default fp32 Jacobi SVD the components came out
    # orthonormal only to 3e-3 at k = 5,000 on an H100 (chip_smoke.py)
    qb, r = torch.linalg.qr(b.T)
    del b
    _, s, wt = torch.linalg.svd(r.T.double())
    comps = wt[:k].float() @ qb.T
    s = s.float()
    ev = (s[:k] ** 2) / max(n - 1, 1)
    return PCAModel(mean.cpu().numpy(), comps.cpu().numpy(),
                    ev.cpu().numpy())


def projector(model: PCAModel, device=None):
    """``model.transform`` on ``device`` (by default ``cuda``): returns
    ``fn(rows) -> (N, k) float32 host array`` that centres the (N, V)
    float32 rows and projects them onto the components, which go to the
    device once, here."""
    device = resolve_device(device)
    mean = torch.from_numpy(np.asarray(model.mean, np.float32)).to(device)
    comps_t = torch.from_numpy(
        np.asarray(model.components, np.float32)).to(device).T

    def fn(rows) -> np.ndarray:
        x = torch.from_numpy(np.require(rows, np.float32, ("C", "W")))
        return ((x.to(device) - mean) @ comps_t).cpu().numpy()
    return fn
