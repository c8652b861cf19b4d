"""The PCA fit on the card (``data.preprocess.pca.fit_pca``, ROADMAP F7).

On an H100, ``torch.linalg.svd`` of a float32 matrix runs cuSOLVER's fp32
Jacobi driver, which left the components of a 5,000-component fit
orthonormal only to 2.95e-03; the fit's core SVD is float64 on every device
since. These tests hold that on the card: the components orthonormal within
1e-4 at a small shape where an fp32 core misses it (1,500 x 3,000 -> 500),
with the fp32 core as the control that shows the shape still does (both
errors are printed); and the
card's fit within 1e-4 of the CPU's, up to sign, on ``chip_smoke.py``'s
rank-256 test matrix. Each needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pca_cuda.py
"""

import numpy as np
import pytest
import torch

from masters_thesis_tpu_torch.data.preprocess.pca import fit_pca

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fit runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _orthonormality(model) -> float:
    comps = torch.from_numpy(model.components).double()
    return float((comps @ comps.T - torch.eye(len(comps),
                                              dtype=torch.float64))
                 .abs().max())


def test_card_fit_is_orthonormal_where_an_fp32_core_is_not(cuda,
                                                           monkeypatch):
    n, v, k = 1_500, 3_000, 500
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, v, generator=gen, device=cuda)
    err = _orthonormality(fit_pca(x.clone(), k, device=cuda))
    svd = torch.linalg.svd
    monkeypatch.setattr(torch.linalg, "svd",
                        lambda a, *args, **kw: svd(a.float(), *args, **kw))
    control = _orthonormality(fit_pca(x, k, device=cuda))
    print(f"|C C^T - I| max at {n} x {v} -> {k}: {err:.3e} (float64 core), "
          f"{control:.3e} (fp32 core)")
    assert err <= TOL, err
    assert control > TOL, (f"the fp32 core is orthonormal to {control:.2e} "
                           f"here: the shape no longer shows F7")


def test_card_fit_follows_the_cpu_fit(cuda):
    """Rank 256, singular values 100 - 0.25 i, well apart and above the
    noise, so that each component is determined to fp32 rounding over its
    gap; 2,000 rows of the reference's 62,756 visual vertices."""
    n, v, k = 2_000, 62_756, 256
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.linalg.qr(torch.randn(n, k, generator=gen, device=cuda))[0]
    w = torch.linalg.qr(torch.randn(v, k, generator=gen, device=cuda))[0]
    spec = 100.0 - 0.25 * torch.arange(k, device=cuda)
    x = (u * spec) @ w.T + 1e-3 * torch.randn(n, v, generator=gen,
                                              device=cuda)
    del u, w
    want = fit_pca(x.cpu(), k, device="cpu")
    got = fit_pca(x, k, device=cuda)
    sign = np.sign((got.components * want.components).sum(axis=1))
    assert np.abs(got.components * sign[:, None]
                  - want.components).max() <= TOL
    assert np.abs(got.explained_variance / want.explained_variance
                  - 1).max() <= TOL
    assert np.abs(got.mean - want.mean).max() <= TOL
