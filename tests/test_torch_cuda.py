"""Tests of mellon_tpu_torch that need an NVIDIA GPU.

They skip without one.  This file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import mellon_tpu_torch
from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU route)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape",
    [(5000, 5000, 20), (8627, 2048, 20), (1000, 2048, 20), (1000, 333, 7), (65535 * 64 + 5, 3, 2)],
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_matern52_kernel_matches_reference(cuda, shape, dtype, tol):
    """The CUDA tile vs its plain version on the card, at the benchmark
    fit's shapes (K_uu, then C and the predictor against the 2,048 kept
    landmarks), a ragged one, and one with more row tiles than grid.y
    could hold: f32 1e-5 (tests/test_ops.py's bar), f64 1e-12."""
    n, m, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, d, device=cuda, dtype=dtype, generator=g)
    y = torch.randn(m, d, device=cuda, dtype=dtype, generator=g)
    before = matern52_gram.launches
    K = matern52_gram(x, y, 3.1)
    torch.cuda.synchronize()
    assert matern52_gram.launches == before + 1
    assert (K - matern52_gram_reference(x, y, 3.1)).abs().max().item() <= tol


def test_small_fit_on_card_matches_cpu(cuda):
    """The same float64 fit with fixed landmarks on the card (kernel route)
    and on the CPU (plain route).  Rounding differs between the devices,
    so the optimizers stop at different points inside their tolerance:
    corr >= 0.99999 and max |Δ| <= 1e-3 of the spread."""
    rng = np.random.RandomState(26)
    x = rng.randn(2000, 10) * np.exp(-0.15 * np.arange(10))
    xu = x[::10]
    lds = []
    for device in ("cpu", cuda):
        est = mellon_tpu_torch.DensityEstimator(landmarks=xu, device=device, dtype=torch.float64)
        lds.append(est.fit_predict(x).cpu().numpy())
    spread = lds[0].max() - lds[0].min()
    assert np.corrcoef(lds[0], lds[1])[0, 1] >= 0.99999
    assert np.abs(lds[0] - lds[1]).max() <= 1e-3 * spread
