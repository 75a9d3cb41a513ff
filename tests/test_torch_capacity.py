"""Full-capacity landmarks (``config.PRUNE_SINGULAR_LANDMARKS = False``)
and the float64 whitening (``config.EXTENDED_PRECISION_WHITEN``) of
mellon_tpu_torch against mellon_tpu and against an all-float64
construction of L.  The flags are restored after each test."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import clustered, jax_x64_off, to_np
import mellon_tpu
import mellon_tpu.config as jax_config
import mellon_tpu_torch as mt
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks
from mellon_tpu_torch import config
from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

CPU32 = dict(device="cpu", dtype=torch.float32)


@pytest.fixture
def flags():
    """Set both packages' flags inside the test, restored after it."""
    saved = [(m, m.PRUNE_SINGULAR_LANDMARKS, m.EXTENDED_PRECISION_WHITEN)
             for m in (config, jax_config)]

    def set_flags(prune, whiten=True):
        for m in (config, jax_config):
            m.PRUNE_SINGULAR_LANDMARKS, m.EXTENDED_PRECISION_WHITEN = prune, whiten

    yield set_flags
    for m, prune, whiten in saved:
        m.PRUNE_SINGULAR_LANDMARKS, m.EXTENDED_PRECISION_WHITEN = prune, whiten


def test_flags_default_as_in_jax():
    assert config.PRUNE_SINGULAR_LANDMARKS is True and config.EXTENDED_PRECISION_WHITEN is True
    assert jax_config.PRUNE_SINGULAR_LANDMARKS == config.PRUNE_SINGULAR_LANDMARKS
    assert jax_config.EXTENDED_PRECISION_WHITEN == config.EXTENDED_PRECISION_WHITEN


def _singular_kernel():
    """tests/test_fused_prepare.py's test_no_prune_config_keeps_all_landmarks
    matrix: a near-all-ones kernel, singular at float32 and factorizable
    at float64 with jitter, and a failed Cholesky attempt."""
    m = 60
    rs = np.random.RandomState(2)
    xu = np.asarray(rs.randn(m, 3), np.float32)
    K = np.asarray(np.ones((m, m)) + 1e-5 * (rs.randn(m, 3) @ rs.randn(3, m)), np.float32)
    K = 0.5 * (K + K.T)
    return xu, K, np.full((m, m), np.nan, dtype=np.float32)


def test_no_prune_config_keeps_all_landmarks(flags, caplog):
    """The JAX test's matrix through both packages' hook with pruning
    off: every landmark kept, the "pruning disabled" warning, a finite
    float32 Lp; the float64 factor equal to JAX's host-float64 one (1e-12
    relative) and Lp to JAX's float32 cast (1e-6 relative)."""
    flags(prune=False)
    xu, K, L_failed = _singular_kernel()
    m = xu.shape[0]
    jest = mellon_tpu.DensityEstimator(n_landmarks=m)
    jest.landmarks = jnp.asarray(xu)
    Lp_j = jest._lp_accept_or_prune(jnp.asarray(K), jnp.asarray(L_failed), False)

    est = mt.DensityEstimator(n_landmarks=m, **CPU32)
    est.landmarks = torch.as_tensor(xu)
    logger = logging.getLogger("mellon_tpu_torch")
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        logger.propagate, was = True, logger.propagate
        try:
            Lp = est._lp_accept_or_prune(torch.as_tensor(K), torch.as_tensor(L_failed), False)
        finally:
            logger.propagate = was
    assert any("pruning disabled" in r.message for r in caplog.records)
    assert Lp.shape == (m, m) and Lp.dtype == torch.float32 and torch.isfinite(Lp).all()
    assert est.landmarks.shape[0] == m
    scale = np.abs(np.asarray(jest._hostf64_Lp)).max()
    np.testing.assert_allclose(to_np(est._f64_Lp), np.asarray(jest._hostf64_Lp),
                               rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(to_np(Lp), np.asarray(Lp_j), rtol=0, atol=1e-6 * scale)


def test_pruning_stays_the_default(flags):
    """With the flag on, the same hook prunes to the pivoted subset, as
    the JAX package's does."""
    flags(prune=True)
    xu, K, L_failed = _singular_kernel()
    jest = mellon_tpu.DensityEstimator(n_landmarks=60)
    jest.landmarks = jnp.asarray(xu)
    jest._lp_accept_or_prune(jnp.asarray(K), jnp.asarray(L_failed), False)
    est = mt.DensityEstimator(n_landmarks=60, **CPU32)
    est.landmarks = torch.as_tensor(xu)
    est._lp_accept_or_prune(torch.as_tensor(K), torch.as_tensor(L_failed), False)
    assert est._f64_Lp is None
    assert est.landmarks.shape[0] == jest.landmarks.shape[0] < 60


@pytest.fixture(scope="module")
def singular_case():
    """test_torch_slice's float32-singular case: 1,500 cells at d = 10 and
    400 k-means landmarks whose float32 gram does not factor."""
    x = clustered(1500, 10, seed=23, n_clusters=6, spread=1.0).astype(np.float32)
    with jax_x64_off():
        xu = np.asarray(jax_compute_landmarks(jnp.asarray(x), n_landmarks=400, random_state=42))
    return x, xu


def _float64_L(est, x):
    """L in float64 from the plain kernel, an unescalated Cholesky of
    K_uu + jitter·I and a triangular solve."""
    x64 = torch.as_tensor(x, dtype=torch.float64)
    xu = est.landmarks.double()
    K = matern52_gram_reference(xu, xu, est.ls)
    Lp = torch.linalg.cholesky(K + est.jitter * torch.eye(K.shape[0], dtype=torch.float64))
    return torch.linalg.solve_triangular(Lp.T, matern52_gram_reference(x64, xu, est.ls),
                                         upper=True, left=False)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))


def test_full_capacity_matches_float64_construction_and_jax(flags, singular_case):
    """A float32 fit with pruning off keeps all 400 landmarks: L equals
    the all-float64 construction to a relative RMS of 1e-6 (the float32
    cast), and the JAX package's (its double-single whitening, x64 off) to
    1e-6 too; the log densities agree to corr >= 0.9999."""
    flags(prune=False, whiten=True)
    x, xu = singular_case
    est = mt.DensityEstimator(landmarks=xu, **CPU32)
    ld = to_np(est.fit_predict(x))
    assert est.landmarks.shape[0] == 400 and est._f64_Lp is not None
    assert est.L.dtype == torch.float32 and np.isfinite(ld).all()
    assert _rel_rms(to_np(est.L), to_np(_float64_L(est, x))) <= 1e-6
    with jax_x64_off():
        jest = mellon_tpu.DensityEstimator(landmarks=jnp.asarray(xu))
        ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    assert jest.landmarks.shape[0] == 400
    assert _rel_rms(to_np(est.L), np.asarray(jest.L)) <= 1e-6
    assert np.corrcoef(ld, ld_j)[0, 1] >= 0.9999


def test_float32_whitening_against_the_float64_factor(flags, singular_case):
    """EXTENDED_PRECISION_WHITEN off: the float32 kernel and solve against
    the float32 cast of the float64 factor, as the JAX package's plain
    TRSM; every landmark kept, L finite, and farther from the float64
    construction than the float64 whitening (which sits at the cast)."""
    flags(prune=False, whiten=False)
    x, xu = singular_case
    est = mt.DensityEstimator(landmarks=xu, **CPU32)
    ld = est.fit_predict(x)
    assert est.landmarks.shape[0] == 400 and torch.isfinite(ld).all()
    gap = _rel_rms(to_np(est.L), to_np(_float64_L(est, x)))
    assert 1e-6 < gap < 1.0
