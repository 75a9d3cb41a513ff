"""The full GP type of mellon_tpu_torch against mellon_tpu: the density
model without landmarks (at most as many cells as the 5,000 default
landmarks), its factor L = chol(k(x, x)), the optimizers and the Laplace
step on it, its predictor, and d_method="fractal".  float64 is held to
the JAX package in float64, float32 to it in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, jax_x64_off, t64, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu import parameters as jp
from mellon_tpu.ops.kernels import Matern52 as JaxMatern52
from mellon_tpu_torch import parameters as tp
from mellon_tpu_torch.utils.util import GaussianProcessType

TOL = 1e-10


def _agreement(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / np.ptp(want)


def test_readme_fit_selects_full_and_matches_jax():
    """The README's first example, DensityEstimator().fit_predict on 100 x
    10 normal cells: the full GP type, the prepared state to 1e-10, the
    L-BFGS log density and the predictor to corr >= 0.99999 and max |Δ|
    <= 1e-3 of the spread."""
    x = np.random.default_rng(0).normal(size=(100, 10))
    jest = mellon_tpu.DensityEstimator()
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    est = mt.DensityEstimator(device="cpu")
    assert est.dtype == torch.float32
    est = mt.DensityEstimator(**CPU64)
    ld = est.fit_predict(x)
    assert est.gp_type == GaussianProcessType.FULL and est.landmarks is None
    assert est.L.shape == (100, 100)
    np.testing.assert_allclose(to_np(est.L), np.asarray(jest.L), rtol=0, atol=TOL)
    np.testing.assert_allclose(est.mu, jest.mu, rtol=TOL)
    corr, err = _agreement(to_np(ld), ld_j)
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)
    x_new = np.random.default_rng(1).normal(size=(20, 10))
    assert type(est.predict) is mt.FullConditional
    corr, err = _agreement(to_np(est.predict(x_new)), np.asarray(jest.predict(jnp.asarray(x_new))))
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)


def test_readme_fit_in_float32_on_the_cpu():
    """The same fit in float32 (the default dtype) against mellon_tpu in
    float32: corr >= 0.9999 and max |Δ| <= 1e-2 of the spread (float32's
    Cholesky of the 100 x 100 gram and L-BFGS's stopping rule; measured
    gap on the CPU ~1e-4)."""
    x = np.random.default_rng(0).normal(size=(100, 10)).astype(np.float32)
    with jax_x64_off():
        ld_j = np.asarray(mellon_tpu.DensityEstimator().fit_predict(jnp.asarray(x)))
    ld = mt.DensityEstimator(device="cpu").fit_predict(x)
    assert ld.dtype == torch.float32
    corr, err = _agreement(to_np(ld), ld_j)
    assert corr >= 0.9999 and err <= 1e-2, (corr, err)


@pytest.mark.parametrize("Lp_given", [False, True])
def test_compute_Lp_and_L_full(Lp_given):
    """compute_Lp and compute_L of the full type: chol(k(x, x) + jitter I)
    to 1e-10, L = Lp where Lp is given; an Lp that is not (n, n) is
    refused as in mellon_tpu."""
    x = clustered(80, 3, seed=31)
    cov_j, cov_t = JaxMatern52(ls=1.3), mt.Matern52(ls=1.3)
    Lp_j = jp.compute_Lp(jnp.asarray(x), cov_j, "full")
    Lp_t = tp.compute_Lp(t64(x), cov_t, "full")
    np.testing.assert_allclose(to_np(Lp_t), np.asarray(Lp_j), rtol=0, atol=TOL)
    L_t = tp.compute_L(t64(x), cov_t, "full", Lp=Lp_t if Lp_given else None)
    np.testing.assert_allclose(to_np(L_t), np.asarray(Lp_j), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="Wrong shape of Lp"):
        tp.compute_L(t64(x), cov_t, "full", Lp=Lp_t[:10, :10])
    with pytest.raises(ValueError, match="Wrong shape of Lp"):
        jp.compute_L(jnp.asarray(x), cov_j, "full", Lp=Lp_j[:10, :10])


@pytest.mark.parametrize("optimizer", ["L-BFGS-B", "adam"])
def test_full_fit_with_uncertainty_matches_jax(optimizer):
    """L-BFGS or adam on the full type with predictor_with_uncertainty:
    the Laplace stds (closed form on the n x n L) and the predictor's
    covariance surface at new points, against mellon_tpu on the same
    cells (L-BFGS: corr >= 0.99999 and max |Δ| <= 1e-3 of the spread;
    adam, whose steps are exact arithmetic: 1e-8 relative)."""
    x = clustered(150, 3, seed=32)
    x_new = clustered(20, 3, seed=33)
    kw = dict(predictor_with_uncertainty=True, optimizer=optimizer, n_iter=60)
    jest = mellon_tpu.DensityEstimator(**kw)
    jest.fit(jnp.asarray(x))
    est = mt.DensityEstimator(**kw, **CPU64)
    est.fit(x)
    assert est.gp_type == GaussianProcessType.FULL
    xj = jnp.asarray(x_new)
    pairs = [
        (est.pre_transformation_std, jest.pre_transformation_std),
        (est.log_density_x, jest.log_density_x),
        (est.predict(x_new), jest.predict(xj)),
        (est.predict.covariance(x_new), jest.predict.covariance(xj)),
        (est.predict.uncertainty(x_new), jest.predict.uncertainty(xj)),
    ]
    for got, want in pairs:
        if optimizer == "adam":
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-8, atol=1e-10)
        else:
            corr, err = _agreement(to_np(got), want)
            assert corr >= 0.99999 and err <= 1e-3, (corr, err)


def test_full_advi_runs():
    """ADVI on the full type's n latents: the ELBO rises and the stds are
    finite (its draws cannot be JAX's; tests/test_torch_uncertainty.py
    holds ADVI to the JAX package's seed spread)."""
    x = clustered(120, 3, seed=34)
    est = mt.DensityEstimator(optimizer="advi", n_iter=60, predictor_with_uncertainty=True, **CPU64)
    ld = est.fit_predict(x)
    elbo = -est.losses
    assert est.pre_transformation.shape == (120,)
    assert float(elbo[-10:].mean()) > float(elbo[:10].mean())
    assert torch.isfinite(ld).all() and torch.isfinite(est.pre_transformation_std).all()


def test_full_predictor_derivatives_match_jax():
    """The full conditional's gradient and Hessian at new points, on the
    same fitted state, to 1e-10 relative."""
    x = clustered(100, 3, seed=35)
    jest = mellon_tpu.DensityEstimator()
    jest.fit(jnp.asarray(x))
    est = mt.state_from_jax(jest, **CPU64)
    assert type(est.predict) is mt.FullConditional
    x_new = clustered(10, 3, seed=36)
    xj = jnp.asarray(x_new)
    np.testing.assert_allclose(to_np(est.predict(x_new)), np.asarray(jest.predict(xj)), rtol=TOL)
    np.testing.assert_allclose(
        to_np(est.predict.gradient(x_new)), np.asarray(jest.predict.gradient(xj)), rtol=1e-9, atol=TOL
    )
    np.testing.assert_allclose(
        to_np(est.predict.hessian(x_new)), np.asarray(jest.predict.hessian(xj)), rtol=1e-9, atol=TOL
    )


def test_fractal_d_matches_jax():
    """d_method="fractal" on 400 cells (under the 500-cell subsample, so
    every cell is a query): d, the fit and its predictor agree with
    mellon_tpu (d to 1e-10; the fit as the L-BFGS fits)."""
    x = clustered(400, 4, seed=37, spread=1.0)
    jest = mellon_tpu.DensityEstimator(d_method="fractal", n_landmarks=50)
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    est = mt.DensityEstimator(d_method="fractal", landmarks=np.asarray(jest.landmarks), **CPU64)
    ld = est.fit_predict(x)
    np.testing.assert_allclose(est.d, jest.d, rtol=TOL)
    assert 1.0 < est.d < 4.5
    corr, err = _agreement(to_np(ld), ld_j)
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)
    assert est.predict.d_method == "fractal"


def test_fractal_d_subsamples_large_inputs():
    """Above 500 cells the fractal d is the mean over 500 query cells drawn
    by a seeded torch generator: the same on every call, and near the
    mean over all cells."""
    x = t64(clustered(900, 3, seed=38, spread=1.0))
    d1, d2 = tp.compute_d_factal(x), tp.compute_d_factal(x)
    assert d1 == d2
    d_all = tp.compute_d_factal(x, n=900)
    assert abs(d1 - d_all) <= 0.1 * d_all
