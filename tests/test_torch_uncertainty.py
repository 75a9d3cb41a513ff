"""The Laplace approximation, adam, ADVI and the predictor's uncertainty of
mellon_tpu_torch against mellon_tpu, on the same numpy inputs at float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
from mellon_tpu.inference import advi as jax_advi
from mellon_tpu.inference.laplace import compute_laplace_std as jax_laplace_std
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.inference.optimizers import minimize_adam as jax_minimize_adam
import mellon_tpu_torch
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference.advi import elbo_from_draws, run_advi_batch
from mellon_tpu_torch.inference.factories import compute_conditional
from mellon_tpu_torch.inference.laplace import laplace_std_from_diagonal
from mellon_tpu_torch.inference.losses import (
    density_hessian_diagonal,
    make_density_loss_batch,
    make_density_value_and_grad,
)
from mellon_tpu_torch.inference.optimizers import minimize_adam_value_and_grad


def _problem(n=200, k=40, seed=50):
    rng = np.random.RandomState(seed)
    L = rng.randn(n, k) * 0.3
    nn = np.exp(rng.randn(n) * 0.3 - 1.0)
    z = rng.randn(k) * 0.5
    return L, nn, z, 4, -2.5


def _agreement(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    spread = want.max() - want.min()
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / spread


def test_laplace_std_matches_jax():
    """The closed-form Hessian diagonal's stds against the JAX package's
    chunked Hessian-vector products: 1e-10 relative."""
    L, nn, z, d, mu = _problem()
    want = np.asarray(jax_laplace_std(
        jax_density_loss, jnp.asarray(z), loss_args=(jnp.asarray(L), jnp.asarray(nn), d, mu)
    ))
    got = laplace_std_from_diagonal(density_hessian_diagonal(t64(z), t64(L), t64(nn), d, mu))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-10)


def test_laplace_std_chunks_rows(monkeypatch):
    """The row chunks of the Hessian diagonal add up to the one-pass sum."""
    from mellon_tpu_torch.inference import losses

    L, nn, z, d, mu = _problem(n=333)
    whole = density_hessian_diagonal(t64(z), t64(L), t64(nn), d, mu)
    monkeypatch.setattr(losses, "HESSIAN_CHUNK_ROWS", 50)
    np.testing.assert_allclose(
        to_np(losses.density_hessian_diagonal(t64(z), t64(L), t64(nn), d, mu)),
        to_np(whole), rtol=1e-13,
    )


def test_adam_matches_jax():
    """50 adam steps on the density loss from the same L and z0: latents
    and the loss history to 1e-8 relative."""
    L, nn, z0, d, mu = _problem(seed=51)
    want = jax_minimize_adam(
        jax_density_loss, jnp.asarray(z0), n_iter=50,
        loss_args=(jnp.asarray(L), jnp.asarray(nn), d, mu),
    )
    got = minimize_adam_value_and_grad(make_density_value_and_grad(t64(L), t64(nn), d, mu), t64(z0), n_iter=50)
    np.testing.assert_allclose(
        to_np(got.pre_transformation), np.asarray(want.pre_transformation), rtol=1e-8, atol=1e-12
    )
    assert got.losses.shape == (50,)
    np.testing.assert_allclose(to_np(got.losses), np.asarray(want.losses), rtol=1e-8)


def test_elbo_matches_jax_on_its_draws():
    """The ELBO estimate fed JAX's own standard-normal draws (40 of them,
    from the keys elbo_estimate splits): 1e-10 relative."""
    L, nn, z, d, mu = _problem(seed=52)
    args = (jnp.asarray(L), jnp.asarray(nn), d, mu)
    log_std = np.linspace(-1.0, 0.5, z.shape[0])
    key = jax.random.PRNGKey(3)
    want = float(jax_advi.elbo_estimate(
        lambda s: -jax_density_loss(s, *args), key, jnp.asarray(z), jnp.asarray(log_std), 40
    ))
    keys = jax.random.split(key, 40)
    draws = np.asarray(jax.vmap(lambda k: jax.random.normal(k, z.shape))(keys))
    got = elbo_from_draws(
        make_density_loss_batch(t64(L), t64(nn), d, mu), t64(z), t64(log_std), t64(draws)
    )
    np.testing.assert_allclose(float(got), want, rtol=1e-10)


def test_advi_on_a_gaussian():
    """The quadratic loss of tests/test_inference.py (an exactly Gaussian
    posterior) with the tolerances used there: mean 0.2, stds 40%."""
    scales = t64([1.0, 4.0, 0.25])
    center = t64([1.0, -2.0, 3.0])

    def loss_batch(Z):
        return 0.5 * torch.sum(scales * (Z - center) ** 2, dim=1)

    res = run_advi_batch(
        loss_batch, torch.zeros(3, dtype=torch.float64), n_iter=600, init_learn_rate=0.1,
        generator=torch.Generator().manual_seed(0),
    )
    np.testing.assert_allclose(to_np(res.pre_transformation), [1.0, -2.0, 3.0], atol=0.2)
    np.testing.assert_allclose(
        to_np(res.pre_transformation_std), 1 / np.sqrt([1.0, 4.0, 0.25]), rtol=0.4
    )
    assert res.losses.shape == (600,)


def test_advi_density_within_the_seed_spread_of_jax():
    """n = 300, 40 landmarks, the JAX package's prepared L and warm start.
    torch cannot draw JAX's noise, so the port's ADVI log density is held to
    the spread of the JAX package's own: its max |Δ| from JAX's seed-0 run
    is at most twice the max |Δ| between JAX's seed-0 and seed-1 runs
    (measured on the CPU: 0.062 against 0.053, the latter 3.1% of the
    log density's spread)."""
    x = clustered(300, 3, seed=53)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40)
    jest.prepare_inference(jnp.asarray(x))
    args = (jest.L, jest.nn_distances, jest.d, jest.mu)
    runs = [
        jax_advi.run_advi(jax_density_loss, jest.initial_value, loss_args=args, seed=s)
        for s in (0, 1)
    ]
    f0, f1 = (np.asarray(jest.L @ r.pre_transformation + jest.mu) for r in runs)
    L, nn = t64(jest.L), t64(jest.nn_distances)
    res = run_advi_batch(
        make_density_loss_batch(L, nn, jest.d, jest.mu), t64(jest.initial_value),
        generator=torch.Generator().manual_seed(0),
    )
    f = to_np(L @ res.pre_transformation + jest.mu)
    assert np.isfinite(f).all() and (to_np(res.pre_transformation_std) > 0).all()
    assert np.abs(f - f0).max() <= 2 * np.abs(f1 - f0).max(), (
        np.abs(f - f0).max(), np.abs(f1 - f0).max()
    )


@pytest.fixture(scope="module")
def laplace_fit():
    """mellon_tpu's L-BFGS fit with Laplace uncertainty (n = 300, d = 3,
    40 landmarks) and new points."""
    x = clustered(300, 3, seed=54)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40, predictor_with_uncertainty=True)
    jest.fit(jnp.asarray(x))
    return x, jest, clustered(60, 3, seed=55)


def test_estimator_lbfgs_laplace_matches_jax(laplace_fit):
    """The port's own fit on the same landmarks: the log density and the
    uncertainty at new points agree to corr >= 0.99999 and max |Δ| <= 1e-3
    of the spread, the bound the L-BFGS stopping rule (tol 1e-5) leaves."""
    x, jest, x_new = laplace_fit
    est = mellon_tpu_torch.DensityEstimator(
        landmarks=np.asarray(jest.landmarks), predictor_with_uncertainty=True, **CPU64
    ).fit(x)
    pj, pt = jest.predict, est.predict
    for got, want in [
        (pt(x_new), pj(jnp.asarray(x_new))),
        (pt.uncertainty(x_new), pj.uncertainty(jnp.asarray(x_new))),
    ]:
        corr, err = _agreement(to_np(got), np.asarray(want))
        assert corr >= 0.99999 and err <= 1e-3, (corr, err)


def test_estimator_same_map_laplace_and_uncertainty(laplace_fit):
    """On the JAX package's MAP carried across by state_from_jax: the
    Laplace stds and the predictor's covariance, mean covariance and
    uncertainty (diagonal and full) agree to 1e-8 relative."""
    x, jest, x_new = laplace_fit
    est = state_from_jax(jest, **CPU64)
    std = laplace_std_from_diagonal(density_hessian_diagonal(
        est.pre_transformation, est.L, est.nn_distances, est.d, est.mu
    ))
    np.testing.assert_allclose(to_np(std), np.asarray(jest.pre_transformation_std), rtol=1e-8)
    pj, pt = jest.predict, est.predict
    xj = jnp.asarray(x_new)
    for method in ("covariance", "mean_covariance", "uncertainty"):
        for diag in (True, False):
            got = to_np(getattr(pt, method)(x_new, diag=diag))
            want = np.asarray(getattr(pj, method)(xj, diag=diag))
            assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max(), (method, diag)


def test_estimator_adam_matches_jax():
    """optimizer="adam" (100 steps, deterministic) on the same landmarks:
    the log density at the training points to 1e-8 relative."""
    x = clustered(300, 3, seed=56)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40, optimizer="adam")
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    est = mellon_tpu_torch.DensityEstimator(
        landmarks=np.asarray(jest.landmarks), optimizer="adam", **CPU64
    )
    ld = to_np(est.fit_predict(x))
    assert np.abs(ld - ld_j).max() <= 1e-8 * np.abs(ld_j).max()
    assert est.losses.shape == (100,) and est.pre_transformation_std is None


def test_estimator_advi_with_uncertainty_runs():
    """optimizer="advi" with uncertainty end to end: finite log density,
    positive stds from ADVI (not Laplace), a predictor with uncertainty,
    and the same result for the same random_state."""
    x = clustered(200, 3, seed=57)
    fits = [
        mellon_tpu_torch.DensityEstimator(
            n_landmarks=30, optimizer="advi", predictor_with_uncertainty=True, **CPU64
        ).fit(x)
        for _ in range(2)
    ]
    est = fits[0]
    assert torch.isfinite(est.log_density_x).all() and (est.pre_transformation_std > 0).all()
    assert torch.equal(est.pre_transformation, fits[1].pre_transformation)
    u = est.predict.uncertainty(clustered(20, 3, seed=58))
    assert torch.isfinite(u).all() and (u > 0).all()


def test_conditional_refuses_missing_or_double_uncertainty():
    """compute_conditional refuses a sigma beside the latents' std, and
    uncertainty without either, as the JAX package does; a predictor
    without uncertainty, or without the observation variance, says so
    when asked for it."""
    x = t64(clustered(50, 2, seed=59))
    xu, z = x[:10], t64(np.linspace(-1, 1, 10))
    cov = mellon_tpu_torch.Matern52(ls=1.0)
    with pytest.raises(ValueError, match="not both"):
        compute_conditional(x, xu, z, torch.ones(10, dtype=torch.float64), None, 0.0, cov, None,
                            sigma=0.5, y_is_mean=True, with_uncertainty=True)
    with pytest.raises(ValueError, match="No input uncertainty"):
        compute_conditional(x, xu, z, None, None, 0.0, cov, None, sigma=None,
                            y_is_mean=True, with_uncertainty=True)
    pred = compute_conditional(x, xu, z, None, None, 0.0, cov, None, y_is_mean=True)
    with pytest.raises(ValueError, match="without covariance"):
        pred.covariance(x)
    with pytest.raises(ValueError, match="without obs_variance"):
        pred.obs_variance(x)


@pytest.mark.parametrize("sigma", [0.3, "per_landmark"])
def test_conditional_from_noise_without_a_factor(sigma):
    """Without a landmark factor and with y_is_mean=False the predictor
    factorizes k(xu, xu) + diag(max(σ², jitter)) itself, for a scalar or a
    per-landmark σ, as the JAX package's class does: mean, covariance and
    mean covariance to 1e-10 relative."""
    from mellon_tpu.inference.conditionals import LandmarksConditionalCholesky as JaxLCC
    from mellon_tpu.ops.kernels import Matern52 as JaxMatern52

    rng = np.random.RandomState(61)
    xu, z, x_new = rng.randn(25, 3), rng.randn(25), rng.randn(30, 3)
    if sigma == "per_landmark":
        sigma = np.exp(rng.randn(25) * 0.3 - 1.0)
    pj = JaxLCC(jnp.asarray(xu), jnp.asarray(z), -1.5, JaxMatern52(ls=1.4), 100,
                sigma=jnp.asarray(sigma), with_uncertainty=True)
    pt = mellon_tpu_torch.LandmarksConditionalCholesky(
        t64(xu), t64(z), -1.5, mellon_tpu_torch.Matern52(ls=1.4), 100,
        sigma=t64(sigma), with_uncertainty=True,
    )
    for method in ("mean", "covariance", "mean_covariance"):
        got, want = to_np(getattr(pt, method)(x_new)), np.asarray(getattr(pj, method)(jnp.asarray(x_new)))
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), method
