"""The density loss, L-BFGS and the landmark predictor of mellon_tpu_torch
against mellon_tpu, on the same numpy inputs at float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.inference.optimizers import _run_lbfgs
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference.conditionals import LandmarksConditionalCholesky
from mellon_tpu_torch.inference.losses import (
    density_loss,
    density_value_and_grad,
    make_density_value_and_grad,
)
from mellon_tpu_torch.inference.optimizers import minimize_lbfgs
from mellon_tpu_torch.ops.kernels import Matern52


def _problem(n=200, k=40, seed=11):
    rng = np.random.RandomState(seed)
    L = rng.randn(n, k) * 0.3
    nn = np.exp(rng.randn(n) * 0.3 - 1.0)
    z = rng.randn(k) * 0.5
    return L, nn, z


@pytest.mark.parametrize("offset", [0.0, 0.37])
def test_density_loss_value_and_grad_match_jax(offset):
    """Value and analytic gradient vs jax.value_and_grad: rtol 1e-10."""
    L, nn, z = _problem()
    d, mu = 4, -2.5
    vj, gj = jax.value_and_grad(jax_density_loss)(
        jnp.asarray(z), jnp.asarray(L), jnp.asarray(nn), d, mu, offset
    )
    vt, gt = density_value_and_grad(t64(z), t64(L), t64(nn), d, mu, offset)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=1e-10, atol=1e-12)
    assert float(density_loss(t64(z), t64(L), t64(nn), d, mu, offset)) == float(vt)


def test_lbfgs_reaches_jax_optimum():
    """From the same L and z0 at tol=1e-10 both reach the unique optimum of
    the strictly convex loss: latents to 1e-6, loss to rtol 1e-10."""
    L, nn, z0 = _problem(seed=12)
    d, mu = 4, -2.5
    zj, vj, _ = _run_lbfgs(
        jax_density_loss, jnp.asarray(z0), 400, 1e-10,
        jnp.asarray(L), jnp.asarray(nn), d, mu,
    )
    res = minimize_lbfgs(
        make_density_value_and_grad(t64(L), t64(nn), d, mu), t64(z0), tol=1e-10
    )
    np.testing.assert_allclose(to_np(res.pre_transformation), np.asarray(zj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.loss, float(vj), rtol=1e-10)
    assert 0 < res.n_steps < 400 and res.n_evals >= res.n_steps


def test_lbfgs_stopping_rule_and_log(caplog):
    """The default tol=1e-5 stops once ‖g‖ < tol·max(1, |loss|), and the
    run is logged as the JAX package logs it."""
    L, nn, z0 = _problem(seed=13)
    fun = make_density_value_and_grad(t64(L), t64(nn), 4, -2.5)
    with caplog.at_level("INFO", logger="mellon_tpu_torch"):
        res = minimize_lbfgs(fun, t64(z0))
    value, grad = fun(res.pre_transformation)
    assert float(grad.norm()) < 1e-5 * max(1.0, abs(float(value)))
    assert res.converged
    assert f"L-BFGS finished after {res.n_steps} steps with loss" in caplog.text


def test_lbfgs_reports_an_unmet_tolerance():
    """A run cut by max_iter before ‖g‖ < tol·max(1, |loss|) says so."""
    L, nn, z0 = _problem(seed=13)
    res = minimize_lbfgs(make_density_value_and_grad(t64(L), t64(nn), 4, -2.5), t64(z0), max_iter=2)
    assert res.n_steps == 2 and not res.converged


def test_state_from_jax_round_trips_predictor():
    """A fitted mellon_tpu predictor brought over by state_from_jax agrees
    at new points to 1e-10, and so does the port's own predictor built
    from the same latents."""
    x = clustered(300, 3, seed=14)
    est = mellon_tpu.DensityEstimator(n_landmarks=60)
    est.fit(jnp.asarray(x))
    pj = est.predict
    x_new = clustered(50, 3, seed=15)
    want = np.asarray(pj(jnp.asarray(x_new)))

    port = state_from_jax(pj, **CPU64)
    np.testing.assert_allclose(to_np(port(x_new)), want, rtol=0, atol=1e-10)
    direct = LandmarksConditionalCholesky(
        t64(est.landmarks), t64(est.pre_transformation), est.mu,
        Matern52(ls=est.ls), x.shape[0], L=t64(est.Lp),
    )
    np.testing.assert_allclose(to_np(direct(x_new)), want, rtol=0, atol=1e-10)

    port_est = state_from_jax(est, **CPU64)
    np.testing.assert_allclose(
        to_np(port_est.log_density_x), np.asarray(est.log_density_x), rtol=0, atol=1e-10
    )
    np.testing.assert_allclose(to_np(port_est.predict(x_new)), want, rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="features"):
        port(x_new[:, :2])


def test_lbfgs_stops_where_the_line_search_finds_no_decrease(caplog):
    """A loss whose reported gradient points uphill (the value is |z|²,
    the gradient −2z): every trial step along the direction it gives
    raises the loss.  The port stops where it is and reports
    ``converged=False``; a
    deliberate divergence from optax, whose zoom line search would move to
    its last trial step anyway."""
    z0 = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def uphill(z):
        return torch.sum(z * z), -2.0 * z

    with caplog.at_level("INFO", logger="mellon_tpu_torch"):
        res = minimize_lbfgs(uphill, z0)
    assert res.n_steps == 0 and not res.converged
    torch.testing.assert_close(res.pre_transformation, z0, rtol=0, atol=0)
    assert res.loss == float(torch.sum(z0 * z0))
    assert "line search found no decrease after 0 steps" in caplog.text
