"""The density loss, L-BFGS and the landmark predictor of mellon_tpu_torch
against mellon_tpu, on the same numpy inputs at float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
import mellon_tpu_torch
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.inference.optimizers import _run_lbfgs
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference.conditionals import LandmarksConditionalCholesky
from mellon_tpu_torch.inference.losses import (
    density_loss,
    density_value_and_grad,
    make_density_value_and_grad,
)
from mellon_tpu_torch.inference.optimizers import minimize_lbfgs_value_and_grad
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
    res = minimize_lbfgs_value_and_grad(
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
        res = minimize_lbfgs_value_and_grad(fun, t64(z0))
    value, grad = fun(res.pre_transformation)
    assert float(grad.norm()) < 1e-5 * max(1.0, abs(float(value)))
    assert res.converged
    assert f"L-BFGS finished after {res.n_steps} steps with loss" in caplog.text


def test_lbfgs_reports_an_unmet_tolerance():
    """A run cut by max_iter before ‖g‖ < tol·max(1, |loss|) says so."""
    L, nn, z0 = _problem(seed=13)
    res = minimize_lbfgs_value_and_grad(make_density_value_and_grad(t64(L), t64(nn), 4, -2.5), t64(z0), max_iter=2)
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
        res = minimize_lbfgs_value_and_grad(uphill, z0)
    assert res.n_steps == 0 and not res.converged
    torch.testing.assert_close(res.pre_transformation, z0, rtol=0, atol=0)
    assert res.loss == float(torch.sum(z0 * z0))
    assert "line search found no decrease after 0 steps" in caplog.text


# ---------------------------------------------------------------------------
# the two-phase precision="bf16" MAP (tests/test_inference.py:150, 179 and
# tests/test_density_estimator.py:296 of the JAX package)
# ---------------------------------------------------------------------------


def _bf16_problem():
    """tests/test_inference.py's bf16 problem, from a numpy seed: L (500,
    32) float32, 1-NN distances, d = 5, mu = -3."""
    rng = np.random.RandomState(12)
    L = (rng.randn(500, 32) / np.sqrt(32)).astype(np.float32)
    nn = (0.05 + 0.3 * rng.rand(500)).astype(np.float32)
    return L, nn, 5.0, -3.0


def test_bf16_operands_round_like_jax():
    """bfloat16 storage of the 2-d float32 operands, round to nearest even:
    the port's values equal JAX's astype(bfloat16) bit for bit; 1-d and
    float64 operands stay as they are."""
    from mellon_tpu_torch.inference.optimizers import bf16_operands

    L, nn, d, mu = _bf16_problem()
    L = L * 1.0001  # off the bf16 grid
    got = bf16_operands((torch.as_tensor(L), torch.as_tensor(nn), d, mu, torch.zeros(2, 2).double()))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got[4].dtype == torch.float64 and got[2:4] == (d, mu)
    want = np.asarray(jnp.asarray(L).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[0].float().numpy(), want)


def test_bf16_loss_reads_l_in_row_blocks(monkeypatch):
    """With L in bfloat16 the loss and gradient upcast L block by block:
    equal (1e-6 relative, float32 sums in another order) to the same
    function with L read in one block, for blocks smaller than L.  (The
    bf16 function itself, z and Lᵀ(1 − e) rounded to bfloat16 as the JAX
    package rounds them, is held to JAX in test_torch_bf16_sampling.py;
    it is not the float32 function on the upcast matrix.)"""
    from mellon_tpu_torch.inference import losses

    L, nn, d, mu = _bf16_problem()
    L16 = torch.as_tensor(L).to(torch.bfloat16)
    z = torch.as_tensor(np.random.RandomState(1).randn(32).astype(np.float32))
    assert L16.shape[0] <= losses.BF16_CHUNK_ROWS
    want = losses.make_density_value_and_grad(L16, torch.as_tensor(nn), d, mu)(z)
    monkeypatch.setattr(losses, "BF16_CHUNK_ROWS", 64)
    got = losses.make_density_value_and_grad(L16, torch.as_tensor(nn), d, mu)(z)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), rtol=1e-5, atol=1e-5)


def test_lbfgs_bf16_two_phase_matches_jax():
    """precision="bf16" on the density loss with float32 operands, both
    packages in float32: 300 bf16 + 100 float32 steps at most; the loss
    within 1e-3 of the single-phase float32 optimum and f = L z within
    corr 0.999 of it (the JAX test's bars), and the port's two-phase
    optimum within corr 0.9999 of JAX's; an unknown precision raises."""
    from mellon_tpu.inference.optimizers import minimize_lbfgsb

    from _torch_parity import jax_x64_off

    L, nn, d, mu = _bf16_problem()
    args = (torch.as_tensor(L), torch.as_tensor(nn), d, mu)
    z0 = torch.zeros(32)
    f32 = minimize_lbfgs_value_and_grad(make_density_value_and_grad(*args), z0)
    bf16 = minimize_lbfgs_value_and_grad(make_density_value_and_grad(*args), z0, precision="bf16",
                          make_value_and_grad=make_density_value_and_grad, loss_args=args)
    assert bf16.phase_steps is not None and bf16.n_steps == sum(bf16.phase_steps)
    assert bf16.phase_steps[0] <= 300 and bf16.phase_steps[1] <= 100
    assert abs(bf16.loss - f32.loss) < 1e-3 * abs(f32.loss)
    f_a, f_b = L @ to_np(f32.pre_transformation), L @ to_np(bf16.pre_transformation)
    assert np.corrcoef(f_a, f_b)[0, 1] > 0.999
    with jax_x64_off():
        jargs = (jnp.asarray(L), jnp.asarray(nn), d, mu)
        jres = minimize_lbfgsb(jax_density_loss, jnp.zeros(32, jnp.float32), loss_args=jargs,
                               precision="bf16")
    assert np.corrcoef(f_b, L @ np.asarray(jres.pre_transformation))[0, 1] > 0.9999
    with pytest.raises(ValueError, match="precision"):
        minimize_lbfgs_value_and_grad(make_density_value_and_grad(*args), z0, precision="int8",
                       make_value_and_grad=make_density_value_and_grad, loss_args=args)


def test_lbfgs_bf16_without_loss_args_falls_back(caplog):
    """precision="bf16" with a closure (no threaded operands) runs the
    single float32 phase and says so, as the JAX package does."""
    import logging

    def value_and_grad(z):
        return torch.sum((z - 3.0) ** 2), 2 * (z - 3.0)

    logger = logging.getLogger("mellon_tpu_torch")
    logger.propagate, was = True, logger.propagate
    try:
        with caplog.at_level(logging.INFO, logger="mellon_tpu_torch"):
            res = minimize_lbfgs_value_and_grad(value_and_grad, torch.zeros(4, dtype=torch.float64),
                                 precision="bf16")
    finally:
        logger.propagate = was
    assert any("no effect without operand-threaded" in r.message for r in caplog.records)
    assert res.phase_steps is None
    np.testing.assert_allclose(to_np(res.pre_transformation), np.full(4, 3.0), atol=1e-4)


def test_bf16_density_estimator_close_to_float32_and_jax(monkeypatch):
    """DensityEstimator(n_landmarks=50, precision="bf16") in float32 on
    JAX's landmarks: the coarse phase's L operand is bfloat16, corr >
    0.999 and std(Δ)/std < 0.05 against the float32 fit
    (tests/test_density_estimator.py:296's bars), and corr > 0.99999
    against JAX's bf16 fit; precision="fp8" raises ValueError in both
    packages."""
    from _torch_parity import jax_x64_off
    from mellon_tpu_torch.inference import optimizers

    coarse_operands = []
    cast = optimizers.bf16_operands

    def recording(loss_args):
        coarse_operands.append(cast(loss_args))
        return coarse_operands[-1]

    monkeypatch.setattr(optimizers, "bf16_operands", recording)

    x = clustered(600, 4, seed=13).astype(np.float32)
    with jax_x64_off():
        jest = mellon_tpu.DensityEstimator(n_landmarks=50, precision="bf16")
        ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
        landmarks = np.asarray(jest.landmarks)
    CPU32 = dict(device="cpu", dtype=torch.float32)
    est = mellon_tpu_torch.DensityEstimator(landmarks=landmarks, precision="bf16", **CPU32)
    dens = to_np(est.fit_predict(x))
    assert est.opt_state.phase_steps is not None
    (operands,) = coarse_operands
    assert [a.dtype for a in operands if getattr(a, "shape", None) == est.L.shape] == [torch.bfloat16]
    ref = to_np(mellon_tpu_torch.DensityEstimator(landmarks=landmarks, **CPU32).fit_predict(x))
    assert np.corrcoef(dens, ref)[0, 1] > 0.999
    assert np.std(dens - ref) / np.std(ref) < 0.05
    assert np.corrcoef(dens, ld_j)[0, 1] > 0.99999
    with pytest.raises(ValueError, match="precision"):
        mellon_tpu.DensityEstimator(precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        mellon_tpu_torch.DensityEstimator(precision="fp8")


def test_bf16_reaches_the_time_and_dimensionality_fits():
    """The time-sensitive density and the dimensionality model thread
    their operands too: precision="bf16" runs both phases there, within
    corr 0.999 of the float32 fit (the dimensionality model's k-NN
    distances are stored in bfloat16 as well, as the JAX package's 2-d
    operand cast does)."""
    CPU32 = dict(device="cpu", dtype=torch.float32)
    x = clustered(500, 3, seed=14).astype(np.float32)
    times = np.repeat(np.arange(5.0), 100).astype(np.float32)
    fits = {}
    for precision in (None, "bf16"):
        t = mellon_tpu_torch.TimeSensitiveDensityEstimator(n_landmarks=60, ls_time=1.5,
                                                           precision=precision, **CPU32)
        dm = mellon_tpu_torch.DimensionalityEstimator(n_landmarks=60, precision=precision, **CPU32)
        fits[precision] = (to_np(t.fit_predict(x, times)), to_np(dm.fit_predict(x)), t, dm)
    for i in (0, 1):
        assert np.corrcoef(fits[None][i], fits["bf16"][i])[0, 1] > 0.999
    for est in fits["bf16"][2:]:
        assert est.opt_state.phase_steps is not None
