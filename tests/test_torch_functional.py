"""The functional inference API of mellon_tpu_torch against mellon_tpu's:
scalar potentials and losses with their ``*_args`` through run_mcmc,
resume_mcmc, the Hessian preconditioner, Newton, the Laplace
approximation, SMC, ADVI, the optimizers and the derivatives, on the same
seeded numpy inputs in float64; the three routes of
``inference.samplers.as_batched``; the estimators called as functions,
``PredictorTime``'s ``Xnew`` and ``run_inference(loss_func=...)``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, JaxReplayDraws, clustered, t64, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu.inference import advi as jax_advi
from mellon_tpu.inference import derivatives as jax_derivatives
from mellon_tpu.inference import laplace as jax_laplace
from mellon_tpu.inference import mcmc as jax_mcmc
from mellon_tpu.inference import optimizers as jax_optimizers
from mellon_tpu.inference import smc as jax_smc
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference import (
    advi, derivatives, laplace, losses, mcmc, optimizers, samplers, smc,
)
from mellon_tpu_torch.inference.losses import (
    BatchedPotential,
    density_loss,
    make_density_value_and_grad_batch,
)

RUN = dict(num_warmup=20, num_samples=10, num_chains=4, max_tree_depth=5)


def user_density_loss(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """The density loss written out in torch ops, as a user writes a
    potential: it goes through the torch.func route."""
    k = z.shape[0]
    const = d * math.log(math.pi) / 2 - math.lgamma(d / 2 + 1)
    V = torch.log(nn_distances) * d + const
    Vdr = math.log(d) + (d - 1) * torch.log(nn_distances) + const
    f = L @ z + mu
    prior = -0.5 * torch.sum(z * z) - (k / 2) * math.log(2 * math.pi)
    return -(prior + torch.sum(f + Vdr - torch.exp(f + V) + loss_offset_per_term))


ROUTES = {"fused": density_loss, "scalar": user_density_loss}


@pytest.fixture(scope="module")
def fitted():
    """mellon_tpu's L-BFGS fit (n = 300, d = 3, 40 landmarks) and the
    port's estimator holding the same state in float64."""
    x = clustered(300, 3, seed=80)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40)
    jest.fit(jnp.asarray(x))
    return jest, state_from_jax(jest, **CPU64)


@pytest.fixture
def jax_step_count(monkeypatch):
    """NUTS counts a doubling's leapfrogs as the JAX package does (the
    replays' convention; test_torch_samplers.py holds the port's count)."""
    monkeypatch.setattr(samplers, "_subtree_steps",
                        lambda leaves, depth: torch.full_like(leaves, 2**depth))


def _problem(n=200, k=40, seed=11):
    rng = np.random.RandomState(seed)
    return rng.randn(n, k) * 0.3, np.exp(rng.randn(n) * 0.3 - 1.0), rng.randn(k) * 0.5, 4.0, -2.5


def _args(L, nn, d, mu):
    return (t64(L), t64(nn), d, mu), (jnp.asarray(L), jnp.asarray(nn), d, mu)


def _centered(jest, est, route):
    """The zero-centred potential operands: JAX's (offset appended), and
    the port's for the route (the fused route's carry the centre too)."""
    _, jax_args = jax_mcmc.zero_centered_potential(jax_density_loss, jest.pre_transformation,
                                                   jest._loss_args)
    fn, args = mcmc.zero_centered_potential(density_loss, est.pre_transformation, est._loss_args)
    if route == "scalar":
        args = args[:5]
    return ROUTES[route], args, jax_args


def assert_runs_match(got, want, rtol=1e-8):
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=rtol, err_msg=name)
    np.testing.assert_array_equal(to_np(got.num_leapfrog), np.asarray(want.num_leapfrog))
    np.testing.assert_array_equal(to_np(got.diverging), np.asarray(want.diverging))


# ---------------------------------------------------------------------------
# the three routes
# ---------------------------------------------------------------------------


def test_a_batched_potential_passes_through():
    """A BatchedPotential (the port's batched forms) is taken as it is, by
    the adapter and by the samplers; it takes no operands."""
    L, nn, z, d, mu = _problem()
    batched = make_density_value_and_grad_batch(t64(L), t64(nn), d, mu)
    assert isinstance(batched, BatchedPotential)
    assert samplers.as_batched(batched) is batched
    calls = []

    @BatchedPotential
    def spy(Z):
        calls.append(Z.shape[0])
        return batched(Z)

    samplers.hmc_init(spy, t64(np.stack([z, z])))
    assert calls == [2]
    with pytest.raises(TypeError, match="takes no operands"):
        samplers.as_batched(batched, (1.0,))


def test_the_density_loss_takes_the_fused_route(monkeypatch):
    """run_mcmc(density_loss, ..., potential_args=...) builds the closed
    form once (a spy on the factory) and draws what the batched call draws
    from the same generator, bit for bit."""
    L, nn, z, d, mu = _problem(seed=12)
    args = (t64(L), t64(nn), d, mu)
    run = dict(num_warmup=6, num_samples=4, num_chains=3, max_tree_depth=4)
    want = mcmc.run_mcmc(make_density_value_and_grad_batch(*args), t64(z),
                         torch.Generator().manual_seed(3), **run)
    calls = []
    fused = losses.make_density_value_and_grad_batch

    def spy(*a, **kw):
        calls.append(len(a))
        return fused(*a, **kw)

    monkeypatch.setattr(losses, "make_density_value_and_grad_batch", spy)
    got = mcmc.run_mcmc(density_loss, t64(z), torch.Generator().manual_seed(3),
                        potential_args=args, **run)
    assert calls == [5]
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag", "num_leapfrog"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_a_scalar_potential_is_vmapped(monkeypatch):
    """Any other scalar function goes through torch.func.vmap of its
    gradient and value (never the fused factory), equal to the closed form
    to 1e-12; one that cannot be vmapped raises, with no loop over rows in
    its place."""
    L, nn, z, d, mu = _problem(seed=13)
    args = (t64(L), t64(nn), d, mu)
    Z = t64(z + 0.1 * np.random.RandomState(14).randn(5, z.shape[0]))
    monkeypatch.setattr(losses, "make_density_value_and_grad_batch",
                        lambda *a, **kw: pytest.fail("took the fused route"))
    values, grads = samplers.as_batched(user_density_loss, args)(Z)
    monkeypatch.undo()
    want_values, want_grads = make_density_value_and_grad_batch(*args)(Z)
    np.testing.assert_allclose(to_np(values), to_np(want_values), rtol=1e-12)
    np.testing.assert_allclose(to_np(grads), to_np(want_grads), rtol=1e-12, atol=1e-12)

    def unvmappable(v):
        return v.sum() * float(v[0].item())

    with pytest.raises(RuntimeError):
        samplers.as_batched(unvmappable)(Z)


def test_the_routes_carry_the_forms_the_api_reads():
    """as_batched is where the routes part: the density loss's potential
    carries every closed form the optimizers, ADVI, SMC, the Hessians and
    the zero-centring read (each equal to its factory's), only the plain
    loss's four operands carry the autograd batch, the likelihood term and
    the centring; a scalar potential carries autograd's one row and the
    defaults built from its vmapped batch."""
    L, nn, z, d, mu = _problem(seed=15)
    args = (t64(L), t64(nn), d, mu)
    Z = t64(z + 0.1 * np.random.RandomState(16).randn(4, z.shape[0]))
    zt = t64(z)
    fused = samplers.as_batched(density_loss, args)
    for got, want in ((fused.one_row(zt), losses.make_density_value_and_grad(*args)(zt)),
                      (fused.loglik()(Z), losses.make_density_loglik_batch(*args)(Z)),
                      ((fused.values(Z),), (losses.make_density_loss_batch(*args)(Z),)),
                      ((fused.hessian(zt),), (losses.density_hessian(zt, *args),)),
                      ((fused.hessian_diagonal(zt),), (losses.density_hessian_diagonal(zt, *args),))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-12, atol=1e-12)
    centered = fused.centered_operands(zt)
    assert centered[:4] == args and centered[5] is zt
    assert centered[4] == losses.zero_centering_offset(zt, *args)[0]
    offset = samplers.as_batched(density_loss, args + (0.5,))
    assert offset.centered_operands is None
    np.testing.assert_allclose(to_np(offset.values(Z)), to_np(offset(Z)[0]), rtol=1e-12)
    scalar = samplers.as_batched(user_density_loss, args)
    assert scalar.hessian is None and scalar.centered_operands is None
    for got, want in ((scalar.one_row(zt), fused.one_row(zt)),
                      (scalar.loglik()(Z), fused.loglik()(Z)),
                      ((scalar.values(Z),), (fused.values(Z),))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-12, atol=1e-12)
    Zg = Z.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(scalar.values(Zg).sum(), Zg)
    np.testing.assert_allclose(to_np(grad), to_np(fused(Z)[1]), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "scalar"])
@pytest.mark.parametrize("algorithm, target_accept", [("nuts", 0.8), ("hmc", 0.95)])
def test_run_mcmc_replayed_matches_jax(fitted, jax_step_count, route, algorithm, target_accept):
    """run_mcmc(potential_fn, z0, draws, potential_args=...) on JAX's own
    draws against the JAX package's run on the zero-centred density loss,
    through the fused route and the torch.func route: 1e-8 (HMC below its
    stability bound, as test_torch_mcmc.py)."""
    jest, est = fitted
    fn, args, jax_args = _centered(jest, est, route)
    key = jax.random.PRNGKey(5)
    run = dict(algorithm=algorithm, target_accept=target_accept, **RUN)
    if algorithm == "hmc":
        run["num_leapfrog_steps"] = 8
    want = jax_mcmc.run_mcmc(jax_density_loss, jest.pre_transformation, key,
                             potential_args=jax_args, **run)
    got = mcmc.run_mcmc(fn, est.pre_transformation, JaxReplayDraws(key), potential_args=args, **run)
    assert_runs_match(got, want)


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_resume_mcmc_replayed_matches_jax(fitted, jax_step_count, route):
    """resume_mcmc in the JAX form from four chains' positions: 10 draws on
    JAX's draws, to 1e-8."""
    jest, est = fitted
    fn, args, jax_args = _centered(jest, est, route)
    rng = np.random.RandomState(81)
    z = np.asarray(jest.pre_transformation) + 0.05 * rng.randn(4, 40)
    inv_mass = np.exp(0.3 * rng.randn(40))
    key = jax.random.PRNGKey(6)
    want = jax_mcmc.resume_mcmc(jax_density_loss, jnp.asarray(z), key, 0.3, jnp.asarray(inv_mass),
                                num_samples=10, max_tree_depth=5, potential_args=jax_args)
    got = mcmc.resume_mcmc(fn, t64(z), JaxReplayDraws(key), 0.3, t64(inv_mass), num_samples=10,
                           max_tree_depth=5, potential_args=args)
    assert_runs_match(got, want)


def test_preconditioned_run_replayed_matches_jax(fitted, jax_step_count):
    """The JAX package's dense-metric recipe written in the JAX form:
    newton_polish, hessian_cholesky, precondition_transform and run_mcmc of
    preconditioned_potential(density_loss) with (T, z*) + args, which takes
    the fused preconditioned path; the draws to 1e-8."""
    jest, est = fitted
    fn, args, jax_args = _centered(jest, est, "fused")
    z_j, _, _ = jax_mcmc.newton_polish(jax_density_loss, jest.pre_transformation, jax_args)
    T_j = jax_mcmc.precondition_transform(
        jax_mcmc.hessian_cholesky(jax_density_loss, z_j, jnp.asarray(1e-6), *jax_args))
    key = jax.random.PRNGKey(7)
    want = jax_mcmc.run_mcmc(jax_mcmc.preconditioned_potential(jax_density_loss), jnp.zeros_like(z_j),
                             key, potential_args=(T_j, z_j) + tuple(jax_args), **RUN)
    z_p, _, _ = mcmc.newton_polish(fn, est.pre_transformation, args)
    T = mcmc.precondition_transform(mcmc.hessian_cholesky(fn, z_p, 1e-6, *args))
    pot = mcmc.preconditioned_potential(fn)
    assert isinstance(samplers.as_batched(pot, (T, z_p) + args), BatchedPotential)
    got = mcmc.run_mcmc(pot, torch.zeros_like(z_p), JaxReplayDraws(key),
                        potential_args=(T, z_p) + args, **RUN)
    assert_runs_match(got, want)
    w = np.random.RandomState(15).randn(40) * 0.1
    np.testing.assert_allclose(float(pot(t64(w), t64(T_j), t64(z_j), *args)),
                               float(jax_mcmc.preconditioned_potential(jax_density_loss)(
                                   jnp.asarray(w), T_j, z_j, *jax_args)), rtol=1e-10)


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_newton_polish_and_hessian_cholesky_match_jax(fitted, route):
    """newton_polish from the warm start (z, ‖g‖ before and after) and
    hessian_cholesky's factor at z* (the scalar route by blocked
    Hessian-vector products, 7 basis vectors a block), against the JAX
    package's: 1e-8 (test_torch_mcmc.py's bars)."""
    jest, est = fitted
    fn, args, jax_args = _centered(jest, est, route)
    z_j, gn0_j, gn1_j = jax_mcmc.newton_polish(jax_density_loss, jest.initial_value, jax_args)
    z_p, gn0, gn1 = mcmc.newton_polish(fn, est.initial_value, args)
    np.testing.assert_allclose(to_np(z_p), np.asarray(z_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose([gn0, gn1], [gn0_j, gn1_j], rtol=1e-8, atol=1e-8)
    R_j = jax_mcmc.hessian_cholesky(jax_density_loss, z_j, jnp.asarray(1e-6), *jax_args)
    R = mcmc.hessian_cholesky(fn, z_p, 1e-6, *args, block=7, host_f64=False)
    np.testing.assert_allclose(to_np(R), np.asarray(R_j), rtol=1e-8, atol=1e-10)


def test_zero_centered_potential_matches_jax(fitted):
    """zero_centered_potential(potential_fn, z0, potential_args) returns the
    density loss with JAX's offset (1e-12) and the centre z0 appended, the
    same function as JAX's centred loss (1e-10 relative at points around
    z0); any other potential, or operands that already carry an offset,
    come back unchanged."""
    jest, est = fitted
    fn, args = mcmc.zero_centered_potential(density_loss, est.pre_transformation, est._loss_args)
    jfn, jax_args = jax_mcmc.zero_centered_potential(jax_density_loss, jest.pre_transformation,
                                                     jest._loss_args)
    assert fn is density_loss and len(args) == 6 and args[5] is est.pre_transformation
    np.testing.assert_allclose(args[4], float(jax_args[4]), rtol=1e-12)
    for z in np.asarray(jest.pre_transformation) + 0.05 * np.random.RandomState(16).randn(3, 40):
        np.testing.assert_allclose(float(fn(t64(z), *args)),
                                   float(jfn(jnp.asarray(z), *jax_args)), rtol=1e-10)
    assert mcmc.zero_centered_potential(user_density_loss, est.pre_transformation,
                                        est._loss_args) == (user_density_loss, est._loss_args)
    assert mcmc.zero_centered_potential(density_loss, est.pre_transformation, args[:5]) == (
        density_loss, args[:5])


# ---------------------------------------------------------------------------
# Laplace, SMC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_compute_laplace_std_matches_jax(route):
    """compute_laplace_std(loss_func, z, loss_args=...) against the JAX
    package's chunked Hessian-vector products: 1e-10 relative (the scalar
    route by 7 Hessian-vector products a chunk)."""
    L, nn, z, d, mu = _problem(seed=17)
    args, jargs = _args(L, nn, d, mu)
    want = np.asarray(jax_laplace.compute_laplace_std(jax_density_loss, jnp.asarray(z), loss_args=jargs))
    got = laplace.compute_laplace_std(ROUTES[route], t64(z), batch_size=7, loss_args=args)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-10)


def test_laplace_start_matches_jax(fitted):
    """laplace_start(loss_fn, loss_args, z0, z_map) in the JAX form: q's
    draws on JAX's normals, q's log density, and the adjusted
    log-likelihood (a scalar taking loss_args, as JAX's) with its
    gradient, scalar and batched: 1e-10."""
    jest, est = fitted
    adjusted_j, kw_j = jax_smc.laplace_start(jax_density_loss, jest._loss_args, jest.initial_value,
                                             z_map=jest.pre_transformation)
    adjusted, kw = smc.laplace_start(density_loss, est._loss_args, est.initial_value,
                                     z_map=est.pre_transformation)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (8, 40)))

    class GivenNormals(samplers.Draws):
        def __init__(self):
            super().__init__(torch.Generator())

        def normal(self, shape, like):
            return t64(eps).reshape(shape)

    want = np.asarray(kw_j["prior_sample"](key, 8))
    Z = kw["prior_sample"](GivenNormals(), 8)
    np.testing.assert_allclose(to_np(Z), want, rtol=1e-10)
    jax_adjusted = lambda z: adjusted_j(z, *jest._loss_args)  # noqa: E731
    for fj, fp, fp_args in ((kw_j["prior_logpdf"], kw["prior_logpdf"], ()),
                            (jax_adjusted, adjusted, est._loss_args)):
        want_values = np.asarray(jax.vmap(fj)(jnp.asarray(want)))
        want_grads = np.asarray(jax.vmap(jax.grad(fj))(jnp.asarray(want)))
        values, grads = samplers.as_batched(fp, fp_args)(Z)
        np.testing.assert_allclose(to_np(values), want_values, rtol=1e-10)
        np.testing.assert_allclose(to_np(grads), want_grads, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose([float(fp(row, *fp_args)) for row in Z], want_values, rtol=1e-10)


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_loglik_from_loss_matches_jax(fitted, route):
    """loglik_from_loss(loss_fn) is a scalar loglik(z, *args), as JAX's;
    batched, the density loss's is its closed-form likelihood term: values
    and gradients to 1e-12."""
    jest, est = fitted
    loglik = smc.loglik_from_loss(ROUTES[route])
    Z = np.random.RandomState(93).randn(5, 40) * 0.3 + np.asarray(jest.pre_transformation)
    jfn = lambda z: jax_smc.loglik_from_loss(jax_density_loss)(z, *jest._loss_args)  # noqa: E731
    want = (np.asarray(jax.vmap(jfn)(jnp.asarray(Z))), np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(Z))))
    for got, w in zip(samplers.as_batched(loglik, est._loss_args)(t64(Z)), want):
        np.testing.assert_allclose(to_np(got), w, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose([float(loglik(t64(z), *est._loss_args)) for z in Z], want[0], rtol=1e-12)


def test_run_smc_takes_a_scalar_loglik_and_its_args():
    """run_smc(loglik_fn, dim, generator, loglik_args=...) with a scalar
    Gaussian log-likelihood: the analytic posterior with the bars of
    tests/test_smc.py:12-31 (mean 0.08, std 15%), and the conjugate
    evidence within 0.1 nats (:34-52)."""

    def loglik(z, m, s2):
        d = z - m
        return -0.5 * torch.sum(d * d) / s2 - 0.5 * z.shape[0] * math.log(2 * math.pi * s2)

    m, s2 = np.array([1.0, -0.5]), 0.5
    res = smc.run_smc(loglik, 2, torch.Generator().manual_seed(0), num_particles=2048,
                      num_mutation_steps=5, loglik_args=(t64(m), s2), dtype=torch.float64)
    post_prec = 1 + 1 / s2
    particles = to_np(res.particles)
    np.testing.assert_allclose(particles.mean(axis=0), (m / s2) / post_prec, atol=0.08)
    np.testing.assert_allclose(particles.std(axis=0), 1 / np.sqrt(post_prec), rtol=0.15)
    res = smc.run_smc(loglik, 1, torch.Generator().manual_seed(1), num_particles=4096,
                      num_mutation_steps=5, loglik_args=(t64([2.0]), 1.0), dtype=torch.float64)
    assert res.log_evidence == pytest.approx(-0.5 * 4.0 / 2.0 - 0.5 * np.log(2 * np.pi * 2.0), abs=0.1)


def test_run_smc_from_the_jax_form_laplace_start(fitted):
    """A sweep from laplace_start(density_loss, args, ...) with
    loglik_args=args, as the JAX package's smc_density_posterior runs it:
    β reaches 1, and the particles' mean sits within 3 Laplace stds of
    the MAP in every latent (the posterior is near-Gaussian there)."""
    jest, est = fitted
    loglik, kw = smc.laplace_start(density_loss, est._loss_args, est.initial_value,
                                   z_map=est.pre_transformation)
    res = smc.run_smc(loglik, 40, torch.Generator().manual_seed(2), num_particles=256,
                      loglik_args=est._loss_args, **kw)
    assert res.betas[-1] == 1.0
    sigma = laplace.compute_laplace_std(density_loss, est.pre_transformation,
                                        loss_args=est._loss_args)
    gap = (res.particles.mean(dim=0) - est.pre_transformation).abs() / sigma
    assert float(gap.max()) < 3.0


# ---------------------------------------------------------------------------
# the optimizers and ADVI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_minimize_lbfgs_matches_jax(route):
    """minimize_lbfgs is minimize_lbfgsb, as in the JAX package: the scalar
    loss with loss_args to its optimum, latents to 1e-6 and the loss to
    1e-10 relative (test_torch_surface.py's bars)."""
    assert optimizers.minimize_lbfgs is optimizers.minimize_lbfgsb
    L, nn, z0, d, mu = _problem(seed=18)
    args, jargs = _args(L, nn, d, mu)
    want = jax_optimizers.minimize_lbfgs(jax_density_loss, jnp.asarray(z0), tol=1e-10, loss_args=jargs)
    got = optimizers.minimize_lbfgs(ROUTES[route], t64(z0), tol=1e-10, loss_args=args)
    np.testing.assert_allclose(to_np(got.pre_transformation), np.asarray(want.pre_transformation),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-10)


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_minimize_adam_matches_jax(route):
    """minimize_adam(loss_func, z0, n_iter, loss_args=...): 50 steps,
    latents and losses to 1e-8 relative (test_torch_uncertainty.py's bars),
    in the JAX package's Results."""
    L, nn, z0, d, mu = _problem(seed=19)
    args, jargs = _args(L, nn, d, mu)
    want = jax_optimizers.minimize_adam(jax_density_loss, jnp.asarray(z0), n_iter=50, loss_args=jargs)
    got = optimizers.minimize_adam(ROUTES[route], t64(z0), n_iter=50, jit=True, loss_args=args)
    assert isinstance(got, optimizers.Results)
    assert optimizers.Results._fields == jax_optimizers.Results._fields
    np.testing.assert_allclose(to_np(got.pre_transformation), np.asarray(want.pre_transformation),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(to_np(got.losses), np.asarray(want.losses), rtol=1e-8)


def test_run_advi_on_a_gaussian_scalar_loss():
    """run_advi(loss_func, z0, ..., seed=...) on the scalar quadratic loss
    of tests/test_inference.py, with the bars used there: mean 0.2, stds
    40%."""
    scales, center = t64([1.0, 4.0, 0.25]), t64([1.0, -2.0, 3.0])

    def loss(z, c):
        return 0.5 * torch.sum(scales * (z - c) ** 2)

    res = advi.run_advi(loss, torch.zeros(3, dtype=torch.float64), n_iter=600, init_learn_rate=0.1,
                        seed=0, loss_args=(center,))
    np.testing.assert_allclose(to_np(res.pre_transformation), [1.0, -2.0, 3.0], atol=0.2)
    np.testing.assert_allclose(to_np(res.pre_transformation_std), 1 / np.sqrt([1.0, 4.0, 0.25]),
                               rtol=0.4)
    assert res.losses.shape == (600,)


@pytest.mark.parametrize("route", ["fused", "scalar"])
def test_run_advi_density_within_the_seed_spread_of_jax(route):
    """run_advi(density loss, warm start, loss_args=..., seed=0) on the JAX
    package's prepared model: its log density within twice the spread of
    JAX's own seed-0 and seed-1 runs (test_torch_uncertainty.py's bar)."""
    x = clustered(300, 3, seed=53)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40)
    jest.prepare_inference(jnp.asarray(x))
    jargs = (jest.L, jest.nn_distances, jest.d, jest.mu)
    f0, f1 = (np.asarray(jest.L @ jax_advi.run_advi(jax_density_loss, jest.initial_value,
                                                     loss_args=jargs, seed=s).pre_transformation + jest.mu)
              for s in (0, 1))
    args = (t64(jest.L), t64(jest.nn_distances), jest.d, jest.mu)
    res = advi.run_advi(ROUTES[route], t64(jest.initial_value), seed=0, loss_args=args)
    f = to_np(args[0] @ res.pre_transformation + jest.mu)
    assert np.isfinite(f).all() and (to_np(res.pre_transformation_std) > 0).all()
    assert np.abs(f - f0).max() <= 2 * np.abs(f1 - f0).max()


def test_elbo_estimate_by_its_moments():
    """elbo_estimate(logprob, generator, mean, log_std, num_samples): 0 for
    every draw where q is the target itself (as JAX's, to 1e-12), and
    −KL(q ‖ p) in the mean over 20,000 draws where it is not (within 4
    standard errors); differentiable in mean and log_std."""
    m, s = t64([0.5, -1.0]), t64([0.7, 1.3])

    def logprob(z):
        u = (z - m) / s
        return torch.sum(-0.5 * u * u - torch.log(s) - 0.5 * math.log(2 * math.pi))

    g = torch.Generator().manual_seed(0)
    exact = advi.elbo_estimate(logprob, g, m, torch.log(s), 40)
    jm, js_ = jnp.asarray(to_np(m)), jnp.asarray(to_np(s))
    jlogprob = lambda z: jnp.sum(-0.5 * ((z - jm) / js_) ** 2 - jnp.log(js_) - 0.5 * jnp.log(2 * jnp.pi))  # noqa: E731
    assert abs(float(exact)) < 1e-12
    assert abs(float(jax_advi.elbo_estimate(jlogprob, jax.random.PRNGKey(0), jm, jnp.log(js_), 40))) < 1e-12
    mean = t64([0.0, 0.0]).requires_grad_(True)
    log_std = t64([0.0, 0.0]).requires_grad_(True)
    with torch.enable_grad():
        elbo = advi.elbo_estimate(logprob, g, mean, log_std, 20000)
        elbo.backward()
    kl = float(torch.sum(torch.log(s) + (1 + m**2) / (2 * s**2) - 0.5))
    # per-draw log-ratio variance bounded by a short pilot
    pilot = torch.stack([advi.elbo_estimate(logprob, g, mean.detach(), log_std.detach(), 1)
                         for _ in range(400)])
    stderr = float(pilot.std()) / math.sqrt(20000)
    assert abs(float(elbo.detach()) + kl) < 4 * stderr
    assert torch.isfinite(mean.grad).all() and float(mean.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# derivatives with per-row operands
# ---------------------------------------------------------------------------


def test_derivatives_take_per_row_args():
    """gradient, hessian and hessian_log_determinant(function, x, *args,
    jit=...) with a per-row operand, against the JAX package's: 1e-12."""
    rng = np.random.RandomState(20)
    x, a = rng.randn(7, 3), rng.rand(7) + 0.5

    def port_f(X, A):
        return torch.sum(torch.sin(X) * X, dim=1) * A + X[:, 0] * X[:, 1] ** 2

    def jax_f(X, A):
        return jnp.sum(jnp.sin(X) * X, axis=1) * A + X[:, 0] * X[:, 1] ** 2

    for name in ("gradient", "hessian"):
        got = getattr(derivatives, name)(port_f, t64(x), t64(a), jit=False)
        want = getattr(jax_derivatives, name)(jax_f, jnp.asarray(x), jnp.asarray(a))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    sign, logdet = derivatives.hessian_log_determinant(port_f, t64(x), t64(a))
    sj, lj = jax_derivatives.hessian_log_determinant(jax_f, jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_array_equal(to_np(sign), np.asarray(sj))
    np.testing.assert_allclose(to_np(logdet), np.asarray(lj), rtol=1e-12)


# ---------------------------------------------------------------------------
# F6, F7, run_inference(loss_func=...), the last names
# ---------------------------------------------------------------------------


def _agreement(got, want):
    got, want = to_np(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / (want.max() - want.min())


def _time_course():
    """Three time points of 40 cells at d = 2 (test_torch_time.py's data)."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(40, 2) + 0.5 * t for t in (0.0, 1.0, 2.0)])
    return x, np.repeat([0.0, 1.0, 2.0], 40)


ESTIMATORS = {
    "density": (mellon_tpu.DensityEstimator, mt.DensityEstimator),
    "time": (mellon_tpu.TimeSensitiveDensityEstimator, mt.TimeSensitiveDensityEstimator),
    "dimensionality": (mellon_tpu.DimensionalityEstimator, mt.DimensionalityEstimator),
}


@pytest.mark.parametrize("kind", list(ESTIMATORS))
def test_estimators_are_callable(kind):
    """est(x) is est.fit_predict(x), bit for bit on a fresh estimator with
    the same seed, and the JAX package's est(x) to the bar of that
    estimator's parity test: 1e-8 relative for the time model's full GP
    (test_torch_time.py), corr >= 0.99999 and max |Δ| <= 1e-3 of the
    spread on JAX's landmarks for the others (test_torch_slice.py,
    test_torch_dimensionality.py)."""
    jax_cls, port_cls = ESTIMATORS[kind]
    if kind == "time":
        x, times = _time_course()
        x = np.concatenate([x, times[:, None]], axis=1)
        jest, kw = jax_cls(ls_time=1.5), dict(ls_time=1.5)
    else:
        x = clustered(300, 3, seed=21, spread=1.0)
        jest = jax_cls(n_landmarks=40)
    want = np.asarray(jest(jnp.asarray(x)))
    if kind != "time":
        kw = dict(landmarks=np.asarray(jest.landmarks))
    called = port_cls(**kw, **CPU64)(x)
    assert torch.equal(called, port_cls(**kw, **CPU64).fit_predict(x))
    if kind == "time":
        assert float(np.abs(to_np(called) - want).max() / np.abs(want).max()) <= 1e-8
    else:
        corr, gap = _agreement(called, want)
        assert corr >= 0.99999 and gap <= 1e-3, (corr, gap)


def test_predictor_time_takes_xnew():
    """PredictorTime's mean, covariance, mean_covariance and uncertainty
    take their points as ``Xnew``, by keyword too, as the JAX package's:
    the mean at one time and on a multi_time grid to 1e-8 relative."""
    x, times = _time_course()
    jest = mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.5, predictor_with_uncertainty=True)
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    est = mt.TimeSensitiveDensityEstimator(ls_time=1.5, predictor_with_uncertainty=True, **CPU64)
    est.fit(x, times)
    xq = np.random.RandomState(25).randn(6, 2)
    for kw in (dict(time=1.0), dict(multi_time=np.array([0.5, 1.5]))):
        got = est.predict.mean(Xnew=xq, **kw)
        want = np.asarray(jest.predict.mean(Xnew=jnp.asarray(xq), **kw))
        assert float(np.abs(to_np(got) - want).max() / np.abs(want).max()) <= 1e-8
    for name in ("covariance", "mean_covariance", "uncertainty"):
        got = getattr(est.predict, name)(Xnew=xq, time=1.0)
        assert torch.equal(got, getattr(est.predict, name)(xq, 1.0))


def test_run_inference_optimizes_the_loss_func_it_is_given():
    """run_inference(loss_func, initial_value, optimizer) as the JAX
    package's: the density loss written as a closure goes through the
    autograd route to the JAX package's fit (the log density at corr >=
    0.99999, max |Δ| <= 1e-3 of its spread, test_torch_slice.py's bar);
    another scalar loss is the one optimized (the JAX package keeps its
    density loss: a recorded divergence), to its own optimum."""
    x = clustered(200, 3, seed=22)
    jest = mellon_tpu.DensityEstimator(n_landmarks=30)
    jest.prepare_inference(jnp.asarray(x))
    want = np.asarray(jest.run_inference(optimizer="L-BFGS-B"))
    est = mt.DensityEstimator(landmarks=np.asarray(jest.landmarks), **CPU64)
    est.prepare_inference(x)
    args = est._loss_args
    got = est.run_inference(lambda z: density_loss(z, *args), est.initial_value, "L-BFGS-B")
    corr, gap = _agreement(est.L @ got + est.mu, np.asarray(jest.L) @ want + jest.mu)
    assert corr >= 0.99999 and gap <= 1e-3, (corr, gap)
    anchor = est.initial_value + 1.0

    def anchored(z):
        return density_loss(z, *args) + 50.0 * torch.sum((z - anchor) ** 2)

    moved = est.run_inference(loss_func=anchored)
    direct = optimizers.minimize_lbfgs(anchored, est.initial_value).pre_transformation
    np.testing.assert_allclose(to_np(moved), to_np(direct), rtol=0, atol=1e-12)
    assert float((moved - got).abs().max()) > 0.1


def test_cholesky_with_check_matches_jax():
    """ops.linalg.cholesky_with_check: the factor of a positive definite
    matrix (1e-12), and the JAX package's ValueError and message where it
    does not factor."""
    from mellon_tpu.ops.linalg import cholesky_with_check as jax_cholesky_with_check

    A = np.random.RandomState(23).randn(6, 6)
    A = A @ A.T + 6 * np.eye(6)
    np.testing.assert_allclose(to_np(mt.ops.linalg.cholesky_with_check(t64(A))),
                               np.asarray(jax_cholesky_with_check(jnp.asarray(A))), rtol=1e-12)
    bad = -np.eye(3)
    with pytest.raises(ValueError) as jax_error:
        jax_cholesky_with_check(jnp.asarray(bad), jitter=1e-3)
    with pytest.raises(ValueError) as error:
        mt.ops.linalg.cholesky_with_check(t64(bad), jitter=1e-3)
    assert str(error.value) == str(jax_error.value)


def test_the_last_module_level_names_match_jax():
    """config.DEFAULT_JITTER, parameters.DEFAULT_RANK, mcmc.welford_update,
    ops.linalg.stabilize, parallel.sharding's CELL_AXIS and replicated, and
    the port's own version module."""
    from mellon_tpu import parallel as jax_parallel
    from mellon_tpu.ops import linalg as jax_linalg

    assert mt.config.DEFAULT_JITTER == mellon_tpu.config.DEFAULT_JITTER
    assert mt.parameters.DEFAULT_RANK == mellon_tpu.parameters.DEFAULT_RANK
    assert mcmc.welford_update is samplers.welford_update
    A = np.random.RandomState(24).randn(4, 4)
    np.testing.assert_allclose(to_np(mt.ops.linalg.stabilize(t64(A), 1e-3)),
                               np.asarray(jax_linalg.stabilize(jnp.asarray(A), 1e-3)), rtol=1e-15)
    assert mt.parallel.sharding.CELL_AXIS == jax_parallel.sharding.CELL_AXIS
    assert mt.parallel.sharding.replicated is mt.parallel.mesh.replicated
    from mellon_tpu_torch import version

    assert version.__version__ == mt.__version__


def test_the_sharded_loss_takes_the_functional_api(fitted):
    """A cell-sharded loss (one rank: a 1 x 1 mesh) is a scalar that knows
    its batched form and closed-form curvature, as the JAX package's
    sharded loss goes through its functional API: run_mcmc of it, and of
    preconditioned_potential(loss) with (T, z*), draw what its
    value_and_grad draws, bit for bit; newton_polish and
    compute_laplace_std take its closed forms."""
    _, est = fitted
    z0 = est.pre_transformation
    mesh = mt.parallel.create_mesh(devices=["cpu"])
    L, nn, d, mu = est._loss_args
    loss, _ = mt.parallel.shard_density_model(nn, d, mu, L, mesh, center=z0)
    run = dict(num_warmup=6, num_samples=4, num_chains=3, max_tree_depth=4)
    fields = ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag", "num_leapfrog")
    got = mcmc.run_mcmc(loss, z0, torch.Generator().manual_seed(1), **run)
    want = mcmc.run_mcmc(loss.value_and_grad, z0, torch.Generator().manual_seed(1), **run)
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)
    z_star, gn0, gn1 = mcmc.newton_polish(loss, z0)
    z_want, gn0_want, gn1_want = mcmc.newton_polish_value_and_grad(loss.value_and_grad, loss.hessian, z0)
    assert torch.equal(z_star, z_want) and (gn0, gn1) == (gn0_want, gn1_want)
    T = mcmc.precondition_transform(mcmc.hessian_cholesky(loss, z_star, 1e-6))
    w0 = torch.zeros_like(z_star)
    got = mcmc.run_mcmc(mcmc.preconditioned_potential(loss), w0, torch.Generator().manual_seed(2),
                        potential_args=(T, z_star), **run)
    want = mcmc.run_mcmc(mcmc.precondition_value_and_grad(loss.value_and_grad, T, z_star), w0,
                         torch.Generator().manual_seed(2), **run)
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)
    assert torch.equal(laplace.compute_laplace_std(loss, z_star),
                       laplace.laplace_std_from_diagonal(loss.hessian_diagonal(z_star)))
