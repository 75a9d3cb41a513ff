"""run_mcmc, resume_mcmc, sample_density_posterior, the Hessian
preconditioner and the estimator's NUTS path of mellon_tpu_torch against
mellon_tpu.  Whole runs are replayed on JAX's own draws (the port counting
NUTS steps as JAX does) on a density model fitted by the JAX package and
carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, JaxReplayDraws, clustered, t64, to_np
import mellon_tpu
from mellon_tpu.inference import mcmc as jax_mcmc
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks
import mellon_tpu_torch
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference import mcmc, samplers
from mellon_tpu_torch.inference.diagnostics import summarize
from mellon_tpu_torch.inference.losses import (
    density_hessian,
    make_density_value_and_grad_batch,
    zero_centering_offset,
)

# one run_mcmc configuration per algorithm (each is one JAX compilation)
RUN = dict(num_warmup=20, num_samples=10, num_chains=4, max_tree_depth=5)


@pytest.fixture(scope="module")
def fitted():
    """mellon_tpu's L-BFGS fit (n = 300, d = 3, 40 landmarks) and the
    port's estimator holding the same state in float64."""
    x = clustered(300, 3, seed=80)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40)
    jest.fit(jnp.asarray(x))
    return jest, state_from_jax(jest, **CPU64)


@pytest.fixture(autouse=True)
def jax_step_count(monkeypatch):
    """The port counts a NUTS doubling's leapfrogs as the JAX package does
    (test_torch_samplers.py holds the port's own count)."""
    monkeypatch.setattr(samplers, "_subtree_steps", lambda leaves, depth: torch.full_like(leaves, 2**depth))


def _centered_args(jest):
    """The JAX package's zero-centred density potential operands."""
    fn, args = jax_mcmc.zero_centered_potential(jax_density_loss, jest.pre_transformation, jest._loss_args)
    return args


def assert_runs_match(got, want, rtol=1e-8):
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=rtol, err_msg=name)
    np.testing.assert_array_equal(to_np(got.num_leapfrog), np.asarray(want.num_leapfrog))
    np.testing.assert_array_equal(to_np(got.diverging), np.asarray(want.diverging))


def test_zero_centered_potential_matches_jax(fitted):
    """The offset loss(z0)/n, rounded to float32 as JAX's operand is: 1e-12;
    the centred potential is ~0 at z0."""
    jest, est = fitted
    want = float(_centered_args(jest)[-1])
    vg, offset = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    np.testing.assert_allclose(offset, want, rtol=1e-12)
    v0 = float(vg(est.pre_transformation[None])[0][0])
    assert abs(v0) < 1e-3 * abs(offset * est.L.shape[0])


def _large_f_model(dtype, n=100_000, k=128, seed=83):
    """A density potential whose log density F = L z + μ sits near 70 with
    e^{F+V} up to ~6,000 at some cells, as at the 1M-cell atlas."""
    rng = np.random.RandomState(seed)
    L = rng.randn(n, k) / np.sqrt(k)
    z = 2.0 * rng.randn(k)
    nn = np.exp(-0.82 + 0.02 * rng.randn(n))
    return (torch.tensor(L, dtype=dtype), torch.tensor(nn, dtype=dtype), 50.0, 70.0,
            torch.tensor(z, dtype=dtype))


def test_centered_potential_is_the_same_function():
    """The batched potential computed around a centre (center=) is the
    plain one in float64 (values 1e-10 of the loss, gradients 1e-10), at
    the centre and away from it."""
    L, nn, d, mu, c = _large_f_model(torch.float64, n=5000)
    Z = c + 0.3 * torch.tensor(np.random.RandomState(84).randn(4, c.shape[0]))
    Z = torch.cat([c[None], Z])
    plain = make_density_value_and_grad_batch(L, nn, d, mu, 0.5)(Z)
    centred = make_density_value_and_grad_batch(L, nn, d, mu, 0.5, center=c)(Z)
    scale = float(plain[0].abs().max())
    np.testing.assert_allclose(to_np(centred[0]), to_np(plain[0]), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(to_np(centred[1]), to_np(plain[1]), rtol=1e-10, atol=1e-10)


def test_centered_potential_keeps_float32_rounding_small():
    """In float32, on 100,000 cells where F is near 70 and e^{F+V} reaches
    the thousands, the rounding of F = L z moves the plain potential (even
    zero-centred by its offset) by ~0.04 from one z to the next; computed
    around the centre it stays within a hundredth of that: the spread of
    each one's error against float64, at the same 21 float32 points within
    1e-4 of the centre."""
    L64, nn64, d, mu, c64 = _large_f_model(torch.float64)
    L, nn, c = L64.float(), nn64.float(), c64.float()
    offset, _ = zero_centering_offset(c64, L64, nn64, d, mu)
    v = torch.tensor(np.random.RandomState(85).randn(c.shape[0]))
    Z = (c.double() + torch.linspace(-1e-4, 1e-4, 21, dtype=torch.float64)[:, None] * v).float()
    truth = make_density_value_and_grad_batch(L64, nn64, d, mu, offset)(Z.double())[0]
    spread = {}
    for name, center in (("plain", None), ("centred", c)):
        vg = make_density_value_and_grad_batch(L, nn, d, mu, offset, center=center)
        spread[name] = float((vg(Z)[0].double() - truth).std())
    assert spread["centred"] < 0.01 * spread["plain"], spread


@pytest.mark.parametrize("algorithm,target_accept", [("nuts", 0.8), ("hmc", 0.95)])
def test_run_mcmc_replayed_matches_jax(fitted, algorithm, target_accept):
    """run_mcmc from a one-row z0 (NUTS depth 5, or HMC with 8 leapfrogs):
    20 warmup, 10 draws, 4 chains on JAX's draws.  Samples, potentials,
    acceptance, step size and inverse mass to 1e-8; step counts and
    divergences exactly.  HMC targets 0.95 acceptance: at 0.8 dual
    averaging settles on steps past the leapfrog's stability bound for the
    stiffest direction (curvature 81 here), where fixed-length trajectories
    amplify the two packages' last-digit rounding differences exponentially
    (1e-13 to 4e-4 over four keys on the CPU, against at most 1.1e-9 over
    six keys at 0.95); NUTS stops such trajectories as divergent."""
    jest, est = fitted
    args = _centered_args(jest)
    key = jax.random.PRNGKey(5)
    run = dict(algorithm=algorithm, target_accept=target_accept, **RUN)
    if algorithm == "hmc":
        run["num_leapfrog_steps"] = 8
    want = jax_mcmc.run_mcmc(jax_density_loss, jest.pre_transformation, key, potential_args=args, **run)
    vg, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    got = mcmc.run_mcmc(vg, est.pre_transformation, JaxReplayDraws(key), **run)
    assert_runs_match(got, want)
    if algorithm == "hmc":
        assert got.host_reads == 0
    assert got.num_evaluations > 0


def test_resume_mcmc_replayed_matches_jax(fitted):
    """resume_mcmc from four chains' positions with a given step size and
    mass: 10 draws on JAX's draws, to 1e-8."""
    jest, est = fitted
    args = _centered_args(jest)
    rng = np.random.RandomState(81)
    z = np.asarray(jest.pre_transformation) + 0.05 * rng.randn(4, 40)
    inv_mass = np.exp(0.3 * rng.randn(40))
    key = jax.random.PRNGKey(6)
    want = jax_mcmc.resume_mcmc(jax_density_loss, jnp.asarray(z), key, 0.3, jnp.asarray(inv_mass),
                                num_samples=10, max_tree_depth=5, potential_args=args)
    vg, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    got = mcmc.resume_mcmc(vg, t64(z), JaxReplayDraws(key), 0.3, t64(inv_mass), num_samples=10,
                           max_tree_depth=5)
    assert_runs_match(got, want)


@pytest.mark.parametrize("precondition", [None, "hessian"])
def test_sample_density_posterior_replayed_matches_jax(fitted, precondition):
    """sample_density_posterior on the same state and JAX's draws (seed 0),
    plain and Hessian-preconditioned: the z-space draws, the run's
    statistics and the function samples to 1e-8."""
    jest, est = fitted
    want, f_want = jax_mcmc.sample_density_posterior(jest, seed=0, precondition=precondition, **RUN)
    got, f_got = mcmc.sample_density_posterior(
        est, precondition=precondition, generator=JaxReplayDraws(jax.random.PRNGKey(0)), **RUN)
    assert_runs_match(got, want)
    np.testing.assert_allclose(to_np(f_got), np.asarray(f_want), rtol=1e-8, atol=1e-8)
    res, f = mcmc.sample_density_posterior(est, function_samples=False, num_warmup=4, num_samples=2)
    assert f is None and res.samples.shape == (4, 2, 40)


def test_hessian_and_preconditioner_match_jax(fitted):
    """The closed-form Hessian against the one JAX assembles from
    Hessian-vector products (_hessian_block) at 1e-10; the Newton polish
    from the warm start (z, |grad| before and after), R, T and the
    unwhitened draws at 1e-8."""
    jest, est = fitted
    args = _centered_args(jest)
    z = jest.pre_transformation
    want_H = jax_mcmc._hessian_block(jax_density_loss, z, jnp.asarray(0), 40, *args)
    H = density_hessian(t64(z), *est._loss_args)
    np.testing.assert_allclose(to_np(H), np.asarray(want_H), rtol=1e-10, atol=1e-10)

    z_j, gn0_j, gn1_j = jax_mcmc.newton_polish(jax_density_loss, jest.initial_value, args)
    vg, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    hessian = lambda v: density_hessian(v, *est._loss_args)  # noqa: E731
    z_p, gn0, gn1 = mcmc.newton_polish_value_and_grad(vg, hessian, est.initial_value)
    np.testing.assert_allclose(to_np(z_p), np.asarray(z_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose([gn0, gn1], [gn0_j, gn1_j], rtol=1e-8, atol=1e-8)
    assert gn1 < 1e-6 * gn0

    R_j = jax_mcmc.hessian_cholesky(jax_density_loss, z_j, jnp.asarray(1e-6), *args)
    T_j = jax_mcmc.precondition_transform(R_j)
    R = mcmc.factor_hessian(hessian(z_p), 1e-6)
    T = mcmc.precondition_transform(R)
    np.testing.assert_allclose(to_np(R), np.asarray(R_j), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(to_np(T), np.asarray(T_j), rtol=1e-8, atol=1e-10)
    w = np.random.RandomState(82).randn(4, 7, 40)
    np.testing.assert_allclose(
        to_np(mcmc.unwhiten_samples(t64(w), T, z_p)),
        np.asarray(jax_mcmc.unwhiten_samples(jnp.asarray(w), T_j, z_j)), rtol=1e-8, atol=1e-10)
    # the whitened potential's Hessian is the identity at the MAP
    Tt = T.T @ hessian(z_p) @ T
    np.testing.assert_allclose(to_np(Tt), np.eye(40), atol=1e-6)


def test_hessian_preconditioned_sampling_on_an_ill_conditioned_gaussian():
    """A correlated Gaussian with a condition number of 1e6 (the target of
    tests/test_mcmc.py:501-562), with the Hessian by autograd: R Rᵀ is the
    precision; NUTS in the whitened coordinates at depth 6 turns its trees
    (< 40 leapfrogs per draw), R-hat < 1.05, no divergence, and the
    worst-scaled directions' stds within 35%."""
    rs = np.random.RandomState(0)
    dim = 24
    Q, _ = np.linalg.qr(rs.randn(dim, dim))
    scales = np.logspace(-1.5, 1.5, dim)
    prec = t64(np.linalg.inv((Q * scales**2) @ Q.T))
    mean = t64(rs.randn(dim))

    def potential(Z):
        return 0.5 * torch.sum(((Z - mean) @ prec) * (Z - mean), dim=1)

    R = mcmc.factor_hessian(mcmc.hessian_of(lambda z: potential(z[None])[0])(mean), 1e-10)
    np.testing.assert_allclose(to_np(R @ R.T), to_np(prec), rtol=2e-3, atol=1e-4)
    T = mcmc.precondition_transform(R)
    vg = mcmc.precondition_value_and_grad(samplers.batched_value_and_grad(potential), T, mean)
    res = mcmc.run_mcmc(vg, torch.zeros(dim, dtype=torch.float64), torch.Generator().manual_seed(0),
                        num_warmup=300, num_samples=600, num_chains=4, max_tree_depth=6)
    assert int(res.diverging.sum()) == 0
    assert float(res.num_leapfrog.double().mean()) < 40
    z = to_np(mcmc.unwhiten_samples(res.samples, T, mean))
    assert summarize(z)["rhat"].max() < 1.05
    flat = z.reshape(-1, dim)
    np.testing.assert_allclose((flat @ Q).std(axis=0), scales, rtol=0.35)
    np.testing.assert_allclose(flat.mean(axis=0), to_np(mean), atol=3 * scales.max() / np.sqrt(len(flat) / 50))


def test_steps_per_call_is_validated_and_ignored(fitted):
    """steps_per_call bounds one XLA program's run time in the JAX package;
    eager PyTorch accepts it, checks it and runs the same transitions."""
    _, est = fitted
    vg, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    runs = [mcmc.run_mcmc(vg, est.pre_transformation, torch.Generator().manual_seed(7), num_warmup=6,
                          num_samples=3, num_chains=2, max_tree_depth=4, steps_per_call=spc)
            for spc in (None, 2)]
    assert torch.equal(runs[0].samples, runs[1].samples)
    with pytest.raises(ValueError, match="steps_per_call"):
        mcmc.run_mcmc(vg, est.pre_transformation, torch.Generator(), steps_per_call=0)


@pytest.fixture(scope="module")
def nuts_fits():
    """optimizer="nuts" (4 chains, 200 warmup, 600 draws, depth 10) on the
    same data and landmarks: the JAX package with seeds 42 and 43, the port
    with its own stream."""
    x = clustered(200, 2, seed=83)
    xu = np.asarray(jax_compute_landmarks(jnp.asarray(x), n_landmarks=30, random_state=42))
    opts = {"num_samples": 600}
    jfits = [mellon_tpu.DensityEstimator(landmarks=jnp.asarray(xu), optimizer="nuts", random_state=s,
                                         sampler_options=opts).fit(jnp.asarray(x)) for s in (42, 43)]
    est = mellon_tpu_torch.DensityEstimator(landmarks=xu, optimizer="nuts", sampler_options=opts,
                                            predictor_with_uncertainty=True, **CPU64).fit(x)
    return jfits, est


def test_estimator_nuts_within_the_seed_spread_of_jax(nuts_fits):
    """The port's posterior mean and std of the latents against the JAX
    package's seed-42 run: each max |Δ| is at most twice the max |Δ|
    between JAX's seed-42 and seed-43 runs (measured on the CPU: mean
    0.036 against 0.052, std 0.040 against 0.064).  The port starts its
    chains at the MAP, JAX at the warm start (ROADMAP Queue 3); the
    posterior is the same."""
    jfits, est = nuts_fits
    for attr in ("pre_transformation", "pre_transformation_std"):
        j0, j1 = (np.asarray(getattr(j, attr)) for j in jfits)
        got = to_np(getattr(est, attr))
        assert np.abs(got - j0).max() <= 2 * np.abs(j1 - j0).max(), (attr, np.abs(got - j0).max(),
                                                                     np.abs(j1 - j0).max())


def test_estimator_nuts_reports_the_run(nuts_fits):
    """The estimator keeps the draws, the run, ESS and ESS/s, skips the
    Laplace step (the stds are the draws'), and its predictor has
    uncertainty."""
    _, est = nuts_fits
    assert est.posterior_samples.shape == (4, 600, est.L.shape[1])
    assert est.mcmc_result.samples is est.posterior_samples
    assert est.losses.shape == (2400,) and est.sampling_time > 0
    assert est.ess.shape == (est.L.shape[1],) and np.isfinite(est.ess).all() and est.ess_per_second > 0
    flat = est.posterior_samples.reshape(-1, est.L.shape[1])
    assert torch.equal(est.pre_transformation_std, flat.std(dim=0, correction=0))
    u = est.predict.uncertainty(clustered(20, 2, seed=84))
    assert torch.isfinite(u).all() and (u > 0).all()


def test_estimator_nuts_precondition_option():
    """sampler_options={"precondition": "hessian"} samples through the
    MAP-Hessian transform and keeps z-space draws whose log density tracks
    the plain NUTS fit (corr > 0.95, tests/test_mcmc.py:565-592)."""
    x = clustered(80, 2, seed=85)
    opts = {"num_warmup": 100, "num_samples": 150, "num_chains": 2}
    fits = [mellon_tpu_torch.DensityEstimator(n_landmarks=24, optimizer="nuts", sampler_options=o, **CPU64)
            for o in (opts, {**opts, "precondition": "hessian"})]
    plain, pre = (to_np(e.fit_predict(x)) for e in fits)
    assert np.isfinite(pre).all() and np.corrcoef(pre, plain)[0, 1] > 0.95
    assert fits[1].posterior_samples.shape[:2] == (2, 150)


@pytest.mark.parametrize(
    "options,match",
    [
        ({"chains": 4}, "Unknown sampler_options"),
        ({"num_chains": -1}, "positive number"),
        ([("num_chains", 4)], "must be a dict"),
        ({"num_chains": 0.5}, "positive integer"),
        ({"num_particles": 0.9}, "positive integer"),
        ({"num_chains": True}, "positive number"),
        ({"num_chains": float("inf")}, "positive number"),
        ({"precondition": "dense"}, "must be one of"),
        ({"start": "warm"}, "must be one of"),
    ],
)
def test_sampler_options_refused_as_jax_refuses(options, match):
    """Each refusal of tests/test_mcmc.py:413-432 (and the string options)
    raises the JAX package's ValueError and message in both packages."""
    for cls in (mellon_tpu.DensityEstimator, mellon_tpu_torch.DensityEstimator):
        with pytest.raises(ValueError, match=match):
            cls(sampler_options=options)


def test_sampler_options_accepted():
    """Whole-valued floats for counts and real floats elsewhere are fine."""
    for opts in ({"num_chains": 4.0}, {"target_accept": 0.9}, {"steps_per_call": 50}):
        assert mellon_tpu_torch.DensityEstimator(sampler_options=opts).sampler_options == opts


def test_unported_sampling_options_raise(fitted):
    """A chain_sharding that is not a sharding of mellon_tpu_torch.parallel
    is a TypeError; an unknown precision, precondition or algorithm is a
    ValueError as in the JAX package (bf16 sampling runs:
    tests/test_torch_bf16_sampling.py)."""
    _, est = fitted
    with pytest.raises(ValueError, match="precision"):
        mcmc.sample_density_posterior(est, precision="fp8")
    with pytest.raises(ValueError, match="precondition"):
        mcmc.sample_density_posterior(est, precondition="dense")
    vg, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *est._loss_args)
    for fn, extra in ((mcmc.run_mcmc, ()), (mcmc.resume_mcmc, (0.1, torch.ones(40, dtype=torch.float64)))):
        with pytest.raises(TypeError, match="chain_sharding must be a sharding"):
            fn(vg, est.pre_transformation, torch.Generator(), *extra, chain_sharding=object())
    with pytest.raises(ValueError, match="Unknown MCMC algorithm"):
        mcmc.run_mcmc(vg, est.pre_transformation, torch.Generator(), algorithm="mala")
