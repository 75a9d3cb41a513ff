"""SMC of mellon_tpu_torch against mellon_tpu: the ESS, the tempering
bisection and systematic resampling exactly, the Laplace start's q, the
moments and evidence of conjugate Gaussian models, the density posterior
sweeps and the estimator's SMC path."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
from mellon_tpu.inference import smc as jax_smc
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks
import mellon_tpu_torch
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference import smc
from mellon_tpu_torch.inference.losses import (
    BatchedPotential,
    density_hessian_diagonal,
    make_density_loglik_batch,
    make_density_value_and_grad_batch,
)
from mellon_tpu_torch.inference.samplers import Draws, as_batched


def _gaussian_loglik(m, s2, normalized=False):
    """log N(z; m, s2 I) (up to its constant unless ``normalized``), batched."""
    m = t64(m)

    def loglik(Z):
        d = Z - m
        value = -0.5 * torch.sum(d * d, dim=1) / s2
        if normalized:
            value = value - 0.5 * Z.shape[1] * np.log(2 * np.pi * s2)
        return value, -d / s2

    return BatchedPotential(loglik)


@pytest.mark.parametrize("spread", [1.0, 30.0, 1e4])
def test_ess_and_next_beta_match_jax(spread):
    """The ESS of log weights and the bisected next β on the same
    log-likelihoods: equal to JAX's."""
    log_lik = -np.abs(np.random.RandomState(90).randn(512)) * spread
    for beta, floor in ((0.0, 0.01), (0.3, 1e-4), (0.9, 0.1)):
        want = jax_smc._next_beta(jnp.asarray(log_lik), jnp.asarray(beta), jnp.asarray(256.0), jnp.asarray(floor))
        got = smc._next_beta(t64(log_lik), t64(beta), t64(256.0), t64(floor))
        assert float(got) == float(want)
    w = 0.01 * log_lik
    assert float(smc._ess_from_log_weights(t64(w))) == float(jax_smc._ess_from_log_weights(jnp.asarray(w)))


def test_next_beta_floored_and_exact_one_in_float32():
    """The cases of tests/test_smc.py:216-237 in float32: a log-likelihood
    spread that admits no step above the float32 resolution takes exactly
    the schedule floor, and a floor of the whole gap lands on exactly 1.0;
    both equal JAX's."""
    log_lik = np.linspace(0.0, -1e8, 256).astype(np.float32)
    f32 = dict(dtype=torch.float32)
    for floor in (0.5 / 50, 0.5):
        want = jax_smc._next_beta(jnp.asarray(log_lik), jnp.asarray(0.5, jnp.float32),
                                  jnp.asarray(128.0, jnp.float32), jnp.asarray(floor, jnp.float32))
        got = smc._next_beta(torch.tensor(log_lik), torch.tensor(0.5, **f32), torch.tensor(128.0, **f32),
                             torch.tensor(floor, **f32))
        assert got.dtype == torch.float32 and float(got) == float(want)
    assert float(got) == 1.0


def test_systematic_resample_matches_jax():
    """Systematic resampling with the uniform JAX draws from the same key:
    the same indices, for spread and for degenerate weights (one particle
    left), and always in range (tests/test_smc.py:274-302)."""
    P = 256
    cases = [
        np.linspace(-21651.0, -21194.0, P)[np.random.RandomState(0).permutation(P)],
        np.random.RandomState(91).randn(P) * 3,
        np.where(np.arange(P) == 3, 0.0, -np.inf),
    ]
    for i, log_w in enumerate(cases):
        key = jax.random.PRNGKey(i)
        want = np.asarray(jax_smc._systematic_resample(key, jnp.asarray(log_w), P))
        got = to_np(smc._systematic_resample(t64(float(jax.random.uniform(key))), t64(log_w), P))
        np.testing.assert_array_equal(got, want)
        assert got.max() <= P - 1
    np.testing.assert_array_equal(got, np.full(P, 3))


@pytest.fixture(scope="module")
def fitted():
    """mellon_tpu's L-BFGS fit (n = 120, d = 2, 30 landmarks) and the port's
    estimator holding the same state in float64."""
    x = clustered(120, 2, seed=92)
    jest = mellon_tpu.DensityEstimator(n_landmarks=30)
    jest.fit(jnp.asarray(x))
    return jest, state_from_jax(jest, **CPU64)


class _GivenNormals(Draws):
    """Draws whose normals are the given array."""

    def __init__(self, normals):
        super().__init__(torch.Generator())
        self.normals = normals

    def normal(self, shape, like):
        return t64(self.normals).reshape(shape)


def test_laplace_start_matches_jax(fitted):
    """The Laplace start at the fitted MAP: q's draws on JAX's normals
    (z* + σ·ε, which holds σ), q's log-density and the adjusted
    log-likelihood with their gradients, against JAX's: 1e-10."""
    jest, est = fitted
    adjusted_j, kw_j = jax_smc.laplace_start(jax_density_loss, jest._loss_args, jest.initial_value,
                                             z_map=jest.pre_transformation)
    args = est._loss_args
    adjusted, kw = smc.laplace_start_value_and_grad(make_density_value_and_grad_batch(*args), est.initial_value,
                                     lambda z: density_hessian_diagonal(z, *args),
                                     z_map=est.pre_transformation)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (8, 30)))
    want = np.asarray(kw_j["prior_sample"](key, 8))
    Z = kw["prior_sample"](_GivenNormals(eps), 8)
    np.testing.assert_allclose(to_np(Z), want, rtol=1e-10)
    for fj, fp in ((kw_j["prior_logpdf"], kw["prior_logpdf"]),
                   (lambda z: adjusted_j(z, *jest._loss_args), adjusted)):
        values, grads = as_batched(fp)(Z)
        np.testing.assert_allclose(to_np(values), np.asarray(jax.vmap(fj)(jnp.asarray(want))), rtol=1e-10)
        np.testing.assert_allclose(to_np(grads), np.asarray(jax.vmap(jax.grad(fj))(jnp.asarray(want))),
                                   rtol=1e-10, atol=1e-10)


def test_laplace_start_clips_and_reports_sigma(caplog):
    """A flat direction and a very sharp one are clipped into
    [LAPLACE_SIGMA_MIN, LAPLACE_SIGMA_MAX] with a warning naming "2 of 4"
    (tests/test_smc.py:394-441); q stays usable."""
    curvature = t64([1.0, 1.0, 0.0, 1e8])

    @BatchedPotential
    def value_and_grad(Z):
        return 0.5 * torch.sum(curvature * Z * Z, dim=1), curvature * Z

    logger = logging.getLogger("mellon_tpu_torch")
    propagate, logger.propagate = logger.propagate, True
    try:
        with caplog.at_level(logging.INFO, logger="mellon_tpu_torch"):
            _, kw = smc.laplace_start_value_and_grad(value_and_grad, None, lambda z: curvature.clone(),
                                      z_map=torch.zeros(4, dtype=torch.float64))
    finally:
        logger.propagate = propagate
    clipped = [r for r in caplog.records if "clipping" in r.message]
    assert clipped and clipped[-1].levelno >= logging.WARNING and "2 of 4" in clipped[-1].message
    samples = kw["prior_sample"](Draws(torch.Generator().manual_seed(0)), 8)
    assert torch.isfinite(samples).all() and float(samples[:, 2].std()) < 3 * smc.LAPLACE_SIGMA_MAX
    assert torch.isfinite(as_batched(kw["prior_logpdf"])(samples)[0]).all()


def test_density_loglik_matches_jax(fitted):
    """The batched log-likelihood SMC tempers: the density model's
    likelihood term, loglik_from_loss of the density potential, and JAX's
    loglik_from_loss(density_loss) with its gradient, to 1e-12."""
    jest, est = fitted
    Z = np.random.RandomState(93).randn(5, 30) * 0.3 + np.asarray(jest.pre_transformation)
    direct = make_density_loglik_batch(*est._loss_args)(t64(Z))
    from_loss = smc.loglik_from_loss(make_density_value_and_grad_batch(*est._loss_args))(t64(Z))
    jfn = lambda z: jax_smc.loglik_from_loss(jax_density_loss)(z, *jest._loss_args)  # noqa: E731
    want = (jax.vmap(jfn)(jnp.asarray(Z)), jax.vmap(jax.grad(jfn))(jnp.asarray(Z)))
    for got in (direct, from_loss):
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-12, atol=1e-9)


def test_smc_recovers_gaussian_posterior():
    """Prior N(0, I), likelihood N(z; m, 0.5 I): the analytic posterior
    with the bars of tests/test_smc.py:12-31 (mean 0.08, std 15%)."""
    m, s2 = np.array([1.0, -0.5]), 0.5
    res = smc.run_smc(_gaussian_loglik(m, s2), 2, torch.Generator().manual_seed(0), num_particles=2048,
                      num_mutation_steps=5, dtype=torch.float64)
    post_prec = 1 + 1 / s2
    particles = to_np(res.particles)
    np.testing.assert_allclose(particles.mean(axis=0), (m / s2) / post_prec, atol=0.08)
    np.testing.assert_allclose(particles.std(axis=0), 1 / np.sqrt(post_prec), rtol=0.15)
    assert res.betas[-1] == 1.0 and len(res.ess_history) == len(res.betas)


def test_smc_log_evidence():
    """The evidence of the conjugate model of tests/test_smc.py:34-52,
    N(2; 0, 2), within 0.1 nats."""
    res = smc.run_smc(_gaussian_loglik([2.0], 1.0, normalized=True), 1, torch.Generator().manual_seed(1),
                      num_particles=4096, num_mutation_steps=5, dtype=torch.float64)
    expected = -0.5 * 4.0 / 2.0 - 0.5 * np.log(2 * np.pi * 2.0)
    assert res.log_evidence == pytest.approx(expected, abs=0.1)


def test_smc_terminates_at_beta_one_on_a_peaked_posterior():
    """A likelihood of std 0.03 against the unit prior needs many stages;
    the schedule floor lands β on exactly 1 within 60, the particles track
    the posterior (mean 0.02, std 35%) and the last stage's weights give
    the last ESS (tests/test_smc.py:240-271)."""
    m, s2 = np.array([1.5, -0.8, 0.4]), 1e-3
    res = smc.run_smc(_gaussian_loglik(m, s2), 3, torch.Generator().manual_seed(7), num_particles=1024,
                      num_mutation_steps=5, max_stages=60, dtype=torch.float64)
    assert res.betas[-1] == 1.0 and len(res.betas) <= 60
    post_prec = 1 + 1 / s2
    particles = to_np(res.particles)
    np.testing.assert_allclose(particles.mean(axis=0), (m / s2) / post_prec, atol=0.02)
    np.testing.assert_allclose(particles.std(axis=0), 1 / np.sqrt(post_prec), rtol=0.35)
    ess = float(smc._ess_from_log_weights(res.final_stage_log_weights))
    assert ess == pytest.approx(res.ess_history[-1], rel=1e-10)


def test_run_smc_refuses_what_it_cannot_do():
    """A one-sided custom prior (it would silently use N(0, I)), and a
    mesh or particle sharding that is not one of mellon_tpu_torch.parallel."""
    loglik = _gaussian_loglik([0.0, 0.0], 1.0)
    with pytest.raises(ValueError, match="BOTH prior_sample and prior_logpdf"):
        smc.run_smc(loglik, 2, torch.Generator(), num_particles=8, prior_sample=lambda d, n: None)
    with pytest.raises(ValueError, match="BOTH prior_sample and prior_logpdf"):
        smc.run_smc(loglik, 2, torch.Generator(), num_particles=8, prior_logpdf=lambda Z: None)
    for kw, match in (({"mesh": object()}, "mesh must be"),
                      ({"particle_sharding": object()}, "particle_sharding must be a sharding")):
        with pytest.raises(TypeError, match=match):
            smc.run_smc(loglik, 2, torch.Generator(), num_particles=8, **kw)


def test_smc_density_posterior_laplace_and_prior_starts(fitted):
    """The Laplace start reaches β = 1 in no more stages than the prior
    start, both posterior-mean log densities track the MAP (corr > 0.9)
    and each other (> 0.95), and the evidences agree within 2 nats
    (tests/test_smc.py:328-359)."""
    jest, est = fitted
    ld_map = to_np(est.log_density_x)
    runs = {start: smc.smc_density_posterior(est, num_particles=512, seed=3, num_mutation_steps=5, start=start)
            for start in ("laplace", "prior")}
    (res_l, f_l), (res_p, f_p) = runs["laplace"], runs["prior"]
    assert res_l.betas[-1] == 1.0 and len(res_l.betas) <= len(res_p.betas)
    f_mean_l, f_mean_p = to_np(f_l.mean(dim=0)), to_np(f_p.mean(dim=0))
    assert np.corrcoef(f_mean_l, ld_map)[0, 1] > 0.9
    assert np.corrcoef(f_mean_l, f_mean_p)[0, 1] > 0.95
    assert res_l.log_evidence == pytest.approx(res_p.log_evidence, abs=2.0)
    with pytest.raises(ValueError, match="Unknown start option"):
        smc.smc_density_posterior(est, num_particles=8, start="bogus")


def test_smc_density_posterior_sweeps_and_auto_start(fitted, monkeypatch, caplog):
    """num_sweeps=3 gives the mean evidence with a finite across-sweep std
    under 5 nats, a single sweep none; start="auto" resolves to "prior"
    below SMC_LAPLACE_AUTO_N terms and to "laplace" above."""
    _, est = fitted
    res, f = smc.smc_density_posterior(est, num_particles=256, seed=0, num_mutation_steps=3, num_sweeps=3)
    assert np.isfinite(res.log_evidence_std) and res.log_evidence_std < 5.0
    assert np.isfinite(res.log_evidence) and f.shape == (256, 120)
    single, _ = smc.smc_density_posterior(est, num_particles=256, seed=0, num_mutation_steps=3)
    assert single.log_evidence_std is None

    logger = logging.getLogger("mellon_tpu_torch")
    propagate, logger.propagate = logger.propagate, True
    resolved = []
    try:
        with caplog.at_level(logging.INFO, logger="mellon_tpu_torch"):
            for threshold in (smc.SMC_LAPLACE_AUTO_N, 10):
                monkeypatch.setattr(smc, "SMC_LAPLACE_AUTO_N", threshold)
                caplog.clear()
                smc.smc_density_posterior(est, num_particles=64, seed=0, num_mutation_steps=2)
                resolved += [r.message for r in caplog.records if "start='auto' resolved" in r.message]
    finally:
        logger.propagate = propagate
    assert "'prior'" in resolved[0] and "'laplace'" in resolved[1]


@pytest.fixture(scope="module")
def smc_fits():
    """optimizer="smc" (1,024 particles, the prior start) on the same data
    and landmarks: the JAX package with seeds 42 and 43, the port with its
    own stream; and the port with the Laplace start."""
    x = clustered(150, 2, seed=94)
    xu = np.asarray(jax_compute_landmarks(jnp.asarray(x), n_landmarks=25, random_state=42))
    jfits = [mellon_tpu.DensityEstimator(landmarks=jnp.asarray(xu), optimizer="smc", random_state=s)
             .fit(jnp.asarray(x)) for s in (42, 43)]
    ports = [mellon_tpu_torch.DensityEstimator(landmarks=xu, optimizer="smc", sampler_options=opts,
                                               predictor_with_uncertainty=True, **CPU64).fit(x)
             for opts in (None, {"start": "laplace", "num_particles": 256})]
    return jfits, ports, x


def test_estimator_smc_within_the_seed_spread_of_jax(smc_fits):
    """The port's particle mean and std of the latents against the JAX
    package's seed-42 run: each max |Δ| is at most twice the max |Δ|
    between JAX's seed-42 and seed-43 runs (measured on the CPU: mean
    0.099 against 0.074, std 0.040 against 0.084)."""
    jfits, (est, _), _ = smc_fits
    for attr in ("pre_transformation", "pre_transformation_std"):
        j0, j1 = (np.asarray(getattr(j, attr)) for j in jfits)
        got = to_np(getattr(est, attr))
        assert np.abs(got - j0).max() <= 2 * np.abs(j1 - j0).max(), (attr, np.abs(got - j0).max(),
                                                                     np.abs(j1 - j0).max())


def test_estimator_smc_reports_the_sweep(smc_fits):
    """The estimator keeps the particles and the result, takes the stds
    from them (no Laplace step), and the Laplace start fits too: β = 1,
    a log density that tracks the prior start's (corr > 0.9)."""
    _, (est, est_l), x = smc_fits
    assert est.posterior_samples.shape == (1024, est.L.shape[1]) and est.smc_result.betas[-1] == 1.0
    assert torch.equal(est.pre_transformation_std, est.posterior_samples.std(dim=0, correction=0))
    assert est.losses == [-est.smc_result.log_evidence]
    assert est_l.smc_result.betas[-1] == 1.0 and est_l.posterior_samples.shape[0] == 256
    assert np.corrcoef(to_np(est_l.log_density_x), to_np(est.log_density_x))[0, 1] > 0.9
    u = est.predict.uncertainty(clustered(20, 2, seed=95))
    assert torch.isfinite(u).all() and (u > 0).all()
