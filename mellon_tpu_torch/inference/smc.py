"""Sequential Monte Carlo with adaptive likelihood tempering (counterpart
of ``mellon_tpu/inference/smc.py``).

Particles start from the prior N(0, I) of the whitened latents (or a custom
start distribution q) and anneal along π_β ∝ prior·L(z)^β, with each β
chosen so the stage keeps its effective sample size near a target.  A
stage is the particles' batched log-likelihood, 30 bisection steps for the
next β on the device, the weights and the evidence increment, systematic
resampling, and HMC mutation of all particles at once; the host reads the
stage's four scalars once (β, ESS, acceptance, evidence increment) for the
step-size controller, the log and the stop at β = 1.

:func:`run_smc`, :func:`loglik_from_loss` and :func:`laplace_start` take
the JAX package's scalar functions of one latent vector, ``loglik_fn(z,
*loglik_args)`` and ``loss_fn(z, *loss_args)``; the sweep evaluates every
particle at once through their batched forms (:func:`.samplers.as_batched`:
``Z (P, k) -> (values (P,), gradients (P, k))``; the density loss in closed
form).  A custom ``prior_logpdf`` is a scalar ``q(z)`` or a batched
potential; ``prior_sample(draws, P)`` draws through the sweep's
:class:`.samplers.Draws` source (its ``generator`` is the
``torch.Generator``), where the JAX package hands it a key.

``mesh=`` (or ``particle_sharding=``) splits the particles in blocks over
the ranks of a mesh axis.  A rank evaluates and mutates its block; what is
global is computed globally on every rank: the P log-likelihoods that the
β bisection, the weights, the ESS and the evidence read are gathered, the
systematic resampling runs over all P particles with the uniform every
rank draws alike, and each rank takes its block of the resampled
particles from the gathered ones.  The draws go through a chain block of
the generator (:meth:`.samplers.Draws.chain_block`), so a sweep on any
mesh is the unsharded sweep of the same seed, up to the summation order of
the global means.
"""

import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from .laplace import hessian_diagonal_of, laplace_std_from_diagonal
from .losses import BatchedPotential, density_loss, make_density_loglik_batch
from ..parallel.mesh import Mesh, chain_sharding, check_sharding, sampling_block
from .optimizers import minimize_lbfgs_value_and_grad
from .samplers import ScalarPotential, as_batched, as_draws, hmc_init, hmc_kernel

logger = logging.getLogger("mellon_tpu_torch")

# laplace_start clips the diagonal-Laplace std into this range so a flat or
# ill-conditioned direction cannot explode the start distribution q; more
# than the warn fraction of clipped directions is a warning
LAPLACE_SIGMA_MIN = 1e-3
LAPLACE_SIGMA_MAX = 10.0
LAPLACE_CLIP_WARN_FRACTION = 0.01

# smc_density_posterior(start="auto"): the number of likelihood terms from
# which the Laplace start replaces the prior start (at scale the prior start
# rides the schedule floor with collapsed ESS and biases the evidence low)
SMC_LAPLACE_AUTO_N = 10_000

_LOG_2PI = math.log(2 * math.pi)


def loglik_from_loss(loss_fn):
    """The likelihood term of the negative log posterior ``loss_fn(z,
    *args)`` with the N(0, I) prior of the whitened latents: −loss − log
    prior, the scalar ``loglik(z, *args)`` of the JAX package.  Batched
    (:func:`.samplers.as_batched`) it is the loss's batched likelihood
    term (:meth:`.losses.BatchedPotential.loglik`; the density loss's in
    closed form).  A batched ``loss_fn`` gives the batched log-likelihood."""
    if isinstance(loss_fn, BatchedPotential):
        return loss_fn.loglik()

    def loglik(z, *args):
        prior = -0.5 * torch.sum(z * z) - 0.5 * z.numel() * _LOG_2PI
        return -loss_fn(z, *args) - prior

    return ScalarPotential(loglik, lambda *args: as_batched(loss_fn, args).loglik())


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (num_particles, dim)
    log_weights: torch.Tensor  # (num_particles,): zeros once the sweep reached β = 1
    betas: list  # the tempering schedule used
    ess_history: list
    acceptance_history: list
    log_evidence: float  # log normalizing-constant estimate
    final_stage_log_weights: torch.Tensor = None  # the last stage's weights before resampling
    log_evidence_std: float = None  # across sweeps, when smc_density_posterior ran several


def _std_normal_logpdf(Z):
    return -0.5 * torch.sum(Z * Z, dim=1) - 0.5 * Z.shape[1] * _LOG_2PI, -Z


def _ess_from_log_weights(log_w):
    log_w = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2 * log_w, 0))


def _next_beta(log_lik, beta, target_ess, min_step):
    """The largest β increment that keeps the ESS at or above
    ``target_ess``: 30 bisection steps on the device, all operands 0-d
    tensors.  ``min_step`` floors the increment (the caller passes the
    schedule floor (1 − β)/stages left, so the sweep reaches β = 1 within
    its stages); a step that reaches the end lands on exactly 1.0."""
    hi0 = 1.0 - beta

    def ess_at(delta):
        return _ess_from_log_weights(delta * log_lik)

    full_ok = ess_at(hi0) >= target_ess
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target_ess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    eps = torch.finfo(hi0.dtype).eps
    lo = torch.minimum(torch.maximum(lo, torch.clamp_min(min_step, eps)), hi0)
    done = full_ok | (lo >= hi0)
    return torch.where(done, torch.ones_like(hi0), beta + lo)


def _systematic_resample(u, log_w, num_particles):
    """Systematic resampling indices from log weights and one uniform u.
    The cumulative sum of the normalized weights can end below the last
    position in float32; the index is clamped into range."""
    w = torch.exp(log_w - torch.logsumexp(log_w, 0))
    positions = (torch.arange(num_particles, dtype=log_w.dtype, device=log_w.device) + u) / num_particles
    idx = torch.searchsorted(torch.cumsum(w, 0), positions)
    return torch.clamp_max(idx, num_particles - 1)


def _smc_stage(loglik_fn, prior_logpdf, particles, draws, beta, step_size, target_ess,
               min_step, num_mutation_steps, num_leapfrog_steps, sharding, num_particles):
    """One tempering stage: weights, next β, evidence and ESS, systematic
    resampling, HMC mutation of this rank's block of the ``num_particles``
    under ``sharding``.  Everything stays on the device; ``loglik_fn`` and
    ``prior_logpdf`` are batched."""
    dim = particles.shape[1]
    log_lik = sharding.gather(loglik_fn(particles)[0])
    new_beta = _next_beta(log_lik, beta, target_ess, min_step)
    log_w = (new_beta - beta) * log_lik
    log_ev_inc = torch.logsumexp(log_w, 0) - math.log(num_particles)
    ess = _ess_from_log_weights(log_w)
    idx = _systematic_resample(draws.uniform((), particles), log_w, num_particles)
    start, stop = sharding.block(num_particles)
    particles = sharding.gather(particles)[idx[start:stop]]

    def potential(Z):
        prior, prior_grad = prior_logpdf(Z)
        lik, lik_grad = loglik_fn(Z)
        return -(prior + new_beta * lik), -(prior_grad + new_beta * lik_grad)

    potential = BatchedPotential(potential)
    kernel = hmc_kernel(potential, num_steps=num_leapfrog_steps)
    state = hmc_init(potential, particles)
    unit_mass = torch.ones(dim, dtype=particles.dtype, device=particles.device)
    accept = torch.zeros_like(state.potential)
    for _ in range(num_mutation_steps):
        state, info = kernel(state, draws, step_size, unit_mass)
        accept = accept + info.accept_prob
    return (state.z, new_beta, ess, sharding.mean(accept / num_mutation_steps, num_particles),
            log_ev_inc, log_w)


def run_smc(
    loglik_fn,
    dim,
    generator,
    num_particles=1024,
    target_ess_frac=0.5,
    num_mutation_steps=5,
    mutation_step_size=0.2,
    num_leapfrog_steps=8,
    max_stages=100,
    prior_sample=None,
    prior_logpdf=None,
    loglik_args=(),
    mesh=None,
    particle_sharding=None,
    dtype=None,
):
    """Anneal particles from N(0, I) (or a custom prior) to the posterior
    ∝ prior·exp(loglik).

    ``loglik_fn(z, *loglik_args)`` and a custom ``prior_logpdf(z)`` are
    scalar functions of one latent vector (or batched potentials), taken
    through :func:`.samplers.as_batched`; ``prior_sample(draws, P)``
    draws the start through the :class:`.samplers.Draws` source made from
    ``generator`` (a ``torch.Generator`` where the JAX package takes a
    key).  The default prior's particles take ``dtype`` (the default
    torch dtype if None) on the generator's device.  Every stage's
    step is floored at (remaining gap)/(stages left), so β reaches 1
    within ``max_stages``.  Returns an :class:`SMCResult`; ``log_evidence``
    estimates log ∫ prior(z)·exp(loglik(z)) dz.

    ``mesh=`` splits the particles over its chains axis
    (``num_particles`` must divide over it); ``particle_sharding=`` (a
    sharding of :mod:`..parallel`) names another split.  Every rank passes
    a generator seeded alike and gets the global result; ``loglik_fn`` may
    be cell-sharded on the same mesh.
    """
    if (prior_sample is None) != (prior_logpdf is None):
        raise ValueError(
            "Custom priors require BOTH prior_sample and prior_logpdf: with "
            "only one of them the tempering weights and HMC mutations would "
            "silently target the default N(0, I) prior, biasing the "
            "posterior and evidence estimates."
        )
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a mellon_tpu_torch.parallel mesh, got {type(mesh).__name__}.")
    sharding = check_sharding(particle_sharding, "particle_sharding")
    if sharding is None and mesh is not None:
        sharding = chain_sharding(mesh)
    draws = as_draws(generator)
    loglik_fn = as_batched(loglik_fn, loglik_args)
    if prior_sample is None:
        like = torch.empty(0, dtype=dtype or torch.get_default_dtype(),
                           device=torch.device(draws.generator.device))
        particles = draws.normal((num_particles, dim), like)
        prior_fn = _std_normal_logpdf
    else:
        particles = prior_sample(draws, num_particles)
        prior_fn = as_batched(prior_logpdf)
    sharding, particles, draws = sampling_block(sharding, particles, draws, "particles")

    def scalar(value):
        return torch.tensor(value, dtype=particles.dtype, device=particles.device)

    beta = 0.0
    betas, ess_hist, accept_hist = [], [], []
    log_evidence = 0.0
    step_size = mutation_step_size
    target_ess = target_ess_frac * num_particles
    final_log_w = None
    for stage in range(max_stages):
        min_step = (1.0 - beta) / (max_stages - stage)
        particles, new_beta, ess, accept, ev_inc, final_log_w = _smc_stage(
            loglik_fn, prior_fn, particles, draws, scalar(beta), scalar(step_size),
            scalar(target_ess), scalar(min_step), num_mutation_steps, num_leapfrog_steps, sharding,
            num_particles,
        )
        # the stage's one host read
        new_beta, ess, accept, ev_inc = torch.stack([new_beta, ess, accept, ev_inc]).tolist()
        log_evidence += ev_inc
        # smooth multiplicative controller towards ~65% acceptance
        step_size *= float(np.clip(np.exp(accept - 0.65), 0.6, 1.45))
        betas.append(new_beta)
        ess_hist.append(ess)
        accept_hist.append(accept)
        logger.info(
            "SMC stage %d: beta=%.4f ess=%.0f accept=%.2f step=%.3g",
            stage, new_beta, ess, accept, step_size,
        )
        if ess < 0.5 * target_ess:
            logger.warning(
                "SMC stage %d ESS %.0f fell well below target %.0f (forced "
                "tempering step on a peaked likelihood); the resample/"
                "mutation absorbs the degeneracy, but consider more stages "
                "or particles if this recurs.",
                stage, ess, target_ess,
            )
        beta = new_beta
        if beta >= 1.0:
            break
    particles = sharding.gather(particles)
    return SMCResult(
        particles=particles,
        log_weights=torch.zeros(num_particles, dtype=particles.dtype, device=particles.device),
        betas=betas,
        ess_history=ess_hist,
        acceptance_history=accept_hist,
        log_evidence=log_evidence,
        final_stage_log_weights=final_log_w,
    )


def laplace_start(loss_fn, loss_args, z0, z_map=None):
    """The Laplace start of :func:`run_smc` for the scalar negative log
    posterior ``loss_fn(z, *loss_args)``, as the JAX package's:
    ``(adjusted_loglik, prior kwargs)``, where ``adjusted_loglik(z, *args)``
    = −loss − log q is a scalar to pass with ``loglik_args=loss_args`` and
    q = N(z*, diag σ²).  The loss is evaluated by
    :func:`.samplers.as_batched` and its Hessian diagonal by
    :func:`.laplace.hessian_diagonal_of` (the density loss in closed form),
    as :func:`laplace_start_value_and_grad` takes them batched."""
    _, prior = laplace_start_value_and_grad(
        as_batched(loss_fn, loss_args), z0, hessian_diagonal_of(loss_fn, loss_args), z_map)
    q_logpdf = prior["prior_logpdf"]

    def adjusted_loglik(z, *args):
        return -loss_fn(z, *args) - q_logpdf(z)

    def adjusted_batched(*args):
        return _adjusted_loglik(as_batched(loss_fn, args), q_logpdf)

    return ScalarPotential(adjusted_loglik, adjusted_batched), prior


def _adjusted_loglik(value_and_grad, q_logpdf):
    """log π(z) − log q(z), batched."""
    q_batch = as_batched(q_logpdf)

    def adjusted_loglik(Z):
        values, grads = value_and_grad(Z)
        q, q_grad = q_batch(Z)
        return -values - q, -grads - q_grad

    return BatchedPotential(adjusted_loglik)


def laplace_start_value_and_grad(value_and_grad, z0, hessian_diagonal, z_map=None):
    """The Laplace start of :func:`run_smc`: ``(adjusted loglik, prior
    kwargs)`` for q = N(z*, diag σ²) and log π(z) − log q(z), batched.

    ``value_and_grad`` is the batched negative log posterior (a
    :class:`.losses.BatchedPotential`) and ``hessian_diagonal(z) -> (k,)``
    its Hessian's diagonal.  ``z_map`` reuses a fitted MAP; otherwise
    L-BFGS from ``z0`` finds it, on the potential's one-row form.  σ is the
    diagonal Laplace std clipped into [LAPLACE_SIGMA_MIN,
    LAPLACE_SIGMA_MAX]; the target at β = 1 and the evidence are those of
    the prior start, on a short, well-mixed annealing path.
    """
    if z_map is None:
        z_map = minimize_lbfgs_value_and_grad(value_and_grad.one_row, z0).pre_transformation
    dim = int(z_map.shape[-1])
    sigma = laplace_std_from_diagonal(hessian_diagonal(z_map))
    n_low, n_high = torch.stack([
        torch.count_nonzero(sigma < LAPLACE_SIGMA_MIN),
        torch.count_nonzero(sigma > LAPLACE_SIGMA_MAX),
    ]).tolist()
    n_clipped = n_low + n_high
    if n_clipped:
        msg = (
            "laplace_start: clipping %d of %d Laplace std entries into "
            "[%g, %g] (%d too sharp, %d too flat/ill-conditioned)."
        )
        args = (n_clipped, dim, LAPLACE_SIGMA_MIN, LAPLACE_SIGMA_MAX, n_low, n_high)
        if n_clipped / dim > LAPLACE_CLIP_WARN_FRACTION:
            logger.warning(
                msg + " The clipped start no longer matches the Laplace "
                "approximation's scales in those directions; the SMC "
                "result at beta=1 is still exact, but expect a longer "
                "annealing path (consider start='prior' or inspecting "
                "the Hessian conditioning).",
                *args,
            )
        else:
            logger.info(msg, *args)
    sigma = torch.clamp(sigma, LAPLACE_SIGMA_MIN, LAPLACE_SIGMA_MAX)
    log_sigma_sum = torch.sum(torch.log(sigma))

    def q_sample(draws, n):
        return z_map[None, :] + sigma[None, :] * draws.normal((n, dim), z_map)

    def q_logpdf_batch(Z):
        u = (Z - z_map) / sigma
        return -0.5 * torch.sum(u * u, dim=1) - log_sigma_sum - 0.5 * dim * _LOG_2PI, -u / sigma

    def q_logpdf(z):
        u = (z - z_map) / sigma
        return -0.5 * torch.sum(u * u) - log_sigma_sum - 0.5 * dim * _LOG_2PI

    # log q: a scalar that knows its batched form
    batched = BatchedPotential(q_logpdf_batch)
    q_logpdf = ScalarPotential(q_logpdf, lambda: batched)
    return _adjusted_loglik(value_and_grad, q_logpdf), dict(prior_sample=q_sample,
                                                            prior_logpdf=q_logpdf)


def smc_density_posterior(estimator, num_particles=1024, seed=0, start="auto", num_sweeps=1,
                          generator=None, **kwargs):
    """SMC over the whitened latents of a prepared density estimator:
    ``(SMCResult, function samples (num_particles, n))``.

    ``start="prior"`` anneals from N(0, I); ``"laplace"`` from the diagonal
    Laplace Gaussian at the MAP (``pre_transformation`` when fitted, else
    an L-BFGS fit); ``"auto"`` takes "laplace" from
    :data:`SMC_LAPLACE_AUTO_N` likelihood terms on.  ``num_sweeps > 1``
    runs that many sweeps, one after another on one generator (seeded with
    ``seed``, or ``generator``), and reports the mean log evidence with its
    across-sweep std (ddof 1); particles are the last sweep's.
    """
    if estimator.loss_func is None:
        raise ValueError("Estimator not prepared. Call prepare_inference(x) first.")
    z0 = estimator.initial_value
    dim = int(z0.shape[0])
    args = (estimator.L, estimator.nn_distances, estimator.d, estimator.mu)
    if start == "auto":
        n_terms = 0 if estimator.nn_distances is None else int(estimator.nn_distances.shape[0])
        start = "laplace" if n_terms >= SMC_LAPLACE_AUTO_N else "prior"
        logger.info(
            "SMC start='auto' resolved to '%s' (%s likelihood terms, threshold %s).",
            start, f"{n_terms:,}", f"{SMC_LAPLACE_AUTO_N:,}",
        )
    if start == "laplace":
        loglik, prior_kwargs = laplace_start(
            density_loss, args, z0, z_map=getattr(estimator, "pre_transformation", None))
        loglik = as_batched(loglik, args)
    elif start == "prior":
        loglik, prior_kwargs = make_density_loglik_batch(*args), {}
    else:
        raise ValueError(
            f"Unknown start option: {start!r}. "
            'Available options are "auto", "prior" and "laplace".'
        )
    if generator is None:
        generator = torch.Generator(device=z0.device).manual_seed(int(seed))
    draws = as_draws(generator)
    evidences = []
    for _ in range(max(int(num_sweeps), 1)):
        result = run_smc(loglik, dim, draws, num_particles=num_particles, dtype=z0.dtype,
                         **prior_kwargs, **kwargs)
        evidences.append(result.log_evidence)
    if len(evidences) > 1:
        ev_mean, ev_std = float(np.mean(evidences)), float(np.std(evidences, ddof=1))
        logger.info(
            "SMC evidence over %d independent sweeps: %.2f +- %.2f nats.",
            len(evidences), ev_mean, ev_std,
        )
        result = result._replace(log_evidence=ev_mean, log_evidence_std=ev_std)
    return result, estimator.transform(result.particles.T).T
