"""Mean-field automatic differentiation variational inference (ADVI)
(counterpart of ``mellon_tpu/inference/advi.py``).

A diagonal Gaussian q(z) = N(mean, diag(std²)) is fit by maximising a
Monte-Carlo ELBO over ``nsamples`` draws per step with adam
(:func:`.optimizers.adam_step`, the schedule exp(−0.01·i)·lr0), from an
initial log-std of 0.  The loss takes all draws at once, as an (S, k)
batch, and autograd gives the gradient.  The standard-normal draws come
from a ``torch.Generator``: torch cannot reproduce JAX's threefry stream,
so :func:`elbo_from_draws` takes the draws as a tensor and a test can feed
it JAX's own.

:func:`run_advi` and :func:`elbo_estimate` take the JAX package's
arguments, a scalar ``loss_func(z, *loss_args)`` (or ``logprob(z)``), and
JAX's ``seed`` (``run_advi``) or a ``torch.Generator`` where JAX takes a
key (``elbo_estimate``); the scalar is evaluated at the batch by the
autograd batch of :func:`.samplers.as_batched` (the density loss in closed
form).  The estimators hand :func:`run_advi_batch` their batched loss and
generator.
"""

import math
from collections import namedtuple

import torch

from .optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, adam_init, adam_step
from .samplers import as_batched

DEFAULT_NUM_SAMPLES = 40

Results = namedtuple("Results", "pre_transformation pre_transformation_std losses")


def _gaussian_logpdf(x, mean, log_std):
    """log q at each row of x (S, k)."""
    z = (x - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def elbo_from_draws(loss_batch, mean, log_std, draws):
    """The ELBO averaged over the standard-normal ``draws`` (S, k):
    samples mean + e^{log_std}·draws, each scored by −loss − log q.
    ``loss_batch`` maps the (S, k) samples to their S losses."""
    samples = mean + torch.exp(log_std) * draws
    return torch.mean(-loss_batch(samples) - _gaussian_logpdf(samples, mean, log_std))


def elbo_estimate(logprob, generator, mean, log_std, num_samples):
    """The ELBO of q = N(mean, diag e^{2 log_std}) against the scalar
    log density ``logprob(z)``, averaged over ``num_samples`` draws from
    ``generator``, as the JAX package's (differentiable in mean and
    log_std)."""
    draws = torch.randn((int(num_samples),) + tuple(mean.shape), generator=generator,
                        dtype=mean.dtype, device=mean.device)
    logprob_batch = as_batched(logprob).values
    return elbo_from_draws(lambda Z: -logprob_batch(Z), mean, log_std, draws)


def run_advi(
    loss_func,
    initial_parameters,
    n_iter=DEFAULT_N_ITER,
    init_learn_rate=DEFAULT_INIT_LEARN_RATE,
    nsamples=DEFAULT_NUM_SAMPLES,
    jit=True,
    seed=0,
    loss_args=(),
):
    """Fit a mean-field Gaussian to exp(−loss_func) for the scalar
    ``loss_func(z, *loss_args)``, as the JAX package's: the noise from a
    ``torch.Generator`` seeded with ``seed`` on the parameters' device;
    ``jit`` is accepted and ignored.  Returns ``(mean, std, losses)``
    (:func:`run_advi_batch`, which takes a generator)."""
    generator = torch.Generator(device=initial_parameters.device).manual_seed(int(seed))
    return run_advi_batch(as_batched(loss_func, loss_args).values, initial_parameters, n_iter=n_iter,
                          init_learn_rate=init_learn_rate, nsamples=nsamples, generator=generator)


def run_advi_batch(
    loss_batch,
    initial_parameters,
    n_iter=DEFAULT_N_ITER,
    init_learn_rate=DEFAULT_INIT_LEARN_RATE,
    nsamples=DEFAULT_NUM_SAMPLES,
    generator=None,
):
    """Fit a mean-field Gaussian to exp(−loss).

    ``loss_batch`` maps an (S, k) batch of latent vectors to their S
    losses.  ``generator`` (a ``torch.Generator`` on the parameters'
    device) draws the noise.  Returns ``(mean, std, losses)``, the losses
    being the negative ELBO of each step, as one tensor (no host read per
    step).
    """
    mean = initial_parameters.detach().clone()
    params = (mean, torch.zeros_like(mean))
    state = adam_init(params)
    losses = []
    for _ in range(int(n_iter)):
        draws = torch.randn(
            (int(nsamples),) + tuple(mean.shape),
            generator=generator, dtype=mean.dtype, device=mean.device,
        )
        leaves = tuple(p.requires_grad_(True) for p in params)
        with torch.enable_grad():
            value = -elbo_from_draws(loss_batch, *leaves, draws)
            grads = torch.autograd.grad(value, leaves)
        losses.append(value.detach())
        params, state = adam_step(
            tuple(p.detach() for p in leaves), grads, state, init_learn_rate
        )
    mean, log_std = params
    losses = torch.stack(losses) if losses else mean.new_empty(0)
    return Results(mean, torch.exp(log_std), losses)
