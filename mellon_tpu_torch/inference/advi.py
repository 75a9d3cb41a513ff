"""Mean-field automatic differentiation variational inference (ADVI)
(counterpart of ``mellon_tpu/inference/advi.py``).

A diagonal Gaussian q(z) = N(mean, diag(std²)) is fit by maximising a
Monte-Carlo ELBO over ``nsamples`` draws per step with adam
(:func:`.optimizers.adam_step`, the schedule exp(−0.01·i)·lr0), from an
initial log-std of 0.  The loss takes all draws at once, as an (S, k)
batch, and autograd gives the gradient.  The standard-normal draws come
from a ``torch.Generator``: torch cannot reproduce JAX's threefry stream,
so :func:`elbo_estimate` takes the draws as a tensor and a test can feed
it JAX's own.
"""

import math
from collections import namedtuple

import torch

from .optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, adam_init, adam_step

DEFAULT_NUM_SAMPLES = 40

Results = namedtuple("Results", "pre_transformation pre_transformation_std losses")


def _gaussian_logpdf(x, mean, log_std):
    """log q at each row of x (S, k)."""
    z = (x - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def elbo_estimate(loss_batch, mean, log_std, draws):
    """The ELBO averaged over the standard-normal ``draws`` (S, k):
    samples mean + e^{log_std}·draws, each scored by −loss − log q.
    ``loss_batch`` maps the (S, k) samples to their S losses."""
    samples = mean + torch.exp(log_std) * draws
    return torch.mean(-loss_batch(samples) - _gaussian_logpdf(samples, mean, log_std))


def run_advi(
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
            value = -elbo_estimate(loss_batch, *leaves, draws)
            grads = torch.autograd.grad(value, leaves)
        losses.append(value.detach())
        params, state = adam_step(
            tuple(p.detach() for p in leaves), grads, state, init_learn_rate
        )
    mean, log_std = params
    losses = torch.stack(losses) if losses else mean.new_empty(0)
    return Results(mean, torch.exp(log_std), losses)
