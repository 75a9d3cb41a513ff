"""Whitened transform and the density loss with its analytic gradient
(counterpart of ``mellon_tpu/inference/losses.py``).

The loss is the negative log posterior of z with f = L z + μ:

    loss(z) = ½‖z‖² + (k/2) log 2π − Σᵢ [fᵢ + Vdrᵢ − exp(fᵢ + Vᵢ) + c]
    ∇loss(z) = z − Lᵀ (1 − exp(f + V))

where V and Vdr are the 1-NN likelihood constants and c the optional
``loss_offset_per_term``.  Autodiff is not needed: the gradient reads L
once more, as a transposed matrix-vector product (a fused one-pass
value-and-grad kernel is ROADMAP kernel K4).
"""

import math

import torch

from .likelihoods import nearest_neighbors_likelihood, nearest_neighbors_terms, normal_prior


def _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term):
    k = z.shape[0]
    f = L @ z + mu
    e = torch.exp(f + V)
    prior = -(1 / 2) * torch.sum(z * z) - (k / 2) * math.log(2 * math.pi)
    likelihood = torch.sum((f + Vdr) - e + loss_offset_per_term)
    return -(prior + likelihood), z - L.T @ (1 - e)


def density_value_and_grad(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """``(loss, gradient)`` of the density model at z (0-d tensor, (k,))."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)
    return _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term)


def density_loss(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """Negative log posterior of the density model at z (a 0-d tensor);
    same arguments as ``mellon_tpu.inference.losses.density_loss``."""
    return density_value_and_grad(z, L, nn_distances, d, mu, loss_offset_per_term)[0]


def make_density_value_and_grad(L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """``z -> (loss, gradient)`` with the likelihood constants computed once,
    for the optimizer's repeated evaluations."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)

    def value_and_grad(z):
        return _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term)

    return value_and_grad


def compute_transform(mu, L):
    """z -> f = L z + mu."""

    def transform(z):
        return L @ z + mu

    return transform


def compute_loss_func(nn_distances, d, transform, k):
    """Closure form of the loss, ``z -> loss`` (kept for API parity)."""
    prior = normal_prior(k)
    likelihood = nearest_neighbors_likelihood(nn_distances, d)

    def loss_func(z):
        return -(prior(z) + likelihood(transform(z)))

    return loss_func


def compute_log_density_x(pre_transformation, transform):
    """Function values at the training points."""
    return transform(pre_transformation)
