"""Whitened transform and the density loss with its analytic gradient
(counterpart of ``mellon_tpu/inference/losses.py``).

The loss is the negative log posterior of z with f = L z + μ:

    loss(z) = ½‖z‖² + (k/2) log 2π − Σᵢ [fᵢ + Vdrᵢ − exp(fᵢ + Vᵢ) + c]
    ∇loss(z) = z − Lᵀ (1 − exp(f + V))

where V and Vdr are the 1-NN likelihood constants and c the optional
``loss_offset_per_term``.  Autodiff is not needed: the gradient reads L
once more, as a transposed matrix-vector product (a fused one-pass
value-and-grad kernel is ROADMAP kernel K4).  The same closed form gives
the Hessian and its diagonal (the Laplace approximation, the samplers'
preconditioner); ADVI, the samplers' chains and SMC's particles evaluate
the loss at a batch of latent vectors at once.
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


def make_density_loss_batch(L, nn_distances, d, mu):
    """``Z -> losses``: the density loss at each row of Z (S, k), shape
    (S,).  The S latent vectors go through L as one (n, k)×(k, S) product,
    F = L Zᵀ + μ; autograd gives the gradient (ADVI's sampled ELBO)."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)

    def loss_batch(Z):
        k = Z.shape[1]
        F = L @ Z.T + mu
        prior = -(1 / 2) * torch.sum(Z * Z, dim=1) - (k / 2) * math.log(2 * math.pi)
        likelihood = torch.sum((F + Vdr[:, None]) - torch.exp(F + V[:, None]), dim=0)
        return -(prior + likelihood)

    return loss_batch


def make_density_value_and_grad_batch(L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """``Z -> (losses (C,), gradients (C, k))`` at the C rows of Z: the
    samplers' potential, one call per leapfrog for every chain.  F = L Zᵀ + μ
    and the gradient Z − (Lᵀ(1 − E))ᵀ are two (n, k)×(k, C) products;
    ``loss_offset_per_term`` as in :func:`density_loss`."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)
    V, Vdr = V[:, None], Vdr[:, None]

    def value_and_grad(Z):
        k = Z.shape[1]
        F = L @ Z.T + mu
        E = torch.exp(F + V)
        prior = -(1 / 2) * torch.sum(Z * Z, dim=1) - (k / 2) * math.log(2 * math.pi)
        likelihood = torch.sum((F + Vdr) - E + loss_offset_per_term, dim=0)
        return -(prior + likelihood), Z - (L.T @ (1 - E)).T

    return value_and_grad


def make_density_loglik_batch(L, nn_distances, d, mu):
    """``Z -> (log-likelihoods (C,), gradients (C, k))``: the likelihood
    term of the density loss alone, which SMC tempers (the JAX package
    gets it as ``loglik_from_loss(density_loss)``)."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)
    V, Vdr = V[:, None], Vdr[:, None]

    def loglik(Z):
        F = L @ Z.T + mu
        E = torch.exp(F + V)
        return torch.sum((F + Vdr) - E, dim=0), (L.T @ (1 - E)).T

    return loglik


# rows of L per step of the Hessian diagonal: bounds its (rows, k) temporary
HESSIAN_CHUNK_ROWS = 4096


def density_hessian_diagonal(z, L, nn_distances, d, mu):
    """Diagonal of the density loss's Hessian at z in closed form.

    The Hessian is I + Lᵀ·diag(e^{Lz+μ+V})·L, so its diagonal is
    1 + Σᵢ eᵢ·Lᵢⱼ².  It accumulates over :data:`HESSIAN_CHUNK_ROWS` rows
    of L at a time: the JAX package gets the same numbers from chunked
    Hessian-vector products (``mellon_tpu/inference/laplace.py``).
    """
    V, _ = nearest_neighbors_terms(nn_distances, d)
    diag = torch.ones_like(z)
    for start in range(0, L.shape[0], HESSIAN_CHUNK_ROWS):
        rows = L[start : start + HESSIAN_CHUNK_ROWS]
        e = torch.exp(rows @ z + mu + V[start : start + HESSIAN_CHUNK_ROWS])
        diag = diag + e @ (rows * rows)
    return diag


def density_hessian(z, L, nn_distances, d, mu):
    """The density loss's Hessian I + Lᵀ·diag(e^{Lz+μ+V})·L at z, (k, k),
    summed over :data:`HESSIAN_CHUNK_ROWS` rows of L at a time: the matrix
    the JAX package assembles from blocked Hessian-vector products
    (``mellon_tpu/inference/mcmc.py:_hessian_block``)."""
    V, _ = nearest_neighbors_terms(nn_distances, d)
    H = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    for start in range(0, L.shape[0], HESSIAN_CHUNK_ROWS):
        rows = L[start : start + HESSIAN_CHUNK_ROWS]
        e = torch.exp(rows @ z + mu + V[start : start + HESSIAN_CHUNK_ROWS])
        H = H + (rows * e[:, None]).T @ rows
    return H


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
