"""Whitened transforms and the density and dimensionality losses with
their analytic gradients (counterpart of ``mellon_tpu/inference/losses.py``).

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

The dimensionality model stacks two latent vectors, z = (z₀, z₁) of shape
(2, k): the log local dimension a = L z₀ + μ_dim (dims = eᵃ) and the log
density b = L z₁ + μ_dens.  With the sorted k-NN log-distances ℓᵢⱼ (plus
log(π)/2), the counts cⱼ = j and pᵢⱼ = bᵢ + dimsᵢ·ℓᵢⱼ − lgamma(dimsᵢ/2 + 1):

    loss(z) = ½‖z‖² + log 2π − Σᵢⱼ [pᵢⱼ cⱼ − e^{pᵢⱼ} − lgamma(cⱼ)]

(the prior's constant uses 2, the first axis of z, as the JAX package
does).  With gᵢⱼ = cⱼ − e^{pᵢⱼ} and qᵢⱼ = ℓᵢⱼ − ½ψ(dimsᵢ/2 + 1), the
gradient is z₀ − Lᵀ(dims·Σⱼ gq) and z₁ − Lᵀ Σⱼ g; these functions take z
flattened to (2k,), as the optimizers do.

An L stored in bfloat16 (the coarse phase of the two-phase
``precision="bf16"`` MAP) is read in row blocks of :data:`BF16_CHUNK_ROWS`
and upcast to the latents' dtype block by block, so the products are IEEE
float32 of the bf16-rounded values, as the JAX package's promotion of
bf16 × f32 gives them, without a float32 copy of L.
"""

import math

import torch
import torch.distributed as dist

from .likelihoods import (
    nearest_neighbors_likelihood,
    nearest_neighbors_terms,
    normal_prior,
    poisson_likelihood,
    poisson_terms,
)


# rows of a bfloat16 L upcast at a time
BF16_CHUNK_ROWS = 65536

SHARDED_DERIVATIVES = (
    "A cell-sharded density loss sums its cells with an all_reduce that autograd and "
    "torch.func cannot differentiate: use its closed forms (loss_func.value_and_grad, "
    "loss_func.hessian, loss_func.hessian_diagonal)."
)


def _matmul(L, Z):
    """L @ Z, with a bfloat16 L upcast to Z's dtype in row blocks."""
    if L.dtype != torch.bfloat16:
        return L @ Z
    return torch.cat(
        [L[i : i + BF16_CHUNK_ROWS].to(Z.dtype) @ Z for i in range(0, L.shape[0], BF16_CHUNK_ROWS)]
    )


def _rmatmul(L, W):
    """Lᵀ @ W, with a bfloat16 L upcast to W's dtype in row blocks."""
    if L.dtype != torch.bfloat16:
        return L.T @ W
    out = None
    for i in range(0, L.shape[0], BF16_CHUNK_ROWS):
        part = L[i : i + BF16_CHUNK_ROWS].to(W.dtype).T @ W[i : i + BF16_CHUNK_ROWS]
        out = part if out is None else out + part
    return out


def _reduce_likelihood(likelihood, grad_likelihood, group):
    """The likelihood and Lᵀ(1 − e) summed over the ranks of ``group``, in
    one ``all_reduce`` of the two stacked (as they are without one).  The
    in-place ``all_reduce`` is invisible to autograd and ``torch.func``,
    which would differentiate this rank's terms alone: a RuntimeError."""
    if group is None:
        return likelihood, grad_likelihood
    parts = torch.cat([likelihood[None], grad_likelihood])
    if parts.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(parts):
        raise RuntimeError(SHARDED_DERIVATIVES)
    dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
    return parts[0], parts[1:]


def _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term, group=None):
    k = z.shape[0]
    f = _matmul(L, z) + mu
    e = torch.exp(f + V)
    prior = -(1 / 2) * torch.sum(z * z) - (k / 2) * math.log(2 * math.pi)
    likelihood, grad_likelihood = _reduce_likelihood(
        torch.sum((f + Vdr) - e + loss_offset_per_term), _rmatmul(L, 1 - e), group)
    return -(prior + likelihood), z - grad_likelihood


def density_value_and_grad(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """``(loss, gradient)`` of the density model at z (0-d tensor, (k,))."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)
    return _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term)


def zero_centering_offset(z0, L, nn_distances, d, mu):
    """``(loss(z0)/n rounded to float32, loss(z0))``: the per-term offset
    that zero-centres the density potential at z0, from the global
    operands (``mellon_tpu/inference/mcmc.py:zero_centered_potential``)."""
    v0 = float(density_value_and_grad(z0, L, nn_distances, d, mu)[0])
    return torch.tensor(v0 / L.shape[0], dtype=torch.float32).item(), v0


def density_loss(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """Negative log posterior of the density model at z (a 0-d tensor);
    same arguments as ``mellon_tpu.inference.losses.density_loss``."""
    return density_value_and_grad(z, L, nn_distances, d, mu, loss_offset_per_term)[0]


def make_density_value_and_grad(L, nn_distances, d, mu, loss_offset_per_term=0.0, group=None):
    """``z -> (loss, gradient)`` with the likelihood constants computed once,
    for the optimizer's repeated evaluations.  With a process ``group``, L
    and nn_distances are this rank's rows of the cells, and the likelihood
    is summed over the group's ranks (:mod:`..parallel.sharding`)."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)

    def value_and_grad(z):
        return _value_and_grad(z, L, V, Vdr, mu, loss_offset_per_term, group)

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


def make_density_value_and_grad_batch(L, nn_distances, d, mu, loss_offset_per_term=0.0,
                                      group=None, center=None):
    """``Z -> (losses (C,), gradients (C, k))`` at the C rows of Z: the
    samplers' potential, one call per leapfrog for every chain.  F = L Zᵀ + μ
    and the gradient Z − (Lᵀ(1 − E))ᵀ are two (n, k)×(k, C) products;
    ``loss_offset_per_term`` as in :func:`density_loss`, ``group`` as in
    :func:`make_density_value_and_grad` (one ``all_reduce`` per call).

    With a ``center`` c (k,), the z-dependent part is computed relative to
    it: ΔF = L (Z − c)ᵀ, E = E_c·e^{ΔF}, and the likelihood's change
    Σᵢ [ΔFᵢ − E_c,ᵢ·expm1(ΔFᵢ)] joins the loss at c, summed once in
    float64 (with ``group``, one more ``all_reduce`` here).  The value is
    the same function, but its rounding no longer grows with |F|: in
    float32 at 10⁶ cells the rounding of F = L z, amplified by cells where
    E is in the thousands, moves the potential by ~0.3–0.8 from one z to
    the next, which freezes NUTS, while ΔF is small near c."""
    V, Vdr = nearest_neighbors_terms(nn_distances, d)
    if center is not None:
        return _centered_batch(L, V, Vdr, mu, loss_offset_per_term, group, center)
    V, Vdr = V[:, None], Vdr[:, None]

    def value_and_grad(Z):
        k = Z.shape[1]
        F = L @ Z.T + mu
        E = torch.exp(F + V)
        prior = -(1 / 2) * torch.sum(Z * Z, dim=1) - (k / 2) * math.log(2 * math.pi)
        likelihood, grad_likelihood = _reduce_likelihood(
            torch.sum((F + Vdr) - E + loss_offset_per_term, dim=0), L.T @ (1 - E), group)
        return -(prior + likelihood), Z - grad_likelihood.T

    return value_and_grad


def _centered_batch(L, V, Vdr, mu, loss_offset_per_term, group, center):
    """The batched potential of :func:`make_density_value_and_grad_batch`
    around ``center``."""
    k = center.shape[0]
    Fc = L @ center + mu
    Ec = torch.exp(Fc + V)
    at_center = torch.sum((Fc + Vdr) - Ec + loss_offset_per_term, dtype=torch.float64)
    if group is not None:
        dist.all_reduce(at_center, op=dist.ReduceOp.SUM, group=group)
    c64 = center.double()
    # the loss at the center: ½|c|² + (k/2) log 2π − its likelihood
    constant = float(0.5 * torch.dot(c64, c64) + (k / 2) * math.log(2 * math.pi) - at_center)
    Ec = Ec[:, None]

    def value_and_grad(Z):
        D = Z - center
        dF = L @ D.T
        likelihood, grad_likelihood = _reduce_likelihood(
            torch.sum(dF - Ec * torch.expm1(dF), dim=0), L.T @ (1 - Ec * torch.exp(dF)), group)
        # ½|Z|² − ½|c|², without the cancellation
        return constant + 0.5 * torch.sum(D * (2 * center + D), dim=1) - likelihood, Z - grad_likelihood.T

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


# rows of L per step of the Hessian and its diagonal: bounds their (rows, k)
# temporaries
HESSIAN_CHUNK_ROWS = 4096


def _curvature(z, L, nn_distances, d, mu, group, out, term):
    """``out`` plus Σᵢ term(rows, eᵢ) over this rank's rows of L, in
    :data:`HESSIAN_CHUNK_ROWS` chunks with eᵢ = e^{Lᵢz+μ+Vᵢ}, summed over
    the ranks of ``group`` in one ``all_reduce``."""
    V, _ = nearest_neighbors_terms(nn_distances, d)
    for start in range(0, L.shape[0], HESSIAN_CHUNK_ROWS):
        rows = L[start : start + HESSIAN_CHUNK_ROWS]
        e = torch.exp(rows @ z + mu + V[start : start + HESSIAN_CHUNK_ROWS])
        out = out + term(rows, e)
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def density_hessian_diagonal(z, L, nn_distances, d, mu, group=None):
    """Diagonal of the density loss's Hessian at z in closed form.

    The Hessian is I + Lᵀ·diag(e^{Lz+μ+V})·L, so its diagonal is
    1 + Σᵢ eᵢ·Lᵢⱼ².  It accumulates over :data:`HESSIAN_CHUNK_ROWS` rows
    of L at a time: the JAX package gets the same numbers from chunked
    Hessian-vector products (``mellon_tpu/inference/laplace.py``).  With
    a process ``group``, L and nn_distances are this rank's rows of the
    cells: the ranks' sums are added in one ``all_reduce``, and the prior's
    1 after it, once.
    """
    out = _curvature(z, L, nn_distances, d, mu, group, torch.zeros_like(z),
                     lambda rows, e: e @ (rows * rows))
    return out + 1


def density_hessian(z, L, nn_distances, d, mu, group=None):
    """The density loss's Hessian I + Lᵀ·diag(e^{Lz+μ+V})·L at z, (k, k),
    summed over :data:`HESSIAN_CHUNK_ROWS` rows of L at a time: the matrix
    the JAX package assembles from blocked Hessian-vector products
    (``mellon_tpu/inference/mcmc.py:_hessian_block``).  ``group`` as in
    :func:`density_hessian_diagonal` (one ``all_reduce`` of k² numbers)."""
    k = z.shape[0]
    out = _curvature(z, L, nn_distances, d, mu, group, z.new_zeros((k, k)),
                     lambda rows, e: (rows * e[:, None]).T @ rows)
    out.diagonal().add_(1)
    return out


def _dimensionality_terms(Z, L, ldist, counts, lgamma_counts, mu_dim, mu_dens):
    """dims (n, S), p (n, k, S) and e^p at the S columns of the (2k, S)
    flattened latents Z."""
    k = L.shape[1]
    dims = torch.exp(_matmul(L, Z[:k]) + mu_dim)
    log_dens = _matmul(L, Z[k:]) + mu_dens
    pred = log_dens[:, None] + dims[:, None] * ldist[..., None] - torch.lgamma(dims / 2 + 1)[:, None]
    return dims, pred, torch.exp(pred)


def _dimensionality_loglik(pred, E, counts, lgamma_counts):
    return torch.sum(pred * counts[:, None] - E - lgamma_counts[:, None], dim=(0, 1))


def _dimensionality_prior(Z):
    # the JAX package's constant: z.shape[0] of the (2, k) latents, i.e. 2
    return -(1 / 2) * torch.sum(Z * Z, dim=0) - math.log(2 * math.pi)


def make_dimensionality_value_and_grad(L, distances, mu_dim, mu_dens):
    """``z -> (loss, gradient)`` of the dimensionality model at the
    flattened latents z (2k,), with the distances sorted once."""
    ldist, counts, lgamma_counts = poisson_terms(distances)

    def value_and_grad(z):
        k = L.shape[1]
        Z = z[:, None]
        dims, pred, E = _dimensionality_terms(Z, L, ldist, counts, lgamma_counts, mu_dim, mu_dens)
        loss = -(_dimensionality_prior(Z) + _dimensionality_loglik(pred, E, counts, lgamma_counts))
        g = counts - E[..., 0]
        u = g.sum(dim=1)
        psi = torch.digamma(dims[:, 0] / 2 + 1)
        v = torch.sum(g * ldist, dim=1) - 0.5 * psi * u
        grad = z - torch.cat([_rmatmul(L, v * dims[:, 0]), _rmatmul(L, u)])
        return loss[0], grad

    return value_and_grad


def make_dimensionality_value_and_grad_batch(L, distances, mu_dim, mu_dens, loss_offset_per_cell=0.0):
    """``Z -> (losses (C,), gradients (C, 2k))`` at the C rows of the
    flattened latents Z (C, 2k): the samplers' potential, one call per
    leapfrog for every chain.  ``loss_offset_per_cell`` is added to each
    cell's log-likelihood inside the sum over cells (the zero-centring of
    :func:`zero_centered_dimensionality_potential`)."""
    ldist, counts, lgamma_counts = poisson_terms(distances)

    def value_and_grad(Z):
        Zt = Z.T
        dims, pred, E = _dimensionality_terms(Zt, L, ldist, counts, lgamma_counts, mu_dim, mu_dens)
        per_cell = torch.sum(pred * counts[:, None] - E - lgamma_counts[:, None], dim=1)
        loss = -(_dimensionality_prior(Zt) + torch.sum(per_cell + loss_offset_per_cell, dim=0))
        g = counts[:, None] - E
        u = g.sum(dim=1)
        psi = torch.digamma(dims / 2 + 1)
        v = torch.sum(g * ldist[..., None], dim=1) - 0.5 * psi * u
        grad = Zt - torch.cat([_rmatmul(L, v * dims), _rmatmul(L, u)])
        return loss, grad.T

    return value_and_grad


def zero_centered_dimensionality_potential(z0, L, distances, mu_dim, mu_dens):
    """The dimensionality potential re-centred to ~0 at the flattened
    ``z0`` (2k,): the batched ``value_and_grad`` with
    ``loss_offset_per_cell`` = loss(z0)/n (as a float32 number), and that
    offset; see :func:`.mcmc.zero_centered_potential`."""
    import numpy as np

    n = L.shape[0]
    v0 = float(make_dimensionality_value_and_grad(L, distances, mu_dim, mu_dens)(z0)[0])
    offset = float(np.float32(v0 / n))
    return make_dimensionality_value_and_grad_batch(L, distances, mu_dim, mu_dens, offset), offset


def make_dimensionality_loss_batch(L, distances, mu_dim, mu_dens):
    """``Z -> losses``: the dimensionality loss at each row of the (S, 2k)
    flattened latents, shape (S,); autograd gives the gradient (ADVI)."""
    ldist, counts, lgamma_counts = poisson_terms(distances)

    def loss_batch(Z):
        Zt = Z.T
        _, pred, E = _dimensionality_terms(Zt, L, ldist, counts, lgamma_counts, mu_dim, mu_dens)
        return -(_dimensionality_prior(Zt) + _dimensionality_loglik(pred, E, counts, lgamma_counts))

    return loss_batch


def dimensionality_hessian_diagonal(z, L, distances, mu_dim, mu_dens):
    """Diagonal of the dimensionality loss's Hessian at the flattened z
    (2k,) in closed form: 1 + (L∘L)ᵀ w per latent row, with
    w₁ = Σⱼ e^p for the density row and
    w₀ = dims²·(Σⱼ e^p q² + ¼ψ′(dims/2 + 1)·Σⱼ g) − dims·Σⱼ g q for the
    dimension row, summed over :data:`HESSIAN_CHUNK_ROWS` rows of L at a
    time (the JAX package takes chunked Hessian-vector products)."""
    ldist, counts, lgamma_counts = poisson_terms(distances)
    k = L.shape[1]
    diag = torch.ones_like(z)
    for start in range(0, L.shape[0], HESSIAN_CHUNK_ROWS):
        rows = L[start : start + HESSIAN_CHUNK_ROWS]
        block = ldist[start : start + HESSIAN_CHUNK_ROWS]
        dims, pred, E = _dimensionality_terms(
            z[:, None], rows, block, counts, lgamma_counts, mu_dim, mu_dens
        )
        dims, E = dims[:, 0], E[..., 0]
        g = counts - E
        q = block - 0.5 * torch.digamma(dims / 2 + 1)[:, None]
        trigamma = torch.special.polygamma(1, dims / 2 + 1)
        w0 = dims * dims * (torch.sum(E * q * q, dim=1) + 0.25 * trigamma * g.sum(dim=1))
        w0 = w0 - dims * torch.sum(g * q, dim=1)
        squares = rows * rows
        diag = diag + torch.cat([w0 @ squares, E.sum(dim=1) @ squares])
    return diag


def dimensionality_hessian(z, L, distances, mu_dim, mu_dens):
    """The dimensionality loss's Hessian at the flattened z (2k,), (2k, 2k),
    in closed form: I + [[Lᵀ W₀₀ L, Lᵀ W₀₁ L], [Lᵀ W₀₁ L, Lᵀ W₁₁ L]] with
    the per-cell weights W₁₁ = Σⱼ e^p, W₀₁ = dims·Σⱼ e^p q and W₀₀ the
    dimension row's weight of :func:`dimensionality_hessian_diagonal`,
    summed over :data:`HESSIAN_CHUNK_ROWS` rows of L at a time."""
    ldist, counts, lgamma_counts = poisson_terms(distances)
    k = L.shape[1]
    H = torch.eye(2 * k, dtype=z.dtype, device=z.device)
    for start in range(0, L.shape[0], HESSIAN_CHUNK_ROWS):
        rows = L[start : start + HESSIAN_CHUNK_ROWS]
        block = ldist[start : start + HESSIAN_CHUNK_ROWS]
        dims, _, E = _dimensionality_terms(
            z[:, None], rows, block, counts, lgamma_counts, mu_dim, mu_dens
        )
        dims, E = dims[:, 0], E[..., 0]
        g = counts - E
        q = block - 0.5 * torch.digamma(dims / 2 + 1)[:, None]
        trigamma = torch.special.polygamma(1, dims / 2 + 1)
        w00 = dims * dims * (torch.sum(E * q * q, dim=1) + 0.25 * trigamma * g.sum(dim=1))
        w00 = w00 - dims * torch.sum(g * q, dim=1)
        w01 = dims * torch.sum(E * q, dim=1)
        w11 = E.sum(dim=1)
        H[:k, :k] += (rows * w00[:, None]).T @ rows
        cross = (rows * w01[:, None]).T @ rows
        H[:k, k:] += cross
        H[k:, :k] += cross
        H[k:, k:] += (rows * w11[:, None]).T @ rows
    return H


def dimensionality_loss(z, L, distances, mu_dim, mu_dens):
    """Negative log posterior of the dimensionality model at z (2, k), a
    0-d tensor; same arguments as
    ``mellon_tpu.inference.losses.dimensionality_loss``."""
    return make_dimensionality_value_and_grad(L, distances, mu_dim, mu_dens)(z.reshape(-1))[0]


def compute_transform(mu, L):
    """z -> f = L z + mu."""

    def transform(z):
        return L @ z + mu

    return transform


def compute_dimensionality_transform(mu_dim, mu_dens, L):
    """z (2, k) -> (exp(L z₀ + mu_dim), L z₁ + mu_dens)."""

    def transform(z):
        return torch.exp(L @ z[0] + mu_dim), L @ z[1] + mu_dens

    return transform


def compute_loss_func(nn_distances, d, transform, k):
    """Closure form of the loss, ``z -> loss`` (kept for API parity)."""
    prior = normal_prior(k)
    likelihood = nearest_neighbors_likelihood(nn_distances, d)

    def loss_func(z):
        return -(prior(z) + likelihood(transform(z)))

    return loss_func


def compute_dimensionality_loss_func(distances, transform, k):
    """Closure form of the dimensionality loss, ``z (2, k') -> loss``, with
    the JAX package's prior constant for ``k`` (the first axis of z)."""
    prior = normal_prior(k)
    likelihood = poisson_likelihood(distances)

    def loss_func(z):
        dims, log_dens = transform(z)
        return -(prior(z) + likelihood(dims, log_dens))

    return loss_func


def compute_log_density_x(pre_transformation, transform):
    """Function values at the training points."""
    return transform(pre_transformation)


def compute_parameter_cov_factor(pre_transformation_std, L):
    """Left factor L·diag(std) of the mean function's covariance from the
    latents' uncertainty."""
    return L * pre_transformation_std[None, :]
