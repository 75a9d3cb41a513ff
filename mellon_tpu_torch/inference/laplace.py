"""Diagonal Laplace approximation of the posterior standard deviations
(counterpart of ``mellon_tpu/inference/laplace.py``).

The JAX package extracts the Hessian diagonal of any loss at the MAP with
chunked Hessian-vector products.  :func:`compute_laplace_std` takes its
arguments; the diagonal comes from :func:`hessian_diagonal_of`: the
closed form where the loss has one (``losses.density_loss``, known by
identity: :func:`.losses.density_hessian_diagonal`), else
:func:`hessian_diagonal`, the JAX package's chunked extraction.  The
estimators hand :func:`laplace_std_from_diagonal` the diagonal itself.

A cell-sharded loss (:func:`..parallel.shard_density_model`) sums its
cells with an ``all_reduce`` that ``torch.func`` cannot differentiate, so
:func:`hessian_diagonal` raises the RuntimeError of
``losses.SHARDED_DERIVATIVES`` on it rather than return this rank's part
of the diagonal; :func:`compute_laplace_std` takes its closed form
(``loss_func.hessian_diagonal``).
"""

import logging

import torch

from .losses import BatchedPotential
from .samplers import as_batched

logger = logging.getLogger("mellon_tpu_torch")

# curvature floor: a flat direction gets std 1e4 instead of infinity
MIN_CURVATURE = 1e-8


def hessian_diagonal(loss_func, z, batch_size=512, loss_args=()):
    """Diagonal of the Hessian of the scalar torch loss ``loss_func(z,
    *loss_args)`` at z: forward-over-reverse Hessian-vector products with
    the basis vectors, ``batch_size`` of them at a time (``torch.func``'s
    vmap of a jvp of the gradient).  RuntimeError for a cell-sharded loss
    (see the module's note)."""
    flat = z.detach().reshape(-1)
    k = flat.numel()

    def fun(v):
        return loss_func(v.reshape(z.shape), *loss_args)

    grad = torch.func.grad(fun)

    def hvp_entry(e):
        return torch.dot(torch.func.jvp(grad, (flat,), (e,))[1], e)

    parts = []
    for start in range(0, k, batch_size):
        basis = torch.eye(k, dtype=flat.dtype, device=flat.device)[start : start + batch_size]
        parts.append(torch.func.vmap(hvp_entry)(basis))
    return torch.cat(parts).reshape(z.shape)


def hessian_diagonal_of(loss_func, loss_args=(), batch_size=512):
    """``z -> diag H`` of ``loss_func(z, *loss_args)``: the closed form
    where its batched form (:func:`.samplers.as_batched`) has one (the
    density loss's, also the cell-sharded one), else :func:`hessian_diagonal`
    of the scalar loss; a :class:`.losses.BatchedPotential` without one
    raises."""
    batched = as_batched(loss_func, loss_args)
    if batched.hessian_diagonal is not None:
        return batched.hessian_diagonal
    if isinstance(loss_func, BatchedPotential):
        raise TypeError(
            "This batched potential has no Hessian diagonal; pass the scalar loss_func."
        )
    return lambda z: hessian_diagonal(loss_func, z, batch_size=batch_size, loss_args=loss_args)


def compute_laplace_std(loss_func, pre_transformation, jit=False, batch_size=512, loss_args=()):
    """Posterior std = 1/√max(diag Hessian, 1e-8) of ``loss_func(z,
    *loss_args)`` at ``pre_transformation``, the diagonal by
    :func:`hessian_diagonal_of` (``batch_size`` Hessian-vector products at
    a time where it takes them); ``jit`` is accepted and ignored."""
    diagonal = hessian_diagonal_of(loss_func, loss_args, batch_size)(pre_transformation)
    return laplace_std_from_diagonal(diagonal)


def laplace_std_from_diagonal(hessian_diagonal):
    """Posterior std = 1/√max(diag Hessian, 1e-8)."""
    h_diag = torch.clamp_min(hessian_diagonal, MIN_CURVATURE)
    stds = 1.0 / torch.sqrt(h_diag)
    if logger.isEnabledFor(logging.INFO):
        lo_h, hi_h, lo_s, hi_s = torch.stack(
            [h_diag.min(), h_diag.max(), stds.min(), stds.max()]
        ).tolist()
        logger.info(
            "Laplace approximation: Hessian diagonal range [%.3e, %.3e], "
            "std range [%.3e, %.3e].",
            lo_h, hi_h, lo_s, hi_s,
        )
    return stds
