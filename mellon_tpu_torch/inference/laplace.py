"""Diagonal Laplace approximation of the posterior standard deviations
(counterpart of ``mellon_tpu/inference/laplace.py``).

The JAX package extracts the Hessian diagonal of any loss at the MAP with
chunked Hessian-vector products; the estimator hands this module the
diagonal itself (for the density loss in closed form:
:func:`.losses.density_hessian_diagonal`).  :func:`hessian_diagonal` is
the JAX package's chunked extraction, for a loss without a closed form.

A cell-sharded loss (:func:`..parallel.shard_density_model`) sums its
cells with an ``all_reduce`` that ``torch.func`` cannot differentiate, so
:func:`hessian_diagonal` raises the RuntimeError of
``losses.SHARDED_DERIVATIVES`` on it rather than return this rank's part
of the diagonal; its Laplace stds are
``compute_laplace_std(loss_func.hessian_diagonal(z))``.
"""

import logging

import torch

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


def compute_laplace_std(hessian_diagonal):
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
