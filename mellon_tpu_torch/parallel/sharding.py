"""The cell-sharded density potential and the cell-sharded predictor
(counterpart of ``mellon_tpu/parallel/sharding.py``).

The n per-cell likelihood terms and the rows of the n×m matrix L are split
over the mesh's ``cells`` axis; the m latents stay whole on every rank.
The potential is the local one of :mod:`..inference.losses` on this rank's
rows, given the cells group: each rank computes its partial likelihood sum
and its partial Lᵀ(1 − e^{f+V}), one ``all_reduce`` sums both, and the
prior is added once, after it.  The loss's curvature, the Hessian and its
diagonal in closed form, is summed the same way: one ``all_reduce`` of the
ranks' partial Lᵀ·diag(e)·L, then the prior's identity.  These are what
the JAX package's ``hessian_cholesky``, ``newton_polish`` and
``laplace.hessian_diagonal`` compute when handed the sharded operands;
autograd cannot pass the ``all_reduce`` (``losses.SHARDED_DERIVATIVES``).

The functions take the global operands and keep this rank's block, as the
JAX package's take global arrays and place them.
"""

import logging
import math

import torch

from ..inference.losses import (
    density_hessian,
    density_hessian_diagonal,
    make_density_value_and_grad,
    make_density_value_and_grad_batch,
    zero_centering_offset,
)
from ..inference.predictors import _check_n_obs
from .mesh import all_gather, cell_sharding, chain_sharding

logger = logging.getLogger("mellon_tpu_torch")


def shard_density_model(nn_distances, d, mu, L, mesh, center=None):
    """The density model's loss with its cells split over ``mesh``.

    ``nn_distances`` (n,) and ``L`` (n, m) are the global operands; this
    rank keeps its row block, on the mesh's device.  Returns
    ``(loss_func, (nn_block, L_block))``: ``loss_func(z)`` is the scalar
    loss at z (m,), ``loss_func.value_and_grad(Z (C, m)) -> (losses
    (C,), gradients (C, m))`` is the samplers' batched potential, and
    ``loss_func.hessian(z) -> (m, m)`` and ``loss_func.hessian_diagonal(z)
    -> (m,)`` its curvature (the Newton polish, the preconditioner, the
    Laplace stds).  Every rank of a cells group must call them together,
    on the same z.  The blocks are copies: the caller may free the global
    L.  With a ``center`` z0 the potential is zero-centred there, as
    :func:`..inference.mcmc.zero_centered_potential`'s: each of the n
    global terms less loss(z0)/n (from the global operands), and
    ``value_and_grad``'s z-dependent part computed around z0
    (:func:`..inference.losses.make_density_value_and_grad_batch`).
    """
    sharding = cell_sharding(mesh)
    nn_block = sharding.shard(nn_distances)
    L_block = sharding.shard(L)
    offset = 0.0 if center is None else zero_centering_offset(center, L, nn_distances, d, mu)[0]
    args = (L_block, nn_block, d, mu, offset)
    value_and_grad = make_density_value_and_grad(*args, group=sharding.group)

    def loss_func(z):
        return value_and_grad(z)[0]

    loss_func.value_and_grad = make_density_value_and_grad_batch(*args, group=sharding.group,
                                                                 center=center)
    curvature = (L_block, nn_block, d, mu)
    loss_func.hessian = lambda z: density_hessian(z, *curvature, group=sharding.group)
    loss_func.hessian_diagonal = lambda z: density_hessian_diagonal(z, *curvature,
                                                                    group=sharding.group)
    return loss_func, (nn_block, L_block)


def sharded_loss_from_estimator(estimator, mesh, center=None):
    """The cell-sharded loss (:func:`shard_density_model`) of a prepared
    DensityEstimator."""
    if estimator.L is None or estimator.nn_distances is None:
        raise ValueError("Estimator not prepared. Call prepare_inference(x) first.")
    loss, _ = shard_density_model(estimator.nn_distances, estimator.d, estimator.mu,
                                  estimator.L, mesh, center)
    return loss


def shard_chains(mesh, z0):
    """This rank's block of the chains' positions ``z0`` (num_chains, k)."""
    return chain_sharding(mesh).shard(z0)


def replicate(mesh, x):
    """``x`` whole on this rank's device."""
    return x.to(mesh.device)


def shard_predict(predictor, mesh):
    """The predictor's mean with the query rows split over the ``cells``
    axis: returns ``predict_fn(Xnew, normalize=False)``.

    Every rank passes the same ``Xnew`` (n, d); each evaluates
    μ + k(X*_block, landmarks)·w on its block of ⌈n / cells⌉ rows (the
    last block padded with zero rows) through the predictor's own mean,
    and the blocks are gathered so every rank returns the full (n,)
    vector.  ``normalize=True`` subtracts log(n_obs).  Every rank of a
    cells group must call it together.
    """
    sharding = cell_sharding(mesh)
    group, size = mesh.groups[sharding.axis], sharding.size

    def predict_fn(Xnew, normalize=False):
        X = predictor._validate(Xnew)
        n = X.shape[0]
        step = max(-(-n // size), 1)
        X = torch.cat([X, X.new_zeros((step * size - n, X.shape[1]))])
        lo = sharding.index * step
        out = all_gather(predictor.mean(X[lo : lo + step]), group, size)[:n]
        if normalize:
            _check_n_obs(predictor, "Cannot normalize without n_obs.")
            out = out - math.log(predictor.n_obs)
        return out

    return predict_fn
