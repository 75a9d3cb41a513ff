"""Bring a fitted ``mellon_tpu`` model over as this package's objects.

``state_from_jax`` reads the arrays of a fitted ``mellon_tpu``
``DensityEstimator`` or ``LandmarksConditionalCholesky`` predictor through
numpy (this module never imports JAX) and builds the port's counterpart on
the device and in the dtype asked for.  torch cannot reproduce JAX's
threefry random stream, so this, or passing ``landmarks=``, is how the two
packages are run on the same state.
"""

import numpy as np
import torch

from .config import resolve_device_dtype
from .inference.conditionals import LandmarksConditionalCholesky
from .inference.losses import compute_log_density_x, compute_transform
from .models.density import DensityEstimator
from .ops import kernels


def _kernel_curry(cov_func):
    """The port's class of a JAX-package covariance (one of the six cores,
    without active_dims)."""
    curry = getattr(kernels, type(cov_func).__name__, None)
    if (
        not isinstance(curry, type)
        or not issubclass(curry, kernels.Covariance)
        or getattr(cov_func, "active_dims", None) is not None
    ):
        raise NotImplementedError(
            f"Covariance {cov_func!r} has no counterpart in mellon_tpu_torch yet "
            "(ROADMAP Queue 1, item 2: the covariance algebra and active_dims)."
        )
    return curry


def state_from_jax(source, device=None, dtype=None):
    """The port's estimator or predictor holding ``source``'s fitted state.

    ``source`` is a fitted ``mellon_tpu.DensityEstimator`` (its ``x``,
    ``landmarks``, ``nn_distances``, ``d``, ``mu``, ``ls``, ``Lp``, ``L``
    and ``pre_transformation`` are read) or a ``mellon_tpu``
    ``LandmarksConditionalCholesky`` predictor (``landmarks``,
    ``weights``, ``mu`` and the kernel's ``ls``).
    """
    device, dtype = resolve_device_dtype(device, dtype)

    def tensor(value):
        return torch.tensor(np.asarray(value, dtype=np.float64)).to(device=device, dtype=dtype)

    curry = _kernel_curry(source.cov_func)
    cov_func = curry(ls=float(source.cov_func.ls))
    if hasattr(source, "weights"):
        return LandmarksConditionalCholesky.from_state(
            tensor(source.landmarks),
            tensor(source.weights),
            float(source.mu),
            cov_func,
            n_obs=getattr(source, "n_obs", None),
        )

    est = DensityEstimator(
        cov_func_curry=curry,
        landmarks=tensor(source.landmarks),
        nn_distances=tensor(source.nn_distances),
        d=source.d,
        mu=float(source.mu),
        ls=float(source.ls),
        Lp=tensor(source.Lp),
        L=tensor(source.L),
        device=device,
        dtype=dtype,
    )
    est.set_x(tensor(source.x))
    est.n_landmarks = est.landmarks.shape[0]
    est.cov_func = cov_func
    est.pre_transformation = tensor(source.pre_transformation)
    est.transform = compute_transform(est.mu, est.L)
    est.log_density_x = compute_log_density_x(est.pre_transformation, est.transform)
    return est
