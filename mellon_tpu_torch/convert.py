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


def _plain(value):
    """An attribute of a JAX-package kernel as Python data: arrays become
    numbers or lists, everything else stays."""
    if hasattr(value, "dtype") and hasattr(value, "tolist"):
        return np.asarray(value).tolist()
    return value


def covariance_from_jax(cov_func):
    """The port's kernel equal to a JAX-package kernel: a core with its
    attributes, or an Add/Mul/Pow built recursively, active_dims kept."""
    name = type(cov_func).__name__
    cls = getattr(kernels, name, None)
    if not (isinstance(cls, type) and issubclass(cls, kernels.Covariance)):
        raise NotImplementedError(
            f"Covariance {name} has no counterpart in mellon_tpu_torch."
        )
    if issubclass(cls, kernels.CovariancePair):
        right = cov_func.right
        right = covariance_from_jax(right) if callable(right) else _plain(right)
        return cls(covariance_from_jax(cov_func.left), right, _plain(cov_func.active_dims))
    instance = cls.__new__(cls)
    for key, value in vars(cov_func).items():
        setattr(instance, key, _plain(value))
    return instance


def state_from_jax(source, device=None, dtype=None):
    """The port's estimator or predictor holding ``source``'s fitted state.

    ``source`` is a fitted ``mellon_tpu.DensityEstimator`` (its ``x``,
    ``landmarks``, ``nn_distances``, ``d``, ``mu``, ``ls``, ``cov_func``,
    ``Lp``, ``L``, ``initial_value``, ``pre_transformation`` and
    ``pre_transformation_std`` are read; the estimator's loss is built, so
    the samplers can run on it) or a ``mellon_tpu`` ``LandmarksConditionalCholesky``
    predictor (``landmarks``, ``weights``, ``mu``, ``jitter``, ``sigma``,
    the kernel, and ``L`` and ``W`` where it has uncertainty).
    """
    device, dtype = resolve_device_dtype(device, dtype)

    def tensor(value):
        if value is None:
            return None
        return torch.tensor(np.asarray(value, dtype=np.float64)).to(device=device, dtype=dtype)

    cov_func = covariance_from_jax(source.cov_func)
    if hasattr(source, "weights"):
        sigma = source.sigma
        return LandmarksConditionalCholesky.from_state(
            tensor(source.landmarks),
            tensor(source.weights),
            float(source.mu),
            cov_func,
            n_obs=getattr(source, "n_obs", None),
            jitter=float(source.jitter),
            sigma=sigma if sigma is None or np.ndim(sigma) == 0 else tensor(sigma),
            L=tensor(getattr(source, "L", None)),
            W=tensor(getattr(source, "W", None)),
        )

    est = DensityEstimator(
        cov_func=cov_func,
        landmarks=tensor(source.landmarks),
        nn_distances=tensor(source.nn_distances),
        d=source.d,
        mu=float(source.mu),
        ls=float(source.ls),
        Lp=tensor(source.Lp),
        L=tensor(source.L),
        predictor_with_uncertainty=bool(source.predictor_with_uncertainty),
        device=device,
        dtype=dtype,
    )
    est.set_x(tensor(source.x))
    est.n_landmarks = est.landmarks.shape[0]
    est.pre_transformation = tensor(source.pre_transformation)
    est.pre_transformation_std = tensor(source.pre_transformation_std)
    est.initial_value = tensor(source.initial_value)
    est.transform = compute_transform(est.mu, est.L)
    est._prepare_attribute("loss_func")
    est.log_density_x = compute_log_density_x(est.pre_transformation, est.transform)
    return est
