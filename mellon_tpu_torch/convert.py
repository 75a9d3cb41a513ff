"""Bring a fitted ``mellon_tpu`` model over as this package's objects.

``state_from_jax`` reads the arrays of a fitted ``mellon_tpu``
``DensityEstimator``, ``TimeSensitiveDensityEstimator``,
``FunctionEstimator`` or ``DimensionalityEstimator``,
or of any of its conditional predictors, through numpy (this module never
imports JAX) and builds the port's counterpart on the device and in the
dtype asked for.  torch cannot reproduce JAX's threefry random stream, so
this, or passing ``landmarks=``, is how the two packages are run on the
same state.
"""

import numpy as np
import torch

from .config import resolve_device_dtype
from .inference import predictors
from .inference.losses import compute_dimensionality_transform, compute_transform
from .models.density import DensityEstimator
from .models.dimensionality import DimensionalityEstimator
from .models.function import FunctionEstimator
from .models.time_density import TimeSensitiveDensityEstimator
from .ops import kernels
from .utils.util import GaussianProcessType

# the fitted state each estimator carries over, beyond x and the kernel
_DENSITY_STATE = (
    "landmarks", "nn_distances", "d", "Lp", "L", "initial_value",
    "pre_transformation", "pre_transformation_std",
)
_ESTIMATOR_STATE = {
    "DensityEstimator": _DENSITY_STATE,
    "TimeSensitiveDensityEstimator": _DENSITY_STATE,
    "DimensionalityEstimator": (
        "landmarks", "distances", "nn_distances", "d", "Lp", "L", "initial_value",
        "pre_transformation", "pre_transformation_std",
    ),
    "FunctionEstimator": ("landmarks", "nn_distances", "Lp", "y"),
}


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


def _converter(device, dtype):
    def convert(value):
        """Arrays as tensors (floating ones in ``dtype``), 0-d arrays as
        numbers, everything else as it is."""
        if not (hasattr(value, "dtype") and hasattr(value, "shape")):
            return value
        array = np.asarray(value)
        if array.ndim == 0:
            return array.item()
        tensor = torch.from_numpy(array.copy())
        if tensor.is_floating_point():
            return tensor.to(device=device, dtype=dtype)
        return tensor.to(device=device)

    return convert


def _predictor_from_jax(source, convert):
    cls = predictors._resolve_predictor_class(type(source).__name__, "mellon_tpu")
    instance = cls.__new__(cls)
    state = set(source._state_variables)
    for key in state | {"n_input_features", "n_obs", "d", "d_method"}:
        setattr(instance, key, convert(getattr(source, key, None)))
    instance._state_variables = state
    instance.cov_func = covariance_from_jax(source.cov_func)
    return instance


def state_from_jax(source, device=None, dtype=None):
    """The port's estimator or predictor holding ``source``'s fitted state.

    ``source`` is a fitted ``mellon_tpu`` estimator (its training data,
    kernel, heuristics, factors, latents and, for the FunctionEstimator,
    its y and predictor are read; the loss is rebuilt, so the optimizers
    and samplers can run on it) or a ``mellon_tpu`` conditional predictor
    (its ``_state_variables``, the kernel, ``n_obs``, ``d`` and
    ``d_method``).
    """
    device, dtype = resolve_device_dtype(device, dtype)
    convert = _converter(device, dtype)
    name = type(source).__name__
    if name not in _ESTIMATOR_STATE:
        return _predictor_from_jax(source, convert)

    cls = {
        "DensityEstimator": DensityEstimator,
        "TimeSensitiveDensityEstimator": TimeSensitiveDensityEstimator,
        "DimensionalityEstimator": DimensionalityEstimator,
        "FunctionEstimator": FunctionEstimator,
    }[name]
    kwargs = dict(
        cov_func=covariance_from_jax(source.cov_func),
        ls=float(source.ls),
        jitter=float(source.jitter),
        predictor_with_uncertainty=bool(source.predictor_with_uncertainty),
        device=device,
        dtype=dtype,
    )
    if name == "FunctionEstimator":
        kwargs.update(sigma=convert(source.sigma), mu=float(source.mu),
                      y_is_mean=source.y_is_mean, obs_variance=source.obs_variance)
    elif name == "DimensionalityEstimator":
        kwargs.update(k=source.k, mu_dim=float(source.mu_dim), mu_dens=float(source.mu_dens))
    else:
        kwargs.update(mu=float(source.mu))
    if name == "TimeSensitiveDensityEstimator":
        kwargs.update(ls_time=float(source.ls_time),
                      normalize_per_time_point=_plain(source.normalize_per_time_point))
    est = cls(**kwargs)
    est.set_x(convert(source.x))
    for key in _ESTIMATOR_STATE[name]:
        setattr(est, key, convert(getattr(source, key, None)))
    est.gp_type = GaussianProcessType.from_string(source.gp_type.value)
    est.n_landmarks = int(source.n_landmarks)
    if name in ("DensityEstimator", "TimeSensitiveDensityEstimator"):
        est.d_method = source.d_method
    if name == "FunctionEstimator":
        if source.conditional is not None:
            est.conditional = _predictor_from_jax(source.conditional, convert)
        return est
    if name == "DimensionalityEstimator":
        est.transform = compute_dimensionality_transform(est.mu_dim, est.mu_dens, est.L)
    else:
        est.transform = compute_transform(est.mu, est.L)
    est._prepare_attribute("loss_func")
    if est.pre_transformation is not None:
        est.process_inference(build_predict=False)
    return est
