"""Input validation helpers (counterpart of ``mellon_tpu/utils/validation.py``).

Error semantics match the JAX package.  Arrays are cast to the dtype and
device the caller names (the estimator's), not to a global default.
"""

import logging
import math
from collections.abc import Iterable

import numpy as np
import torch

logger = logging.getLogger("mellon_tpu_torch")


def _to_python_scalar(value):
    """Collapse 0-d tensors/arrays and numpy scalars to Python scalars."""
    if isinstance(value, torch.Tensor) and value.ndim == 0:
        return value.item()
    if isinstance(value, (np.ndarray, np.generic)) and np.ndim(value) == 0:
        return value.item()
    return value


def validate_array(iterable, name, optional=False, ndim=None, dtype=None, device=None):
    """Convert to a floating tensor of ``dtype`` on ``device``.

    Tensors keep their dtype/device where none is given; everything else
    (numpy, lists, sparse matrices, arrays of other frameworks) goes
    through numpy and defaults to float64.
    """
    if iterable is None:
        if optional:
            return None
        raise TypeError(f"'{name}' can't be None.")

    if isinstance(iterable, torch.Tensor):
        array = iterable
        if not array.is_floating_point():
            array = array.to(torch.float64)
    elif hasattr(iterable, "todense"):
        array = torch.tensor(np.asarray(iterable.todense(), dtype=np.float64))
    elif isinstance(iterable, Iterable) or hasattr(iterable, "shape"):
        array = torch.tensor(np.asarray(iterable, dtype=np.float64))
    else:
        raise TypeError(
            f"'{name}' should be iterable or sparse, got {type(iterable)} instead."
        )
    array = array.to(device=device, dtype=dtype)

    if ndim is not None:
        allowed = (ndim,) if isinstance(ndim, int) else tuple(ndim)
        if array.ndim not in allowed:
            raise ValueError(
                f"'{name}' must be a {allowed}-dimensional array, "
                f"got {array.ndim}-dimensional array instead."
            )
    return array


def _is_scalar_time(times):
    return isinstance(times, (int, float, np.generic)) or (
        hasattr(times, "shape") and all(s == 1 for s in times.shape)
    )


def validate_time_x(x, times=None, n_features=None, cast_scalar=False, dtype=None, device=None):
    """x (n, d) with the time column appended: ``times`` (n,) or (n, 1),
    or, with ``cast_scalar``, one time for every row.  Without ``times``
    x must already hold it.  ``n_features`` checks the width of the
    result, with the JAX package's messages."""
    x = validate_array(x, "x", ndim=2, dtype=dtype, device=device)
    if cast_scalar and times is not None and _is_scalar_time(times):
        if isinstance(times, torch.Tensor):
            # expand, not a copy of its value: a time that requires grad
            # keeps its graph
            times = times.reshape(()).expand(x.shape[0])
        else:
            times = torch.full((x.shape[0],), float(np.asarray(times).reshape(())))
    times = validate_array(times, "times", optional=True, ndim=(1, 2))
    if times is not None:
        if times.ndim == 1:
            times = times.reshape(-1, 1)
        elif times.shape[1] != 1:
            raise ValueError("'times' must be a 1D array or a 2D array with 1 column.")
        if x.shape[0] != times.shape[0]:
            raise ValueError(
                "'x' and 'times' must have the same number of samples. "
                f"Got {x.shape[0]} for 'x' and {times.shape[0]} for 'times'."
            )
        x = torch.cat((x, times.to(device=x.device, dtype=x.dtype)), dim=1)
    if n_features is not None:
        if x.shape[1] == n_features - 1 and times is None:
            raise ValueError(
                f"Expected {n_features} features including 'times' in 'x' but "
                f"only found {x.shape[1]} features and 'times' is not provided."
            )
        if x.shape[1] != n_features:
            raise ValueError(
                f"Wrong number of features in 'x'. Expected {n_features} "
                f"but got {x.shape[1]}."
            )
    return x


def validate_1d(x):
    """x as a 1-d float64 tensor (a scalar becomes one element)."""
    x = validate_array(x, "x")
    if x.ndim == 0:
        x = x[None]
    if x.ndim != 1:
        raise ValueError("`x` must be exactly 1-dimensional.")
    return x


def validate_float_or_int(value, param_name, optional=False):
    if value is None and optional:
        return None
    value = _to_python_scalar(value)
    if not isinstance(value, (float, int)):
        try:
            value = float(value)
        except TypeError:
            raise ValueError(
                f"'{param_name}' should be a positive integer or float number "
                f"but is {type(value)}"
            )
    if isinstance(value, float) and math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_positive_float(value, param_name, optional=False):
    if value is None and optional:
        return None
    value = _to_python_scalar(value)
    try:
        value = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"'{param_name}' should be a float number but is {type(value)}"
        )
    if value <= 0:
        raise ValueError(f"'{param_name}' should be a positive float number")
    if math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_float(value, param_name, optional=False):
    if value is None:
        if optional:
            return None
        raise ValueError(
            f"'{param_name}' is None, but is required to be a float number"
        )
    if getattr(value, "ndim", 0) > 0 and np.size(value) == 1:
        value = value.reshape(())
    value = _to_python_scalar(value)
    if not isinstance(value, (float, int)):
        try:
            value = float(value)
        except TypeError:
            raise ValueError(
                f"'{param_name}' should be a float number but is {type(value)}"
            )
    if isinstance(value, float) and math.isnan(value):
        raise ValueError(f"'{param_name}' should be a non-NaN float number")
    return value


def validate_positive_int(value, param_name, optional=False):
    if optional and value is None:
        return None
    value = _to_python_scalar(value)
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ValueError(f"'{param_name}' should be a positive integer number")
    return value


def validate_bool(value, name, optional=False):
    if value is None:
        if optional:
            return None
        raise TypeError(f"'{name}' can't be None.")
    if not isinstance(value, bool):
        raise TypeError(f"{name} should be of type bool, got {type(value)} instead.")
    return value


def validate_string(value, name, choices=None):
    if not isinstance(value, str):
        raise TypeError(f"{name} should be of type str, got {type(value)} instead.")
    if choices and value not in choices:
        raise ValueError(f"{name} should be one of {choices}, got '{value}' instead.")
    return value


def validate_float_or_iterable_numerical(value, name, optional=False, positive=False):
    """A non-negative scalar stays a Python float; anything array-like
    becomes a float64 tensor."""
    if value is None and optional:
        return None
    if getattr(value, "ndim", None) == 0:
        value = _to_python_scalar(value)
    if isinstance(value, bool):
        raise TypeError(
            f"{name} should be of type int, float or iterable, got {type(value)} instead."
        )
    if isinstance(value, (int, float)):
        value = float(value)
        if positive and value < 0:
            raise ValueError(f"{name} should be a non-negative number or array")
        return value
    if (isinstance(value, Iterable) and not isinstance(value, str)) or hasattr(
        value, "shape"
    ):
        result = validate_array(value, name)
        if positive and bool((result < 0).any()):
            raise ValueError(f"All elements in {name} should be non-negative")
        return result
    raise TypeError(
        f"{name} should be of type int, float or iterable, got {type(value)} instead."
    )


def _nn_repair_impl(nn):
    """Replace NaN, infinite and non-positive distances by the smallest
    valid one; returns the repaired tensor and the counts as one tensor
    ``(nan, inf, non_positive, all_bad)`` so the host reads them at once."""
    nan_mask = torch.isnan(nn)
    inf_mask = torch.isinf(nn)
    non_positive_mask = nn <= 0
    bad_idx = nan_mask | inf_mask | non_positive_mask
    min_positive = torch.min(torch.where(bad_idx, torch.inf, nn))
    repaired = torch.where(bad_idx, min_positive, nn)
    counts = torch.stack(
        [
            nan_mask.sum(),
            inf_mask.sum(),
            non_positive_mask.sum(),
            bad_idx.all().to(torch.int64),
        ]
    )
    return repaired, counts


def report_nn_repair(nan_count, inf_count, negative_count, all_bad):
    """Emit the repair warning, or raise when every distance is invalid."""
    total_invalid = nan_count + inf_count + negative_count
    if all_bad:
        message = (
            f"All {total_invalid:,} computed nearest neighbor distances "
            "(`nn_distances` attribute) contain invalid values: "
            f"{nan_count:,} NaN, {inf_count:,} infinite, "
            f"{negative_count:,} less or equal 0. "
            "Please check the input data. Setting invalid distances to the "
            "minimum positive value found."
        )
        logger.error(message)
        raise ValueError(message)
    if total_invalid > 0:
        logger.warning(
            "The computed nearest neighbor distances (`nn_distances` attribute) "
            f"contain {total_invalid:,} invalid values: {nan_count:,} NaN, "
            f"{inf_count:,} infinite, {negative_count:,} less or equal 0. "
            "Please check the input data. Setting invalid distances to the "
            "minimum positive value found."
        )


def validate_nn_distances(nn_distances, optional=False):
    """Repair invalid nearest-neighbor distances (one host read)."""
    if nn_distances is None:
        if optional:
            return None
        message = "nn_distances are required but None is given."
        logger.error(message)
        raise ValueError(message)
    repaired, counts = _nn_repair_impl(nn_distances)
    nan_count, inf_count, negative_count, all_bad = counts.tolist()
    report_nn_repair(nan_count, inf_count, negative_count, bool(all_bad))
    return repaired


def validate_k(k, n_samples):
    if isinstance(k, bool) or not isinstance(k, int):
        message = f"Parameter k must be an integer, got {type(k).__name__} instead."
        logger.error(message)
        raise ValueError(message)
    if k < 1:
        message = f"Parameter k must be at least 1, got {k}."
        logger.error(message)
        raise ValueError(message)
    if k >= n_samples:
        message = (
            "Parameter k must be smaller than the number of samples. "
            f"Got k={k:,} with {n_samples:,} samples."
        )
        logger.error(message)
        raise ValueError(message)
