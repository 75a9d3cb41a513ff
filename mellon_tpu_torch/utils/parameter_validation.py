"""Cross-parameter compatibility checks of the default density path.

Counterpart of ``mellon_tpu/utils/parameter_validation.py``: the same
accept/reject decisions for ``gp_type`` / ``rank`` / ``n_landmarks`` and the
kernel arguments.
"""

import logging

import numpy as np
import torch

from .util import GaussianProcessType
from .validation import validate_float_or_int, validate_positive_int

logger = logging.getLogger("mellon_tpu_torch")

# the sequence forms of normalize_per_time_point, one target per time
# point: the JAX package's list and array (here numpy's or torch's)
NORMALIZE_SEQUENCES = (list, np.ndarray, torch.Tensor)

_SPARSE_TYPES = frozenset(
    {GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.SPARSE_NYSTROEM}
)
_FULL_TYPES = frozenset({GaussianProcessType.FULL, GaussianProcessType.FULL_NYSTROEM})
_NYSTROEM_TYPES = frozenset(
    {GaussianProcessType.FULL_NYSTROEM, GaussianProcessType.SPARSE_NYSTROEM}
)


def _reject(message):
    logger.error(message)
    raise ValueError(message)


def _rank_basis_size(gp_type, n_samples, n_landmarks):
    if gp_type in _SPARSE_TYPES:
        return n_landmarks
    if gp_type in _FULL_TYPES:
        return n_samples
    return None


def _rank_is_effectively_full(rank, basis_size):
    """0 and fractions >= 1.0 mean full rank; an integer rank only when it
    reaches the basis size."""
    if rank == 0:
        return True
    if type(rank) is float:
        return rank >= 1.0
    if type(rank) is int:
        return basis_size is not None and rank >= basis_size
    return False


def validate_landmark_params(n_landmarks, landmarks):
    if landmarks is None:
        return
    n_given = landmarks.shape[0]
    if n_landmarks != n_given:
        _reject(
            f"landmarks has {n_given:,} rows, which conflicts with "
            f"n_landmarks={n_landmarks:,}. When passing landmarks "
            "explicitly, leave n_landmarks unset."
        )


def validate_rank_params(gp_type, n_samples, rank, n_landmarks):
    basis_size = _rank_basis_size(gp_type, n_samples, n_landmarks)
    keeps_full_rank = _rank_is_effectively_full(rank, basis_size)
    is_nystroem = gp_type in _NYSTROEM_TYPES
    if keeps_full_rank and is_nystroem:
        basis_name = "landmarks" if gp_type in _SPARSE_TYPES else "cells"
        _reject(
            f"rank={rank} keeps the full eigenbasis, but gp_type "
            f"{gp_type} performs a Nyström reduction: pass a fraction "
            "0 < rank < 1 (eigenvalue mass to keep) or an integer "
            f"0 < rank < {basis_size:,} (the number of {basis_name})."
        )
    if not keeps_full_rank and not is_nystroem:
        _reject(
            f"rank={rank} requests a Nyström rank reduction, which "
            f"gp_type {gp_type} does not perform. Choose a Nyström "
            "gp_type or leave rank at full."
        )


def validate_gp_type(gp_type, n_samples, n_landmarks):
    if gp_type in _FULL_TYPES:
        if 0 != n_landmarks and n_landmarks < n_samples:
            _reject(
                f"n_landmarks={n_landmarks:,} is below the cell count "
                f"{n_samples:,}, which would make the process sparse, but "
                f"gp_type {gp_type} is a full (non-sparse) process. Drop "
                "n_landmarks (or set it to 0) for a full process, or drop "
                "gp_type for a sparse one."
            )
        return
    if gp_type in _SPARSE_TYPES:
        if n_landmarks == 0:
            _reject(
                f"gp_type {gp_type} is sparse but n_landmarks=0 disables "
                "landmarks entirely. Choose n_landmarks below the cell "
                f"count {n_samples:,}, or drop gp_type for a full process."
            )
        if n_landmarks >= n_samples:
            message = (
                f"gp_type {gp_type} is sparse but n_landmarks="
                f"{n_landmarks:,} is not below the cell count "
                f"{n_samples:,}, so no compression happens. Lower "
                "n_landmarks, or drop gp_type for a full process."
            )
            logger.warning(message)
            raise ValueError(message)


def validate_params(rank, gp_type, n_samples, n_landmarks, landmarks):
    """Run the full cross-parameter compatibility table."""
    n_landmarks = validate_positive_int(n_landmarks, "n_landmarks")
    rank = validate_float_or_int(rank, "rank")
    if not isinstance(gp_type, GaussianProcessType):
        _reject(
            "gp_type must be a mellon_tpu_torch.GaussianProcessType, got "
            f"{type(gp_type)}."
        )
    validate_landmark_params(n_landmarks, landmarks)
    if n_landmarks > n_samples and gp_type != GaussianProcessType.FIXED:
        logger.warning(
            "n_landmarks=%s exceeds the number of cells (%s).",
            f"{n_landmarks:,}",
            f"{n_samples:,}",
        )
    validate_gp_type(gp_type, n_samples, n_landmarks)
    validate_rank_params(gp_type, n_samples, rank, n_landmarks)


def validate_normalize_parameter(normalize, unique_times):
    """Per-time normalization targets must cover every time point: a dict
    needs an entry for each, a sequence (list, array or tensor) one value
    per time point in order."""
    times = unique_times.tolist()
    if isinstance(normalize, dict):
        uncovered = [t for t in times if t not in normalize]
        if uncovered:
            raise ValueError(
                f"The normalization dictionary lacks entries for time point(s): {uncovered}"
            )
        return
    if isinstance(normalize, NORMALIZE_SEQUENCES) and len(normalize) != len(times):
        raise ValueError(
            f"normalize has {len(normalize)} entries but there are "
            f"{len(times)} unique time points; the counts must match."
        )


def validate_cov_func_curry(cov_func_curry, cov_func, param_name):
    """A kernel arrives either as a curry (a Covariance subclass) or as an
    instance."""
    from ..ops.kernels import Covariance

    if cov_func_curry is None and cov_func is None:
        raise ValueError(
            "Provide a covariance function: neither 'cov_func_curry' nor "
            "'cov_func' was given."
        )
    if cov_func_curry is not None:
        is_class = isinstance(cov_func_curry, type)
        if not is_class or not issubclass(cov_func_curry, Covariance):
            raise ValueError(
                f"'{param_name}' must be a mellon_tpu_torch.Covariance subclass "
                "(the class itself, not an instance)."
            )
    return cov_func_curry


def validate_cov_func(cov_func, param_name, optional=False):
    from ..ops.kernels import Covariance

    if cov_func is None and optional:
        return None
    if not isinstance(cov_func, Covariance):
        raise ValueError(
            f"'{param_name}' must be an instance of a "
            "mellon_tpu_torch.Covariance subclass."
        )
    return cov_func
