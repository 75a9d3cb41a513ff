"""Foundation utilities: distances, jitter, MLE, GP-type enum, rank check,
active dims and the typed JSON encoding.

Counterpart of ``mellon_tpu/utils/util.py`` for the density path.
"""

import functools
import html
import inspect
import logging
import math
from enum import Enum
from inspect import Parameter

import numpy as np
import torch

logger = logging.getLogger("mellon_tpu_torch")

DEFAULT_JITTER = 1e-6
DEFAULT_RANK_TOL = 5e-1
# the tag of an array in the JSON files that this package, mellon_tpu and
# the reference Mellon all read and write
ARRAY_TAG = "jax.numpy"


def distance(x, y):
    """Pairwise Euclidean distances in the ``|x|² - 2x·yᵀ + |y|²`` form.

    Same floor as the JAX package: 1e-12 is added inside the sqrt and the
    squared distance is floored at 1e-12, not at 0, so coincident points
    stay finite under cancellation (``mellon_tpu/utils/util.py:51-57``).
    """
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    xy = x @ y.T
    sq = xx - 2 * xy + yy + 1e-12
    return torch.sqrt(torch.clamp_min(sq, 1e-12))


def distance_grad(x, eps=1e-12):
    """``y -> (dist (n, m), ∂dist/∂y (n, m, d))`` for fixed x, with the JAX
    package's arithmetic (``mellon_tpu/utils/util.py:60-78``): the squared
    distance floored at 0 and the gradient divided by ``dist + eps``."""
    xx = torch.sum(x * x, dim=1)[:, None]

    def grad(y):
        yy = torch.sum(y * y, dim=1)[None, :]
        sq = xx - 2 * (x @ y.T) + yy + eps
        dist = torch.sqrt(torch.clamp_min(sq, 0))
        delta = y[None, :] - x[:, None]
        return dist, delta / (dist[..., None] + eps)

    return grad


def batched_vmap(func, x, *args, batch_size=100):
    """``torch.func.vmap(func)`` over row batches of x (``args`` shared by
    every row), stacked as ``vstack``: it bounds the peak memory of a
    function of one row applied to many."""
    vfunc = torch.func.vmap(func, in_dims=(0,) + (None,) * len(args))
    return torch.vstack([vfunc(x[start : start + batch_size], *args)
                         for start in range(0, x.shape[0], batch_size)])


def _active_index(active_dims):
    if isinstance(active_dims, (int, np.integer)):
        return [int(active_dims)]
    if isinstance(active_dims, np.ndarray):
        return torch.from_numpy(active_dims)
    return active_dims


def select_active_dims(x, active_dims):
    """The feature columns ``active_dims`` (an int, a sequence, a slice or
    a boolean mask) of x; all of x where it is None."""
    if active_dims is None:
        return x
    return x[..., _active_index(active_dims)]


def expand_to_inactive(values, target_shape, active_dims):
    """Scatter ``values`` of the active features into zeros of
    ``target_shape`` (the gradient of a kernel that ignores the others)."""
    if active_dims is None:
        return values
    full = values.new_zeros(target_shape)
    full[..., _active_index(active_dims)] = values
    return full


def add_diagonal(A, value):
    """A + value * I (a new tensor)."""
    A = A.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(value)
    return A


def stabilize(A, jitter=DEFAULT_JITTER):
    """A + jitter I."""
    return add_diagonal(A, jitter)


def add_variance(K, M=None, jitter=DEFAULT_JITTER):
    """K + M Mᵀ, with the added diagonal floored at ``jitter``: M None adds
    jitter I, a scalar M adds max(M², jitter) I (as
    ``mellon_tpu.utils.util.add_variance``)."""
    if M is None:
        return stabilize(K, jitter)
    if not isinstance(M, torch.Tensor) or M.ndim == 0:
        return add_diagonal(K, max(jitter, float(M) ** 2))
    noise = M @ M.T
    diag_noise = torch.diagonal(noise)
    return K + noise + torch.diag(torch.clamp_min(jitter - diag_noise, 0))


def mle(nn_distances, d):
    """Point-wise MLE of log density from 1-NN distances in d dimensions."""
    d = torch.as_tensor(d, dtype=nn_distances.dtype, device=nn_distances.device)
    return (
        torch.lgamma(d / 2 + 1)
        - (d / 2) * math.log(math.pi)
        - d * torch.log(nn_distances)
    )


def ensure_2d(X):
    """Promote a 1-d tensor to one column per sample."""
    return X[:, None] if X.ndim == 1 else X


def make_multi_time_argument(func):
    """Add a ``multi_time`` argument to a time predictor's method
    ``func(self, x, time, ...)``: the method at every time of the grid,
    stacked on axis 1 of the result ((n, T, ...)).

    The JAX package maps the method over the grid.  Here every row of x
    is paired with every time in one call (n·T rows, one kernel launch per
    factor of the product kernel), and the result is reshaped; a full
    covariance (``diag=False``), which is not row-wise, is taken time by
    time.
    """
    sig = inspect.signature(func)
    x_name = list(sig.parameters)[1]
    new_sig = sig.replace(
        parameters=[
            *sig.parameters.values(),
            Parameter("multi_time", Parameter.POSITIONAL_OR_KEYWORD, default=None),
        ]
    )

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        multi_time = kwargs.pop("multi_time", None)
        if multi_time is None:
            return func(self, *args, **kwargs)
        bound = sig.bind_partial(self, *args, **kwargs)
        if bound.arguments.get("time") is not None:
            raise ValueError("Cannot specify both 'time' and 'multi_time' arguments")
        from .validation import validate_array

        grid = validate_array(multi_time, "multi_time", dtype=self.dtype, device=self.device)
        grid = grid.reshape(-1)
        if bound.arguments.get("diag", True) is False:
            return torch.stack(
                [func(self, *args, **kwargs, time=float(t)) for t in grid.tolist()], dim=1
            )
        x = validate_array(bound.arguments[x_name], "x", ndim=2, dtype=self.dtype, device=self.device)
        n, T = x.shape[0], grid.shape[0]
        bound.arguments[x_name] = x.repeat_interleave(T, dim=0)
        bound.arguments["time"] = grid.repeat(n)
        out = func(*bound.args, **bound.kwargs)
        if isinstance(out, tuple):
            return tuple(o.reshape(n, T, *o.shape[1:]) for o in out)
        return out.reshape(n, T, *out.shape[1:])

    wrapper.__signature__ = new_sig
    return wrapper


def test_rank(input, tol=DEFAULT_RANK_TOL, threshold=None):
    """Approximate-rank diagnostic of the transformation matrix L
    (counterpart of ``mellon_tpu/utils/util.py:209``)."""
    if isinstance(input, torch.Tensor):
        L = input
    elif hasattr(input, "L"):
        L = input.L
        if L is None:
            raise AttributeError(
                "Matrix L is not found in the estimator object. "
                "Consider running `.prepare_inference()`."
            )
    else:
        raise TypeError(
            "Input must be either a matrix or an estimator with a transformation L."
        )
    if L.ndim != 2:
        raise ValueError("Matrix L must be 2D.")

    approx_rank = int(torch.linalg.matrix_rank(L, rtol=tol))
    max_rank = min(L.shape)
    rank_fraction = approx_rank / max_rank

    if threshold is not None:
        if rank_fraction > threshold:
            logger.warning(
                f"High approx. rank fraction ({rank_fraction:.1%}). "
                "Consider increasing 'n_landmarks'."
            )
        else:
            logger.info(
                f"Rank fraction ({rank_fraction:.1%}, lower is better) is "
                "within acceptable range. Current settings should provide "
                "satisfactory model performance."
            )
    else:
        print(
            f"The approx. rank fraction is {rank_fraction:.1%} "
            f"({approx_rank:,} of {max_rank:,}). Lower is better."
        )
    return approx_rank


class GaussianProcessType(str, Enum):
    """Sparse-GP strategy selector with fuzzy string parsing (same values
    and parsing as ``mellon_tpu.utils.util.GaussianProcessType``)."""

    FULL = "full"
    FULL_NYSTROEM = "full_nystroem"
    SPARSE_CHOLESKY = "sparse_cholesky"
    SPARSE_NYSTROEM = "sparse_nystroem"
    FIXED = "fixed"

    @staticmethod
    def from_string(s, optional: bool = False):
        if s is None:
            if optional:
                return None
            logger.error("Gaussian process type must be specified but is None.")
            raise ValueError("Gaussian process type must be specified but is None.")
        if isinstance(s, GaussianProcessType):
            return s
        if not isinstance(s, str):
            raise ValueError(f"Unknown Gaussian Process type: {s}")

        normalized = s.lower().replace(" ", "_")
        for gp_type in GaussianProcessType:
            if gp_type.value == normalized:
                logger.info(f"Gaussian Process type: {gp_type.value}")
                return gp_type
        for gp_type in GaussianProcessType:
            if normalized in gp_type.value:
                logger.warning(
                    f"Partial match found for Gaussian Process type: "
                    f"{gp_type.value}. Input was: {s}"
                )
                return gp_type
        message = f"Unknown Gaussian Process type: {s}"
        logger.error(message)
        raise ValueError(message)


def _None_to_str(v):
    return "None" if v is None else v


def _str_to_None(v):
    return None if isinstance(v, str) and v == "None" else v


def make_serializable(x):
    """Typed JSON encoding of tensors, arrays, slices, dicts and sets, in the
    on-disk format of ``mellon_tpu.utils.util.make_serializable``: an array
    is ``{"type": "jax.numpy", "data": [...]}``, a 0-d one a plain number."""
    if isinstance(x, bool):
        return x
    if hasattr(x, "dtype") and hasattr(x, "tolist"):
        # torch tensors and numpy arrays and scalars
        if getattr(x, "ndim", 1) == 0:
            return x.item()
        return {"type": ARRAY_TAG, "data": x.tolist()}
    if isinstance(x, int):
        return int(x)
    if isinstance(x, float):
        return float(x)
    if isinstance(x, slice):
        return {"type": "slice", "data": [_None_to_str(v) for v in (x.start, x.stop, x.step)]}
    if isinstance(x, dict):
        return {"type": "dict", "data": {k: make_serializable(v) for k, v in x.items()}}
    if isinstance(x, (set, frozenset)):
        return {"type": "set", "data": [make_serializable(v) for v in x]}
    return _None_to_str(x)


def deserialize(serializable_x, device=None, dtype=None):
    """Inverse of :func:`make_serializable`.  Arrays become tensors on
    ``device``; floating ones in ``dtype`` (integer and boolean ones keep
    their type, as index arrays must)."""
    if isinstance(serializable_x, dict):
        data_type = serializable_x.get("type")
        if data_type == ARRAY_TAG:
            array = torch.from_numpy(np.asarray(serializable_x["data"]))
            if array.is_floating_point():
                return array.to(device=device, dtype=dtype)
            return array.to(device=device)
        if data_type == "slice":
            return slice(*[_str_to_None(v) for v in serializable_x["data"]])
        if data_type == "dict":
            return {
                k: deserialize(v, device, dtype) for k, v in serializable_x["data"].items()
            }
        if data_type == "set":
            return {deserialize(v, device, dtype) for v in serializable_x["data"]}
        return serializable_x
    return _str_to_None(serializable_x)


def object_str(obj, dim_names=None):
    """Concise metadata repr for tensors."""
    if isinstance(obj, torch.Tensor):
        dims = obj.shape
        names = list(dim_names or [])
        dim_strs = [
            f"{dim:,} {name}" if name else f"{dim:,}"
            for dim, name in zip(dims, names + [None] * (len(dims) - len(names)))
        ]
        return f"<tensor {' x '.join(dim_strs)}, dtype={obj.dtype}, device={obj.device}>"
    return str(obj)


def object_html(obj, dim_names=None):
    """HTML metadata repr for tensors, escaped text otherwise."""
    if isinstance(obj, torch.Tensor):
        return f"<span>{html.escape(object_str(obj, dim_names))}</span>"
    return f"<span>{html.escape(str(obj))}</span>"


def set_verbosity(verbose):
    """INFO logging of the package with ``verbose``, else WARNING."""
    logger.setLevel(logging.INFO if verbose else logging.WARNING)
    logger.info(f"Logging verbosity set to {'INFO' if verbose else 'WARNING'}.")
