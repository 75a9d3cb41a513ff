"""Predictor facade (counterpart of ``mellon_tpu/inference/predictors.py``):
the conditional mean, its covariance and uncertainty, the leverage, the
leave-one-out residuals and the observation variance, derivatives, and
JSON in the format that the JAX package and the reference Mellon read.
:class:`ExpPredictor` returns exp of the mean (the local dimensionality),
:class:`PredictorTime` takes a time beside the states (one time for every
row, a time per row, or a grid of times with ``multi_time``).

A predictor written by mellon_tpu or the reference loads here, and one
written here loads there: arrays are tagged ``"jax.numpy"``, classes are
resolved by name first, and files of the reference Mellon older than 1.4.0
are migrated as the JAX package migrates them.  The JSON carries no dtype:
a loaded predictor lands on ``config.DEFAULT_DEVICE`` in
``config.DEFAULT_DTYPE`` unless ``device=``/``dtype=`` say otherwise.
"""

import bz2
import gzip
import json
import logging
import math
import re
import sys
from abc import ABC, abstractmethod
from datetime import datetime
from functools import wraps
from importlib import import_module

import torch

from ..config import resolve_device_dtype
from ..ops.kernels import FOREIGN_PACKAGES, Covariance
from ..utils.util import (
    deserialize,
    ensure_2d,
    make_multi_time_argument,
    make_serializable,
    object_html,
    object_str,
)
from ..utils.validation import validate_array, validate_bool, validate_time_x
from .derivatives import gradient, hessian, hessian_log_determinant

logger = logging.getLogger("mellon_tpu_torch")

# queries larger than this evaluate in row chunks so the (n_query, m)
# kernel tile stays memory-bounded
PREDICT_CHUNK_SIZE = 200_000
# files of the reference Mellon older than this lack n_obs and
# _state_variables
MIGRATION_VERSION = (1, 4, 0)


def _chunked_rows(fn, x, chunk_size=PREDICT_CHUNK_SIZE):
    if x.shape[0] <= chunk_size:
        return fn(x)
    return torch.cat([fn(x[s : s + chunk_size]) for s in range(0, x.shape[0], chunk_size)])


def _normalization_warnings(obj):
    """The d/d_method advisory of a normalized mean, with the JAX
    package's messages: none for the fractal d, an info line for a manual
    d, a warning for the embedding's (or an integral d of unknown
    method)."""
    if obj.d_method == "fractal":
        return
    if obj.d_method == "manual":
        logger.info(
            f"Using normalization with manually set d={obj.d}. "
            "Note: Normalization is most effective when d approximates the "
            "intrinsic dimensionality of the data."
        )
    elif (
        obj.d_method is None
        and isinstance(obj.d, (int, float))
        and float(obj.d).is_integer()
    ) or obj.d_method == "embedding":
        logger.warning(
            "The normalization is only effective if d approximates the "
            f"intrinsic dimensionality. Current values: d_method={obj.d_method}, "
            f'd={obj.d}. Consider using d_method="fractal" for more accurate '
            "results."
        )


def _check_n_obs(obj, message):
    if not obj.n_obs:
        logger.error(message)
        raise ValueError(message)


def _release(version):
    """The leading release numbers of a version string, e.g. (1, 7, 1)."""
    match = re.match(r"\s*v?(\d+(?:\.\d+)*)", str(version))
    return tuple(int(p) for p in match.group(1).split(".")) if match else None


class Predictor(ABC):
    """Callable conditional-mean predictor on the device of its state."""

    n_input_features: int
    n_obs: int = None
    d = None
    d_method = None

    @abstractmethod
    def _mean(self, x):
        ...

    @abstractmethod
    def _covariance(self, x, diag=True):
        ...

    @abstractmethod
    def _mean_covariance(self, x, diag=True):
        ...

    @abstractmethod
    def _leverage(self, x, sigma):
        ...

    @abstractmethod
    def _obs_variance(self, x):
        ...

    @property
    @abstractmethod
    def device(self):
        ...

    @property
    @abstractmethod
    def dtype(self):
        ...

    def __str__(self):
        return self.__repr__()

    def __repr__(self):
        n_obs = "None" if self.n_obs is None else f"{self.n_obs:,}"
        return (
            f'A predictor of class "{self.__class__.__name__}" with covariance '
            f'function "{self.cov_func!r}" trained on {n_obs} observations '
            f"with {self.n_input_features:,} features and data:\n"
            + "\n".join(f"{key}: {object_str(v)}" for key, v in self._data_dict().items())
        )

    def _repr_html_(self):
        n_obs = "None" if self.n_obs is None else f"{self.n_obs:,}"
        rows = "".join(
            f"<tr><td>{key}</td><td>{object_html(value)}</td></tr>"
            for key, value in self._data_dict().items()
        )
        return (
            f"<h2>Predictor Object: {self.__class__.__name__}</h2>"
            f"<p><strong>Covariance Function:</strong> {object_html(repr(self.cov_func))}</p>"
            f"<p><strong>Trained on:</strong> {n_obs} observations</p>"
            f"<p><strong>Number of Features:</strong> {self.n_input_features:,}</p>"
            "<h3>Data Attributes</h3>"
            '<table style="border: 1px solid black; border-collapse: collapse;">'
            f"<tr><th>Attribute</th><th>Value</th></tr>{rows}</table>"
        )

    def _validate(self, x):
        x = ensure_2d(validate_array(x, "x", dtype=self.dtype, device=self.device))
        if x.shape[1] != self.n_input_features:
            raise ValueError(
                f"The predictor was trained on data with {self.n_input_features} "
                f"features. However, the provided input data has {x.shape[1]} "
                "features. Please ensure that the input data has the same number "
                "of features as the training data."
            )
        return x

    def mean(self, x, normalize=False):
        """Conditional mean at x, optionally normalized by log(n_obs)."""
        x = self._validate(x)
        normalize = validate_bool(normalize, "normalize")
        if not normalize:
            return _chunked_rows(self._mean, x)
        _check_n_obs(
            self,
            "Cannot normalize without n_obs. Please set self.n_obs to "
            "the number of samples/cells trained on to enable normalization.",
        )
        _normalization_warnings(self)
        return _chunked_rows(self._mean, x) - math.log(self.n_obs)

    __call__ = mean

    def covariance(self, x, diag=True, noise_free=False):
        """Posterior covariance of the conditional GP at x: its diagonal,
        shape (n,), or the (n, n) matrix."""
        if getattr(self, "per_feature_sigma", False) and not noise_free:
            raise ValueError(
                "This predictor was fitted with per-feature sigma, so the "
                "covariance is noise-free (sigma=0) and does not include "
                "observation noise. Pass noise_free=True to acknowledge this "
                "and obtain the noise-free covariance, then account for "
                "observation noise separately (e.g., via obs_variance)."
            )
        x = self._validate(x)
        if diag:
            return _chunked_rows(lambda b: self._covariance(b, diag=True), x)
        return self._covariance(x, diag=False)

    def mean_covariance(self, x, diag=True):
        """Covariance of the mean from the latents' uncertainty."""
        x = self._validate(x)
        if diag:
            return _chunked_rows(lambda b: self._mean_covariance(b, diag=True), x)
        return self._mean_covariance(x, diag=False)

    def uncertainty(self, x, diag=True):
        """Total predictive uncertainty: covariance + mean_covariance."""
        x = self._validate(x)
        if diag:
            return _chunked_rows(
                lambda b: self._covariance(b, diag=True) + self._mean_covariance(b, diag=True), x
            )
        return self._covariance(x, diag=False) + self._mean_covariance(x, diag=False)

    def leverage(self, x):
        """Diagonal of the hat matrix K (K + σ² I)⁻¹ at x, with the
        predictor's σ: (n,), or (n, p) for a per-feature σ."""
        return self._leverage(self._validate(x), self.sigma)

    def loo_residuals_squared(self, x, y):
        """Squared leave-one-out residuals by the HC3 shortcut r²/(1 − h)²."""
        x = self._validate(x)
        y = validate_array(y, "y", dtype=self.dtype, device=self.device)
        residual = y - self._mean(x)
        h = self._leverage(x, self.sigma)
        if residual.ndim > h.ndim:
            h = h[..., None]
        return residual**2 / (1 - h) ** 2

    def obs_variance(self, x):
        """The smoothed observation-noise variance at x."""
        return self._obs_variance(self._validate(x))

    def gradient(self, x, jit=True):
        """Gradient of the mean at each row of x, shape (n, d).  ``jit`` is
        accepted for the JAX package's signature and ignored."""
        return gradient(self._mean, self._validate(x))

    def hessian(self, x, jit=True):
        """Hessian of the mean at each row of x, shape (n, d, d)."""
        return hessian(self.__call__, self._validate(x))

    def hessian_log_determinant(self, x, jit=True):
        """``(sign, log|det|)`` of the Hessian at each row of x."""
        return hessian_log_determinant(self.__call__, self._validate(x))

    # -- serialization ------------------------------------------------------

    def _data_dict(self):
        return {key: getattr(self, key) for key in self._state_variables}

    def __getstate__(self):
        module_name = self.__class__.__module__
        try:
            version = getattr(import_module(module_name.split(".")[0]), "__version__", "NA")
        except ImportError:
            version = "NA"
        data = self._data_dict()
        data.update(
            {
                "n_input_features": self.n_input_features,
                "n_obs": self.n_obs,
                "d": self.d,
                "d_method": self.d_method,
                "_state_variables": self._state_variables,
            }
        )
        return {
            "data": {k: make_serializable(v) for k, v in data.items()},
            "cov_func": self.cov_func.__getstate__(),
            "metadata": {
                "classname": self.__class__.__name__,
                "module_name": module_name,
                "module_version": version,
                "serialization_date": datetime.now().isoformat(),
                "python_version": sys.version,
            },
        }

    def __setstate__(self, state, device=None, dtype=None):
        device, dtype = resolve_device_dtype(device, dtype)
        for name, value in state["data"].items():
            setattr(self, name, deserialize(value, device, dtype))
        self.cov_func = Covariance.from_dict(state["cov_func"])

    def copy(self):
        """A deep copy through serialization, on the same device and dtype."""
        new_instance = self.__class__.__new__(self.__class__)
        new_instance.__setstate__(self.__getstate__(), self.device, self.dtype)
        return new_instance

    def to_json(self, filename=None, compress=None):
        """The JSON string, or a file of it (``compress`` None, "gzip" or
        "bz2", which add ".gz" or ".bz2" to a name that lacks it)."""
        json_str = json.dumps(self.to_dict())
        if filename is None:
            return json_str
        if compress == "gzip":
            if isinstance(filename, str) and not filename.endswith(".gz"):
                filename += ".gz"
            open_func = gzip.open
        elif compress == "bz2":
            if isinstance(filename, str) and not filename.endswith(".bz2"):
                filename += ".bz2"
            open_func = bz2.open
        elif compress is None:
            open_func = open
        else:
            message = (
                f"Unknown compression format {compress}.\n"
                'Availabe formats are "gzip", "bz2" and None.'
            )
            logger.error(message)
            raise ValueError(message)
        with open_func(filename, "wt") as f:
            f.write(json_str)
        logger.info(f"Written predictor to {filename}.")

    def to_dict(self):
        return self.__getstate__()

    @classmethod
    def from_json(cls, filepath, compress=None, device=None, dtype=None):
        """A predictor from a JSON file; ".gz" and ".bz2" names (or
        ``compress``) are decompressed."""
        filename = str(filepath)
        if compress == "gzip" or filename.endswith(".gz"):
            open_func = gzip.open
        elif compress == "bz2" or filename.endswith(".bz2"):
            open_func = bz2.open
        else:
            open_func = open
        with open_func(filepath, "rt") as f:
            return cls.from_json_str(f.read(), device=device, dtype=dtype)

    @classmethod
    def from_dict(cls, data_dict, device=None, dtype=None):
        """A predictor from its dict, with the reference's <1.4.0 migration
        for files it wrote (module names ``mellon.*``)."""
        metadata = data_dict["metadata"]
        clsname = metadata["classname"]
        module_name = metadata["module_name"]
        release = _release(metadata["module_version"])
        if module_name.split(".")[0] == "mellon" and release and release < MIGRATION_VERSION:
            logger.warning(
                f"Loading a predictor written by version {metadata['module_version']} "
                "< 1.4.0. Please set predictor.n_obs to enable normalization."
            )
            if module_name.endswith(".conditional"):
                clsname = clsname.replace("ConditionalMean", "Conditional")
            data = data_dict["data"]
            data["n_obs"] = data.get("n_obs", None)
            data["_state_variables"] = data.get(
                "_state_variables", set(data.keys()) - {"n_input_features"}
            )
        Subclass = _resolve_predictor_class(clsname, module_name)
        instance = Subclass.__new__(Subclass)
        instance.__setstate__(data_dict, device, dtype)
        return instance

    @classmethod
    def from_json_str(cls, json_str, device=None, dtype=None):
        return cls.from_dict(json.loads(json_str), device=device, dtype=dtype)


def _resolve_predictor_class(clsname, module_name):
    """A predictor class by name first (files of mellon_tpu and of the
    reference name their own modules), then from the stated module unless
    that module belongs to another package."""
    from . import conditionals

    found = getattr(conditionals, clsname, None)
    if isinstance(found, type) and issubclass(found, Predictor):
        return found
    if module_name.split(".")[0] not in FOREIGN_PACKAGES:
        try:
            return getattr(import_module(module_name), clsname)
        except (ImportError, AttributeError):
            pass
    raise ValueError(
        f"Cannot resolve predictor class {clsname} from module {module_name}: "
        "mellon_tpu_torch has the full, landmarks and landmarks-Cholesky "
        "conditionals, their exp forms and their time-aware forms."
    )


class ExpPredictor(Predictor):
    """A predictor of exp(mean): the local dimensionality, whose GP models
    its logarithm.  The covariance methods describe the log scale, and say
    so."""

    def mean(self, x, logscale=False):
        """exp of the conditional mean at x, or the mean itself with
        ``logscale=True``."""
        x = self._validate(x)
        logscale = validate_bool(logscale, "logscale")
        out = _chunked_rows(self._mean, x)
        return out if logscale else torch.exp(out)

    __call__ = mean

    @wraps(Predictor.covariance)
    def covariance(self, *args, **kwargs):
        logger.warning("The covariance will be computed for the predicted value in log scale.")
        return super().covariance(*args, **kwargs)

    @wraps(Predictor.mean_covariance)
    def mean_covariance(self, *args, **kwargs):
        logger.warning(
            "The mean_covariance will be computed for the predicted value in log scale."
        )
        return super().mean_covariance(*args, **kwargs)

    @wraps(Predictor.uncertainty)
    def uncertainty(self, *args, **kwargs):
        logger.warning("The uncertainty will be computed for the predicted value in log scale.")
        return super().uncertainty(*args, **kwargs)


class PredictorTime(Predictor):
    """A predictor whose last input column is time.  Each method takes the
    states x (n, d − 1) and ``time``: a number for every row, or one time
    per row; ``multi_time`` (T,) evaluates it at every time of a grid,
    shape (n, T, ...)."""

    def _with_time(self, x, time):
        return validate_time_x(
            x, time, n_features=self.n_input_features, cast_scalar=True,
            dtype=self.dtype, device=self.device,
        )

    @make_multi_time_argument
    def mean(self, x, time=None, normalize=False):
        """Conditional mean at (x, time), optionally normalized by
        log(n_obs), the cells per time point."""
        x = self._with_time(x, time)
        normalize = validate_bool(normalize, "normalize")
        if not normalize:
            return _chunked_rows(self._mean, x)
        _check_n_obs(
            self,
            "Cannot normalize without n_obs. Please set self.n_obs to "
            "the number of samples/cells (per time point) trained on "
            "to enable normalization.",
        )
        _normalization_warnings(self)
        return _chunked_rows(self._mean, x) - math.log(self.n_obs)

    __call__ = mean

    @make_multi_time_argument
    def covariance(self, x, time=None, diag=True):
        """Posterior covariance of the conditional GP at (x, time)."""
        x = self._with_time(x, time)
        if diag:
            return _chunked_rows(lambda b: self._covariance(b, diag=True), x)
        return self._covariance(x, diag=False)

    @make_multi_time_argument
    def mean_covariance(self, x, time=None, diag=True):
        """Covariance of the mean from the latents' uncertainty."""
        x = self._with_time(x, time)
        if diag:
            return _chunked_rows(lambda b: self._mean_covariance(b, diag=True), x)
        return self._mean_covariance(x, diag=False)

    @make_multi_time_argument
    def uncertainty(self, x, time=None, diag=True):
        """Total predictive uncertainty: covariance + mean_covariance."""
        x = self._with_time(x, time)
        return self._covariance(x, diag=diag) + self._mean_covariance(x, diag=diag)

    @make_multi_time_argument
    def time_derivative(self, x, time, jit=True):
        """∂/∂t of the mean at (x, time), shape (n,)."""
        return gradient(self._mean, self._with_time(x, time))[:, -1]

    def _at_time(self, x, time):
        """(states, the mean as a function of the states at ``time``)."""
        x = self._with_time(x, time)
        states, times = x[:, :-1], x[:, -1:]
        return states, lambda s: self._mean(torch.cat([s, times], dim=1))

    @make_multi_time_argument
    def gradient(self, x, time, jit=True):
        """Gradient of the mean in the states at (x, time), shape (n, d − 1)."""
        states, mean_at_time = self._at_time(x, time)
        return gradient(mean_at_time, states)

    @make_multi_time_argument
    def hessian(self, x, time, jit=True):
        """Hessian of the mean in the states at (x, time)."""
        states, mean_at_time = self._at_time(x, time)
        return hessian(mean_at_time, states)

    @make_multi_time_argument
    def hessian_log_determinant(self, x, time, jit=True):
        """``(sign, log|det|)`` of the Hessian in the states at (x, time)."""
        states, mean_at_time = self._at_time(x, time)
        return hessian_log_determinant(mean_at_time, states)
