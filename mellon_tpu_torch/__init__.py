"""mellon_tpu_torch: the estimators of mellon_tpu in PyTorch and CUDA.

A port of ``mellon_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100.  It runs
``DensityEstimator(...).fit(x)`` on every GP type (full, sparse Cholesky,
fixed, and the full and sparse Nyström rank reductions) with L-BFGS (also
the two-phase ``precision="bf16"`` MAP), adam or ADVI and the optional
diagonal Laplace uncertainty, or with the posterior samplers (multi-chain
NUTS and HMC, Hessian-preconditioned sampling, SMC, their diagnostics in
:mod:`.inference`, and sampler checkpoints in :mod:`.parallel`);
``FunctionEstimator`` (gene trends: the conditional mean under scalar,
per-feature or per-observation noise, the leverage and the observation
variance) and ``DimensionalityEstimator`` (the local dimensionality
jointly with the density, also by NUTS); ``TimeSensitiveDensityEstimator``
(the density over cell states and time, with the time length scale given
or fit from per-time densities); and their predictors: the mean, its
covariance and uncertainty, gradient and Hessian, and JSON in the format
mellon_tpu reads.  A float32 landmark kernel that does not factor is
pruned, or kept whole in float64 with ``config.PRUNE_SINGULAR_LANDMARKS =
False``.  The Matern-5/2 covariance tile is a hand-written CUDA kernel for
``sm_90a`` (``csrc/matern52_tile.cu``), built from source at first use.
Importing the package turns TF32 off (see :mod:`.config`); it configures
no logging handler (:func:`setup_logging` does, with :data:`LOGGING_CONFIG`).
"""

import logging
import sys

from . import config, inference, parallel, parameters
from . import models as model
from .config import DEFAULT_DEVICE, DEFAULT_DTYPE
from .convert import state_from_jax
from .inference.conditionals import (
    ExpFullConditional,
    ExpLandmarksConditional,
    ExpLandmarksConditionalCholesky,
    FullConditional,
    FullConditionalTime,
    LandmarksConditional,
    LandmarksConditionalCholesky,
    LandmarksConditionalCholeskyTime,
    LandmarksConditionalTime,
)
from .inference.predictors import ExpPredictor, Predictor, PredictorTime
from .models.density import DensityEstimator
from .models.dimensionality import DimensionalityEstimator
from .models.function import FunctionEstimator
from .models.time_density import TimeSensitiveDensityEstimator
from .ops.kernels import (
    Covariance,
    Exponential,
    ExpQuad,
    Linear,
    Matern32,
    Matern52,
    RatQuad,
)
from .inference import conditionals as conditional
from .inference import derivatives
from .ops import kernels as cov
from .ops import linalg as decomposition
from .parallel import load_sampler_state, save_sampler_state
from .utils import util, validation
from .utils.util import GaussianProcessType, set_verbosity

__version__ = "0.6.0"

# the legacy module paths of the reference (``from mellon.util import
# distance``) as importable modules, as the JAX package registers them
for _name, _mod in (
    ("util", util),
    ("cov", cov),
    ("model", model),
    ("conditional", conditional),
    ("validation", validation),
    ("derivatives", derivatives),
    ("decomposition", decomposition),
):
    sys.modules[__name__ + "." + _name] = _mod

# the default logging configuration, in the reference's dictConfig shape
LOGGING_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {"standard": {"format": "[%(asctime)s] [%(levelname)-8s] %(message)s"}},
    "handlers": {
        "console": {
            "level": "DEBUG",
            "class": "logging.StreamHandler",
            "formatter": "standard",
            "stream": sys.stdout,
        },
    },
    "loggers": {
        "mellon_tpu_torch": {"handlers": ["console"], "level": "INFO", "propagate": False},
    },
}

logger = logging.getLogger("mellon_tpu_torch")


def setup_logging(config=None):
    """Configure logging (``logging.config.dictConfig`` of ``config``, by
    default :data:`LOGGING_CONFIG`) and return the package logger."""
    import logging.config

    logging.config.dictConfig(LOGGING_CONFIG if config is None else config)
    return logger


__all__ = [
    "__version__",
    "config",
    "conditional",
    "cov",
    "decomposition",
    "derivatives",
    "inference",
    "load_sampler_state",
    "LOGGING_CONFIG",
    "logger",
    "model",
    "parallel",
    "parameters",
    "save_sampler_state",
    "set_verbosity",
    "setup_logging",
    "util",
    "validation",
    "DEFAULT_DEVICE",
    "DEFAULT_DTYPE",
    "Covariance",
    "DensityEstimator",
    "DimensionalityEstimator",
    "ExpFullConditional",
    "ExpLandmarksConditional",
    "ExpLandmarksConditionalCholesky",
    "ExpPredictor",
    "Exponential",
    "ExpQuad",
    "FullConditional",
    "FullConditionalTime",
    "FunctionEstimator",
    "GaussianProcessType",
    "LandmarksConditional",
    "LandmarksConditionalCholesky",
    "LandmarksConditionalCholeskyTime",
    "LandmarksConditionalTime",
    "Linear",
    "Matern32",
    "Matern52",
    "Predictor",
    "PredictorTime",
    "RatQuad",
    "state_from_jax",
    "TimeSensitiveDensityEstimator",
]
