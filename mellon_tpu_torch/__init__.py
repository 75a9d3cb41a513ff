"""mellon_tpu_torch: the estimators of mellon_tpu in PyTorch and CUDA.

A port of ``mellon_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100.  It runs
``DensityEstimator(...).fit(x)`` on the full or the sparse GP with
L-BFGS, adam or ADVI and the optional diagonal Laplace uncertainty, or
with the posterior samplers (multi-chain NUTS and HMC,
Hessian-preconditioned sampling, SMC, and their diagnostics in
:mod:`.inference`); ``FunctionEstimator`` (gene trends: the conditional
mean under scalar, per-feature or per-observation noise, the leverage and
the observation variance) and ``DimensionalityEstimator`` (the local
dimensionality jointly with the density); ``TimeSensitiveDensityEstimator``
(the density over cell states and time, with the time length scale given
or fit from per-time densities); and their predictors: the mean,
its covariance and uncertainty, gradient and Hessian, and JSON in the
format mellon_tpu reads.  The Matern-5/2 covariance tile is a hand-written CUDA
kernel for ``sm_90a`` (``csrc/matern52_tile.cu``), built from source at
first use.  Importing the package turns TF32 off (see :mod:`.config`).
"""

from . import config
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
from .utils.util import GaussianProcessType

__version__ = "0.6.0"

__all__ = [
    "__version__",
    "config",
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
