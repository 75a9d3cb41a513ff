"""Estimators (the names of ``mellon_tpu.models``)."""

from .base import BaseEstimator, DEFAULT_COV_FUNC
from .density import DensityEstimator
from .dimensionality import DimensionalityEstimator
from .function import FunctionEstimator
from .ls_time import compute_ls_time
from .time_density import TimeSensitiveDensityEstimator
