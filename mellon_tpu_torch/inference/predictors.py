"""Predictor facade (counterpart of ``mellon_tpu/inference/predictors.py``).

Only the conditional mean is ported; uncertainty, derivatives and JSON
I/O come with ROADMAP Queue 1, items 9 and 11.
"""

import logging
import math
from abc import ABC, abstractmethod

import torch

from ..utils.util import ensure_2d
from ..utils.validation import validate_array, validate_bool

logger = logging.getLogger("mellon_tpu_torch")

# queries larger than this evaluate in row chunks so the (n_query, m)
# kernel tile stays memory-bounded
PREDICT_CHUNK_SIZE = 200_000


class Predictor(ABC):
    """Callable conditional-mean predictor on the device of its state."""

    n_input_features: int
    n_obs: int = None
    d = None
    d_method = None

    @abstractmethod
    def _mean(self, x):
        ...

    @property
    @abstractmethod
    def device(self):
        ...

    @property
    @abstractmethod
    def dtype(self):
        ...

    def __repr__(self):
        return (
            f'A predictor of class "{self.__class__.__name__}" with covariance '
            f'function "{self.cov_func!r}" trained on {self.n_obs} observations '
            f"with {self.n_input_features:,} features."
        )

    def mean(self, x, normalize=False):
        """Conditional mean at x, optionally normalized by log(n_obs)."""
        x = ensure_2d(validate_array(x, "x", dtype=self.dtype, device=self.device))
        normalize = validate_bool(normalize, "normalize")
        if x.shape[1] != self.n_input_features:
            raise ValueError(
                f"The predictor was trained on data with {self.n_input_features} "
                f"features. However, the provided input data has {x.shape[1]} "
                "features. Please ensure that the input data has the same number "
                "of features as the training data."
            )
        out = torch.cat(
            [self._mean(x[s : s + PREDICT_CHUNK_SIZE]) for s in range(0, x.shape[0], PREDICT_CHUNK_SIZE)]
        )
        if not normalize:
            return out
        if not self.n_obs:
            message = (
                "Cannot normalize without n_obs. Please set self.n_obs to "
                "the number of samples/cells trained on to enable normalization."
            )
            logger.error(message)
            raise ValueError(message)
        return out - math.log(self.n_obs)

    __call__ = mean
