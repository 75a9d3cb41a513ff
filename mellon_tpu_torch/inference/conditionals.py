"""Landmark conditional (counterpart of ``_LandmarksConditionalCholesky`` in
``mellon_tpu/inference/conditionals.py``), mean only.

The latents live on the landmarks: weights = Lp⁻ᵀ z, and the mean at new
points is μ + k(X*, xu) · weights, whose kernel tile is the hand-written
CUDA kernel on the card (a fused mean kernel is ROADMAP kernel K5).
"""

import torch

from ..ops.linalg import _full_rank
from ..utils.util import DEFAULT_JITTER, ensure_2d
from .predictors import Predictor


def _conditional_mean(cov_func, Xnew, base, weights, mu):
    """mu + k(Xnew, base) @ weights."""
    return mu + cov_func(Xnew, base) @ weights


class LandmarksConditionalCholesky(Predictor):
    """Mean of the GP conditioned through the landmark Cholesky factor."""

    def __init__(self, xu, pre_transformation, mu, cov_func, n_obs, L=None, jitter=DEFAULT_JITTER):
        xu = ensure_2d(xu)
        if L is None:
            L = _full_rank(xu, cov_func, jitter=jitter)
        weights = torch.linalg.solve_triangular(
            L.T, pre_transformation[:, None], upper=True
        )[:, 0]
        self._set_state(xu, weights, mu, cov_func, n_obs, jitter)

    @classmethod
    def from_state(cls, landmarks, weights, mu, cov_func, n_obs=None, jitter=DEFAULT_JITTER):
        """A predictor from its stored state (landmarks and weights)."""
        self = cls.__new__(cls)
        self._set_state(ensure_2d(landmarks), weights, mu, cov_func, n_obs, jitter)
        return self

    def _set_state(self, landmarks, weights, mu, cov_func, n_obs, jitter):
        self.cov_func = cov_func
        self.landmarks = landmarks
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.n_input_features = landmarks.shape[1]
        self.n_obs = n_obs

    @property
    def device(self):
        return self.landmarks.device

    @property
    def dtype(self):
        return self.landmarks.dtype

    def _mean(self, Xnew):
        return _conditional_mean(self.cov_func, Xnew, self.landmarks, self.weights, self.mu)
