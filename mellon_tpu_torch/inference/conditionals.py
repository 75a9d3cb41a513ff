"""Landmark conditional (counterpart of ``_LandmarksConditionalCholesky`` in
``mellon_tpu/inference/conditionals.py``): mean, covariance and the
covariance of the mean from the latents' uncertainty.

The latents live on the landmarks: weights = Lp⁻ᵀ z, and the mean at new
points is μ + k(X*, xu)·weights.  With uncertainty the predictor keeps the
landmark factor L and W = L⁻ᵀ·diag(std):

* covariance: k(x*, x*) − colsum((L⁻¹·k(xu, X*))²), the kernel with the
  landmarks as rows;
* mean covariance: rowsum((k(X*, xu)·W)²).

Every k(·, xu) and k(xu, ·) is the hand-written CUDA tile on the card (a
fused mean kernel is ROADMAP kernel K5).  The leverage and the observation
variance belong to the FunctionEstimator (ROADMAP Queue 1, item 12).
"""

import torch

from ..ops.linalg import DEFAULT_SIGMA, _full_rank, safe_cholesky
from ..utils.util import DEFAULT_JITTER, add_diagonal, ensure_2d
from .predictors import _FUNCTION_ESTIMATOR, Predictor


def _conditional_mean(cov_func, Xnew, base, weights, mu):
    """mu + k(Xnew, base) @ weights."""
    return mu + cov_func(Xnew, base) @ weights


def _conditional_cov_diag(cov_func, Xnew, base, L):
    """k(x, x) − colsum((L⁻¹·k(base, Xnew))²)."""
    A = torch.linalg.solve_triangular(L, cov_func(base, Xnew), upper=False)
    return cov_func.diag(Xnew) - torch.sum(A * A, dim=0)


def _conditional_mean_cov_diag(cov_func, Xnew, base, W):
    """rowsum((k(Xnew, base)·W)²)."""
    cov_L = cov_func(Xnew, base) @ W
    return torch.sum(cov_L * cov_L, dim=1)


def _no_input_uncertainty():
    return ValueError(
        "No input uncertainty specified. Make sure to set `sigma` or "
        "`pre_transformation_std`, e.g., by using `optimizer=\"advi\"`, to "
        "quantify uncertainty of the prediction."
    )


def _noise_cholesky(xu, cov_func, sigma, jitter):
    """chol(k(xu, xu) + diag(max(σ², jitter))) for a scalar or per-landmark
    σ (the JAX package's add_variance of diag(σ))."""
    if sigma is None:
        raise _no_input_uncertainty()
    K = cov_func(xu, xu)
    sigma = torch.as_tensor(sigma, dtype=K.dtype, device=K.device)
    noise = torch.clamp_min(sigma * sigma, jitter).expand(K.shape[0])
    max_tries = 0 if K.dtype == torch.float64 else 3
    return safe_cholesky(add_diagonal(K, noise), jitter=0.0, max_tries=max_tries)


def _check_covariance(obj):
    if not hasattr(obj, "L"):
        raise ValueError(
            "The predictor was computed without covariance. "
            "Recompute setting `with_uncertainty=True.`"
        )


def _check_uncertainty(obj):
    if not hasattr(obj, "W"):
        raise ValueError(
            "The predictor was computed without uncertainty, e.g., using ADVI. "
            "Recompute setting `with_uncertainty=True.` and define "
            "`pre_transformation_std`, e.g., by using `optimizer='advi'`."
        )


class LandmarksConditionalCholesky(Predictor):
    """The GP conditioned through the landmark Cholesky factor L.

    Same arguments as the JAX package's class; ``sigma`` is the latents'
    std (a vector) or a scalar noise, used by ``with_uncertainty=True``.
    """

    def __init__(
        self,
        xu,
        pre_transformation,
        mu,
        cov_func,
        n_obs,
        L=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
    ):
        if obs_variance:
            raise NotImplementedError(f"obs_variance is {_FUNCTION_ESTIMATOR}")
        xu = ensure_2d(xu)
        if L is None:
            if y_is_mean:
                L = _full_rank(xu, cov_func, jitter=jitter)
            else:
                L = _noise_cholesky(xu, cov_func, sigma, jitter)
        weights = torch.linalg.solve_triangular(
            L.T, pre_transformation[:, None], upper=True
        )[:, 0]
        self._set_state(xu, weights, mu, cov_func, n_obs, jitter, sigma)
        if not with_uncertainty:
            return
        if sigma is None:
            raise _no_input_uncertainty()
        sigma = torch.as_tensor(sigma, dtype=L.dtype, device=L.device)
        stds = torch.diag(sigma) if sigma.ndim == 1 else torch.eye(
            xu.shape[0], dtype=L.dtype, device=L.device
        ) * sigma
        self._set_uncertainty(L, torch.linalg.solve_triangular(L.T, stds, upper=True))

    @classmethod
    def from_state(
        cls, landmarks, weights, mu, cov_func, n_obs=None, jitter=DEFAULT_JITTER,
        sigma=None, L=None, W=None,
    ):
        """A predictor from its stored state (landmarks and weights, and L
        and W for one with uncertainty)."""
        self = cls.__new__(cls)
        self._set_state(ensure_2d(landmarks), weights, mu, cov_func, n_obs, jitter, sigma)
        if L is not None:
            self._set_uncertainty(L, W)
        return self

    def _set_state(self, landmarks, weights, mu, cov_func, n_obs, jitter, sigma):
        self.cov_func = cov_func
        self.landmarks = landmarks
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = sigma
        self.per_feature_sigma = False
        self.n_input_features = landmarks.shape[1]
        self.n_obs = n_obs
        self._state_variables = {
            "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

    def _set_uncertainty(self, L, W):
        self.L = L
        self.W = W
        self._state_variables |= {"L", "W"}

    @property
    def device(self):
        return self.landmarks.device

    @property
    def dtype(self):
        return self.landmarks.dtype

    def _mean(self, Xnew):
        return _conditional_mean(self.cov_func, Xnew, self.landmarks, self.weights, self.mu)

    def _covariance(self, Xnew, diag=True):
        _check_covariance(self)
        if diag:
            return _conditional_cov_diag(self.cov_func, Xnew, self.landmarks, self.L)
        A = torch.linalg.solve_triangular(
            self.L, self.cov_func(self.landmarks, Xnew), upper=False
        )
        return self.cov_func(Xnew, Xnew) - A.T @ A

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(self.cov_func, Xnew, self.landmarks, self.W)
        cov_L = self.cov_func(Xnew, self.landmarks) @ self.W
        return cov_L @ cov_L.T
