"""Smoothing and extending observed function values over cell states, such
as gene trends (counterpart of ``mellon_tpu/models/function.py``).

No optimization: the estimator prepares the kernel (1-NN distances, the
length scale, k-means landmarks) and conditions a GP on (x, y) directly,
with a scalar, per-feature (p,) or (1, p), per-observation (n,) or (n, 1),
per-observation-and-feature (n, p) or full (n, n) noise σ.  Its predictor
gives the mean, the leverage, the leave-one-out residuals and, with
``obs_variance=True``, a smoothed observation variance.  Without landmarks
(``n_landmarks=0`` or at most as many cells as landmarks) it is the full
GP; with them the landmarks conditional, whose landmark Cholesky factor is
the estimator's own (pruned where f32-singular) and is reused across
repeated conditioning.
"""

import logging

import numpy as np
import torch

from ..inference.factories import compute_conditional
from ..inference.optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, DEFAULT_OPTIMIZER
from ..parameters import DEFAULT_RANDOM_SEED
from ..utils import profiling
from ..utils.util import DEFAULT_JITTER, GaussianProcessType, ensure_2d, object_html, object_str
from ..utils.validation import (
    validate_array,
    validate_bool,
    validate_float,
    validate_float_or_iterable_numerical,
)
from .base import DEFAULT_COV_FUNC, BaseEstimator
from .fused import maybe_fused_function_prepare

logger = logging.getLogger("mellon_tpu_torch")


class FunctionEstimator(BaseEstimator):
    """Conditional-mean smoothing of function values with a GP.

    Takes the arguments of ``mellon_tpu.FunctionEstimator``, plus
    ``device`` (default ``"cuda"``) and ``dtype`` (default
    ``torch.float32``).  ``jit`` is accepted and ignored; the optimizer
    arguments are accepted for the signature (nothing is optimized).
    """

    def __init__(
        self,
        cov_func_curry=DEFAULT_COV_FUNC,
        n_landmarks=None,
        gp_type=None,
        jitter=DEFAULT_JITTER,
        optimizer=DEFAULT_OPTIMIZER,
        n_iter=DEFAULT_N_ITER,
        init_learn_rate=DEFAULT_INIT_LEARN_RATE,
        landmarks=None,
        nn_distances=None,
        mu=0,
        ls=None,
        ls_factor=1,
        cov_func=None,
        sigma=0,
        y_is_mean=False,
        predictor_with_uncertainty=False,
        obs_variance=False,
        jit=True,
        random_state=DEFAULT_RANDOM_SEED,
        device=None,
        dtype=None,
    ):
        super().__init__(
            cov_func_curry=cov_func_curry,
            n_landmarks=n_landmarks,
            rank=1.0,
            jitter=jitter,
            gp_type=gp_type,
            optimizer=optimizer,
            n_iter=n_iter,
            init_learn_rate=init_learn_rate,
            landmarks=landmarks,
            nn_distances=nn_distances,
            mu=mu,
            ls=ls,
            ls_factor=ls_factor,
            cov_func=cov_func,
            predictor_with_uncertainty=predictor_with_uncertainty,
            jit=jit,
            random_state=random_state,
            device=device,
            dtype=dtype,
        )
        self.y_is_mean = validate_bool(y_is_mean, "y_is_mean")
        self.mu = validate_float(mu, "mu")
        sigma = validate_float_or_iterable_numerical(sigma, "sigma", positive=True)
        if isinstance(sigma, torch.Tensor):
            sigma = sigma.to(device=self.device, dtype=self.dtype)
        self.sigma = sigma
        self.obs_variance = validate_bool(obs_variance, "obs_variance")
        self.conditional = None
        self.y = None
        if self.gp_type in (GaussianProcessType.FULL_NYSTROEM, GaussianProcessType.SPARSE_NYSTROEM):
            message = (
                f"gp_type={gp_type} but the Nyström rank reduction is "
                "not available for the Function Estimator. "
                "Use gp_type='cholesky' or gp_type='full' instead."
            )
            logger.error(message)
            raise ValueError(message)

    def __call__(self, x=None, y=None):
        return self.fit_predict(x=x, y=y)

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"\n    cov_func={self.cov_func},"
            f"\n    device={self.device}, dtype={self.dtype},"
            f"\n    gp_type={self.gp_type},"
            f"\n    jitter={self.jitter},"
            f"\n    landmarks={object_str(self.landmarks, ['landmarks', 'dims'])},"
            f"\n    ls={self.ls},"
            f"\n    mu={self.mu},"
            f"\n    n_landmarks={self.n_landmarks},"
            f"\n    predictor_with_uncertainty={self.predictor_with_uncertainty},"
            f"\n    sigma={object_str(self.sigma)},"
            f"\n    y_is_mean={self.y_is_mean},"
            "\n)"
        )

    def _repr_html_(self):
        status = (
            "<p style='color:green;'><strong>Predictor:</strong> Available</p>"
            if getattr(self, "conditional", None)
            else "<p style='color:red;'><strong>Predictor:</strong> Not Yet Computed</p>"
        )
        return (
            "<h2>Function Estimator</h2><p><em>Conditional-mean smoothing of "
            "observed function values over cell states using a Gaussian "
            "Process.</em></p><h3>Core Attributes</h3><ul>"
            f"<li><strong>Covariance Function:</strong> {object_html(self.cov_func or 'Not Set')}</li>"
            f"<li><strong>Number of Landmarks:</strong> {object_html(self.n_landmarks or 'Not Set')}</li>"
            f"<li><strong>Gaussian Process Type:</strong> {object_html(self.gp_type or 'Not Set')}</li>"
            f"<li><strong>Noise Standard Deviation (σ):</strong> {object_html(self.sigma)}</li>"
            "<li><strong>Predictor with Uncertainty:</strong> "
            f"{'Yes' if self.predictor_with_uncertainty else 'No'}</li></ul>" + status
        )

    def prepare_inference(self, x):
        """The kernel and the landmarks (there is nothing to optimize)."""
        with profiling.span("prepare"):
            self.set_x(x)
            self._prepare_attribute("n_landmarks")
            self._prepare_attribute("gp_type")
            # the default sparse configuration: the fused prepare (one host
            # read); customizations take the lazy chain
            maybe_fused_function_prepare(self)
            if self.ls is None and self.cov_func is None:
                self._prepare_attribute("nn_distances")
            self._prepare_attribute("ls")
            self._prepare_attribute("cov_func")
            self._prepare_attribute("landmarks")

    def compute_conditional(self, x=None, y=None, obs_variance=None):
        """The predictor conditioned on (x, y), with the estimator's landmark
        Cholesky factor (computed once, pruned where f32-singular)."""
        if x is None:
            x = self.x
        else:
            x = ensure_2d(validate_array(x, "x", dtype=self.dtype, device=self.device))
        if self.x is not None and self.x is not x:
            logger.warning(
                "self.x has been set already, but is not equal to the argument x. "
                "Current landmarks might be inapropriate."
            )
        if x is None:
            raise ValueError("Required argument x is missing and self.x has not been set.")
        if y is None:
            raise ValueError("Required argument y is missing.")
        y = validate_array(y, "y", dtype=self.dtype, device=self.device)
        if obs_variance is None:
            obs_variance = self.obs_variance
        Lp = None
        if self.landmarks is not None and self.gp_type in (
            GaussianProcessType.SPARSE_CHOLESKY,
            GaussianProcessType.FIXED,
        ):
            self._prepare_attribute("Lp")
            Lp = self.Lp
        self.conditional = compute_conditional(
            x,
            self.landmarks,
            None,
            None,
            y,
            self.mu,
            self.cov_func,
            None,
            Lp,
            self.sigma,
            jitter=self.jitter,
            y_is_mean=self.y_is_mean,
            with_uncertainty=self.predictor_with_uncertainty,
            obs_variance=obs_variance,
        )
        return self.conditional

    def fit(self, x=None, y=None, obs_variance=None):
        """Prepare and condition on (x, y)."""
        x = self.set_x(x)
        y = validate_array(y, "y", dtype=self.dtype, device=self.device)
        if y.shape[0] != x.shape[0]:
            raise ValueError(
                f"X.shape[0] = {x.shape[0]:,} (n_samples) should equal "
                f"y.shape[0] = {y.shape[0]:,}."
            )
        self.prepare_inference(x)
        self.compute_conditional(x, y, obs_variance=obs_variance)
        self.y = y
        return self

    @property
    def predict(self):
        """The conditional predictor of the last fit."""
        if self.conditional is None:
            raise ValueError(
                "The predictor is not yet computed. Call fit(x, y) or "
                "fit_predict(x, y) first."
            )
        return self.conditional

    def leverage(self, X=None):
        """The hat matrix's diagonal at X (default: the training points)."""
        return self.predict.leverage(self.x if X is None else X)

    def loo_residuals_squared(self, X=None, y=None):
        """Squared leave-one-out residuals by the HC3 shortcut (those of the
        fit's observation variance where it computed them)."""
        if X is None and y is None and hasattr(self.predict, "_corrected_r2"):
            return self.predict._corrected_r2
        return self.predict.loo_residuals_squared(
            self.x if X is None else X, self.y if y is None else y
        )

    def get_obs_variance(self, X=None):
        """The smoothed observation variance at X (default: the training
        points)."""
        return self.predict.obs_variance(self.x if X is None else X)

    def fit_predict(self, x=None, y=None, Xnew=None):
        """Fit on (x, y) and return the conditional mean at Xnew (default:
        x).  The dimensions of x and Xnew are compared as given: both 1-d
        (one feature) or both 2-d."""
        x_ndim = None if x is None else np.ndim(x)
        x = self.set_x(x)
        y = validate_array(y, "y", dtype=self.dtype, device=self.device)
        Xnew = validate_array(Xnew, "Xnew", optional=True, dtype=self.dtype, device=self.device)
        if Xnew is None:
            Xnew = x
        elif x_ndim is not None and x_ndim != Xnew.ndim:
            raise ValueError(
                "The provided arrays, 'x' and 'Xnew', do not have the "
                f"same number of dimensions. 'x' is {x_ndim}-D and 'Xnew' "
                f"is {Xnew.ndim}-D. Please provide arrays with consistent "
                "dimensionality."
            )
        elif Xnew.ndim > 1 and x.shape[1] != Xnew.shape[1]:
            raise ValueError(
                "The provided arrays, 'x' and 'Xnew', should have the "
                f"same number of features. Got Xnew.shape[1] = "
                f"{Xnew.shape[1]}, but expected it to be equal to "
                f"x.shape[1] = {x.shape[1]}. Please provide arrays with "
                "the same number of features."
            )
        self.fit(x, y)
        return self.predict(Xnew)

    def multi_fit_predict(self, x=None, Y=None, Xnew=None):
        """Deprecated: :meth:`fit_predict` with the outputs as the rows of
        Y (transposed when its columns are the samples); returns
        (outputs, points)."""
        logger.warning(
            "Deprecation Warning: FunctionEstimator's multi_fit_predict "
            "method is deprecated. Use FunctionEstimator.fit_predict instead."
        )
        Y = validate_array(Y, "Y", dtype=self.dtype, device=self.device)
        # x goes on as given, so that fit_predict compares its dimensions
        n_samples = self.set_x(None).shape[0] if x is None else np.shape(x)[0]
        if Y.shape[0] != n_samples and Y.ndim > 1 and Y.shape[1] == n_samples:
            logger.warning(
                "Y.shape[0] does not equal X.shape[0] (the number of "
                "samples). However, Y.shape[1] == X.shape[0]. Transposing "
                "Y. This assumes the columns of Y are the samples. Please "
                "verify."
            )
            Y = Y.T
        return self.fit_predict(x, Y, Xnew).T
