"""Time-sensitive cell-state density estimation (counterpart of
``mellon_tpu/models/time_density.py``).

The density over (state, time): a product of a state kernel at ``ls`` and
a time kernel at ``ls_time``, 1-NN distances within each time point
(optionally corrected for the time points' sampling bias), landmarks by
k-means in time-rescaled space, and a time-aware predictor normalized by
the average cell count per time point.  Without ``ls_time`` it is fit
from per-time density models (:mod:`.ls_time`).
"""

import html
import logging

from ..inference.factories import compute_conditional_times
from ..inference.optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, DEFAULT_OPTIMIZER
from ..parameters import (
    DEFAULT_RANDOM_SEED,
    compute_average_cell_count,
    compute_cov_func,
    compute_landmarks_rescale_time,
    compute_ls,
    compute_nn_distances_within_time_points,
)
from ..utils.util import DEFAULT_JITTER, object_str
from ..utils.validation import validate_nn_distances, validate_positive_float, validate_time_x
from .base import DEFAULT_COV_FUNC
from .density import DEFAULT_D_METHOD, SIZE_ATTRIBUTES, DensityEstimator
from .ls_time import compute_ls_time

logger = logging.getLogger("mellon_tpu_torch")

# the attributes prepare_inference computes, in order (d first: the
# within-time distances' normalization needs it)
TIME_PREPARED_ATTRIBUTES = (
    "d",
    "nn_distances",
    "mu",
    "ls",
    "ls_time",
    "cov_func",
    "landmarks",
    "Lp",
    "L",
    "initial_value",
    "transform",
    "loss_func",
)


class TimeSensitiveDensityEstimator(DensityEstimator):
    """Log density over cell states and time.  x holds the states with
    time as its last column, or ``times`` is given beside them.

    Takes the arguments of ``mellon_tpu.TimeSensitiveDensityEstimator``,
    plus ``device`` (default ``"cuda"``) and ``dtype`` (default
    ``torch.float32``); ``jit`` is accepted and ignored.  With
    ``ls_time=None`` the time length scale comes from per-time density
    fits (``_save_intermediate_ls_times=True`` keeps them as
    ``densities``, ``predictors`` and ``numeric_stages``).
    """

    def __init__(
        self,
        cov_func_curry=DEFAULT_COV_FUNC,
        n_landmarks=None,
        rank=None,
        gp_type=None,
        d_method=DEFAULT_D_METHOD,
        jitter=DEFAULT_JITTER,
        optimizer=DEFAULT_OPTIMIZER,
        n_iter=DEFAULT_N_ITER,
        init_learn_rate=DEFAULT_INIT_LEARN_RATE,
        landmarks=None,
        nn_distances=None,
        normalize_per_time_point=False,
        d=None,
        mu=None,
        ls=None,
        ls_time=None,
        ls_factor=1,
        ls_time_factor=1,
        density_estimator_kwargs=None,
        cov_func=None,
        Lp=None,
        L=None,
        initial_value=None,
        predictor_with_uncertainty=False,
        _save_intermediate_ls_times=False,
        jit=False,
        check_rank=None,
        random_state=DEFAULT_RANDOM_SEED,
        precision=None,
        sampler_options=None,
        device=None,
        dtype=None,
    ):
        super().__init__(
            cov_func_curry=cov_func_curry,
            n_landmarks=n_landmarks,
            rank=rank,
            gp_type=gp_type,
            d_method=d_method,
            jitter=jitter,
            optimizer=optimizer,
            n_iter=n_iter,
            init_learn_rate=init_learn_rate,
            landmarks=landmarks,
            nn_distances=nn_distances,
            d=d,
            mu=mu,
            ls=ls,
            ls_factor=ls_factor,
            cov_func=cov_func,
            Lp=Lp,
            L=L,
            initial_value=initial_value,
            predictor_with_uncertainty=predictor_with_uncertainty,
            jit=jit,
            check_rank=check_rank,
            random_state=random_state,
            precision=precision,
            sampler_options=sampler_options,
            device=device,
            dtype=dtype,
        )
        density_estimator_kwargs = {} if density_estimator_kwargs is None else density_estimator_kwargs
        if not isinstance(density_estimator_kwargs, dict):
            raise ValueError("density_estimator_kwargs needs to be a dictionary.")
        self.density_estimator_kwargs = density_estimator_kwargs
        self.ls_time = validate_positive_float(ls_time, "ls_time", optional=True)
        self.ls_time_factor = validate_positive_float(ls_time_factor, "ls_time_factor")
        self._save_intermediate_ls_times = _save_intermediate_ls_times
        self.normalize_per_time_point = normalize_per_time_point

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"\n    cov_func={self.cov_func},"
            f"\n    device={self.device}, dtype={self.dtype},"
            f"\n    gp_type={self.gp_type},"
            f"\n    landmarks={object_str(self.landmarks, ['landmarks', 'dims'])},"
            f"\n    L={object_str(self.L, ['cells', 'ranks'])},"
            f"\n    ls={self.ls},"
            f"\n    ls_time={self.ls_time},"
            f"\n    mu={self.mu},"
            f"\n    n_landmarks={self.n_landmarks},"
            f"\n    nn_distances={object_str(self.nn_distances, ['cells'])},"
            f"\n    normalize_per_time_point={self.normalize_per_time_point},"
            f"\n    optimizer={self.optimizer},"
            f"\n    rank={self.rank},"
            "\n)"
        )

    def _repr_html_(self):
        def value(v):
            return html.escape(str(v))

        status = (
            "<p style='color:green;'><strong>Predictor:</strong> Available</p>"
            if self.log_density_func
            else "<p style='color:red;'><strong>Predictor:</strong> Not Yet Computed</p>"
        )
        return (
            f"<h2>Time-Sensitive Density Estimator: {self.__class__.__name__}</h2>"
            "<p><em>A non-parametric density estimation model with time "
            "sensitivity using Gaussian Processes.</em></p><ul>"
            f"<li><strong>Covariance Function:</strong> {value(self.cov_func or 'Not Set')}</li>"
            f"<li><strong>Optimizer:</strong> {value(self.optimizer)}</li>"
            f"<li><strong>Number of Landmarks:</strong> {value(self.n_landmarks or 'Not Set')}</li>"
            f"<li><strong>Gaussian Process Type:</strong> {value(self.gp_type or 'Not Set')}</li>"
            "<li><strong>Time Normalization:</strong> "
            f"{value(self.normalize_per_time_point or 'Disabled')}</li></ul>" + status
        )

    def _states(self):
        return self.x[:, :-1]

    def _compute_nn_distances(self):
        logger.info("Computing nearest neighbor distances within time points.")
        return validate_nn_distances(
            compute_nn_distances_within_time_points(
                self.x, d=self.d, normalize=self.normalize_per_time_point
            )
        )

    def _compute_ls(self):
        nn_distances = self.nn_distances
        if self.normalize_per_time_point is not False and self.normalize_per_time_point is not None:
            logger.info("Computing non-normalized nn_distances for length scale heuristic.")
            nn_distances = compute_nn_distances_within_time_points(self.x, normalize=False)
        return compute_ls(nn_distances) * self.ls_factor

    def _compute_ls_time(self):
        kwargs = {
            "cov_func_curry": self.cov_func_curry,
            "d_method": self.d_method,
            "d": self.d,
            "optimizer": self.optimizer,
            "ls": self.ls,
            "ls_factor": self.ls_factor,
            "jit": self.jit,
            "mu": self.mu,
        }
        kwargs.update(self.density_estimator_kwargs)
        logger.info(
            "Initiating density computation for each time point to estimate "
            "the 'ls_time' parameter. You can directly specify 'ls_time' to "
            "bypass this computation-intensive step."
        )
        ls = compute_ls_time(
            self.nn_distances,
            self.x,
            self.cov_func_curry,
            return_data=self._save_intermediate_ls_times,
            density_estimator_kwargs=kwargs,
        )
        if self._save_intermediate_ls_times:
            logger.info("Storing `self.densities`, `self.predictors`, and `self.numeric_stages`.")
            ls, self.densities, self.predictors, self.numeric_stages = ls
        return ls * self.ls_time_factor

    def _compute_landmarks(self):
        return compute_landmarks_rescale_time(
            self.x,
            self.ls,
            self.ls_time,
            n_landmarks=self.n_landmarks,
            random_state=self._landmark_seed(),
        )

    def _compute_cov_func(self):
        cov_func = compute_cov_func(self.cov_func_curry, self.ls, self.ls_time)
        logger.info("Using covariance function %s.", str(cov_func))
        return cov_func

    def _set_log_density_func(self):
        logger.info("Computing predictive function.")
        log_density_func = compute_conditional_times(
            self.x,
            self.landmarks,
            self.pre_transformation,
            self.pre_transformation_std,
            self.log_density_x,
            self.mu,
            self.cov_func,
            self.L,
            self.Lp,
            sigma=None,
            jitter=self.jitter,
            y_is_mean=True,
            with_uncertainty=self.predictor_with_uncertainty,
        )
        log_density_func.n_obs = compute_average_cell_count(self.x, self.normalize_per_time_point)
        log_density_func.d = self.d
        log_density_func.d_method = self.d_method
        self.log_density_func = log_density_func

    def _time_x(self, x, times):
        return validate_time_x(x, times, dtype=self.dtype, device=self.device)

    def prepare_inference(self, x, times=None):
        """Set every attribute the optimization needs; returns
        ``(loss_func, initial_value)``."""
        if x is not None:
            x = self._time_x(x, times)
        x = self.set_x(x)
        for attribute in SIZE_ATTRIBUTES:
            self._prepare_attribute(attribute)
        self.validate_parameter()
        for attribute in TIME_PREPARED_ATTRIBUTES:
            self._prepare_attribute(attribute)
        return self.loss_func, self.initial_value

    def run_inference(self, loss_func=None, initial_value=None, optimizer=None):
        """Optimize the latents (``optimizer`` replaces the estimator's);
        returns ``pre_transformation``."""
        if loss_func is not None:
            self.loss_func = loss_func
        if initial_value is not None:
            self.initial_value = initial_value
        if optimizer is not None:
            self.optimizer = optimizer
        self._run_inference()
        return self.pre_transformation

    def fit(self, x=None, times=None, build_predict=True):
        """End-to-end training on x (with ``times``, or time as its last
        column)."""
        self.prepare_inference(x, times)
        self.run_inference()
        self.process_inference(build_predict=build_predict)
        return self

    def fit_predict(self, x=None, times=None, build_predict=False):
        """Train and return the log density at the training points."""
        if x is not None:
            x = self._time_x(x, times)
        self.fit(x, build_predict=build_predict)
        return self.log_density_x
