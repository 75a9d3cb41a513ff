"""Cell-state density estimation (counterpart of ``mellon_tpu/models/density.py``).

``DensityEstimator().fit_predict(x)`` runs the main path: 1-NN distances and
their repair, the d/mu/ls heuristics (d the embedding's, or the mean local
fractal dimension with ``d_method="fractal"``), k-means landmarks, the
landmark Cholesky (pruned when singular at f32), L = k(x, xu) Lp⁻ᵀ, the
ridge warm start, the latents' fit (L-BFGS by default, or adam, ADVI, or
the posterior mean of NUTS or SMC draws) and f = L z + μ.  At most 5,000
cells take the full GP type instead: no landmarks, L = chol(k(x, x)).
``.predict`` builds the conditional predictor lazily; with
``predictor_with_uncertainty=True`` it also carries the latents' std (from
ADVI, NUTS or SMC, or else the diagonal Laplace approximation).
"""

import logging

from ..inference.factories import compute_conditional
from ..inference.losses import (
    compute_log_density_x,
    compute_loss_func,
    compute_transform,
    density_hessian,
    density_hessian_diagonal,
    make_density_loss_batch,
    make_density_value_and_grad,
)
from ..inference.mcmc import zero_centered_potential
from ..inference.optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, DEFAULT_OPTIMIZER
from ..parameters import (
    DEFAULT_RANDOM_SEED,
    compute_d,
    compute_d_factal,
    compute_initial_value,
    compute_mu,
)
from ..utils.util import DEFAULT_JITTER, object_html
from ..utils.validation import validate_array, validate_string
from .base import DEFAULT_COV_FUNC, BaseEstimator

DEFAULT_D_METHOD = "embedding"

# the attributes prepare_inference computes, in order: the sizes, which
# validate_parameter checks, then the main path's stages
SIZE_ATTRIBUTES = ("n_landmarks", "rank", "gp_type")
PREPARED_ATTRIBUTES = (
    "nn_distances",
    "d",
    "mu",
    "ls",
    "cov_func",
    "landmarks",
    "Lp",
    "L",
    "initial_value",
    "transform",
    "loss_func",
)

logger = logging.getLogger("mellon_tpu_torch")


class DensityEstimator(BaseEstimator):
    """Bayesian log-density model with a GP prior and a 1-NN likelihood.

    Takes the arguments of ``mellon_tpu.DensityEstimator``, plus
    ``device`` (default ``"cuda"``) and ``dtype`` (default
    ``torch.float32``).  ``landmarks=`` fixes the landmarks instead of
    drawing them by k-means.  ``jit`` is accepted and ignored, and so is
    ``sampler_options["steps_per_call"]``.  ``precision="bf16"`` runs the
    two-phase L-BFGS MAP (3/4 of the steps with L stored in bfloat16, then
    float32); bf16 sampling raises.  ``optimizer="nuts"`` or
    ``"smc"`` keeps the posterior draws (``posterior_samples``,
    ``mcmc_result`` or ``smc_result``; NUTS also ``sampling_time``,
    ``ess`` and ``ess_per_second``), seeded from ``random_state``.
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
        d=None,
        mu=None,
        ls=None,
        ls_factor=1,
        cov_func=None,
        Lp=None,
        L=None,
        initial_value=None,
        predictor_with_uncertainty=False,
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
            jitter=jitter,
            gp_type=gp_type,
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
        if d is not None:
            self.d_method = "manual"
            logger.info(f"Explicitly provided d={d}, setting d_method to 'manual'.")
        else:
            self.d_method = validate_string(
                d_method, "d_method", choices={"fractal", "embedding", "manual"}
            )
        self.transform = None
        self.loss_func = None
        self.opt_state = None
        self.losses = None
        self.pre_transformation = None
        self.pre_transformation_std = None
        self.log_density_x = None
        self.log_density_func = None

    def _repr_html_(self):
        status = (
            "<p style='color:green;'><strong>Predictor:</strong> Available</p>"
            if self.log_density_func
            else "<p style='color:red;'><strong>Predictor:</strong> Not Yet Computed</p>"
        )
        return (
            "<h2>Density Estimator</h2><p><em>A non-parametric density estimation "
            "model using Gaussian Processes and Nearest Neighbor Distance "
            "Distribution.</em></p><h3>Core Attributes</h3><ul>"
            f"<li><strong>Covariance Function:</strong> {object_html(self.cov_func or 'Not Set')}</li>"
            f"<li><strong>Optimizer:</strong> {object_html(self.optimizer)}</li>"
            f"<li><strong>Number of Landmarks:</strong> {object_html(self.n_landmarks or 'Not Set')}</li>"
            f"<li><strong>Gaussian Process Type:</strong> {object_html(self.gp_type or 'Not Set')}</li>"
            f"<li><strong>Dimensionality Method:</strong> {object_html(self.d_method)}</li>"
            "</ul>" + status
        )

    def _states(self):
        """The training cells' state coordinates."""
        return self.x

    def _compute_d(self):
        if self.d_method == "fractal":
            d = compute_d_factal(self._states())
            logger.info(f"Using d={d}.")
        elif self.d_method == "manual":
            if self.d is None:
                raise ValueError(
                    'd_method="manual" requires the intrinsic '
                    "dimensionality d to be passed explicitly."
                )
            d = self.d
            logger.info(f"Using manually set d={d}.")
        else:
            d = compute_d(self._states())
            logger.info(
                f"Using embedding dimensionality d={d}. "
                'Use d_method="fractal" to enable effective density normalization.'
            )
        if float(d if not hasattr(d, "max") else d.max()) > 50:
            raise ValueError(
                f"The detected dimensionality of the data is over 50, which is "
                "likely to cause numerical instability issues. Consider running a "
                "dimensionality reduction algorithm, or if this number of "
                f"dimensions is intended, explicitly pass d={d} as a parameter."
            )
        return d

    def _compute_mu(self):
        return compute_mu(self.nn_distances, self.d)

    def _compute_initial_value(self):
        return compute_initial_value(self.nn_distances, self.d, self.mu, self.L)

    def _compute_transform(self):
        return compute_transform(self.mu, self.L)

    def _compute_loss_func(self):
        # the forms the optimizers and the Laplace approximation take
        args = (self.L, self.nn_distances, self.d, self.mu)
        self._loss_args = args
        self._make_value_and_grad = make_density_value_and_grad
        self._value_and_grad = make_density_value_and_grad(*args)
        self._loss_batch = make_density_loss_batch(*args)
        self._hessian_diagonal = lambda z: density_hessian_diagonal(z, *args)
        self._sampler_potential = lambda z0: zero_centered_potential(z0, *args)[0]
        self._sampler_hessian = lambda z: density_hessian(z, *args)
        return compute_loss_func(
            self.nn_distances, self.d, self.transform, self.initial_value.shape[0]
        )

    def _set_log_density_x(self):
        self.log_density_x = compute_log_density_x(self.pre_transformation, self.transform)

    def _set_log_density_func(self):
        logger.info("Computing predictive function.")
        log_density_func = compute_conditional(
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
        log_density_func.n_obs = self.x.shape[0]
        log_density_func.d = self.d
        log_density_func.d_method = self.d_method
        self.log_density_func = log_density_func

    def prepare_inference(self, x):
        """Set every attribute the optimization needs; returns
        ``(loss_func, initial_value)``."""
        x = self.set_x(x)
        for attribute in SIZE_ATTRIBUTES:
            self._prepare_attribute(attribute)
        self.validate_parameter()
        for attribute in PREPARED_ATTRIBUTES:
            self._prepare_attribute(attribute)
        return self.loss_func, self.initial_value

    def run_inference(self):
        """Optimize the latents; returns ``pre_transformation``."""
        self._run_inference()
        return self.pre_transformation

    def process_inference(self, pre_transformation=None, build_predict=True):
        """Log density at the training points and, optionally, the predictor."""
        if pre_transformation is not None:
            self.pre_transformation = validate_array(
                pre_transformation, "pre_transformation", dtype=self.dtype, device=self.device
            )
        self._set_log_density_x()
        if build_predict:
            self._set_log_density_func()
        return self.log_density_x

    def fit(self, x=None, build_predict=True):
        """End-to-end training."""
        self.prepare_inference(x)
        self.run_inference()
        self.process_inference(build_predict=build_predict)
        return self

    @property
    def predict(self):
        """The log-density predictor, built at first use."""
        if self.log_density_func is None:
            self._set_log_density_func()
        return self.log_density_func

    def fit_predict(self, x=None, build_predict=False):
        """Train and return the log density at the training points."""
        self.fit(x, build_predict=build_predict)
        return self.log_density_x
