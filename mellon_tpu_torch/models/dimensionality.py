"""Joint estimation of the local dimensionality and the density (counterpart
of ``mellon_tpu/models/dimensionality.py``).

Two GPs share one whitening L: the log local dimension and the log
density, latents z of shape (2, k), fit to the k-NN distances by a
Poisson likelihood (:func:`.losses.make_dimensionality_value_and_grad`).
The local dimensions at the cells (:func:`.neighbors.local_dimensionality`,
30 neighbours) give the dimension's warm start and the density's d.
``.predict`` is the exp-mean predictor of the local dimension,
``.predict_density`` the log-density predictor.
"""

import logging

from ..inference.factories import compute_conditional, compute_conditional_explog
from ..inference.losses import (
    compute_dimensionality_loss_func,
    compute_dimensionality_transform,
    compute_log_density_x,
    dimensionality_hessian,
    dimensionality_hessian_diagonal,
    make_dimensionality_loss_batch,
    make_dimensionality_value_and_grad,
    zero_centered_dimensionality_potential,
)
from ..inference.optimizers import DEFAULT_INIT_LEARN_RATE, DEFAULT_N_ITER, DEFAULT_OPTIMIZER
from ..ops.neighbors import local_dimensionality
from ..parameters import (
    DEFAULT_RANDOM_SEED,
    compute_distances,
    compute_initial_dimensionalities,
    compute_mu,
)
from ..utils.util import DEFAULT_JITTER, object_html, object_str
from ..utils.validation import validate_array, validate_float, validate_positive_int
from .base import DEFAULT_COV_FUNC, BaseEstimator

logger = logging.getLogger("mellon_tpu_torch")

# the attributes prepare_inference computes after the sizes, in order
PREPARED_ATTRIBUTES = (
    "distances",
    "nn_distances",
    "d",
    "mu_dens",
    "ls",
    "cov_func",
    "landmarks",
    "Lp",
    "L",
    "initial_value",
    "transform",
    "loss_func",
)
class DimensionalityEstimator(BaseEstimator):
    """Local fractal dimension and log density, jointly.

    Takes the arguments of ``mellon_tpu.DimensionalityEstimator``, plus
    ``device`` (default ``"cuda"``) and ``dtype`` (default
    ``torch.float32``), and ``precision`` (``"bf16"``: the two-phase
    L-BFGS MAP).  ``optimizer`` is L-BFGS-B (the default), adam, advi or
    nuts, which samples the flattened (2, k) latents from the L-BFGS MAP
    (``posterior_samples`` is (chains, draws, 2, k)); smc raises, as in
    the JAX package, since it samples 1-d latents only.  ``jit`` is
    accepted and ignored.
    """

    def __init__(
        self,
        cov_func_curry=DEFAULT_COV_FUNC,
        n_landmarks=None,
        rank=None,
        gp_type=None,
        jitter=DEFAULT_JITTER,
        optimizer=DEFAULT_OPTIMIZER,
        n_iter=DEFAULT_N_ITER,
        init_learn_rate=DEFAULT_INIT_LEARN_RATE,
        landmarks=None,
        k=10,
        distances=None,
        d=None,
        mu_dim=0,
        mu_dens=None,
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
            gp_type=gp_type,
            jitter=jitter,
            optimizer=optimizer,
            n_iter=n_iter,
            init_learn_rate=init_learn_rate,
            landmarks=landmarks,
            nn_distances=None,
            d=d,
            mu=mu_dens,
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
        self.k = validate_positive_int(k, "k")
        self.mu_dim = validate_float(mu_dim, "mu_dim")
        self.mu_dens = validate_float(mu_dens, "mu_dens", optional=True)
        self.distances = validate_array(
            distances, "distances", optional=True, dtype=self.dtype, device=self.device
        )
        self.transform = None
        self.loss_func = None
        self.opt_state = None
        self.losses = None
        self.pre_transformation = None
        self.pre_transformation_std = None
        self.local_dim_x = None
        self.log_density_x = None
        self.local_dim_func = None
        self.log_density_func = None

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"\n    cov_func={self.cov_func},"
            f"\n    d={object_str(self.d, ['cells'])},"
            f"\n    device={self.device}, dtype={self.dtype},"
            f"\n    gp_type={self.gp_type},"
            f"\n    k={self.k},"
            f"\n    L={object_str(self.L, ['cells', 'ranks'])},"
            f"\n    landmarks={object_str(self.landmarks, ['landmarks', 'dims'])},"
            f"\n    ls={self.ls},"
            f"\n    mu_dens={self.mu_dens},"
            f"\n    mu_dim={self.mu_dim},"
            f"\n    n_landmarks={self.n_landmarks},"
            f"\n    optimizer={self.optimizer},"
            f"\n    rank={self.rank},"
            "\n)"
        )

    def _repr_html_(self):
        status = (
            "<p style='color:green;'><strong>Predictors:</strong> Available</p>"
            if self.local_dim_func and self.log_density_func
            else "<p style='color:red;'><strong>Predictors:</strong> Not Yet Computed</p>"
        )
        return (
            f"<h2>Dimensionality Estimator: {self.__class__.__name__}</h2>"
            "<p><em>A non-parametric method for estimating local dimensionality "
            "and density using Gaussian Processes.</em></p><ul>"
            f"<li><strong>Covariance Function:</strong> {object_html(self.cov_func or 'Not Set')}</li>"
            f"<li><strong>Optimizer:</strong> {object_html(self.optimizer)}</li>"
            f"<li><strong>Number of Landmarks:</strong> {object_html(self.n_landmarks or 'Not Set')}</li>"
            f"<li><strong>Gaussian Process Type:</strong> {object_html(self.gp_type or 'Not Set')}</li>"
            f"<li><strong>k (nearest neighbors):</strong> {object_html(self.k)}</li>"
            "</ul>" + status
        )

    def _compute_mu_dens(self):
        return compute_mu(self.nn_distances, self.d)

    def _compute_d(self):
        return local_dimensionality(self.x)

    def _compute_initial_value(self):
        return compute_initial_dimensionalities(
            self.x, self.mu_dim, self.mu_dens, self.L, self.nn_distances, self.d
        )

    def _compute_transform(self):
        return compute_dimensionality_transform(self.mu_dim, self.mu_dens, self.L)

    def _compute_distances(self):
        logger.info("Computing distances.")
        seed = self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED
        return compute_distances(self.x, k=self.k, seed=seed)

    def _compute_nn_distances(self):
        return self.distances[:, 0]

    def _compute_loss_func(self):
        # the flattened forms the optimizers and the Laplace step take
        args = (self.L, self.distances, self.mu_dim, self.mu_dens)
        self._loss_args = args
        self._make_value_and_grad = make_dimensionality_value_and_grad
        self._value_and_grad = make_dimensionality_value_and_grad(*args)
        self._loss_batch = make_dimensionality_loss_batch(*args)
        self._hessian_diagonal = lambda z: dimensionality_hessian_diagonal(z, *args)
        self._sampler_potential = lambda z0: zero_centered_dimensionality_potential(z0, *args)[0]
        self._sampler_hessian = lambda z: dimensionality_hessian(z, *args)
        return compute_dimensionality_loss_func(
            self.distances, self.transform, self.initial_value.shape[0]
        )

    def _set_local_dim_x(self):
        self.local_dim_x, self.log_density_x = compute_log_density_x(
            self.pre_transformation, self.transform
        )

    def _row_std(self, row):
        std = self.pre_transformation_std
        return None if std is None else std[row]

    def _set_local_dim_func(self):
        logger.info("Computing predictive dimensionality function.")
        self.local_dim_func = compute_conditional_explog(
            self.x,
            self.landmarks,
            self.pre_transformation[0],
            self._row_std(0),
            self.local_dim_x,
            self.mu_dim,
            self.cov_func,
            self.L,
            self.Lp,
            sigma=None,
            jitter=self.jitter,
            y_is_mean=True,
            with_uncertainty=self.predictor_with_uncertainty,
        )

    def _set_log_density_func(self):
        logger.info("Computing predictive density function.")
        self.log_density_func = compute_conditional(
            self.x,
            self.landmarks,
            self.pre_transformation[1],
            self._row_std(1),
            self.log_density_x,
            self.mu_dens,
            self.cov_func,
            self.L,
            self.Lp,
            sigma=None,
            jitter=self.jitter,
            y_is_mean=True,
            with_uncertainty=self.predictor_with_uncertainty,
        )

    def prepare_inference(self, x):
        """Set every attribute the optimization needs; returns
        ``(loss_func, initial_value)``."""
        self.set_x(x)
        for attribute in ("n_landmarks", "rank", "gp_type"):
            self._prepare_attribute(attribute)
        self.validate_parameter()
        for attribute in PREPARED_ATTRIBUTES:
            self._prepare_attribute(attribute)
        return self.loss_func, self.initial_value

    def run_inference(self, loss_func=None, initial_value=None, optimizer=None):
        """Fit the latents; returns ``pre_transformation`` (2, k).  A
        ``loss_func`` given here is kept as the attribute; the optimizers
        run the estimator's own loss, as in the JAX package."""
        if loss_func is not None:
            self.loss_func = loss_func
        if initial_value is not None:
            self.initial_value = validate_array(
                initial_value, "initial_value", dtype=self.dtype, device=self.device
            )
        if optimizer is not None:
            self.optimizer = optimizer
        self._run_inference()
        return self.pre_transformation

    def process_inference(self, pre_transformation=None, build_predict=True):
        """The local dimensions and log densities at the training points
        and, optionally, both predictors."""
        if pre_transformation is not None:
            self.pre_transformation = validate_array(
                pre_transformation, "pre_transformation", dtype=self.dtype, device=self.device
            )
        self._set_local_dim_x()
        if build_predict:
            self._set_local_dim_func()
            self._set_log_density_func()
        return self.local_dim_x, self.log_density_x

    def fit(self, x=None, build_predict=True):
        self.prepare_inference(x)
        self.run_inference()
        self.process_inference(build_predict=build_predict)
        return self

    @property
    def predict_density(self):
        """The log-density predictor, built at first use."""
        if self.log_density_func is None:
            self._set_log_density_func()
        return self.log_density_func

    @property
    def predict(self):
        """The local-dimension (exp-mean) predictor, built at first use."""
        if self.local_dim_func is None:
            self._set_local_dim_func()
        return self.local_dim_func

    def fit_predict(self, x=None, build_predict=False):
        """Train and return the local dimensions at the training points."""
        self.fit(x, build_predict=build_predict)
        return self.local_dim_x
