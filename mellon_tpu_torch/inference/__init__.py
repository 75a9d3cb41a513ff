"""Losses, optimizers, the Laplace approximation and ADVI, conditional
predictors, derivatives and the density model's posterior samplers: the
names of ``mellon_tpu.inference``."""

from .likelihoods import nearest_neighbors_likelihood, normal_prior, poisson_likelihood
from .losses import (
    compute_dimensionality_loss_func,
    compute_dimensionality_transform,
    compute_log_density_x,
    compute_loss_func,
    compute_parameter_cov_factor,
    compute_transform,
)
from .optimizers import (
    DEFAULT_INIT_LEARN_RATE,
    DEFAULT_JIT,
    DEFAULT_N_ITER,
    DEFAULT_OPTIMIZER,
    minimize_adam,
    minimize_lbfgs,
    minimize_lbfgsb,
)
from .advi import DEFAULT_NUM_SAMPLES, run_advi
from .laplace import compute_laplace_std, hessian_diagonal
from .factories import (
    compute_conditional,
    compute_conditional_explog,
    compute_conditional_times,
)
from .conditionals import (
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
from .predictors import ExpPredictor, Predictor, PredictorTime
from .derivatives import derivative, gradient, hessian, hessian_log_determinant
from .mcmc import MCMCResult, resume_mcmc, run_mcmc, sample_density_posterior
from .samplers import hmc_kernel, nuts_kernel
from .smc import SMCResult, run_smc, smc_density_posterior
from .diagnostics import effective_sample_size, split_rhat, summarize
