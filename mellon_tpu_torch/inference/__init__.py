"""Losses, optimizers, conditional predictors and the density model's
posterior samplers."""

from .diagnostics import effective_sample_size, split_rhat, summarize
from .mcmc import MCMCResult, resume_mcmc, run_mcmc, sample_density_posterior
from .samplers import hmc_kernel, nuts_kernel
from .smc import SMCResult, run_smc, smc_density_posterior

__all__ = [
    "MCMCResult",
    "SMCResult",
    "effective_sample_size",
    "hmc_kernel",
    "nuts_kernel",
    "resume_mcmc",
    "run_mcmc",
    "run_smc",
    "sample_density_posterior",
    "smc_density_posterior",
    "split_rhat",
    "summarize",
]
