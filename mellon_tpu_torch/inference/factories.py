"""Predictor factory (counterpart of ``mellon_tpu/inference/factories.py``):
the sparse-Cholesky branch of ``compute_conditional``."""

import logging

import torch

from ..utils.util import DEFAULT_JITTER, ensure_2d
from .conditionals import LandmarksConditionalCholesky

logger = logging.getLogger("mellon_tpu_torch")


def _check_sigma_std_conflict(pre_transformation_std, sigma):
    if (
        pre_transformation_std is not None
        and sigma is not None
        and bool(torch.any(torch.as_tensor(sigma) > 0))
    ):
        raise ValueError(
            "One can specify either `sigma` or `pre_transformation_std` "
            "to describe uncertainty, but not both."
        )


def compute_conditional(
    x,
    landmarks,
    pre_transformation,
    pre_transformation_std,
    y,
    mu,
    cov_func,
    L,
    Lp=None,
    sigma=0,
    jitter=DEFAULT_JITTER,
    y_is_mean=False,
    with_uncertainty=False,
    obs_variance=False,
):
    """The predictor of a landmark-latent fit (one latent per landmark),
    with the JAX package's signature.  ``y`` and ``L`` serve the full and
    Nyström conditionals, which come with ROADMAP Queue 1, items 12-13; the
    latents' std, where given, is the predictor's ``sigma``."""
    if (
        landmarks is None
        or pre_transformation is None
        or pre_transformation.shape[0] != landmarks.shape[0]
    ):
        raise NotImplementedError(
            "Only the sparse-Cholesky conditional (one latent per landmark) is "
            "ported to mellon_tpu_torch (ROADMAP Queue 1, items 12-13 bring "
            "the full and Nyström conditionals)."
        )
    logger.debug("Using LandmarksConditionalCholesky GP.")
    _check_sigma_std_conflict(pre_transformation_std, sigma)
    if pre_transformation_std is not None:
        sigma = pre_transformation_std
    return LandmarksConditionalCholesky(
        ensure_2d(landmarks),
        pre_transformation,
        mu,
        cov_func,
        x.shape[0],
        Lp,
        sigma=sigma,
        jitter=jitter,
        y_is_mean=y_is_mean,
        with_uncertainty=with_uncertainty,
        obs_variance=obs_variance,
    )
