"""Predictor factories (counterpart of ``mellon_tpu/inference/factories.py``):
the conditional family from the model's configuration.

* no landmarks: :class:`.FullConditional`, conditioned on y at every cell;
* one latent per landmark: :class:`.LandmarksConditionalCholesky`;
* otherwise: :class:`.LandmarksConditional`, conditioned on y through the
  landmarks (the FunctionEstimator's sparse path).

``compute_conditional_explog`` builds the exp-mean forms for the
dimensionality model, ``compute_conditional_times`` the time-aware ones
for the time-sensitive density model.
"""

import logging

import torch

from ..utils.util import DEFAULT_JITTER, ensure_2d
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
from .losses import compute_parameter_cov_factor

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


def _y_cov_factor(with_uncertainty, pre_transformation_std, L):
    if with_uncertainty and pre_transformation_std is not None:
        return compute_parameter_cov_factor(pre_transformation_std, L)
    return None


def _conditional(
    classes, x, landmarks, pre_transformation, pre_transformation_std, y, mu, cov_func,
    L, Lp, sigma, jitter, y_is_mean, with_uncertainty, obs_variance=False, logscale=False,
):
    full, cholesky, sparse = classes
    if landmarks is None:
        logger.debug("Using FullConditional GP.")
        return full(
            x,
            torch.log(y) if logscale else y,
            mu,
            cov_func,
            Lp,
            sigma=sigma,
            jitter=jitter,
            y_cov_factor=_y_cov_factor(with_uncertainty, pre_transformation_std, L),
            y_is_mean=y_is_mean,
            with_uncertainty=with_uncertainty,
            obs_variance=obs_variance,
        )
    landmarks = ensure_2d(landmarks)
    if pre_transformation is not None and pre_transformation.shape[0] == landmarks.shape[0]:
        logger.debug("Using LandmarksConditionalCholesky GP.")
        _check_sigma_std_conflict(pre_transformation_std, sigma)
        if pre_transformation_std is not None:
            sigma = pre_transformation_std
        return cholesky(
            landmarks,
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
            obs_x=x if obs_variance else None,
            obs_y=y if obs_variance else None,
        )
    logger.debug("Using LandmarksConditional GP.")
    return sparse(
        x,
        landmarks,
        torch.log(y) if logscale else y,
        mu,
        cov_func,
        L,
        # the landmark Cholesky, so the conditional skips its own
        Lp=Lp,
        sigma=sigma,
        jitter=jitter,
        y_cov_factor=_y_cov_factor(with_uncertainty, pre_transformation_std, L),
        y_is_mean=y_is_mean,
        with_uncertainty=with_uncertainty,
        obs_variance=obs_variance,
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
    """The conditional-mean predictor of a fit, with the JAX package's
    signature: the full conditional without landmarks, the
    landmarks-Cholesky one where the latents live on the landmarks (their
    std, where given, is its ``sigma``), the landmarks conditional
    otherwise."""
    return _conditional(
        (FullConditional, LandmarksConditionalCholesky, LandmarksConditional),
        x, landmarks, pre_transformation, pre_transformation_std, y, mu, cov_func,
        L, Lp, sigma, jitter, y_is_mean, with_uncertainty, obs_variance,
    )


def compute_conditional_explog(
    x,
    landmarks,
    pre_transformation,
    pre_transformation_std,
    y,
    mu,
    cov_func,
    L,
    Lp,
    sigma=0,
    jitter=DEFAULT_JITTER,
    y_is_mean=False,
    with_uncertainty=False,
):
    """The exp-mean predictor of the dimensionality GP: as
    :func:`compute_conditional`, with y (the local dimensions) conditioned
    on as log y and the mean returned as exp."""
    return _conditional(
        (ExpFullConditional, ExpLandmarksConditionalCholesky, ExpLandmarksConditional),
        x, landmarks, pre_transformation, pre_transformation_std, y, mu, cov_func,
        L, Lp, sigma, jitter, y_is_mean, with_uncertainty, logscale=True,
    )


def compute_conditional_times(
    x,
    landmarks,
    pre_transformation,
    pre_transformation_std,
    y,
    mu,
    cov_func,
    L,
    Lp,
    sigma=0,
    jitter=DEFAULT_JITTER,
    y_is_mean=False,
    with_uncertainty=False,
):
    """The time-aware predictor of a time-sensitive fit (x's last column
    is time), chosen as in :func:`compute_conditional`."""
    return _conditional(
        (FullConditionalTime, LandmarksConditionalCholeskyTime, LandmarksConditionalTime),
        x, landmarks, pre_transformation, pre_transformation_std, y, mu, cov_func,
        L, Lp, sigma, jitter, y_is_mean, with_uncertainty,
    )
