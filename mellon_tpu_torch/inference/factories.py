"""Predictor factory (counterpart of ``mellon_tpu/inference/factories.py``):
the sparse-Cholesky branch of ``compute_conditional``."""

import logging

from ..utils.util import DEFAULT_JITTER, ensure_2d
from .conditionals import LandmarksConditionalCholesky

logger = logging.getLogger("mellon_tpu_torch")


def compute_conditional(x, landmarks, pre_transformation, mu, cov_func, Lp=None, jitter=DEFAULT_JITTER):
    """The conditional-mean predictor of a landmark-latent fit (latents
    one per landmark).  The other conditionals (full GP, Nyström) come
    with ROADMAP Queue 1, items 11-13."""
    if landmarks is None or pre_transformation.shape[0] != landmarks.shape[0]:
        raise NotImplementedError(
            "Only the sparse-Cholesky conditional (one latent per landmark) is "
            "ported to mellon_tpu_torch (ROADMAP Queue 1, items 11-13 bring "
            "the full and Nyström conditionals)."
        )
    logger.debug("Using LandmarksConditionalCholesky GP.")
    return LandmarksConditionalCholesky(
        ensure_2d(landmarks), pre_transformation, mu, cov_func, x.shape[0], Lp, jitter=jitter
    )
