"""Diagonal Laplace approximation of the posterior standard deviations
(counterpart of ``mellon_tpu/inference/laplace.py``).

The JAX package extracts the Hessian diagonal of any loss at the MAP with
chunked Hessian-vector products; the estimator hands this module the
diagonal itself (for the density loss in closed form:
:func:`.losses.density_hessian_diagonal`).
"""

import logging

import torch

logger = logging.getLogger("mellon_tpu_torch")

# curvature floor: a flat direction gets std 1e4 instead of infinity
MIN_CURVATURE = 1e-8


def compute_laplace_std(hessian_diagonal):
    """Posterior std = 1/√max(diag Hessian, 1e-8)."""
    h_diag = torch.clamp_min(hessian_diagonal, MIN_CURVATURE)
    stds = 1.0 / torch.sqrt(h_diag)
    if logger.isEnabledFor(logging.INFO):
        lo_h, hi_h, lo_s, hi_s = torch.stack(
            [h_diag.min(), h_diag.max(), stds.min(), stds.max()]
        ).tolist()
        logger.info(
            "Laplace approximation: Hessian diagonal range [%.3e, %.3e], "
            "std range [%.3e, %.3e].",
            lo_h, hi_h, lo_s, hi_s,
        )
    return stds
