"""Automatic time length scale (counterpart of ``mellon_tpu/models/ls_time.py``).

One density model per time point, the correlations of their log densities
across time points, and the time kernel's length scale fit to match those
correlations (L-BFGS on the log length scale).

In the default configuration every per-time model is a full GP (a time
point holds fewer cells than the 5,000 default landmarks), so the T fits
run as one batched, masked problem: the groups padded to a common width,
their kernels factored as one batch (``torch.linalg.cholesky_ex``) and one
joint L-BFGS over the stacked whitened latents.  The per-group losses are
independent and a padded latent has zero gradient at its zero start, so
the joint optimum is each group's own.  Any configuration the batch cannot
express exactly (:func:`_batched_ls_time_densities` returns None) takes
the per-time loop of :class:`~mellon_tpu_torch.DensityEstimator` fits.

Where a group's float32 kernel does not factor even after the jitter
escalation, its kernel is built again in float64 from its cells (on the
card through the Matern-5/2 kernel's float64 entry), factored in float64,
and that group's prediction solves and multiplies in float64, on the
device; the JAX package does this on the host and with a double-single
product.
"""

import copy
import logging
import math

import torch

from ..inference.optimizers import minimize_lbfgs
from ..ops.kernels import Exponential, ExpQuad, Linear, Matern32, Matern52
from ..ops.linalg import _cholesky_f64_rescue
from ..utils.util import DEFAULT_JITTER, mle
from ..utils.validation import validate_time_x

logger = logging.getLogger("mellon_tpu_torch")

# above this per-time cell count the batched fit's (T, n_pad, n_pad)
# kernel stack outgrows its value; the per-time loop takes over
BATCH_GROUP_CAP = 4096
# keys of density_estimator_kwargs the batched fits honor
_BATCHABLE_KEYS = {
    "cov_func_curry",
    "d_method",
    "d",
    "optimizer",
    "ls",
    "ls_factor",
    "jit",
    "mu",
    "jitter",
}
# the kernels whose one parameter is the length scale: the JAX package
# batches exactly these (a kernel whose operand spec has one parameter)
_SINGLE_LENGTH_SCALE_CORES = (Matern32, Matern52, ExpQuad, Exponential, Linear)
JITTER_TRIES = 3
# exp's linear continuation starts here
SAFE_EXP_MAX = 60.0


def _masked_quantile_01(values, mask, n_real):
    """Per row of ``values`` (T, n_pad), the 1% quantile (linear
    interpolation) of its first ``n_real`` entries (those where ``mask``
    is set): ``torch.quantile(values[mask], 0.01)`` for every row."""
    srt = torch.sort(torch.where(mask > 0, values, torch.inf), dim=1).values
    n_pad = srt.shape[1]
    pos = 0.01 * (n_real - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, n_pad - 1)
    hi = torch.clamp(lo + 1, 0, n_pad - 1)
    w = pos - lo
    v_lo = srt.gather(1, lo[:, None])[:, 0]
    v_hi = torch.where(hi < n_real, srt.gather(1, hi[:, None])[:, 0], v_lo)
    return v_lo * (1.0 - w) + v_hi * w


def _safe_exp(x):
    """``(exp(x), its derivative)`` with a linear continuation above
    :data:`SAFE_EXP_MAX`: finite and still increasing, so an overflowing
    line-search trial stays repelling (a large finite loss and gradient)
    instead of giving inf − inf = NaN.  The fit itself never reaches it
    (e^60 ~ 1e26)."""
    big = x > SAFE_EXP_MAX
    e_max = math.exp(SAFE_EXP_MAX)
    value = torch.where(big, e_max * (1.0 + (x - SAFE_EXP_MAX)), torch.exp(torch.where(big, SAFE_EXP_MAX, x)))
    slope = torch.where(big, e_max, value)
    return value, slope


def _batched_density_value_and_grad(zflat, L_stack, nng, mask, mu_t, d):
    """Loss and gradient of the sum of the T masked whitened density
    losses (the math of ``inference.losses.density_loss`` per group).  A
    padded cell adds no likelihood term (a ``where``, not a product, so
    that an overflowing trial gives no 0·inf) and only its prior term,
    whose gradient is zero at the zero start."""
    T, n_pad, _ = L_stack.shape
    Z = zflat.reshape(T, n_pad)
    F = torch.bmm(L_stack, Z[:, :, None])[:, :, 0] + mu_t[:, None]
    d = torch.as_tensor(d, dtype=Z.dtype, device=Z.device)
    const = d * math.log(math.pi) / 2 - torch.lgamma(d / 2 + 1)
    log_nn = torch.log(nng)
    A, dA = _safe_exp(F + log_nn * d + const)
    B = F + torch.log(d) + (d - 1) * log_nn + const
    real = mask > 0
    loglik = torch.sum(torch.where(real, B - A, 0.0))
    prior = -0.5 * torch.sum(Z * Z) - (Z.numel() / 2) * math.log(2 * math.pi)
    dF = torch.where(real, dA - 1.0, 0.0)
    grad = torch.bmm(L_stack.mT, dF[:, :, None])[:, :, 0] + Z
    return -(prior + loglik), grad.reshape(-1)


def _single_length_scale_template(cov_func_curry):
    """``cov_func_curry(ls=1.0)`` where it is a kernel whose one parameter
    is its length scale, else None."""
    try:
        template = cov_func_curry(ls=1.0)
    except (NotImplementedError, TypeError):
        return None
    return template if isinstance(template, _SINGLE_LENGTH_SCALE_CORES) else None


def _at_length_scale(template, ls):
    kernel = copy.copy(template)
    kernel.ls = ls
    return kernel


def _factor(K_stack, jitters):
    """Cholesky factors of K + jitter·I, one jitter per matrix, and
    whether each failed."""
    A = K_stack.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(jitters[:, None])
    L, info = torch.linalg.cholesky_ex(A)
    return L, (info > 0) | ~torch.isfinite(L).all(dim=2).all(dim=1)


def _ridge(L_stack, mask, target):
    """The masked ridge warm start per group: (LᵀWL + I) z = LᵀW target;
    a group whose normal equations do not factor starts at zero."""
    Lw = L_stack * mask[:, :, None]
    G = Lw.mT @ Lw
    G.diagonal(dim1=-2, dim2=-1).add_(1.0)
    c, info = torch.linalg.cholesky_ex(G)
    rhs = (Lw.mT @ (target * mask)[:, :, None])
    z = torch.linalg.solve_triangular(c.mT, torch.linalg.solve_triangular(c, rhs, upper=False), upper=True)
    z = torch.where((info > 0)[:, None, None], torch.nan, z)[:, :, 0]
    return torch.where(torch.isfinite(z), z, 0.0)


def _padded_groups(x, nn_distances, unique_times):
    """The states and 1-NN distances of each time point, padded to the
    largest group: xg (T, n_pad, d), nng (T, n_pad), mask (T, n_pad), the
    group sizes (a list) and the mask of invalid distances (T, n_pad)."""
    times = x[:, -1]
    group = torch.searchsorted(unique_times, times.contiguous())
    T = unique_times.shape[0]
    counts = torch.bincount(group, minlength=T)
    order = torch.argsort(group, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    g_sorted = group[order]
    slot = torch.arange(x.shape[0], device=x.device) - starts[g_sorted]
    sizes = counts.tolist()
    n_pad = max(sizes)
    xg = x.new_zeros((T, n_pad, x.shape[1] - 1))
    xg[g_sorted, slot] = x[order, :-1]
    nng = x.new_ones((T, n_pad))
    nng[g_sorted, slot] = nn_distances[order].to(x.dtype)
    mask = x.new_zeros((T, n_pad))
    mask[g_sorted, slot] = 1.0
    invalid = (mask > 0) & (~torch.isfinite(nng) | (nng <= 0))
    return xg, nng, mask, sizes, invalid


def _batched_ls_time_densities(x, nn_distances, cov_func_curry, kw, unique_times, warn_below):
    """The T per-time log densities at every cell, (T, n), from one
    batched masked full-GP fit; None where the configuration needs the
    per-time loop."""
    if set(kw) - _BATCHABLE_KEYS:
        return None
    if kw.get("optimizer") not in (None, "L-BFGS-B"):
        return None
    d_method, d_given = kw.get("d_method"), kw.get("d")
    if d_method == "fractal":
        return None  # the per-group fractal d needs the loop
    if d_method == "manual" and d_given is None:
        return None  # the per-time estimator raises its documented error
    template = _single_length_scale_template(cov_func_curry)
    if template is None:
        return None
    xg, nng, mask, sizes, invalid = _padded_groups(x, nn_distances, unique_times)
    if max(sizes) > BATCH_GROUP_CAP or min(sizes) < 2:
        return None
    states = x[:, :-1]
    d = float(d_given) if d_given is not None else float(states.shape[1])
    if d > 50:
        return None  # the per-time estimator raises the documented error
    jitter_kw = kw.get("jitter")
    if jitter_kw is not None and not (isinstance(jitter_kw, (int, float)) and jitter_kw > 0):
        return None  # the per-time estimator raises its validation error
    jitter = float(jitter_kw) if jitter_kw is not None else DEFAULT_JITTER

    T, n_pad = mask.shape
    ut = unique_times.tolist()
    logger.info(
        f"Batched ls_time fits: {T} time points padded to {n_pad:,} cells "
        "run as one masked FULL-GP program (joint L-BFGS over all groups)."
    )
    for t, n_cells in zip(ut, sizes):
        if n_cells < warn_below:
            logger.warning(
                f"Time point {t} only has {n_cells:,} cells. "
                "This could lead to inaccurate estimation of the time "
                "length scale `ls_time`."
            )
    n_invalid = invalid.sum(dim=1).tolist()
    if any(bad == size for bad, size in zip(n_invalid, sizes)):
        return None  # the per-time loop raises the documented error
    for t, bad in zip(ut, n_invalid):
        if bad:
            logger.warning(
                f"Repairing {bad:,} invalid nn_distances in time group {t} "
                "(set to the minimum positive value found)."
            )
    if any(n_invalid):
        smallest = torch.where(invalid | (mask == 0), torch.inf, nng).min(dim=1).values
        nng = torch.where(invalid, smallest[:, None], nng)

    n_t = torch.tensor(sizes, dtype=x.dtype, device=x.device)
    mle_g = mle(nng, d)
    if kw.get("mu") is not None:
        mu_t = torch.full((T,), float(kw["mu"]), dtype=x.dtype, device=x.device)
    else:
        mu_t = _masked_quantile_01(mle_g, mask, n_t) - 10.0
    if kw.get("ls") is not None:
        ls_t = [float(kw["ls"])] * T
    else:
        ls_factor = float(kw["ls_factor"]) if kw.get("ls_factor") is not None else 1.0
        log_mean = torch.sum(torch.log(nng) * mask, dim=1) / n_t
        ls_t = (torch.exp(log_mean + 3.0) * ls_factor).tolist()
    kernels = [_at_length_scale(template, ls) for ls in ls_t]

    # one kernel call per group: K on the group's cells, identity on the
    # padding
    K_stack = torch.stack([kernels[g](xg[g], xg[g]) for g in range(T)])
    K_stack = K_stack * (mask[:, :, None] * mask[:, None, :])
    K_stack.diagonal(dim1=-2, dim2=-1).add_(1.0 - mask)

    # the rescue ladder of safe_cholesky, batched: per-group jitter
    # escalation, then float64 for the groups still singular
    jitters = torch.full((T,), jitter, dtype=x.dtype, device=x.device)
    L_stack, bad = _factor(K_stack, jitters)
    bad_idx = torch.nonzero(bad).flatten().tolist()
    tries = 0
    while bad_idx and tries < JITTER_TRIES:
        tries += 1
        jitters[bad_idx] *= 10
        logger.warning(
            f"Batched Cholesky failed for {len(bad_idx)} time group(s); "
            f"retrying with escalated jitter (try {tries})."
        )
        L_retry, still = _factor(K_stack[bad_idx], jitters[bad_idx])
        L_stack[bad_idx] = L_retry
        bad_idx = [g for g, s in zip(bad_idx, still.tolist()) if s]
    rescued = {}
    if bad_idx:
        logger.warning(
            f"Batched Cholesky failed for {len(bad_idx)} time group(s) after "
            "jitter escalation; factorizing those groups in float64 on the device."
        )
        for g in bad_idx:
            k = sizes[g]
            K64 = torch.eye(n_pad, dtype=torch.float64, device=x.device)
            cells = xg[g, :k].double()
            K64[:k, :k] = kernels[g](cells, cells)
            L64 = _cholesky_f64_rescue(K64, jitter)
            if L64 is None:
                return None  # not factorizable: the exact loop decides
            rescued[g] = L64
            L_stack[g] = L64.to(x.dtype)

    z0 = _ridge(L_stack, mask, mle_g - mu_t[:, None])
    loss_args = (L_stack, nng, mask, mu_t, d)

    def value_and_grad(z):
        return _batched_density_value_and_grad(z, *loss_args)

    res = minimize_lbfgs(value_and_grad, z0.reshape(-1))
    if not math.isfinite(res.loss):
        logger.warning(
            "Batched ls_time L-BFGS diverged (non-finite loss); "
            "retrying from the zero initialization."
        )
        res = minimize_lbfgs(value_and_grad, torch.zeros_like(z0.reshape(-1)))
        if not math.isfinite(res.loss):
            logger.warning(
                "Batched ls_time fit is non-finite after the zero-init "
                "retry; falling back to the exact per-time loop."
            )
            return None
    Z = res.pre_transformation.reshape(T, n_pad)

    rows = []
    for g in range(T):
        if g in rescued:
            # an ill-conditioned factor amplifies rounding by ~cond(L) in
            # w = L⁻ᵀz and K_s w: both in float64
            w = torch.linalg.solve_triangular(rescued[g].mT, Z[g, :, None].double(), upper=True)
            Ks = kernels[g](states.double(), xg[g].double())
            rows.append((mu_t[g].double() + (Ks @ w)[:, 0]).to(x.dtype))
        else:
            w = torch.linalg.solve_triangular(L_stack[g].mT, Z[g, :, None], upper=True)
            rows.append(mu_t[g] + (kernels[g](states, xg[g]) @ w)[:, 0])
    if rescued:
        logger.info("Float64 predict for %d rescued time group(s).", len(rescued))
    dens = torch.stack(rows)
    if not bool(torch.isfinite(dens).all()):
        logger.warning(
            "Batched ls_time densities are non-finite; falling back to "
            "the exact per-time loop."
        )
        return None
    return dens


def _ls_loss_value_and_grad(cov_func_curry, delta_t, corrs):
    """``log_ls -> (‖k(Δt; e^log_ls) − corrs‖, gradient)``.  The length
    scale enters as a scaling of the time differences of a unit-length
    kernel, k(Δt; ℓ) = k(Δt/ℓ; 1) for the radial kernels, so that the
    gradient flows through the kernel call's inputs."""
    unit = cov_func_curry(1.0)
    n = corrs.shape[0]
    origin = delta_t.new_zeros((1, 1))

    def value_and_grad(log_ls):
        log_ls = log_ls.detach().requires_grad_(True)
        with torch.enable_grad():
            covs = unit(delta_t / torch.exp(log_ls), origin).reshape(n, n)
            loss = torch.linalg.norm(covs - corrs)
            (grad,) = torch.autograd.grad(loss, log_ls)
        return loss.detach(), grad

    return value_and_grad


def compute_ls_time(
    nn_distances,
    x,
    cov_func_curry,
    times=None,
    warn_below=500,
    return_data=False,
    density_estimator_kwargs=None,
):
    """The time length scale ls_time from the correlations of per-time
    density fits: x (n, d + 1) with time last (or ``times``).  Returns
    ls_time, or with ``return_data`` ``(ls_time, densities (T, n), the
    per-time estimators, the unique times)``, which takes the per-time
    loop."""
    from .density import DensityEstimator

    kw = dict(density_estimator_kwargs or {})
    x = validate_time_x(x, times)
    times = x[:, -1]
    states = x[:, :-1]
    unique_times = torch.unique(times)
    n_times = unique_times.shape[0]

    densities = None
    if not return_data:
        densities = _batched_ls_time_densities(
            x, nn_distances, cov_func_curry, kw, unique_times, warn_below
        )
    predictors = []
    if densities is None:
        per_time = []
        loop_kw = {"device": x.device, "dtype": x.dtype, **kw}
        for i, time in enumerate(unique_times.tolist()):
            mask = times == time
            n_cells = int(mask.sum())
            logger.info(
                f"[{i + 1} of {n_times}] Computing density for {n_cells:,} "
                f"cells at time point {time}."
            )
            if n_cells < warn_below:
                logger.warning(
                    f"Time point {time} only has {n_cells:,} cells. "
                    "This could lead to inaccurate estimation of the time "
                    "length scale `ls_time`."
                )
            est = DensityEstimator(nn_distances=nn_distances[mask], **loop_kw)
            est.fit(states[mask])
            per_time.append(est.predict(states))
            predictors.append(est)
        densities = torch.stack(per_time)

    corrs = torch.corrcoef(densities)
    delta_t = torch.abs(unique_times[:, None] - unique_times[None, :]).reshape(-1, 1)
    fun = _ls_loss_value_and_grad(cov_func_curry, delta_t.to(corrs.dtype), corrs)
    opt = minimize_lbfgs(fun, corrs.new_zeros(1))
    ls = float(torch.exp(opt.pre_transformation[0]))
    if return_data:
        return ls, densities, predictors, unique_times
    return ls
