"""Conditional-GP predictors (counterpart of
``mellon_tpu/inference/conditionals.py``): three ways to condition, each as
a plain predictor, as an exp-mean one (the dimensionality model's) and as
a time-aware one (``*Time``: the time-sensitive density model's, whose
last input column is time).

* :class:`FullConditional`: exact conditioning on every training point
  (the full GP type, and the FunctionEstimator without landmarks);
* :class:`LandmarksConditional`: conditioning through inducing points
  with the σ-weighted sparse solve (the FunctionEstimator's sparse path);
* :class:`LandmarksConditionalCholesky`: latents on the landmarks,
  weights = L⁻ᵀ z (the density models' sparse path).

Each gives the mean, the covariance and the covariance of the mean, the
leverage (the hat matrix's diagonal) and the observation variance (HC3
residuals r²/(1 − h)² smoothed by a second GP).  A per-feature σ, (p,) or
(n, p), takes one factorization per feature: those run as batches over
feature chunks of at most :data:`FEATURE_CHUNK_BYTES`.  Every k(·, ·) is
the covariance module's, on the card the hand-written CUDA tile; the
Cholesky factorizations and triangular solves are ``torch.linalg``.

Where the JAX package rescues a float32-singular landmark kernel on the
host in float64 (the conditional weights, the leverage), this module does
the same arithmetic in float64 on the tensors' own device.
"""

import logging

import torch

from ..ops.linalg import (
    DEFAULT_SIGMA,
    _cholesky_f64_rescue,
    _jittered_cholesky,
    safe_cholesky,
    select_stable_landmarks,
)
from ..utils.util import DEFAULT_JITTER, add_variance, ensure_2d, stabilize
from .predictors import ExpPredictor, Predictor, PredictorTime

logger = logging.getLogger("mellon_tpu_torch")

# above this many Kuf elements the float64 rescue of the landmarks
# conditional (the JAX package's HOST_F64_BUDGET) gives way to pruning
F64_RESCUE_BUDGET = 250_000_000
# bytes of the temporaries of one chunk of per-feature factorizations
FEATURE_CHUNK_BYTES = 1 << 31
# the leverage's range check before the float64 rescue, and its ceiling
LEVERAGE_TOL = 1e-3
LEVERAGE_CEILING = 1.0 - 1e-6


def _ndim(a):
    return a.ndim if isinstance(a, torch.Tensor) else 0


def _as_sigma(sigma, like):
    """sigma as given (None or a number) or as a tensor on ``like``'s
    device and dtype."""
    if sigma is None or isinstance(sigma, (int, float)):
        return sigma
    return torch.as_tensor(sigma).to(device=like.device, dtype=like.dtype)


def _solve(A, B, lower=True):
    """A⁻¹B for a triangular A (or a batch of them); B a vector, a matrix
    or a batch of matrices (a batch of vectors has a trailing axis of 1)."""
    if B.ndim == 1:
        return torch.linalg.solve_triangular(A, B.unsqueeze(-1), upper=not lower).squeeze(-1)
    return torch.linalg.solve_triangular(A, B, upper=not lower)


def _cho_solve(L, B):
    """(L Lᵀ)⁻¹ B."""
    return _solve(L.mT, _solve(L, B), lower=False)


def _cholesky(A):
    """Cholesky factor(s) of A; a factor that fails is NaN, as JAX's is."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _plus_diag(K, values):
    """K + diag(values), a new tensor: values a number, (n,) or a batch
    (c, 1) or (c, n), which adds a batch axis."""
    values = torch.as_tensor(values, dtype=K.dtype, device=K.device)
    batch = values.shape[:-1] if values.ndim > 1 else ()
    A = K.expand(*batch, *K.shape).clone()
    A.diagonal(dim1=-2, dim2=-1).add_(values)
    return A


def _noise_factor(K, s2, jitter):
    """Cholesky factor(s) of K + diag(s²) + jitter I, one per row of a
    batched s²."""
    A = _plus_diag(K, s2)
    A.diagonal(dim1=-2, dim2=-1).add_(jitter)
    return _cholesky(A)


def _feature_chunks(p, bytes_per_feature):
    """Slices of at most :data:`FEATURE_CHUNK_BYTES` worth of features."""
    size = max(1, min(p, FEATURE_CHUNK_BYTES // max(1, bytes_per_feature)))
    if size < p:
        logger.info(
            "Solving %d features in chunks of %d (%.0f MB of temporaries each).",
            p, size, size * bytes_per_feature / 1e6,
        )
    return [slice(start, start + size) for start in range(0, p, size)]


def _feature_s2(sigma, sl, jitter, floor):
    """The noise variances of the features ``sl`` of a per-feature σ as a
    batch: (c, 1) for σ of shape (p,), (c, n) for (n, p); floored at
    ``jitter`` where ``floor``."""
    s = sigma[sl][:, None] if sigma.ndim == 1 else sigma[:, sl].T
    s2 = s * s
    return torch.clamp_min(s2, jitter) if floor else s2


def _conditional_mean(cov_func, Xnew, base, weights, mu):
    """mu + k(Xnew, base) @ weights."""
    return mu + cov_func(Xnew, base) @ weights


def _conditional_cov_diag(cov_func, Xnew, base, L):
    """k(x, x) − colsum((L⁻¹·k(base, Xnew))²)."""
    A = _solve(L, cov_func(base, Xnew))
    return cov_func.diag(Xnew) - torch.sum(A * A, dim=0)


def _conditional_cov_diag2(cov_func, Xnew, base, L, Cs):
    """The Nyström residual and the sparse correction: k(x, x) −
    colsum((L⁻¹K)²) + colsum((Cs⁻¹K)²) with K = k(base, Xnew)."""
    Kus = cov_func(base, Xnew)
    A = _solve(L, Kus)
    C = _solve(Cs, Kus)
    return cov_func.diag(Xnew) - torch.sum(A * A, dim=0) + torch.sum(C * C, dim=0)


def _conditional_mean_cov_diag(cov_func, Xnew, base, W):
    """rowsum((k(Xnew, base)·W)²)."""
    cov_L = cov_func(Xnew, base) @ W
    return torch.sum(cov_L * cov_L, dim=1)


# ---------------------------------------------------------------------------
# sigma shapes
# ---------------------------------------------------------------------------


def _is_per_feature_sigma(sigma, y):
    """Whether sigma is per feature: (p,), (1, p) or (n, p) against a 2-d
    y (n, p)."""
    if sigma is None or _ndim(sigma) == 0 or y.ndim != 2:
        return False
    if sigma.ndim == 2 and sigma.shape[0] == 1 and sigma.shape[1] == y.shape[1]:
        return True
    if sigma.ndim == 2 and tuple(sigma.shape) == tuple(y.shape):
        return True
    if sigma.ndim == 1 and sigma.shape[0] == y.shape[1]:
        if sigma.shape[0] == y.shape[0]:
            logger.warning(
                f"sigma length {sigma.shape[0]} matches both n_obs and "
                "n_features. Interpreting as per-feature. Pass sigma with "
                "shape (n, 1) for per-observation."
            )
        return True
    return False


def _normalize_per_feature_sigma(sigma):
    """(1, p) -> (p,)."""
    if _ndim(sigma) == 2 and sigma.shape[0] == 1:
        return sigma[0]
    return sigma


def _check_covariance(obj):
    if not hasattr(obj, "L"):
        raise ValueError(
            "The predictor was computed without covariance. "
            "Recompute setting `with_uncertainty=True.`"
        )


def _check_uncertainty(obj):
    if not hasattr(obj, "W"):
        raise ValueError(
            "The predictor was computed without uncertainty, e.g., using ADVI. "
            "Recompute setting `with_uncertainty=True.` and define "
            "`pre_transformation_std`, e.g., by using `optimizer='advi'`."
        )


def _check_obs_variance(obj):
    if not hasattr(obj, "variance_weights"):
        raise ValueError(
            "The predictor was computed without obs_variance. "
            "Recompute setting `obs_variance=True`."
        )


def _get_L(x, cov_func, jitter=DEFAULT_JITTER, y_cov_factor=None, K=None):
    """Cholesky factor of k(x, x) + the noise; float32 escalates the
    jitter and then factorizes in float64."""
    if K is None:
        K = cov_func(x, x)
    K = add_variance(K, y_cov_factor, jitter=jitter)
    max_tries = 0 if K.dtype == torch.float64 else 3
    # K already carries the noise and jitter on its diagonal
    return safe_cholesky(K, jitter=0.0, max_tries=max_tries)


def _sigma_to_y_cov_factor(sigma, y_cov_factor, n, like):
    """sigma as a left factor of the noise covariance: σI, diag(σ), or,
    for a 2-d σ, an (n, *σ.shape) stack whose i-th slice is zero but for
    its i-th row, σᵢ (the JAX package's vmapped update); on ``like``'s
    device and dtype."""
    if sigma is None and y_cov_factor is None:
        message = (
            "No input uncertainty specified. Make sure to set `sigma` or "
            "`pre_transformation_std`, "
            'e.g., by using `optimizer="advi", to quantify uncertainty '
            "of the prediction."
        )
        logger.error(message)
        raise ValueError(message)
    if y_cov_factor is not None and sigma is not None and bool(torch.any(torch.as_tensor(sigma) > 0)):
        raise ValueError(
            "One can specify either `sigma` or `y_cov_factor` to describe "
            "input noise, but not both."
        )
    if y_cov_factor is not None:
        return y_cov_factor
    if _ndim(sigma) == 2 and tuple(sigma.shape) == (n, 1):
        sigma = sigma.reshape(-1)
    if _ndim(sigma) == 0:
        return torch.eye(n, dtype=like.dtype, device=like.device) * sigma
    if sigma.ndim == 1:
        return torch.diag(sigma)
    factor = sigma.new_zeros((n,) + tuple(sigma.shape))
    rows = torch.arange(n, device=sigma.device)
    factor[rows, rows] = sigma[:n]
    return factor


def _process_sigma(sigma, r, A, jitter=DEFAULT_JITTER):
    """The σ-weighted (r_l, A_l) of the sparse solve for a scalar, an
    element-wise (n,) or (n, 1), or a full (n, n) covariance σ.  σ² is
    floored at ``jitter``, as in the JAX package."""
    if _ndim(sigma) == 2 and tuple(sigma.shape) == (r.shape[0], 1):
        sigma = sigma.reshape(-1)
    if _ndim(sigma) == 0 or (sigma.ndim == 1 and sigma.shape[0] == r.shape[0]):
        logger.info("Sigma interpreted as element-wise standard deviation.")
        if _ndim(sigma) == 0:
            sigma2 = max(float(sigma) ** 2, jitter)
        else:
            sigma2 = torch.clamp_min(sigma * sigma, jitter)
        if _ndim(sigma2) == 1 and r.ndim > 1:
            r_l = r / sigma2[:, None]
        else:
            r_l = r / sigma2
        return r_l, A / sigma2
    if tuple(sigma.shape) == tuple(r.shape) and r.ndim > 1:
        logger.error("Sigma as distinct noise per output is not implemented.")
        raise NotImplementedError("FunctionEstimator not implemented for multiple noises.")
    if tuple(sigma.shape) == (r.shape[0],) + tuple(r.shape) and r.ndim > 1:
        logger.error("Sigma as distinct covariance matrix per output is not implemented.")
        raise NotImplementedError(
            "FunctionEstimator not implemented for multiple covariance matrices."
        )
    if tuple(sigma.shape) == (r.shape[0], r.shape[0]):
        logger.info("Sigma interpreted as full covariance matrix.")
        L_s = _cholesky(stabilize(sigma, jitter))
        # whiten A's observation axis (its columns): A is (m, n)
        return _cho_solve(L_s, r), _cho_solve(L_s, A.T).T
    raise ValueError("Unsupported sigma configuration.")


def _sparse_solve(Lp, A, r_l, A_l):
    """The sparse GP's weights Lp⁻ᵀ L_B⁻ᵀ L_B⁻¹ A r_l with L_B = chol(I +
    A_l Aᵀ); returns (weights, L_B)."""
    L_B = _cholesky(stabilize(A_l @ A.T, 1))
    c = _solve(L_B, A @ r_l)
    return _solve(Lp.T, _solve(L_B.T, c, lower=False), lower=False), L_B


def _scaled_solves(Lp, S, Ar, s2):
    """The weights of a batch of scalar noise variances s2 (c,) at once:
    Lp⁻ᵀ L⁻ᵀ L⁻¹ (Ar/s2) with L = chol(I + S/s2), S = A Aᵀ and the
    columns Ar (m, c) of A r; returns (m, c)."""
    L_B = _cholesky(stabilize(S / s2[:, None, None], 1))
    c = _solve(L_B, (Ar / s2).T.unsqueeze(-1))
    return _solve(Lp.T, _solve(L_B.mT, c, lower=False), lower=False)[..., 0].T


def _weighted_solves(Lp, A, R, s2):
    """The weights of per-observation noise variances, one (n,) column of
    s2 (c, n) per feature of R (n, c): each its own I + A diag(1/s2) Aᵀ."""
    A_l = A / s2[:, None, :]
    L_B = _cholesky(stabilize(A_l @ A.T, 1))
    c = _solve(L_B, (A @ (R / s2.T)).T.unsqueeze(-1))
    return _solve(Lp.T, _solve(L_B.mT, c, lower=False), lower=False)[..., 0].T


def _per_feature_sparse_weights(Lp, A, R, sigma, jitter):
    """The sparse weights (m, p) of a per-feature σ, (p,) or (n, p), σ²
    floored at ``jitter``.  For (p,) the O(m²n) product S = A Aᵀ is formed
    once: A_l Aᵀ = S/σ² exactly."""
    m, n = A.shape
    item = A.element_size()
    if sigma.ndim == 1:
        S, Ar = A @ A.T, A @ R
        cols = [
            _scaled_solves(Lp, S, Ar[:, sl], _feature_s2(sigma, sl, jitter, True)[:, 0])
            for sl in _feature_chunks(sigma.shape[0], 2 * m * m * item)
        ]
    else:
        cols = [
            _weighted_solves(Lp, A, R[:, sl], _feature_s2(sigma, sl, jitter, True))
            for sl in _feature_chunks(sigma.shape[1], (m * n + 2 * m * m) * item)
        ]
    return torch.cat(cols, dim=1)


def _leverage_sigma_is_per_feature(conditional, sigma, n_eval):
    """Whether a leverage σ (which may differ from the constructor's) is
    per feature: the stored flag where the shapes match, else a 1-d σ of
    the evaluation points' length is per observation and any other
    non-scalar σ per feature."""
    if _ndim(sigma) == 0:
        return False
    stored = getattr(conditional, "sigma", None)
    if stored is not None and _ndim(stored) == sigma.ndim and tuple(stored.shape) == tuple(sigma.shape):
        return bool(getattr(conditional, "per_feature_sigma", False))
    if sigma.ndim == 2:
        return True
    return sigma.shape[0] != n_eval


def _in_range(h):
    """Whether every h lies in [0, 1] up to :data:`LEVERAGE_TOL`; all() of
    the in-range test, so NaN and Inf fail it."""
    return bool(torch.all((h >= -LEVERAGE_TOL) & (h <= 1 + LEVERAGE_TOL)))


def _hat_chunk(M, Bt, weigh, check):
    """weigh(colsum((L⁻¹Bᵀ)²)) for the Cholesky factors L of a batch M,
    transposed: (n, c).  A factor that fails gives NaN; with ``check``,
    None instead, before the solve, or where the result fails ``check``."""
    L, info = torch.linalg.cholesky_ex(M)
    failed = info != 0
    if check is not None and bool(failed.any()):
        return None
    X = _solve(torch.where(failed[..., None, None], torch.nan, L), Bt)
    h = weigh(torch.sum(X * X, dim=1)).T
    return None if check is not None and not check(h) else h


def _hat_scalar(B, K_uu, sigmas, jitter, check=None):
    """diag(B M⁻¹ Bᵀ) with M = σ² K_uu + BᵀB + jitter I for each σ of
    ``sigmas`` (c,), through the Cholesky factor of M: (n, c); None as
    soon as a chunk fails ``check`` (see :func:`_hat_chunk`)."""
    Bt = B.T
    BtB = Bt @ B
    m, n = Bt.shape
    cols = []
    for sl in _feature_chunks(sigmas.shape[0], (2 * m * m + m * n) * B.element_size()):
        s2 = sigmas[sl] ** 2
        h = _hat_chunk(stabilize(s2[:, None, None] * K_uu + BtB, jitter), Bt, lambda q: q, check)
        if h is None:
            return None
        cols.append(h)
    return torch.cat(cols, dim=1)


def _hat_per_obs(B, K_uu, sigma_cols, jitter, floor=True, check=None):
    """diag(B M⁻¹ Bᵀ D⁻¹) with D = diag(σ²) per (n,) column of
    ``sigma_cols`` (n, c) and M = K_uu + Bᵀ D⁻¹ B + jitter I: (n, c).  σ²
    is floored at ``jitter`` where ``floor``; None as soon as a chunk
    fails ``check``."""
    Bt = B.T
    m, n = Bt.shape
    cols = []
    for sl in _feature_chunks(sigma_cols.shape[1], (2 * m * n + m * m) * B.element_size()):
        s2 = sigma_cols[:, sl].T ** 2
        inv_s2 = 1.0 / (torch.clamp_min(s2, jitter) if floor else s2)
        M = stabilize(K_uu + (Bt * inv_s2[:, None, :]) @ B, jitter)
        h = _hat_chunk(M, Bt, lambda q: inv_s2 * q, check)
        if h is None:
            return None
        cols.append(h)
    return torch.cat(cols, dim=1)


def _hat_diagonal(B, K_uu, sigma, jitter, per_feature=False):
    """The sparse GP's hat diagonal, checked against its range.

    Scalar σ: h = diag(B M⁻¹ Bᵀ), M = σ² K_uu + BᵀB.  Per-feature σ (p,):
    that for each feature, (n, p).  Per-observation σ (n,): h =
    diag(B M⁻¹ Bᵀ D⁻¹), D = diag(σ²), M = K_uu + Bᵀ D⁻¹ B; an (n, p) σ
    takes that per feature column.  M is factorized by Cholesky (the JAX
    package inverts it).  In float32, at the first chunk of features
    whose factor fails or whose h leaves [0, 1] (by more than
    :data:`LEVERAGE_TOL`, or is not finite: an f32-singular K_uu), the
    whole leverage is recomputed in float64 on the same device, clipped
    to [0, 1 − 1e-6], with a warning where h reaches 1 even in float64.
    """
    n = B.shape[0]

    def check_per_obs_length(k):
        if k != n:
            raise ValueError(
                f"Per-observation sigma has length {k} but leverage is "
                f"evaluated at {n} points; per-observation noise is only "
                "defined at the training geometry."
            )

    def compute(B, K_uu, sigma, floor, check=None):
        if per_feature and sigma.ndim == 2:
            check_per_obs_length(sigma.shape[0])
            return _hat_per_obs(B, K_uu, sigma, jitter, floor, check)
        if per_feature:
            return _hat_scalar(B, K_uu, sigma.reshape(-1), jitter, check)
        if sigma.ndim >= 2:
            raise NotImplementedError(
                "Leverage with a full-covariance sigma is not supported; "
                "supply a scalar, per-feature, or per-observation sigma."
            )
        if sigma.ndim == 1:
            check_per_obs_length(sigma.shape[0])
            h = _hat_per_obs(B, K_uu, sigma[:, None], jitter, floor, check)
        else:
            h = _hat_scalar(B, K_uu, sigma.reshape(1), jitter, check)
        return None if h is None else h[:, 0]

    sigma = torch.as_tensor(sigma, dtype=B.dtype, device=B.device)
    if not per_feature and sigma.ndim == 2 and sigma.shape[1] == 1:
        sigma = sigma.reshape(-1)  # (n, 1) per observation
    if B.dtype == torch.float64:
        return compute(B, K_uu, sigma, floor=True)
    h = compute(B, K_uu, sigma, floor=True, check=_in_range)
    if h is not None:
        return h
    logger.warning(
        "Leverage left [0, 1] or its factorization failed on the f32 path "
        "(ill-conditioned landmark kernel); recomputing in float64."
    )
    h64 = compute(B.double(), K_uu.double(), sigma.double(), floor=False)
    if not bool(torch.isfinite(h64).all()):
        raise ValueError("The leverage is not finite even in float64.")
    # h -> 1 is zero-noise interpolation: the HC3 correction divides by
    # (1 - h)², so say so before bounding the overshoot below 1
    n_degenerate = int(torch.sum(h64 >= LEVERAGE_CEILING))
    if n_degenerate:
        logger.warning(
            "%d observation(s) have leverage ~1 even in float64 "
            "(zero-noise interpolation): the HC3 observation-variance "
            "correction is undefined there and will be reported at its "
            "clipped ceiling. Increase sigma (observation noise) or reduce "
            "landmark density to resolve the degeneracy.",
            n_degenerate,
        )
    return torch.clamp(h64, 0.0, LEVERAGE_CEILING).to(B.dtype)


def _landmarks_lp_with_pruning(xu, cov_func, jitter, K=None, known_singular=False):
    """Landmark Cholesky that prunes, at float32, to the pivoted-Cholesky
    landmark subset where the kernel is singular (escalating the jitter
    would keep every landmark and lose the solve's accuracy).  Returns
    (xu, possibly pruned, and Lp)."""
    if K is None:
        K = cov_func(xu, xu)
    if K.dtype == torch.float64:
        return xu, _get_L(xu, cov_func, jitter, K=K)
    if not known_singular:
        L, ok = _jittered_cholesky(K, jitter)
        if bool(ok):
            return xu, L
    piv = select_stable_landmarks(K)
    logger.warning(
        "Landmark kernel is singular at f32; pruning %d "
        "redundant landmarks (keeping %d).",
        xu.shape[0] - len(piv),
        len(piv),
    )
    return xu[piv], safe_cholesky(K[piv][:, piv], jitter=jitter, max_tries=3)


# ---------------------------------------------------------------------------
# full conditional
# ---------------------------------------------------------------------------


def _full_leverage(K, sigma, jitter):
    """h = 1 − σ² diag((K + σ² I)⁻¹) with σ² floored at ``jitter``, for a
    scalar or per-observation σ: (n,)."""
    s2 = sigma * sigma
    s2 = max(s2, jitter) if _ndim(s2) == 0 else torch.clamp_min(s2, jitter)
    Linv = _solve(_noise_factor(K, s2, jitter), torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
    return 1 - s2 * torch.sum(Linv * Linv, dim=0)


def _full_per_feature(K, sigma, R, jitter, what):
    """Per-feature σ (p,) or (n, p) on the full GP, one factor of
    K + diag(σ²) + jitter I per feature, in chunks: the weights
    (K + σ²)⁻¹ R of R's columns (``what="weights"``, σ² as given) or the
    leverage (``what="leverage"``, σ² floored at ``jitter``); (n, p)."""
    n = K.shape[0]
    p = sigma.shape[-1]
    floor = what == "leverage"
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    cols = []
    for sl in _feature_chunks(p, 3 * n * n * K.element_size()):
        s2 = _feature_s2(sigma, sl, jitter, floor)
        L = _noise_factor(K, s2, jitter)
        if floor:
            Linv = _solve(L, eye)
            cols.append((1 - s2 * torch.sum(Linv * Linv, dim=1)).T)
        else:
            cols.append(_cho_solve(L, R[:, sl].T.unsqueeze(-1))[..., 0].T)
    return torch.cat(cols, dim=1)


class _FullConditional:
    """Exact GP conditioning on every training point."""

    def __init__(
        self,
        x,
        y,
        mu,
        cov_func,
        L=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_cov_factor=None,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
    ):
        x = ensure_2d(x)
        sigma = _as_sigma(sigma, x)
        original_sigma = sigma
        per_feature = _is_per_feature_sigma(sigma, y)
        n = x.shape[0]
        K = cov_func(x, x)
        r = y - mu

        if per_feature:
            weights = _full_per_feature(
                K, _normalize_per_feature_sigma(sigma), r, jitter, "weights"
            )
        else:
            if L is None:
                logger.info("Recomputing covariance decomposition for predictive function.")
                if y_is_mean:
                    L = _get_L(x, cov_func, jitter, K=K)
                else:
                    y_cov_factor = _sigma_to_y_cov_factor(sigma, y_cov_factor, n, x)
                    sigma = None
                    L = _get_L(x, cov_func, jitter, y_cov_factor, K=K)
            weights = _cho_solve(L, r)

        self.cov_func = cov_func
        self.x = x
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = original_sigma
        self.per_feature_sigma = per_feature
        self.n_input_features = x.shape[1]
        self.n_obs = n
        self._state_variables = {"x", "weights", "mu", "jitter", "sigma", "per_feature_sigma"}

        if obs_variance:
            self._compute_obs_variance(y, mu, original_sigma, jitter, weights, K, per_feature)

        if not with_uncertainty:
            return
        if per_feature:
            # one noise-free factor instead of one per feature
            L = _get_L(x, cov_func, jitter, K=K)
        elif L is None:
            y_cov_factor = _sigma_to_y_cov_factor(sigma, y_cov_factor, n, x)
            sigma = None
            L = _get_L(x, cov_func, jitter, y_cov_factor, K=K)
        self.L = L
        self._state_variables.add("L")
        if not per_feature:
            self.W = _cho_solve(L, _sigma_to_y_cov_factor(sigma, y_cov_factor, n, x))
            self._state_variables.add("W")

    def _compute_obs_variance(self, y, mu, sigma, jitter, weights, K, per_feature):
        """HC3-corrected squared residuals r²/(1 − h)², smoothed by a second
        GP with the same noise: its weights are ``variance_weights``.  A
        per-observation (n,) σ is heteroscedastic noise on the scalar
        formulas, and an (n, p) σ maps over its feature axis, as in the JAX
        package."""
        prediction = mu + K @ weights
        if per_feature:
            sigma_pf = _normalize_per_feature_sigma(sigma)
            h = _full_per_feature(K, sigma_pf, None, jitter, "leverage")
        else:
            sigma_eff = sigma if _ndim(sigma) == 0 else sigma.reshape(-1)
            h = _full_leverage(K, sigma_eff, jitter)
        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2
        variance_mu = 0.0
        if per_feature:
            variance_weights = _full_per_feature(
                K, sigma_pf, corrected_r2 - variance_mu, jitter, "weights"
            )
        else:
            s2 = sigma_eff * sigma_eff
            variance_weights = _cho_solve(_noise_factor(K, s2, jitter), corrected_r2 - variance_mu)
        self.variance_weights = variance_weights
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables |= {"variance_weights", "variance_mu"}

    @property
    def device(self):
        return self.x.device

    @property
    def dtype(self):
        return self.x.dtype

    def _mean(self, Xnew):
        return _conditional_mean(self.cov_func, Xnew, self.x, self.weights, self.mu)

    def _leverage(self, Xnew, sigma):
        """h = 1 − σ² diag((K + σ² I)⁻¹) at the training points (the only
        geometry the full conditional defines it at): Xnew must have as
        many rows as the training data."""
        x = self.x
        n = x.shape[0]
        K_train = self.cov_func(x, x)
        if Xnew is not None and Xnew.shape[0] != n:
            raise ValueError(
                f"Leverage of the full conditional is defined at the "
                f"{n:,} training points but {Xnew.shape[0]:,} points "
                "were given."
            )
        sigma = _as_sigma(sigma, x)
        if _leverage_sigma_is_per_feature(self, sigma, n):
            return _full_per_feature(
                K_train, _normalize_per_feature_sigma(sigma), None, self.jitter, "leverage"
            )
        if _ndim(sigma) == 2 and sigma.shape[1] == 1:
            sigma = sigma.reshape(-1)  # (n, 1) per observation
        if _ndim(sigma) >= 2:
            raise NotImplementedError(
                "Leverage with a full-covariance sigma is not supported; "
                "supply a scalar, per-feature, or per-observation sigma."
            )
        return _full_leverage(K_train, sigma, self.jitter)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func, Xnew, self.x, self.variance_weights, self.variance_mu
        )

    def _covariance(self, Xnew, diag=True):
        _check_covariance(self)
        if diag:
            return _conditional_cov_diag(self.cov_func, Xnew, self.x, self.L)
        A = _solve(self.L, self.cov_func(self.x, Xnew))
        return self.cov_func(Xnew, Xnew) - A.T @ A

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(self.cov_func, Xnew, self.x, self.W)
        cov_L = self.cov_func(Xnew, self.x) @ self.W
        return cov_L @ cov_L.T


class FullConditional(_FullConditional, Predictor):
    pass


class ExpFullConditional(_FullConditional, ExpPredictor):
    pass


class FullConditionalTime(_FullConditional, PredictorTime):
    pass


# ---------------------------------------------------------------------------
# landmarks conditional
# ---------------------------------------------------------------------------


class _LandmarksConditional:
    """Conditioning through inducing points xu: weights from the sparse
    solve with the σ-weighted I + A_l Aᵀ, A = Lp⁻¹ k(xu, x).

    Without ``Lp``, a float32 landmark kernel that does not factorize is
    pruned (a noise-free mean, or Kuf above :data:`F64_RESCUE_BUDGET`
    elements) or solved in float64 on the device, as the JAX package
    decides (it solves on the host).
    """

    def __init__(
        self,
        x,
        xu,
        y,
        mu,
        cov_func,
        L=None,
        Lp=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_cov_factor=None,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
    ):
        x = ensure_2d(x)
        xu = ensure_2d(xu)
        sigma = _as_sigma(sigma, x)
        original_sigma = sigma
        per_feature = _is_per_feature_sigma(sigma, y)

        if Lp is None:
            K = cov_func(xu, xu)
            if K.dtype == torch.float64:
                Lp = _get_L(xu, cov_func, jitter, K=K)
            else:
                Lp, chol_ok = _jittered_cholesky(K, jitter)
                if not bool(chol_ok):
                    # a noise-free mean (the density models' reconditioning)
                    # prunes; a noisy or multi-output fit keeps every
                    # landmark through the float64 solve
                    noise_free_mean = (
                        y_is_mean
                        and y_cov_factor is None
                        and (sigma is None or (_ndim(sigma) == 0 and float(sigma) == 0.0))
                    )
                    if noise_free_mean or xu.shape[0] * x.shape[0] > F64_RESCUE_BUDGET:
                        xu, Lp = _landmarks_lp_with_pruning(
                            xu, cov_func, jitter, K=K, known_singular=True
                        )
                    else:
                        logger.warning(
                            "Landmark kernel is singular at f32; computing "
                            "the conditional weights in float64."
                        )
                        # the float32 kernel values, factorized in float64:
                        # escalating the jitter would let the float32
                        # factorization succeed and the solve lose accuracy
                        Lp = _cholesky_f64_rescue(K.double(), jitter)
                        if Lp is None:
                            raise ValueError(
                                "The landmark kernel is not positive definite "
                                "even in float64 after jitter escalation."
                            )

        # the solves run in Lp's dtype, float64 after the rescue; what is
        # stored is rounded to the kernel's dtype
        Kuf = cov_func(xu, x)
        dtype, work = Kuf.dtype, Lp.dtype
        sigma_w = sigma.to(work) if isinstance(sigma, torch.Tensor) else sigma
        A = _solve(Lp, Kuf.to(work))
        r = (y - mu).to(work)
        if per_feature:
            weights = _per_feature_sparse_weights(
                Lp, A, r, _normalize_per_feature_sigma(sigma_w), jitter
            )
            L_B = None
        else:
            r_l, A_l = (r, A) if y_is_mean else _process_sigma(sigma_w, r, A, jitter=jitter)
            weights, L_B = _sparse_solve(Lp, A, r_l, A_l)

        self.cov_func = cov_func
        self.landmarks = xu
        self.weights = weights.to(dtype)
        self.mu = mu
        self.jitter = jitter
        self.sigma = original_sigma
        self.per_feature_sigma = per_feature
        self.n_input_features = xu.shape[1]
        self.n_obs = x.shape[0]
        self._state_variables = {
            "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

        if obs_variance:
            self._compute_obs_variance(y, mu, sigma_w, jitter, Lp, Kuf, A, per_feature)

        if not with_uncertainty:
            return
        self.L = Lp.to(dtype)
        self._state_variables.add("L")
        if not per_feature:
            self.Cs = (Lp @ L_B).to(dtype)
            self._state_variables.add("Cs")
        if not y_is_mean or per_feature:
            # a per-feature σ has no shared L_B: no W, and mean_covariance
            # says so
            return
        y_l = (
            y_cov_factor
            if y_cov_factor is not None
            else _sigma_to_y_cov_factor(sigma, None, x.shape[0], x)
        )
        Z = _solve(L_B.T, _solve(L_B, A @ y_l.to(work)), lower=False)
        self.W = _solve(Lp.T, Z, lower=False).to(dtype)
        self._state_variables.add("W")

    def _compute_obs_variance(self, y, mu, sigma, jitter, Lp, Kuf, A, per_feature):
        """HC3-corrected squared residuals smoothed by a second sparse GP,
        whose weights are solved in Lp's dtype (float64 after the rescue);
        the leverage takes the stored weights and factor."""
        prediction = mu + Kuf.T @ self.weights
        Lp_stored = Lp.to(Kuf.dtype)
        sigma_h = _normalize_per_feature_sigma(sigma) if per_feature else sigma
        h = _hat_diagonal(Kuf.T, Lp_stored @ Lp_stored.T, sigma_h, jitter, per_feature=per_feature)
        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2
        variance_mu = 0.0
        r_var = (corrected_r2 - variance_mu).to(Lp.dtype)
        if per_feature:
            variance_weights = _per_feature_sparse_weights(Lp, A, r_var, sigma_h, jitter)
        else:
            r_l, A_l = _process_sigma(sigma, r_var, A, jitter=jitter)
            variance_weights, _ = _sparse_solve(Lp, A, r_l, A_l)
        self.variance_weights = variance_weights.to(Kuf.dtype)
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables |= {"variance_weights", "variance_mu"}

    @property
    def device(self):
        return self.landmarks.device

    @property
    def dtype(self):
        return self.landmarks.dtype

    def _mean(self, Xnew):
        return _conditional_mean(self.cov_func, Xnew, self.landmarks, self.weights, self.mu)

    def _leverage(self, Xnew, sigma):
        """The sparse hat diagonal through M = σ² K_uu + BᵀB, B = k(Xnew, xu)."""
        xu = self.landmarks
        B = self.cov_func(Xnew, xu)
        if getattr(self, "L", None) is not None:
            K_uu = self.L @ self.L.T
        else:
            K_uu = self.cov_func(xu, xu)
        sigma = _as_sigma(sigma, B)
        per_feature = _leverage_sigma_is_per_feature(self, sigma, B.shape[0])
        if per_feature:
            sigma = _normalize_per_feature_sigma(sigma)
        return _hat_diagonal(B, K_uu, sigma, self.jitter, per_feature=per_feature)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func, Xnew, self.landmarks, self.variance_weights, self.variance_mu
        )

    def _covariance(self, Xnew, diag=False):
        """The Nyström residual plus the sparse correction CᵀC (without it
        for a per-feature σ, which has no shared factor)."""
        _check_covariance(self)
        xu, L = self.landmarks, self.L
        if self.per_feature_sigma:
            if diag:
                return _conditional_cov_diag(self.cov_func, Xnew, xu, L)
            As = _solve(L, self.cov_func(xu, Xnew))
            return self.cov_func(Xnew, Xnew) - As.T @ As
        if diag:
            return _conditional_cov_diag2(self.cov_func, Xnew, xu, L, self.Cs)
        Kus = self.cov_func(xu, Xnew)
        As = _solve(L, Kus)
        C = _solve(self.Cs, Kus)
        return self.cov_func(Xnew, Xnew) - As.T @ As + C.T @ C

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(self.cov_func, Xnew, self.landmarks, self.W)
        cov_L = self.cov_func(Xnew, self.landmarks) @ self.W
        return cov_L @ cov_L.T


class LandmarksConditional(_LandmarksConditional, Predictor):
    pass


class ExpLandmarksConditional(_LandmarksConditional, ExpPredictor):
    pass


class LandmarksConditionalTime(_LandmarksConditional, PredictorTime):
    pass


# ---------------------------------------------------------------------------
# landmarks-Cholesky conditional
# ---------------------------------------------------------------------------


class _LandmarksConditionalCholesky:
    """The GP whose latents live on the landmarks: weights = L⁻ᵀ z.

    Same arguments as the JAX package's class; ``sigma`` is the latents'
    std (a vector) or a scalar noise, used by ``with_uncertainty=True``
    and the leverage; ``obs_variance=True`` needs the observations
    ``obs_x`` and ``obs_y``.
    """

    def __init__(
        self,
        xu,
        pre_transformation,
        mu,
        cov_func,
        n_obs,
        L=None,
        sigma=DEFAULT_SIGMA,
        jitter=DEFAULT_JITTER,
        y_is_mean=False,
        with_uncertainty=False,
        obs_variance=False,
        obs_x=None,
        obs_y=None,
    ):
        xu = ensure_2d(xu)
        sigma = _as_sigma(sigma, xu)
        original_sigma = sigma
        if L is None:
            logger.info("Recomputing covariance decomposition for predictive function.")
            if y_is_mean:
                L = _get_L(xu, cov_func, jitter)
            else:
                y_cov_factor = _sigma_to_y_cov_factor(sigma, None, xu.shape[0], xu)
                sigma = None
                L = _get_L(xu, cov_func, jitter, y_cov_factor)
        weights = _solve(L.T, pre_transformation, lower=False)
        self._set_state(xu, weights, mu, cov_func, n_obs, jitter, original_sigma)

        if obs_variance:
            if obs_x is None or obs_y is None:
                raise ValueError(
                    "obs_x and obs_y are required when obs_variance=True "
                    "for LandmarksConditionalCholesky."
                )
            Lp = L if y_is_mean else _get_L(xu, cov_func, jitter)
            self._compute_obs_variance(obs_x, obs_y, original_sigma, Lp)

        if not with_uncertainty:
            return
        if sigma is None:
            # the L branch above took sigma into the noise factor
            sigma = original_sigma
        if sigma is None:
            # raises the informative "No input uncertainty specified"
            _sigma_to_y_cov_factor(None, None, xu.shape[0], xu)
        if _ndim(sigma) == 1:
            stds = torch.diag(sigma)
        else:
            stds = torch.eye(xu.shape[0], dtype=L.dtype, device=L.device) * sigma
        self._set_uncertainty(L, _solve(L.T, stds, lower=False))

    @classmethod
    def from_state(
        cls, landmarks, weights, mu, cov_func, n_obs=None, jitter=DEFAULT_JITTER,
        sigma=None, L=None, W=None,
    ):
        """A predictor from its stored state (landmarks and weights, and L
        and W for one with uncertainty)."""
        self = cls.__new__(cls)
        self._set_state(ensure_2d(landmarks), weights, mu, cov_func, n_obs, jitter, sigma)
        if L is not None:
            self._set_uncertainty(L, W)
        return self

    def _set_state(self, landmarks, weights, mu, cov_func, n_obs, jitter, sigma):
        self.cov_func = cov_func
        self.landmarks = landmarks
        self.weights = weights
        self.mu = mu
        self.jitter = jitter
        self.sigma = sigma
        self.per_feature_sigma = False
        self.n_input_features = landmarks.shape[1]
        self.n_obs = n_obs
        self._state_variables = {
            "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma",
        }

    def _set_uncertainty(self, L, W):
        self.L = L
        self.W = W
        self._state_variables |= {"L", "W"}

    def _compute_obs_variance(self, x, y, sigma, Lp):
        """HC3-corrected squared residuals at the observations, smoothed by
        a sparse GP on the landmarks with the noise σ."""
        x = ensure_2d(x)
        xu, cov_func, jitter = self.landmarks, self.cov_func, self.jitter
        prediction = self.mu + cov_func(x, xu) @ self.weights
        h = self._leverage(x, sigma)
        residual = y - prediction
        if residual.ndim > h.ndim:
            h = h[..., None]
        corrected_r2 = residual**2 / (1 - h) ** 2
        A_var = _solve(Lp, cov_func(xu, x))
        variance_mu = 0.0
        r_l, A_l = _process_sigma(sigma, corrected_r2 - variance_mu, A_var, jitter=jitter)
        self.variance_weights, _ = _sparse_solve(Lp, A_var, r_l, A_l)
        self.variance_mu = variance_mu
        self._corrected_r2 = corrected_r2
        self._state_variables |= {"variance_weights", "variance_mu"}

    @property
    def device(self):
        return self.landmarks.device

    @property
    def dtype(self):
        return self.landmarks.dtype

    def _mean(self, Xnew):
        return _conditional_mean(self.cov_func, Xnew, self.landmarks, self.weights, self.mu)

    def _leverage(self, Xnew, sigma):
        """The sparse hat diagonal; this family's σ is never per feature."""
        xu = self.landmarks
        B = self.cov_func(Xnew, xu)
        if getattr(self, "L", None) is not None:
            K_uu = self.L @ self.L.T
        else:
            K_uu = self.cov_func(xu, xu)
        return _hat_diagonal(B, K_uu, sigma, self.jitter, per_feature=False)

    def _obs_variance(self, Xnew):
        _check_obs_variance(self)
        return _conditional_mean(
            self.cov_func, Xnew, self.landmarks, self.variance_weights, self.variance_mu
        )

    def _covariance(self, Xnew, diag=True):
        _check_covariance(self)
        if diag:
            return _conditional_cov_diag(self.cov_func, Xnew, self.landmarks, self.L)
        A = _solve(self.L, self.cov_func(self.landmarks, Xnew))
        return self.cov_func(Xnew, Xnew) - A.T @ A

    def _mean_covariance(self, Xnew, diag=True):
        _check_uncertainty(self)
        if diag:
            return _conditional_mean_cov_diag(self.cov_func, Xnew, self.landmarks, self.W)
        cov_L = self.cov_func(Xnew, self.landmarks) @ self.W
        return cov_L @ cov_L.T


class LandmarksConditionalCholesky(_LandmarksConditionalCholesky, Predictor):
    pass


class ExpLandmarksConditionalCholesky(_LandmarksConditionalCholesky, ExpPredictor):
    pass


class LandmarksConditionalCholeskyTime(_LandmarksConditionalCholesky, PredictorTime):
    pass
