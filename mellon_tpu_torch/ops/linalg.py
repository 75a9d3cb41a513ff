"""Covariance factorizations of the sparse-Cholesky path.

Counterpart of the main-path subset of ``mellon_tpu/ops/linalg.py``:
jittered Cholesky with a validity flag, the f32 rescue ladder, the pivoted
partial Cholesky that prunes f32-singular landmark sets, the whitening
L = C Lp⁻ᵀ and the ridge warm start.  Dense Cholesky and triangular
solves go to ``torch.linalg`` (cuSOLVER/cuBLAS on the card).  The JAX
package's row-chunked whitening (``_chunked_rows``/``TRSM_CHUNK_*``) is a
workaround for the 16 GB TPU v5e and is not ported.
"""

import logging

import torch

from ..utils.util import DEFAULT_JITTER, add_diagonal

DEFAULT_SIGMA = 0
# relative diagonal tolerance of the pivoted partial Cholesky
PIVOT_REL_TOL = 1e-6
RANK_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# pivot steps between host checks of the stopping rule max(d) > thresh
PIVOT_CHUNK = 64
# host-f64 rescue budget of the JAX package (host_cholesky_f64)
F64_RESCUE_TRIES = 8

logger = logging.getLogger("mellon_tpu_torch")


def _jittered_cholesky(K, jitter):
    """chol(K + jitter I) and a validity flag (a 0-d bool tensor).

    ``torch.linalg.cholesky_ex`` reports failure in ``info`` where
    ``torch.linalg.cholesky`` would raise; a failed factor is returned as
    NaN, as JAX's Cholesky returns it, so callers may branch on either.
    """
    L, info = torch.linalg.cholesky_ex(add_diagonal(K, jitter))
    ok = (info == 0) & ~torch.any(torch.isnan(L))
    return torch.where(ok, L, torch.nan), ok


def _cholesky_f64_rescue(K, jitter):
    """Float64 Cholesky on K's device with x10 jitter escalation from
    max(jitter, 1e-12): the device counterpart of the JAX package's
    ``host_cholesky_f64``.  Returns the float64 factor or None."""
    A = K.to(torch.float64)
    requested = max(float(jitter), 1e-12)
    hj = requested
    for _ in range(F64_RESCUE_TRIES):
        L, info = torch.linalg.cholesky_ex(add_diagonal(A, hj))
        if int(info) == 0:
            if hj > requested:
                logger.warning(
                    "Float64 Cholesky needed jitter escalation to %.1e "
                    "(requested %.1e); the factor is valid but the matrix "
                    "is ill-conditioned at the requested regularization.",
                    hj,
                    requested,
                )
            return L
        hj *= 10
    return None


def safe_cholesky(K, jitter=DEFAULT_JITTER, max_tries=0):
    """Cholesky with optional geometric jitter escalation and a float64
    factorization as the final rescue.

    ``max_tries=0`` raises on failure (the f64 contract).  ``max_tries > 0``
    retries with x10 jitter, then factorizes once in float64 on the device
    (the JAX package does this on the host); the factor comes back in K's
    dtype.
    """
    L, ok = _jittered_cholesky(K, jitter)
    ok = bool(ok)
    tries = 0
    extra = max(jitter, DEFAULT_JITTER)
    while not ok and tries < max_tries:
        extra = extra * 10
        tries += 1
        logger.warning(f"Cholesky failed; retrying with jitter={extra:.2e}.")
        L, ok = _jittered_cholesky(K, extra)
        ok = bool(ok)
    if not ok and max_tries > 0:
        logger.warning(
            "Cholesky failed after jitter escalation; factorizing once in float64."
        )
        L64 = _cholesky_f64_rescue(K, max(jitter, DEFAULT_JITTER))
        if L64 is not None:
            L, ok = L64.to(K.dtype), True
    if not ok:
        message = (
            f"Covariance not positively definite with jitter={jitter}. "
            "Consider increasing the jitter for numerical stabilization."
        )
        logger.error(message)
        raise ValueError(message)
    return L


def _full_rank(x, cov_func, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """L = chol(K + max(sigma², jitter) I); float32 escalates the jitter."""
    eff_jitter = max(float(sigma) ** 2, jitter)
    K = cov_func(x, x)
    max_tries = 0 if K.dtype == torch.float64 else 3
    return safe_cholesky(K, jitter=eff_jitter, max_tries=max_tries)


def _standard_low_rank(x, cov_func, xu, Lp=None, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """Sparse-Cholesky L = C Lp⁻ᵀ with C = k(x, xu): the kernel tile, then
    one triangular solve (X Lpᵀ = C)."""
    if Lp is None:
        Lp = _full_rank(xu, cov_func, sigma=sigma, jitter=jitter)
    C = cov_func(x, xu)
    return torch.linalg.solve_triangular(Lp.T, C, upper=True, left=False)


def _pivoted_cholesky(K, rel_tol, max_rank):
    """Greedy diagonally-pivoted partial Cholesky of a PSD matrix.

    Returns (pivots (max_rank,), r, L (m, max_rank)) like the JAX package's
    ``while_loop``: it stops after ``max_rank`` steps or once the largest
    residual diagonal is at most ``rel_tol`` times the largest diagonal.
    The stopping rule is read on the host once per :data:`PIVOT_CHUNK`
    steps; inside a chunk a device-side flag masks the updates once it
    fails, so every step after it leaves the state unchanged.  The pivot
    stays a one-element tensor (``index_select``/``gather``): indexing with
    a 0-d tensor would read it on the host at every step.
    """
    m = K.shape[0]
    d = torch.diagonal(K).clone()
    thresh = rel_tol * torch.max(d)
    L = torch.zeros((m, max_rank), dtype=K.dtype, device=K.device)
    piv = torch.zeros(max_rank, dtype=torch.int64, device=K.device)
    active = torch.ones((), dtype=torch.bool, device=K.device)
    r = torch.zeros((), dtype=torch.int64, device=K.device)
    rows = torch.arange(m, device=K.device)
    k = 0
    while k < max_rank:
        steps = min(PIVOT_CHUNK, max_rank - k)
        for j in range(k, k + steps):
            active = active & (torch.max(d) > thresh)
            p = torch.argmax(d, dim=0, keepdim=True)
            col = K.index_select(1, p)[:, 0] - L[:, :j] @ L.index_select(0, p)[0, :j]
            l_col = torch.where(active, col / torch.sqrt(d.gather(0, p)), 0.0)
            d_new = torch.clamp_min(d - l_col * l_col, 0.0)
            d = torch.where(active & (rows != p), d_new, torch.where(active, 0.0, d))
            L[:, j] = l_col
            piv[j : j + 1] = torch.where(active, p, 0)
            r = r + active.to(torch.int64)
        k += steps
        if int(r) < k:
            break
    return piv, int(r), L


def select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL, max_rank=None, quantize=True):
    """Greedy landmark subset whose kernel submatrix is f32-factorizable.

    The pivoted partial Cholesky runs with a cap of min(m, 1024) that
    doubles while the cap binds; ``quantize=True`` rounds the selected
    count DOWN to a :data:`RANK_BUCKETS` power of two, as the JAX package
    does (it changes which landmarks are kept).  Returns the pivot indices
    as a tensor on K's device.
    """
    m = K.shape[0]
    if max_rank is None:
        cap = min(m, 1024)
        while True:
            piv, r, _ = _pivoted_cholesky(K, rel_tol, cap)
            if r < cap or cap >= m:
                break
            cap = min(2 * cap, m)
    else:
        piv, r, _ = _pivoted_cholesky(K, rel_tol, int(max_rank))
    if quantize:
        buckets = [b for b in RANK_BUCKETS if b <= r]
        if buckets:
            r = buckets[-1]
    logger.info(
        "Pivoted Cholesky selected %d of %d landmarks (relative tolerance %.0e).",
        r,
        m,
        rel_tol,
    )
    return piv[:r]


def ridge_solve(L, target, alpha=1.0):
    """Minimize ||L z - target||² + alpha ||z||² through the normal
    equations and a Cholesky of (LᵀL + alpha I)."""
    G = add_diagonal(L.T @ L, alpha)
    Lc = torch.linalg.cholesky(G)
    rhs = (L.T @ target)[:, None]
    y = torch.linalg.solve_triangular(Lc, rhs, upper=False)
    return torch.linalg.solve_triangular(Lc.T, y, upper=True)[:, 0]
