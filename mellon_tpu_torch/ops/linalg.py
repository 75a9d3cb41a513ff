"""Covariance factorizations (counterpart of ``mellon_tpu/ops/linalg.py``).

Jittered Cholesky with a validity flag, the f32 rescue ladder, the pivoted
partial Cholesky that prunes f32-singular landmark sets, the whitening
L = C Lp⁻ᵀ, the ridge warm start, and the Nyström rank reductions: the
truncated eigendecomposition with its count or eigenvalue-mass selection,
the randomized range-finder eigensolver, the full type's truncated
factor and the improved (sparse) Nyström factor, exact below
:data:`NYSTROEM_EXACT_MAX` landmarks and Cholesky-whitened above.  Dense
Cholesky, eigh, QR and triangular solves go to ``torch.linalg``
(cuSOLVER/cuBLAS on the card); every float32 product runs in IEEE
float32 (TF32 is off, :mod:`..config`).  The pivoted Cholesky's step is
the hand-written kernel of :mod:`.hopper_kernels` on the card (its plain
version on the CPU), replayed a chunk at a time from a CUDA graph.  The
JAX package's row-chunked
whitening (``_chunked_rows``/``TRSM_CHUNK_*``) is a workaround for the
16 GB TPU v5e and is not ported.
"""

import logging

import torch

from . import hopper_kernels
from ..utils import profiling
from ..utils.util import DEFAULT_JITTER, add_diagonal, stabilize  # noqa: F401 (stabilize: re-exported)

DEFAULT_RANK = 0.99
DEFAULT_SIGMA = 0
# relative diagonal tolerance of the pivoted partial Cholesky
PIVOT_REL_TOL = 1e-6
RANK_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# pivot steps between host checks of the stopping rule max(d) > thresh
PIVOT_CHUNK = 64
# the pivoted selection's first cap (the JAX package's), doubled while it binds
PIVOT_FIRST_CAP = 1024
# host-f64 rescue budget of the JAX package (host_cholesky_f64)
F64_RESCUE_TRIES = 8

logger = logging.getLogger("mellon_tpu_torch")


def cholesky_with_check(K, jitter=DEFAULT_JITTER):
    """Cholesky of an already-stabilized matrix; a ValueError (logged) where
    it fails, with the JAX package's message (``jitter`` is only named in
    it)."""
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0 or bool(torch.any(torch.isnan(L))):
        message = (
            f"Covariance not positively definite with jitter={jitter}. "
            "Consider increasing the jitter for numerical stabilization."
        )
        logger.error(message)
        raise ValueError(message)
    return L


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


def _jitter_ladder(jitter, max_tries):
    """The jitters :func:`safe_cholesky` retries with after ``jitter``:
    ``max_tries`` x10 steps from max(jitter, DEFAULT_JITTER)."""
    extra, ladder = max(jitter, DEFAULT_JITTER), []
    for _ in range(max_tries):
        extra = extra * 10
        ladder.append(extra)
    return ladder


def _log_retry(extra):
    logger.warning(f"Cholesky failed; retrying with jitter={extra:.2e}.")


def escalated_cholesky(K, jitter, max_tries):
    """:func:`safe_cholesky`'s jitter ladder without a host read (the form
    a CUDA graph captures): K is factored at ``jitter`` and at each of the
    ladder's ``max_tries`` jitters, and the first factor that succeeded is
    selected on the device, the same bits safe_cholesky returns.  Returns
    (L, tries): ``tries`` (a 0-d int64 tensor) counts the retries that
    factor took, ``max_tries + 1`` (and L NaN) where none succeeded."""
    L, ok = _jittered_cholesky(K, jitter)
    tries = torch.where(ok, 0, max_tries + 1)
    for i, extra in enumerate(_jitter_ladder(jitter, max_tries), 1):
        L_i, ok_i = _jittered_cholesky(K, extra)
        take = ok_i & ~ok
        L = torch.where(take, L_i, L)
        tries = torch.where(take, i, tries)
        ok = ok | ok_i
    return L, tries


def log_escalation(jitter, tries):
    """The warnings :func:`safe_cholesky` logs for a factor that took
    ``tries`` retries (from :func:`escalated_cholesky`)."""
    for extra in _jitter_ladder(jitter, tries):
        _log_retry(extra)


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
    for extra in _jitter_ladder(jitter, max_tries):
        if ok:
            break
        _log_retry(extra)
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


def _noise_floor(sigma, jitter):
    """max(σ², jitter): a number for a scalar σ, else elementwise."""
    if isinstance(sigma, torch.Tensor) and sigma.ndim > 0:
        return torch.clamp_min(sigma * sigma, jitter)
    return max(float(sigma) ** 2, jitter)


def _eigendecomposition(A, rank=DEFAULT_RANK, with_raw_rank=False, force_quantize=False):
    """Top eigenpairs of the symmetric A, kept by count (an int ``rank``)
    or by eigenvalue mass (a float): :func:`_select_eigenpairs` on
    ``torch.linalg.eigh`` (ascending, as ``jnp.linalg.eigh``)."""
    s, v = torch.linalg.eigh(A)
    return _select_eigenpairs(s, v, rank, A.shape[0], with_raw_rank, force_quantize)


def _select_eigenpairs(s, v, rank, quantize_dim, with_raw_rank=False, force_quantize=False):
    """The count/mass selection on an ascending eigendecomposition (s, v).

    A float ``rank`` keeps the largest count whose cumulative mass is
    strictly below ``rank`` times the positive eigenvalues' mass (the
    reference's searchsorted, so the kept pairs can fall one short of the
    target; at least 1), rounded UP to a :data:`RANK_BUCKETS` power of two
    (capped at ``quantize_dim``) above 256 rows or when
    ``force_quantize``; an int keeps min(rank, positive count).  A matrix
    with no positive eigenvalue raises ValueError.  The "Recovering"
    message reports the mass of one pair more than is kept, as the
    reference does.  Returns (s, v) of the kept pairs, ascending, and with
    ``with_raw_rank`` the count before the rounding.
    """
    n_pos, any_nonpos = torch.stack([torch.count_nonzero(s > 0), torch.any(s <= 0)]).tolist()
    if any_nonpos:
        logger.warning(
            "Covariance matrix is singular (non-positive eigenvalues "
            "detected); predictions may be unreliable. Consider raising "
            "the jitter."
        )
    p = int(n_pos)
    if p == 0:
        message = (
            "Covariance matrix has no positive eigenvalues; cannot compute "
            "a low-rank factorization. Consider raising the jitter."
        )
        logger.error(message)
        raise ValueError(message)
    summed = torch.cumsum(torch.flip(s[-p:], dims=(0,)), dim=0)
    n_summed = summed.shape[0]
    if isinstance(rank, float):
        p = int(torch.searchsorted(summed, summed[-1:] * rank)[0])
        if p == 0:
            logger.warning(f"Low variance percentage {rank:%} indicated rank=0. Bumping rank to 1.")
            p = 1
        raw_p = p
        if force_quantize or quantize_dim > 256:
            quantized = next((b for b in RANK_BUCKETS if b >= p), p)
            p_stable = min(quantized, quantize_dim)
            if p_stable != p:
                logger.info(
                    "Quantizing eigendecomposition rank %d to %d (shape-stable executables).",
                    p,
                    p_stable,
                )
                p = p_stable
    else:
        p = min(rank, p)
        raw_p = p
    # a sketch may hold fewer eigenpairs than quantize_dim
    p = min(p, s.shape[0])
    if (isinstance(rank, float) and rank < 1) or rank < n_summed:
        p_report = min(p, n_summed - 1)
        frac = float(summed[p_report] / summed[-1])
        logger.info(f"Recovering {frac:%} variance in eigendecomposition.")
    if with_raw_rank:
        return s[-p:], v[:, -p:], raw_p
    return s[-p:], v[:, -p:]


def _sketch_omega(m, p, dtype, device, seed):
    """The (m, p) Gaussian test matrix of :func:`randomized_eigh`, from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (torch cannot
    draw JAX's threefry stream, so the tests hand over JAX's matrix)."""
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((m, p), dtype=dtype, device=device, generator=generator)


def randomized_eigh(A, rank, n_iter=2, seed=0, omega=None):
    """Randomized truncated eigendecomposition of a symmetric PSD matrix:
    a Gaussian range finder with p = min(m, rank + 16) columns, ``n_iter``
    subspace iterations, and an exact eigh of the projected p × p matrix
    (Halko, Martinsson and Tropp).  ``omega`` is the (m, p) test matrix;
    by default :func:`_sketch_omega` draws it.  Returns (s, v), ascending,
    truncated to min(rank, p) pairs."""
    m = A.shape[0]
    p = min(m, rank + 16)
    if omega is None:
        omega = _sketch_omega(m, p, A.dtype, A.device, seed)
    Q, _ = torch.linalg.qr(A @ omega)
    for _ in range(n_iter):
        Q, _ = torch.linalg.qr(A @ Q)
    B = Q.T @ (A @ Q)
    B = 0.5 * (B + B.T)
    s, U = torch.linalg.eigh(B)
    keep = min(rank, p)
    return s[-keep:], Q @ U[:, -keep:]


def _full_decomposition_low_rank(x, cov_func, rank=DEFAULT_RANK, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """The full Nyström type's L: the kept eigenpairs of k(x, x) +
    max(σ², jitter) I, v·√s (a rounded-up rank's non-positive eigenvalues
    give zero columns)."""
    W = add_diagonal(cov_func(x, x), _noise_floor(sigma, jitter))
    s, v = _eigendecomposition(W, rank=rank)
    return v * torch.sqrt(torch.clamp_min(s, 0.0))


def _standard_low_rank(x, cov_func, xu, Lp=None, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """Sparse-Cholesky L = C Lp⁻ᵀ with C = k(x, xu): the kernel tile, then
    one triangular solve (X Lpᵀ = C)."""
    if Lp is None:
        Lp = _full_rank(xu, cov_func, sigma=sigma, jitter=jitter)
    C = cov_func(x, xu)
    return torch.linalg.solve_triangular(Lp.T, C, upper=True, left=False)


def _nystroem_gram(C):
    """CᵀC."""
    return C.T @ C


# below this landmark count the improved Nyström takes the exact route
NYSTROEM_EXACT_MAX = 512
# the first sketch width of the large-m selection; doubled when saturated
NYSTROEM_SKETCH = 512
# above this whitened-basis width the selection sketches the Gram
NYSTROEM_DIRECT_EIGH_MAX = 1024


def _modified_low_rank(x, cov_func, xu, rank=DEFAULT_RANK, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """The improved Nyström L with L Lᵀ ≈ C W⁻¹ Cᵀ, C = k(x, xu), W = k(xu, xu).

    Up to :data:`NYSTROEM_EXACT_MAX` landmarks it is the reference's: the
    QR C = Q R, the eigendecomposition W = v s vᵀ of the stabilized W, the
    selection on T s⁻¹ Tᵀ with T = R v, and L = Q V √S.  Above, W is
    factored (Lp, float32 escalating the jitter) and the selection runs on
    the whitened Gram of H = C Lp⁻ᵀ, whose nonzero spectrum is that of
    R W⁻¹ Rᵀ (:func:`_nystroem_select_and_project`).
    """
    m = xu.shape[0]
    if m <= NYSTROEM_EXACT_MAX:
        W = add_diagonal(cov_func(xu, xu), _noise_floor(sigma, jitter))
        C = cov_func(x, xu)
        Q, R = torch.linalg.qr(C)
        s, v = _eigendecomposition(W, rank=m)
        T = R @ v
        S, V = _eigendecomposition((T / s) @ T.T, rank=rank)
        return Q @ V * torch.sqrt(torch.clamp_min(S, 0.0))
    max_tries = 0 if x.dtype == torch.float64 else 3
    K = cov_func(xu, xu)
    if isinstance(sigma, torch.Tensor) and sigma.ndim > 0:
        # the elementwise floor on the diagonal, no extra first-try jitter
        Lp = safe_cholesky(add_diagonal(K, _noise_floor(sigma, jitter)), jitter=0.0,
                           max_tries=max_tries)
    else:
        Lp = safe_cholesky(K, jitter=_noise_floor(sigma, jitter), max_tries=max_tries)
    return _nystroem_select_and_project(_standard_low_rank(x, cov_func, xu, Lp=Lp), rank)


def _nystroem_select_and_project(H, rank):
    """The mass selection on the whitened Gram G = HᵀH and L = H U.

    Up to :data:`NYSTROEM_DIRECT_EIGH_MAX` columns an exact eigh of G;
    above, :func:`randomized_eigh` with a sketch of
    :data:`NYSTROEM_SKETCH` columns (at least twice an int rank), doubled
    while the selected count reaches 3/4 of it.  The selection is rounded
    up to a power of two (``force_quantize``).
    """
    G = _nystroem_gram(H)
    m = G.shape[0]
    if m <= NYSTROEM_DIRECT_EIGH_MAX:
        S, U, _ = _eigendecomposition(G, rank=rank, with_raw_rank=True, force_quantize=True)
        basis = m
    else:
        sketch = min(m, NYSTROEM_SKETCH)
        if isinstance(rank, int):
            sketch = min(m, max(sketch, 2 * rank))
        while True:
            s_all, v_all = randomized_eigh(G, sketch)
            S, U, raw_p = _select_eigenpairs(
                s_all, v_all, rank, m, with_raw_rank=True, force_quantize=True
            )
            if raw_p < (3 * sketch) // 4 or sketch >= m:
                break
            logger.info(
                "Nyström mass selection saturated the %d-column sketch "
                "(selected %d); doubling the sketch.",
                sketch,
                raw_p,
            )
            sketch = min(2 * sketch, m)
        basis = sketch
    logger.info(
        "Cholesky-whitened Nyström eigensolver: rank %d from the "
        "%d-column whitened basis of %d landmarks.",
        S.shape[0],
        basis,
        m,
    )
    return H @ U


def _pivot_begin(state, rel_tol, active=None, prefix=None):
    """Write into ``state`` (a :class:`~.hopper_kernels.PivotState` whose L
    and pivots are zero) the greedy pivoted Cholesky's first step on its K:
    step 0, d the diagonal of K, the stopping threshold ``rel_tol`` times
    its largest entry and the flag ``active`` (a 0-d bool tensor, or
    True); or, with ``prefix`` = (L, d, pivots) of a run on the same K
    whose every step was active, the step after that run's, which then
    continues as though it had not stopped.  Returns that step."""
    diag = torch.diagonal(state.K)
    state.vals[:1].copy_(rel_tol * torch.max(diag))
    if prefix is None:
        j0 = 0
        state.d.copy_(diag)
        active = True if active is None else active
    else:
        L0, d0, piv0 = prefix
        j0 = L0.shape[1]
        state.L[:, :j0].copy_(L0)
        state.d.copy_(d0)
        state.piv[:j0].copy_(piv0)
        active = True
    state.ints[:2].fill_(j0)  # the step, and the steps that ran
    hopper_kernels.choose_pivot(state, active)
    return j0


class _ChunkGraph:
    """:data:`PIVOT_CHUNK` launches of the step kernel on ``state`` (a
    :class:`~.hopper_kernels.PivotState` on the card), captured as one CUDA
    graph.  The kernel reads its step from the state, so each replay runs
    the state's next chunk.  The capture runs nothing and reads nothing on
    the host: it is made on a stream of its own, without the synchronise
    and the cache release that ``torch.cuda.graph`` adds, and the kernel
    allocates nothing."""

    def __init__(self, state):
        device = state.K.device
        hopper_kernels.load_pivot_step(device)
        self.graph = torch.cuda.CUDAGraph()
        with hopper_kernels.captured_launches(), torch.cuda.stream(torch.cuda.Stream(device)):
            self.graph.capture_begin()
            try:
                for j in range(PIVOT_CHUNK):
                    hopper_kernels.pivot_step(state, j)
            finally:
                self.graph.capture_end()

    def replay(self, steps):
        """Run the state's next ``steps`` (at most the chunk) on the
        current stream; launches past the state's width do nothing."""
        self.graph.replay()
        hopper_kernels.pivot_step.launches += PIVOT_CHUNK
        profiling.count("pivot.kernel_steps", steps)


def _pivoted_cholesky_masked(K, rel_tol, max_rank, active=None):
    """The ``max_rank`` steps of the greedy diagonally-pivoted partial
    Cholesky of a PSD matrix, with the stopping rule (the largest residual
    diagonal at most ``rel_tol`` times the largest diagonal) kept in a
    device-side flag that masks every step after it fails, so such a step
    leaves the state unchanged.  ``active`` (a 0-d bool tensor) is the
    flag's start: where it is False no step runs.  Nothing is read on the
    host (the form a CUDA graph captures); on the card each step is one
    launch of the step kernel.  Returns the
    :class:`~.hopper_kernels.PivotState` after the steps: its pivots
    (max_rank,), its step count r (``.r``, a 0-d tensor), L (m,
    max_rank) and the residual diagonal d."""
    state = hopper_kernels.PivotState(K, max_rank)
    _pivot_begin(state, rel_tol, active=active)
    for j in range(max_rank):
        hopper_kernels.pivot_step(state, j)
    return state


def _pivot_selection(K, rel_tol, max_rank=None, prefix=None, plain=False):
    """The greedy pivoted Cholesky of K, stopped by its rule: the step
    count r is read on the host once per :data:`PIVOT_CHUNK` steps, and the
    run ends with the chunk in which the rule fell, or at ``max_rank``
    steps.  Without ``max_rank`` the factor's width starts at
    min(m, :data:`PIVOT_FIRST_CAP`) and doubles, up to m, while the rule
    holds at it, as the JAX package's cap does; but the wider state holds
    the narrower one's columns
    (:meth:`~.hopper_kernels.PivotState.widened`) and continues its steps,
    so none runs twice.  ``prefix`` continues a run whose every step ran
    (:func:`_pivot_begin`).  On the card each chunk is one replay of a CUDA
    graph of the step kernel, captured on each width's state
    (:class:`_ChunkGraph`); on the CPU, or with ``plain``, the plain steps
    run (the card's tests compare the two).  Returns (the state, r)."""
    m = K.shape[0]
    limit = m if max_rank is None else int(max_rank)
    width = min(m, PIVOT_FIRST_CAP) if max_rank is None else limit
    j0 = 0 if prefix is None else prefix[0].shape[1]
    while width <= j0 and width < limit:
        width = min(2 * width, limit)
    graphed = K.device.type == "cuda" and not plain
    state, graph = hopper_kernels.PivotState(K, width), None
    k = r = _pivot_begin(state, rel_tol, prefix=prefix)
    while True:
        while k < width:
            steps = min(PIVOT_CHUNK, width - k)
            if graphed:
                if graph is None:
                    graph = _ChunkGraph(state)
                graph.replay(steps)
            else:
                for j in range(k, k + steps):
                    hopper_kernels.pivot_step_reference(state, j)
            k += steps
            profiling.count("pivot.steps", steps)
            profiling.count("host_reads")
            r = int(state.r)
            if r < k:
                return state, r
        if width >= limit:
            return state, r
        width = min(2 * width, limit)
        state, graph = state.widened(width), None


def _pivoted_cholesky(K, rel_tol, max_rank):
    """Greedy diagonally-pivoted partial Cholesky of a PSD matrix.

    Returns (pivots (max_rank,), r, L (m, max_rank)) like the JAX package's
    ``while_loop``: it stops after ``max_rank`` steps or once the largest
    residual diagonal is at most ``rel_tol`` times the largest diagonal.
    The stopping rule is read on the host once per :data:`PIVOT_CHUNK`
    steps (:func:`_pivot_selection`).
    """
    state, r = _pivot_selection(K, rel_tol, max_rank)
    return state.piv, r, state.L.contiguous()


def select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL, max_rank=None, quantize=True, prefix=None):
    """Greedy landmark subset whose kernel submatrix is f32-factorizable.

    The pivoted partial Cholesky runs until its stopping rule, or
    ``max_rank`` steps; without ``max_rank`` its cap of min(m, 1024)
    doubles while it binds, as the JAX package's does, and each step
    depends only on the steps before it, so the wider cap continues the
    narrower one's steps (:func:`_pivot_selection`).  ``prefix`` = (L, d,
    pivots) continues a run of the first steps on K whose every step ran
    (stage 1's, ``models/fused.py``).  ``quantize=True`` rounds
    the selected count DOWN to a :data:`RANK_BUCKETS` power of two, as the
    JAX package does (it changes which landmarks are kept).  Returns the
    pivot indices as a tensor on K's device.
    """
    m = K.shape[0]
    with profiling.span("prepare.pivots"):
        state, r = _pivot_selection(K, rel_tol, max_rank, prefix)
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
    return state.piv[:r]


def solve_psd_from_cholesky(L, b):
    """Solve (L Lᵀ) z = b given the lower Cholesky factor L; b is (m,) or
    (m, p)."""
    rhs = b[:, None] if b.ndim == 1 else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    z = torch.linalg.solve_triangular(L.T, y, upper=True)
    return z[:, 0] if b.ndim == 1 else z


def ridge_solve(L, target, alpha=1.0):
    """Minimize ||L z - target||² + alpha ||z||² through the normal
    equations and a Cholesky of (LᵀL + alpha I).  The factorization reads
    no validity flag (a non-finite L gives a non-finite z, as in the JAX
    package), so the solve can be captured in a CUDA graph."""
    G = add_diagonal(L.T @ L, alpha)
    return solve_psd_from_cholesky(torch.linalg.cholesky_ex(G)[0], L.T @ target)
