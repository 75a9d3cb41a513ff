"""Fused preparation for the default sparse fits of all four estimator
families (counterpart of ``mellon_tpu/models/fused.py``).

The lazy attribute chain (``BaseEstimator._prepare_attribute``) computes
the nearest-neighbour distances, the heuristics, the landmarks and the
landmark factor one attribute at a time, reading values on the host between
them.  Here each family's default prepare runs as two stages:

    stage 1: kNN -> nn repair -> heuristics (mu/ls; the local fractal
    dimension for the dimensionality model; the within-time search and the
    sampling-bias normalization for the time-sensitive model) ->
    (subsample) -> k-means++ -> Lloyd -> landmark kernel (K1 on the card)
    -> Cholesky attempt + pivoted-Cholesky landmark selection

    stage 2: k(x, xu) -> triangular solve -> ridge warm start (on the
    pivoted landmark subset where stage 1's Cholesky failed, whose factor
    takes the lazy chain's jitter escalation, every rung factored and the
    first that succeeds selected on the device)

with ONE host read between them: the repair counts, mu, ls, the Cholesky
flag, the pivots and their count, packed in one float64 vector.  On the
card each stage is a CUDA graph, captured at the first call with a key
(shapes, dtype, device and the static arguments) and replayed after, so a
warm prepare makes no launch from Python; the landmark kernel reads its
length scale on the device (``ops/hopper_kernels.py``), and the k-means
generators are registered with the graph and seeded before each replay, so
a replay draws what an eager run from that seed draws.  On the CPU the same
stage functions run eagerly.  Either way every attribute is set bit for bit
as the lazy chain sets it (``tests/test_torch_fused.py``; on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``[fused]``).

The first call with a key runs the stage eagerly (PyTorch's warm-up before
a capture, and this call's result), captures it, replays the graph once
and raises if the replay's outputs differ from the eager run's in a single
bit; a capture that fails raises too.  Neither returns to the lazy chain:
``ENABLED = False`` is the only switch.  The graphs are cached one per
stage of each family; a call with another key replaces the entry, which
frees the old graph's memory pool.  A pool stays allocated while its graph
is cached, so a prepare captures only where an (n, k) factor of its cells
and landmarks takes at most ``GRAPH_MEMORY_SHARE`` of the card's memory;
a larger one (the 1M-cell atlas) runs its stages eagerly, as on the CPU,
and drops its families' graphs.

Any customization (precomputed attributes, ``d_method`` other than
"embedding", a kernel other than a core with a length scale alone, a GP
type other than the default, d > 50, the CPU's IVF kNN, for the time model
no given ``ls_time``) declines, exactly where the JAX package's fused
prepare declines, and leaves the attributes to the lazy chain.  The JAX
package's row-chunked stage 2 (``_chunked_prune_factorize``) works around
the 16 GB v5e and is not ported.
"""

import ctypes
import logging
import time
from functools import partial

import numpy as np
import torch

from ..ops import hopper_kernels
from ..ops.cluster import DEFAULT_ASSIGN_BLOCK, DEFAULT_N_ITER, _kmeanspp_init, _lloyd
from ..ops.linalg import (
    PIVOT_REL_TOL,
    RANK_BUCKETS,
    _jittered_cholesky,
    _pivoted_cholesky_masked,
    _standard_low_rank,
    escalated_cholesky,
    log_escalation,
    ridge_solve,
    safe_cholesky,
    select_stable_landmarks,
)
from ..ops.neighbors import DEFAULT_BATCH_SIZE, DEFAULT_COL_BLOCK, knn_distances  # noqa: F401
from ..parameters import KMEANS_SUBSAMPLE_THRESHOLD, compute_cov_func
from ..utils import profiling
from ..utils.util import GaussianProcessType, mle
from ..utils.validation import _nn_repair_impl, report_nn_repair

# pivot-factor width inside stage 1; a selection that reaches it continues
# from stage 1's state in select_stable_landmarks
FUSED_PIVOT_CAP = 1024
# the jitter retries of the pruned landmark factor, as the lazy chain's
# safe_cholesky(..., max_tries=3)
PRUNE_MAX_TRIES = 3

logger = logging.getLogger("mellon_tpu_torch")

# escape hatch (and A/B test hook): setting this False forces the lazy
# per-attribute path everywhere
ENABLED = True

# the JAX package's operand-spec cores (ops/kernels.py:_SPEC_CORES); the
# fused prepare takes those whose only parameter is the length scale
_SPEC_CORES = ("matern32", "matern52", "expquad", "exponential", "ratquad", "linear")

# the captured stages, one per (family, stage) slot; see _run
_GRAPHS = {}
# a prepare captures its stages (and keeps their graphs) only where an
# (n, k) factor of its cells and landmarks takes at most this share of the
# card's memory: a cached graph's pool stays allocated, and the pools
# measured 1.25 (1M x 50) to 4.5 (8,627 x 20) times that factor's bytes
# on an H100 (PERF.md).  Past it the stages run eagerly, as on the CPU.
GRAPH_MEMORY_SHARE = 1 / 16
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _cpu_ivf_applies(n, device):
    """True where the lazy kNN takes the cluster-pruned (IVF) search: a CPU
    tensor of more than IVF_THRESHOLD rows.  The fused exact search declines
    there, so that the lazy path keeps its cheaper search."""
    from ..ops.neighbors import IVF_THRESHOLD

    return n > IVF_THRESHOLD and device.type == "cpu"


def _default_curry(est):
    """The estimator's kernel curry is a core whose one parameter is the
    length scale (the JAX package's operand-spec condition)."""
    curry = est.cov_func_curry
    return (
        getattr(curry, "_spec_tag", None) in _SPEC_CORES
        and tuple(getattr(curry, "_spec_params", ())) == ("ls",)
    )


def _landmark_preamble(est, n, k):
    """The landmark bookkeeping on the host: the large-n advisory, the
    uniform-subsample decision and its log, the k-means log and the
    resolved random_state, with the lazy path's messages
    (``compute_landmarks``)."""
    random_state = est._landmark_seed()
    threshold = max(KMEANS_SUBSAMPLE_THRESHOLD, 20 * k)
    n_sub = threshold if n > threshold else None
    if n_sub is not None:
        logger.info(
            f"Running k-means on a uniform subsample of {n_sub:,} of "
            f"{n:,} cells (quantization quality is insensitive to this)."
        )
    logger.info(
        f"Computing {k:,} landmarks with k-means clustering "
        f"(random_state={random_state})."
    )
    return n_sub, random_state


def _landmarks(x, k, n_sub, sub_generator, generator):
    """``compute_landmarks`` on given generators: the uniform subsample,
    k-means++ and Lloyd."""
    x_fit = x
    if n_sub is not None:
        x_fit = x[torch.randperm(x.shape[0], generator=sub_generator, device=x.device)[:n_sub]]
    init_centroids = _kmeanspp_init(x_fit, k, generator)
    return _lloyd(x_fit, init_centroids, k, DEFAULT_N_ITER, min(DEFAULT_ASSIGN_BLOCK, x_fit.shape[0]))


def _length_scale(nn, ls_factor):
    """``compute_ls(nn) * ls_factor`` as a 0-d float64 tensor on nn's
    device: the float32 heuristic widened, times the factor in float64."""
    return torch.exp(torch.log(nn).mean() + 3.0).double() * ls_factor


def _chol_attempt_with_pivot(K, jitter):
    """The jittered Cholesky attempt and the pivoted landmark selection
    that applies where it failed, with no host read: the selection's
    min(m, FUSED_PIVOT_CAP) steps all run, masked from the start where the
    attempt succeeded (pivots 0, r = 0), as ``lax.cond`` selects in the JAX
    package.  Returns (Lp, ok, pivots, r) as tensors, and then the
    selection's L and residual diagonal d, from which a selection that
    reached the cap continues (:func:`_pruned_pivots`)."""
    Lp, ok = _jittered_cholesky(K, jitter)
    cap = min(K.shape[0], FUSED_PIVOT_CAP)
    state = _pivoted_cholesky_masked(K, PIVOT_REL_TOL, cap, active=~ok)
    return Lp, ok, state.piv, state.r, state.L, state.d


def _device_scalar(value, x, dtype=None):
    """A 0-d tensor of ``value`` on x's device (x's dtype by default),
    filled there: no host-to-device copy, which syncs from pageable
    memory."""
    return torch.full((), value, dtype=dtype or x.dtype, device=x.device)


def _pack(*values):
    """The scalars and the pivots the host needs, in one float64 vector
    (every count and index below 2**53 is exact)."""
    return torch.cat([v.reshape(-1).to(torch.float64) for v in values])


def _read_host(packed):
    """The prepare's one host read: the packed vector as Python numbers."""
    profiling.count("host_reads")
    return packed.tolist()


# ---------------------------------------------------------------------------
# the stages: functions of tensors (and the generators they draw from),
# their static arguments bound by partial
# ---------------------------------------------------------------------------


def _sparse_stage(x, d, sub_generator, generator, *, curry, k, n_sub, ls_factor, jitter):
    """Stage 1 of the density (and sparse Nyström) prepare."""
    nn, counts = _nn_repair_impl(knn_distances(x, 1, method="exact")[:, 0])
    mu = torch.quantile(mle(nn, d), 0.01) - 10
    ls = _length_scale(nn, ls_factor)
    xu = _landmarks(x, k, n_sub, sub_generator, generator)
    K = compute_cov_func(curry, ls)(xu, xu)
    Lp, ok, piv, r, L, d_res = _chol_attempt_with_pivot(K, jitter)
    return nn, mu, ls, xu, K, Lp, piv, L, d_res, _pack(counts, mu, ls, ok, r, piv)


def _time_stage(x, group, counts, targets, d, ls_time, sub_generator, generator, *,
                curry, k, n_sub, n_times, normalize, ls_factor, jitter):
    """Stage 1 of the time-sensitive prepare: the within-time 1-NN
    (``compute_nn_distances_within_time_points``), the optional sampling-bias
    normalization, the repair, mu/ls (ls from the raw distances when
    normalizing), landmarks in time-rescaled space
    (``compute_landmarks_rescale_time``) and the product kernel's Cholesky
    attempt."""
    from ..parameters import within_time_augmented

    d_int = x.shape[1] - 1
    x_aug = within_time_augmented(x[:, :-1], group, n_times)
    nn_raw = knn_distances(x_aug, 1, method="exact")[:, 0]
    nn_model = nn_raw
    if normalize:
        nn_model = (counts[group].to(x.dtype) / targets[group]) ** (1 / d_int) * nn_raw
    nn, repair = _nn_repair_impl(nn_model)
    mu = torch.quantile(mle(nn, d), 0.01) - 10
    ls = _length_scale(nn_raw if normalize else nn, ls_factor)
    time_factor = ls / ls_time
    x_rescaled = x.clone()
    x_rescaled[:, -1] *= time_factor
    xu = _landmarks(x_rescaled, k, n_sub, sub_generator, generator)
    xu[:, -1] /= time_factor
    K = compute_cov_func(curry, ls, ls_time)(xu, xu)
    Lp, ok, piv, r, L, d_res = _chol_attempt_with_pivot(K, jitter)
    return nn, mu, ls, xu, K, Lp, piv, L, d_res, _pack(repair, mu, ls, ok, r, piv)


def _dim_stage(x, sub_generator, generator, *, curry, k, k_query, n_sub, ls_factor, jitter):
    """Stage 1 of the dimensionality prepare: the k-NN distances, the
    local fractal dimensions (their own 30-neighbour search, as the lazy
    path runs it), mu_dens/ls (no repair, as the lazy path), the landmarks
    and the Cholesky attempt."""
    from ..ops.neighbors import local_dimensionality

    distances = knn_distances(x, k_query, method="exact")
    nn = distances[:, 0]
    d = local_dimensionality(x)
    mu_dens = torch.quantile(mle(nn, d), 0.01) - 10
    ls = _length_scale(nn, ls_factor)
    xu = _landmarks(x, k, n_sub, sub_generator, generator)
    K = compute_cov_func(curry, ls)(xu, xu)
    Lp, ok, piv, r, L, d_res = _chol_attempt_with_pivot(K, jitter)
    return distances, d, mu_dens, ls, xu, K, Lp, piv, L, d_res, _pack(mu_dens, ls, ok, r, piv)


def _function_stage(x, sub_generator, generator, *, k, n_sub, ls_factor):
    """Stage 1 of the function estimator's prepare: kNN, repair, ls and the
    landmarks (it has no optimizer and no landmark factor here)."""
    nn, counts = _nn_repair_impl(knn_distances(x, 1, method="exact")[:, 0])
    ls = _length_scale(nn, ls_factor)
    xu = _landmarks(x, k, n_sub, sub_generator, generator)
    return nn, ls, xu, _pack(counts, ls)


def _density_target(nn, d, mu):
    return (mle(nn, d) - mu,)


def _dim_targets(nn, d, mu_dim, mu_dens):
    return torch.log(d) - mu_dim, mle(nn, d) - mu_dens


def _warm_start(L, targets):
    """The ridge warm start of each target; stacked where there are two
    (``compute_initial_dimensionalities``)."""
    z = [ridge_solve(L, t, 1.0) for t in targets]
    return z[0] if len(z) == 1 else torch.stack(z)


def _factorize_stage(x, xu, Lp, *operands, curry, n_params, targets):
    """Stage 2 where stage 1's Cholesky succeeded: L = k(x, xu) Lp⁻ᵀ and the
    ridge warm start.  ``operands`` are the kernel's ``n_params``
    parameters (ls, and ls_time for the time model) and then the targets'
    operands."""
    cov = compute_cov_func(curry, *operands[:n_params])
    L = _standard_low_rank(x, cov, xu, Lp=Lp)
    return L, _warm_start(L, targets(*operands[n_params:]))


def _prune_factorize_stage(K, piv, x, xu, *operands, curry, n_params, targets, jitter):
    """Stage 2 on the pivoted subset: the submatrix's Cholesky with the
    lazy chain's jitter escalation (every rung factored, the first that
    succeeds selected on the device), L = k(x, xu[piv]) Lp⁻ᵀ and the ridge
    warm start, with the retries the factor took (read only outside a
    fit; PRUNE_MAX_TRIES + 1 where no rung succeeded)."""
    Lp, tries = escalated_cholesky(K[piv][:, piv], jitter, PRUNE_MAX_TRIES)
    xu_sel = xu[piv]
    cov = compute_cov_func(curry, *operands[:n_params])
    L = _standard_low_rank(x, cov, xu_sel, Lp=Lp)
    return Lp, xu_sel, L, _warm_start(L, targets(*operands[n_params:])), tries


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------


def _generators(device, seeds):
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def _graph_nodes(graph):
    """The node count of a captured graph (libcuda's cuGraphGetNodes)."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count)
    )
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {err}).")
    return int(count.value)


class _StageGraph:
    """One stage captured as a CUDA graph: its static inputs (copied into at
    each replay), its generators (seeded at each replay), the graph, its
    outputs (cloned out at each replay) and the K1 launches it holds."""

    def __init__(self, key, fn, inputs, seeds):
        device = inputs[0].device
        self.key = key
        self.inputs = [t.clone() for t in inputs]
        self.generators = [torch.Generator(device=device) for _ in seeds]
        # the captured graph is kept for its node count
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.generators:
            self.graph.register_generator_state(g)
        for g, s in zip(self.generators, seeds):
            g.manual_seed(int(s))
        start = time.perf_counter()
        with hopper_kernels.captured_launches() as calls, torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs, *self.generators)
        self.kernel_calls = calls
        self.nodes = _graph_nodes(self.graph)
        self.graph.instantiate()
        self.capture_seconds = time.perf_counter() - start
        self.replays = 0

    def replay(self, inputs, seeds):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        for g, s in zip(self.generators, seeds):
            g.manual_seed(int(s))
        self.graph.replay()
        self.replays += 1
        hopper_kernels.count_replay(self.kernel_calls)
        return tuple(t.clone() for t in self.outputs)


def _same_bits(a, b):
    if a.dtype in _BITS:
        return torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))
    return torch.equal(a, b)


def _captures(x, k):
    """True where a prepare of x's cells with k landmarks captures its
    stages: on the card, where an (n, k) factor takes at most
    GRAPH_MEMORY_SHARE of its memory."""
    if x.device.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(x.device).total_memory
    return x.shape[0] * k * x.element_size() <= GRAPH_MEMORY_SHARE * total


def _run(slot, key, fn, inputs, seeds=(), capture=False):
    """``fn(*inputs, *generators)``, the generators seeded with ``seeds``.
    Without ``capture`` it runs eagerly, and on the card the slot's graph
    is dropped.  With it, the graph cached in ``slot`` replays where its
    key is ``key``; else the stage runs eagerly (its result is this
    call's), is captured in place of the slot's graph, and one replay is
    held to the eager run bit for bit."""
    device = inputs[0].device
    if not capture:
        # a stage run eagerly releases the slot's graph and its pool
        _GRAPHS.pop(slot, None)
        return fn(*inputs, *_generators(device, seeds))
    key = (key, tuple((tuple(t.shape), t.dtype, t.device) for t in inputs))
    entry = _GRAPHS.get(slot)
    if entry is not None and entry.key == key:
        return entry.replay(inputs, seeds)
    # release the old graph and its pool before the new one is captured
    _GRAPHS.pop(slot, None)
    eager = fn(*inputs, *_generators(device, seeds))
    entry = _StageGraph(key, fn, inputs, seeds)
    replayed = entry.replay(inputs, seeds)
    differ = [i for i, (a, b) in enumerate(zip(eager, replayed)) if not _same_bits(a, b)]
    if differ:
        raise RuntimeError(
            f"the replayed CUDA graph of the fused {slot} differs from its eager run "
            f"in outputs {differ}."
        )
    _GRAPHS[slot] = entry
    return eager


def graph_stats():
    """One row per cached stage graph: its slot, nodes, K1 launches per
    replay, capture seconds (capture and instantiation, host clock) and
    replays so far."""
    return [
        {"slot": slot, "nodes": g.nodes, "kernel_launches": len(g.kernel_calls),
         "capture_seconds": g.capture_seconds, "replays": g.replays}
        for slot, g in _GRAPHS.items()
    ]


def clear_graphs():
    """Drop every cached stage graph (and its memory pool)."""
    _GRAPHS.clear()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _sparse_declines(est, gp_type):
    return not (
        ENABLED
        and est.nn_distances is None
        and est.mu is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.d is None
        and getattr(est, "d_method", None) == "embedding"
        and est.gp_type == gp_type
        and _default_curry(est)
    )


def _stage_one_sparse(est, x, k):
    """Stage 1 of the density prepares (shared by the sparse and the sparse
    Nyström types) and its host read; sets nn_distances, d, mu, ls and
    cov_func.  Returns (xu, K, Lp, ok, (device pivots, r, their L, the
    residual diagonal), stage outputs)."""
    n, d_int = x.shape
    logger.info("Computing nearest neighbor distances.")
    logger.info(
        f"Using embedding dimensionality d={d_int}. "
        'Use d_method="fractal" to enable effective density normalization.'
    )
    n_sub, random_state = _landmark_preamble(est, n, k)
    curry = est.cov_func_curry
    d = _device_scalar(d_int, x)
    stage = partial(_sparse_stage, curry=curry, k=k, n_sub=n_sub,
                    ls_factor=float(est.ls_factor), jitter=float(est.jitter))
    key = (curry, k, n_sub, float(est.ls_factor), float(est.jitter))
    with profiling.span("prepare.stage1", x.device):
        nn, mu_t, ls_t, xu, K, Lp, piv, L_piv, d_piv, packed = _run(
            "density", key, stage, (x, d), (random_state, random_state), _captures(x, k))
    host = _read_host(packed)
    counts, (mu, ls, ok, r) = host[:4], host[4:8]
    report_nn_repair(*(int(c) for c in counts[:3]), bool(counts[3]))
    est.nn_distances = nn
    est.d = d_int
    est.mu = mu
    est.ls = ls
    est.cov_func = compute_cov_func(curry, ls)
    logger.info("Using covariance function %s.", str(est.cov_func))
    return xu, K, Lp, bool(ok), (piv, int(r), L_piv, d_piv), (d, mu_t, ls_t)


def maybe_fused_sparse_prepare(est):
    """Apply the fused prepare to ``est`` if it is in the default sparse
    configuration.  Returns True when the attributes were set (the lazy
    ``_prepare_attribute`` chain then finds them present and skips), False
    to fall back to the lazy path."""
    if _sparse_declines(est, GaussianProcessType.SPARSE_CHOLESKY):
        return False
    x = est.x
    n, d_int = x.shape
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n, x.device):
        return False  # the lazy kNN takes the IVF search at this scale on the CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False
    xu, K, Lp, ok, pivot, (d, mu_t, ls_t) = _stage_one_sparse(est, x, k)
    est.landmarks = xu
    _finish_sparse_factorization(est, "density", x, xu, K, Lp, ok, pivot, (ls_t,),
                                 (est.nn_distances, d, mu_t), _density_target)
    return True


def _finish_sparse_factorization(est, family, x, xu, K, Lp, ok, pivot, params,
                                 target_operands, targets):
    """Stage 2 of the density, time and dimensionality prepares through
    :func:`_finish_factorization`."""
    curry, n_params, jitter = est.cov_func_curry, len(params), float(est.jitter)
    static = (curry, n_params, targets, jitter)
    capture = _captures(x, xu.shape[0])

    def run_ok(xu_, Lp_):
        stage = partial(_factorize_stage, curry=curry, n_params=n_params, targets=targets)
        with profiling.span("prepare.stage2", x.device):
            return _run(f"{family} factorize", static, stage,
                        (x, xu_, Lp_, *params, *target_operands), capture=capture)

    def run_prune(piv_):
        stage = partial(_prune_factorize_stage, curry=curry, n_params=n_params,
                        targets=targets, jitter=jitter)
        with profiling.span("prepare.stage2", x.device):
            return _run(f"{family} prune factorize", static, stage,
                        (K, piv_, x, xu, *params, *target_operands), capture=capture)

    _finish_factorization(est, x, xu, K, Lp, ok, x.dtype == torch.float64, run_ok, run_prune,
                          pivot=pivot)


def maybe_fused_nystroem_prepare(est):
    """Fused prepare for the ``sparse_nystroem`` configuration above
    NYSTROEM_EXACT_MAX landmarks.

    Stage 1 is the density prepare's (kNN -> heuristics -> k-means ->
    landmark kernel -> Cholesky attempt + pivots), and the same graph.
    Where the landmark kernel is float32-singular the pivoted subset
    prunes the landmarks, as the sparse path does; then H = k(x, xu) Lp⁻ᵀ
    and the mass selection on its Gram run eagerly, as the lazy chain's
    ``_nystroem_L``.  m ≤ NYSTROEM_EXACT_MAX keeps the lazy exact-eigh path.
    """
    from ..ops.linalg import NYSTROEM_EXACT_MAX, _nystroem_select_and_project
    from .base import RANK_FRACTION_THRESHOLD

    if est.check_rank or _sparse_declines(est, GaussianProcessType.SPARSE_NYSTROEM):
        return False
    x = est.x
    n, d_int = x.shape
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n, x.device):
        return False  # the lazy kNN takes the IVF search at this scale on the CPU
    k = int(est.n_landmarks)
    if not NYSTROEM_EXACT_MAX < k < n:
        return False  # small m: exact-eigh lazy path (reference parity)
    xu, K, Lp, ok, pivot, _ = _stage_one_sparse(est, x, k)

    if ok:
        xu_sel, Lp_sel = xu, Lp
    elif x.dtype == torch.float64:
        # float64: no pruning; safe_cholesky raises like the lazy path
        xu_sel = xu
        Lp_sel = safe_cholesky(K, jitter=est.jitter, max_tries=0)
    else:
        piv_sel = _pruned_pivots(K, *pivot)
        xu_sel = xu[piv_sel]
        est.n_landmarks = int(len(piv_sel))
        if est.check_rank is None:
            est.check_rank = False
        Lp_sel = safe_cholesky(K[piv_sel][:, piv_sel], jitter=est.jitter, max_tries=3)
    est.landmarks = xu_sel

    rank = est.rank
    H = _standard_low_rank(x, est.cov_func, xu_sel, Lp=Lp_sel)
    L = _nystroem_select_and_project(H, rank)
    # _compute_L's logging/warning contract for the Nyström types
    new_rank = L.shape[1]
    n_landmarks_now = xu_sel.shape[0]
    if new_rank > (rank * RANK_FRACTION_THRESHOLD * n_landmarks_now):
        logger.warning(
            f"Shallow rank reduction from {n_landmarks_now:,} to "
            f"{new_rank:,} indicates underrepresentation by landmarks. "
            "Consider increasing n_landmarks!"
        )
    logger.info(f"Using rank {new_rank:,} covariance representation.")
    est.L = L
    return True


def maybe_fused_function_prepare(est):
    """Fused prepare for FunctionEstimator in its default sparse
    configuration.  Returns True when applied."""
    if not (
        ENABLED
        and est.nn_distances is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and _default_curry(est)
    ):
        return False
    x = est.x
    n = x.shape[0]
    if _cpu_ivf_applies(n, x.device):
        return False  # the lazy kNN takes the IVF search at this scale on the CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False

    logger.info("Computing nearest neighbor distances.")
    n_sub, random_state = _landmark_preamble(est, n, k)
    stage = partial(_function_stage, k=k, n_sub=n_sub, ls_factor=float(est.ls_factor))
    with profiling.span("prepare.stage1", x.device):
        nn, _, xu, packed = _run("function", (k, n_sub, float(est.ls_factor)), stage, (x,),
                                 (random_state, random_state), _captures(x, k))
    host = _read_host(packed)
    report_nn_repair(*(int(c) for c in host[:3]), bool(host[3]))
    ls = host[4]
    est.nn_distances = nn
    est.ls = ls
    est.cov_func = compute_cov_func(est.cov_func_curry, ls)
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    return True


def maybe_fused_dimensionality_prepare(est):
    """Fused prepare for DimensionalityEstimator in its default sparse
    configuration.  Returns True when applied."""
    if not (
        ENABLED
        and est.distances is None
        and est.nn_distances is None
        and est.d is None
        and est.mu_dens is None
        and est.ls is None
        and est.cov_func is None
        and est.landmarks is None
        and est.Lp is None
        and est.L is None
        and est.initial_value is None
        and est.gp_type == GaussianProcessType.SPARSE_CHOLESKY
        and _default_curry(est)
    ):
        return False
    x = est.x
    n = x.shape[0]
    if _cpu_ivf_applies(n, x.device):
        return False  # the lazy kNN takes the IVF search at this scale on the CPU
    k = int(est.n_landmarks)
    k_query = int(est.k)
    if not 1 < k < n or k_query + 1 >= n or n < 31:
        return False  # tiny inputs: lazy path's validation/warnings apply

    logger.info("Computing distances.")
    n_sub, random_state = _landmark_preamble(est, n, k)
    curry = est.cov_func_curry
    stage = partial(_dim_stage, curry=curry, k=k, k_query=k_query, n_sub=n_sub,
                    ls_factor=float(est.ls_factor), jitter=float(est.jitter))
    key = (curry, k, k_query, n_sub, float(est.ls_factor), float(est.jitter))
    with profiling.span("prepare.stage1", x.device):
        distances, d, mu_t, ls_t, xu, K, Lp, piv, L_piv, d_piv, packed = _run(
            "dimensionality", key, stage, (x,), (random_state, random_state), _captures(x, k))
    mu_dens, ls, ok, r = _read_host(packed)[:4]

    est.distances = distances
    est.nn_distances = distances[:, 0]
    est.d = d
    est.mu_dens = mu_dens
    est.ls = ls
    est.cov_func = compute_cov_func(curry, ls)
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    mu_dim = _device_scalar(float(est.mu_dim), x)
    _finish_sparse_factorization(
        est, "dimensionality", x, xu, K, Lp, bool(ok), (piv, int(r), L_piv, d_piv), (ls_t,),
        (est.nn_distances, d, mu_dim, mu_t), _dim_targets,
    )
    return True


def maybe_fused_time_prepare(est):
    """Fused prepare for TimeSensitiveDensityEstimator when ls_time is
    given and the estimator is otherwise in its default sparse
    configuration.  Returns True when applied."""
    from ..parameters import MAX_ONEHOT_TIME_GROUPS, _get_target_cell_count

    if est.ls_time is None or _sparse_declines(est, GaussianProcessType.SPARSE_CHOLESKY):
        return False
    x = est.x
    n = x.shape[0]
    d_int = x.shape[1] - 1
    if d_int > 50:
        return False  # the lazy path raises the documented d>50 error
    if _cpu_ivf_applies(n, x.device):
        return False  # the lazy kNN takes the IVF search at this scale on the CPU
    k = int(est.n_landmarks)
    if not 1 < k < n:
        return False

    # host-side time bookkeeping (one transfer of the time column)
    t_host = x[:, -1].cpu().numpy()
    unique_np, counts_np = np.unique(t_host, return_counts=True)
    n_times = len(unique_np)
    if n_times > MAX_ONEHOT_TIME_GROUPS or (counts_np < 2).any():
        # many groups: the lazy path's per-group search applies;
        # undersampled time point: the lazy path raises the documented error
        return False
    unique_times = torch.as_tensor(unique_np, device=x.device)
    group = torch.searchsorted(unique_times, x[:, -1].contiguous())
    counts = torch.as_tensor(counts_np, dtype=torch.int64, device=x.device)

    normalize = est.normalize_per_time_point
    do_normalize = normalize is not False and normalize is not None
    av_cells_per_tp = n / n_times
    if do_normalize:
        # the lazy path's validation, before the targets are looked up
        from ..utils.parameter_validation import validate_normalize_parameter

        validate_normalize_parameter(normalize, unique_times)
        targets = [
            float(_get_target_cell_count(normalize, t, av_cells_per_tp, unique_times))
            for t in unique_np.tolist()
        ]
        logger.info(
            "Normalizing nearest neighbor distances correcting sampling "
            f"bias for {n_times:,} different time points."
        )
    else:
        targets = [1.0] * n_times
    targets = torch.tensor(targets, dtype=x.dtype, device=x.device)

    logger.info("Computing nearest neighbor distances within time points.")
    logger.info(
        f"Using embedding dimensionality d={d_int}. "
        'Use d_method="fractal" to enable effective density normalization.'
    )
    if do_normalize:
        logger.info("Computing non-normalized nn_distances for length scale heuristic.")
    n_sub, random_state = _landmark_preamble(est, n, k)

    curry = est.cov_func_curry
    d = _device_scalar(d_int, x)
    ls_time_t = _device_scalar(float(est.ls_time), x, torch.float64)
    stage = partial(_time_stage, curry=curry, k=k, n_sub=n_sub, n_times=n_times,
                    normalize=do_normalize, ls_factor=float(est.ls_factor),
                    jitter=float(est.jitter))
    key = (curry, k, n_sub, n_times, do_normalize, float(est.ls_factor), float(est.jitter))
    with profiling.span("prepare.stage1", x.device):
        nn, mu_t, ls_t, xu, K, Lp, piv, L_piv, d_piv, packed = _run(
            "time", key, stage, (x, group, counts, targets, d, ls_time_t),
            (random_state, random_state), _captures(x, k))
    host = _read_host(packed)
    report_nn_repair(*(int(c) for c in host[:3]), bool(host[3]))
    mu, ls, ok, r = host[4:8]

    est.nn_distances = nn
    est.d = d_int
    est.mu = mu
    est.ls = ls
    est.cov_func = compute_cov_func(curry, ls, float(est.ls_time))
    logger.info("Using covariance function %s.", str(est.cov_func))
    est.landmarks = xu
    _finish_sparse_factorization(est, "time", x, xu, K, Lp, bool(ok),
                                 (piv, int(r), L_piv, d_piv), (ls_t, ls_time_t), (nn, d, mu_t),
                                 _density_target)
    return True


def _pruned_pivots(K, piv, r, L=None, d=None):
    """The pivoted subset of the landmarks: stage 1's pivots where their
    count r stopped below the cap (rounded down to a RANK_BUCKETS power of
    two, as select_stable_landmarks rounds), else select_stable_landmarks'
    selection on K, which continues stage 1's steps where r reached the cap
    and their L and residual diagonal d are given."""
    cap = min(K.shape[0], FUSED_PIVOT_CAP)
    if not 0 < r < cap:
        prefix = (L, d, piv) if r == cap and L is not None else None
        return select_stable_landmarks(K, rel_tol=PIVOT_REL_TOL, prefix=prefix)
    buckets = [b for b in RANK_BUCKETS if b <= r]
    if buckets:
        r = buckets[-1]
    logger.info(
        "Pivoted Cholesky selected %d of %d landmarks (relative tolerance %.0e).",
        r,
        K.shape[0],
        PIVOT_REL_TOL,
    )
    return piv[:r]


def _finish_factorization(est, x, xu, K, Lp, ok, x64, run_ok, run_prune, pivot=None):
    """Stage 2 of the fused prepares: accept the landmark Cholesky attempt,
    or prune to the pivoted subset and run one stage on it.  ``run_ok(xu,
    Lp) -> (L, z0)`` and ``run_prune(piv) -> (Lp, xu_sel, L, z0, ok)`` are
    the family's stage-2 graphs; ``pivot`` is (device pivots, r) from stage
    1, with its L and residual diagonal d after them where r may reach the
    cap (:func:`_pruned_pivots`; None takes select_stable_landmarks)."""
    from .. import config
    from .base import SAMPLE_LANDMARK_RATIO

    n = x.shape[0]
    k = xu.shape[0]
    if ok:
        est.Lp = Lp
        would_check_rank = (
            est.check_rank is None and SAMPLE_LANDMARK_RATIO * k < n
        ) or bool(est.check_rank)
        if would_check_rank:
            # leave L/initial_value to the lazy path so the documented
            # rank-estimation diagnostics run unchanged
            return
        L, z0 = run_ok(xu, Lp)
        est.L = L
        est.initial_value = z0
        logger.info(f"Using rank {k:,} covariance representation.")
        return

    if x64:
        # float64 parity: the lazy path raises through safe_cholesky
        est.Lp = safe_cholesky(K, jitter=est.jitter, max_tries=0)
        return

    if not config.PRUNE_SINGULAR_LANDMARKS:
        # full capacity: every landmark with a float64 factor on the device
        # (the lazy chain's own hook), L and initial_value left to it
        est.Lp = est._lp_accept_or_prune(K, Lp, False)
        return

    piv = _pruned_pivots(K, *(pivot if pivot is not None else (None, 0)))
    logger.warning(
        "Landmark kernel is singular at f32; pruning %d "
        "redundant landmarks (keeping %d).",
        k - len(piv),
        len(piv),
    )
    est.n_landmarks = int(len(piv))
    if est.check_rank is None:
        # rank is known by construction; skip the SVD check
        est.check_rank = False
    if bool(est.check_rank):
        # an explicitly requested rank diagnostic must run in _compute_L:
        # set only the (validated) Cholesky and landmarks and leave
        # L/initial_value lazy
        est.landmarks = xu[piv]
        est.Lp = safe_cholesky(K[piv][:, piv], jitter=est.jitter, max_tries=3)
        return
    Lp2, xu_sel, L, z0, tries = run_prune(piv)
    est.landmarks = xu_sel
    if est.optimizer == "L-BFGS-B" and getattr(est, "_in_fit", False):
        # optimistic (only inside fit, where run_inference follows): the
        # retries are not read here; _run_inference reads them after the
        # optimizer (logging the escalation's warnings then), and a factor
        # no rung gave shows as a non-finite loss, after which it rebuilds
        # from this fallback and retries.  A bare prepare_inference()
        # validates below instead.
        est.Lp = Lp2
        est.L = L
        est.initial_value = z0
        est._fused_lp_fallback = (K, piv, tries)
        logger.info(f"Using rank {len(piv):,} covariance representation.")
        return
    profiling.count("host_reads")
    tries = int(tries)
    if tries <= PRUNE_MAX_TRIES:
        log_escalation(est.jitter, tries)
        est.Lp = Lp2
        est.L = L
        est.initial_value = z0
        logger.info(f"Using rank {len(piv):,} covariance representation.")
    else:
        # no rung factored the submatrix: the lazy chain's float64 rescue
        # (safe_cholesky), L and initial_value left to the lazy chain
        est.Lp = safe_cholesky(K[piv][:, piv], jitter=est.jitter, max_tries=PRUNE_MAX_TRIES)