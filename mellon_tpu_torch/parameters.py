"""Parameter heuristics of the density main path.

Counterpart of ``mellon_tpu/parameters.py``: the gp_type / n_landmarks /
rank decision tables, landmarks by seeded k-means, k-NN distances, the
d/mu/ls heuristics (with the fractal d), the Cholesky factors and the
ridge warm starts, for every GP type (full, sparse Cholesky, fixed and
the two Nyström types), and the predictor summaries
:func:`compute_density_gradient` and :func:`compute_density_diffusion`.
"""

import logging

import torch

from .ops.cluster import k_means
from .ops.linalg import (
    DEFAULT_SIGMA,
    _full_decomposition_low_rank,
    _full_rank,
    _modified_low_rank,
    _standard_low_rank,
    ridge_solve,
)
from .ops.neighbors import EXACT_CAND_DIM_MAX, knn_distances, local_dimensionality
from .utils.parameter_validation import (
    NORMALIZE_SEQUENCES,
    validate_normalize_parameter,
    validate_params,
)
from .utils.util import DEFAULT_JITTER, GaussianProcessType, ensure_2d, mle
from .utils.validation import (
    validate_float_or_int,
    validate_float_or_iterable_numerical,
    validate_k,
    validate_positive_float,
    validate_positive_int,
    validate_time_x,
)

DEFAULT_N_LANDMARKS = 5000
DEFAULT_RANDOM_SEED = 42
# above this cell count, k-means runs on a uniform subsample
KMEANS_SUBSAMPLE_THRESHOLD = 200_000

logger = logging.getLogger("mellon_tpu_torch")

# the subsample of compute_d_factal
FRACTAL_D_SAMPLES = 500
FRACTAL_D_SEED = 432


def compute_rank(gp_type):
    """Default rank from the GP type."""
    if gp_type in (GaussianProcessType.FULL_NYSTROEM, GaussianProcessType.SPARSE_NYSTROEM):
        return 0.99
    return 1.0


def compute_n_landmarks(gp_type, n_samples, landmarks):
    """Default number of landmarks."""
    if landmarks is not None:
        return landmarks.shape[0]
    if gp_type is None or gp_type == GaussianProcessType.FIXED:
        return min(n_samples, DEFAULT_N_LANDMARKS)
    if gp_type in (GaussianProcessType.FULL, GaussianProcessType.FULL_NYSTROEM):
        return n_samples
    if gp_type in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.SPARSE_NYSTROEM):
        if n_samples <= DEFAULT_N_LANDMARKS:
            logger.warning(
                f"Gaussian Process type {gp_type} and default "
                f"number of landmarks {DEFAULT_N_LANDMARKS:,} < "
                f"number of cells {n_samples:,}. Reduce n_landmarks below "
                f"the number of cells to use {gp_type}."
            )
        return DEFAULT_N_LANDMARKS
    n_landmarks = min(n_samples, DEFAULT_N_LANDMARKS)
    logger.warning(
        f"Unknown Gaussian Process type {gp_type}, using default "
        f"n_landmarks={n_landmarks:,}."
    )
    return n_landmarks


def compute_gp_type(n_landmarks, rank, n_samples):
    """GP-type inference from landmarks/rank/samples."""
    rank = validate_float_or_int(rank, "rank", optional=True)
    n_landmarks = validate_positive_int(n_landmarks, "n_landmarks")
    n_samples = validate_positive_int(n_samples, "n_samples")

    def keeps_full_rank(basis_size):
        return (
            rank is None
            or (isinstance(rank, int) and rank >= basis_size)
            or (isinstance(rank, float) and rank >= 1.0)
            or rank == 0
        )

    if n_landmarks == 0 or n_landmarks >= n_samples:
        if keeps_full_rank(n_samples):
            logger.info(
                "Using non-sparse Gaussian Process since n_landmarks "
                f"({n_landmarks:,}) >= n_samples ({n_samples:,}) and rank = {rank}."
            )
            return GaussianProcessType.FULL
        logger.info(
            "Using full Gaussian Process with Nyström rank reduction since "
            f"n_landmarks ({n_landmarks:,}) >= n_samples ({n_samples:,}) "
            f"and rank = {rank}."
        )
        return GaussianProcessType.FULL_NYSTROEM
    if keeps_full_rank(n_landmarks):
        logger.info(
            "Using sparse Gaussian Process since n_landmarks "
            f"({n_landmarks:,}) < n_samples ({n_samples:,}) and rank = {rank}."
        )
        return GaussianProcessType.SPARSE_CHOLESKY
    logger.info(
        "Using sparse Gaussian Process with improved Nyström rank reduction "
        f"since n_landmarks ({n_landmarks:,}) < n_samples ({n_samples:,}) "
        f"and rank = {rank}."
    )
    return GaussianProcessType.SPARSE_NYSTROEM


def compute_landmarks(x, gp_type=None, n_landmarks=DEFAULT_N_LANDMARKS, random_state=DEFAULT_RANDOM_SEED):
    """Landmarks as seeded k-means centroids on x's device."""
    if n_landmarks == 0:
        return None
    n = x.shape[0]
    x = ensure_2d(x)
    if n_landmarks <= 1:
        raise ValueError(
            f"n_landmarks must be 0 (disabled) or greater than 1, got {n_landmarks}."
        )
    if n_landmarks >= n:
        if gp_type == GaussianProcessType.FIXED:
            logger.info(
                f"Gaussian process type is {gp_type} and "
                f"n_landmarks={n_landmarks:,} requested while only {n:,} "
                f"datapoints are available. Using all {n:,} datapoints as landmarks."
            )
            return x
        return None
    seed = random_state if random_state is not None else DEFAULT_RANDOM_SEED
    x_fit = x
    n_sub = max(KMEANS_SUBSAMPLE_THRESHOLD, 20 * n_landmarks)
    if n > n_sub:
        generator = torch.Generator(device=x.device).manual_seed(int(seed))
        idx = torch.randperm(n, generator=generator, device=x.device)[:n_sub]
        x_fit = x[idx]
        logger.info(
            f"Running k-means on a uniform subsample of {n_sub:,} of "
            f"{n:,} cells (quantization quality is insensitive to this)."
        )
    logger.info(
        f"Computing {n_landmarks:,} landmarks with k-means clustering "
        f"(random_state={random_state})."
    )
    return k_means(x_fit, n_landmarks, random_state=seed)


def compute_distances(x, k, seed=DEFAULT_RANDOM_SEED):
    """Distances to the k nearest other points of each row of x, (n, k),
    ascending.  The search is exact; ``seed`` is accepted for the JAX
    package's signature."""
    x = ensure_2d(x)
    n_samples = x.shape[0]
    if n_samples == 0:
        message = "Input data x is empty."
        logger.error(message)
        raise ValueError(message)
    validate_k(k, n_samples)
    return knn_distances(x, k)


def compute_nn_distances(x):
    """Distance to the nearest other point of each row of x."""
    return compute_distances(x, 1)[:, 0]


def compute_d(x):
    """Embedding dimensionality."""
    if x.ndim < 2:
        return 1
    return x.shape[1]


def compute_d_factal(x, k=10, n=FRACTAL_D_SAMPLES, seed=FRACTAL_D_SEED):
    """Mean local fractal dimension over ``n`` cells drawn without
    replacement (all cells where there are at most ``n``).  The draw comes
    from a ``torch.Generator`` seeded with ``seed``: torch cannot repeat
    JAX's threefry stream, so above ``n`` cells the subsample, and with it
    the mean, differs from the JAX package's."""
    if x.ndim < 2:
        return 1
    x_query = x
    if n < x.shape[0]:
        generator = torch.Generator(device=x.device).manual_seed(int(seed))
        x_query = x[torch.randperm(x.shape[0], generator=generator, device=x.device)[:n]]
    return float(local_dimensionality(x, k=k, x_query=x_query).mean())


def compute_mu(nn_distances, d):
    """1st percentile of the nearest-neighbor MLE, minus 10."""
    return float(torch.quantile(mle(nn_distances, d), 0.01) - 10)


def compute_ls(nn_distances):
    """Geometric-mean nearest-neighbor distance times e³."""
    return float(torch.exp(torch.log(nn_distances).mean() + 3.0))


def compute_cov_func(cov_func_curry, ls, ls_time=None):
    """Kernel from its curry and the length scale; with ``ls_time``, the
    space × time product kernel: the state columns at ``ls`` times the
    last (time) column at ``ls_time``."""
    if ls_time is not None:
        return cov_func_curry(ls=ls, active_dims=slice(None, -1)) * cov_func_curry(
            ls=ls_time, active_dims=-1
        )
    return cov_func_curry(ls=ls)


def compute_landmarks_rescale_time(
    x, ls, ls_time, times=None, n_landmarks=DEFAULT_N_LANDMARKS, random_state=DEFAULT_RANDOM_SEED
):
    """Landmarks by k-means in (state, time) space with the time column
    scaled by ls / ls_time, so that both kernels' length scales weigh
    alike; the landmarks' time column is scaled back."""
    if n_landmarks == 0:
        return None
    ls = validate_positive_float(ls, "ls")
    ls_time = validate_positive_float(ls_time, "ls_time")
    x = validate_time_x(x, times).clone()
    time_factor = ls / ls_time
    x[:, -1] *= time_factor
    landmarks = compute_landmarks(x, n_landmarks=n_landmarks, random_state=random_state)
    if landmarks is not None:
        landmarks[:, -1] /= time_factor
    return landmarks


def _get_target_cell_count(normalize, time, av_cells_per_tp, unique_times):
    """The target cell count of time point ``time`` (a float) under
    ``normalize``: the average for True, else its entry."""
    if isinstance(normalize, bool):
        return av_cells_per_tp
    if isinstance(normalize, dict):
        return normalize[time]
    return normalize[unique_times.tolist().index(time)]


# above this many time points the within-time 1-NN distances run one
# search per time point
MAX_ONEHOT_TIME_GROUPS = 64


def within_time_augmented(states, group, n_times):
    """The states with columns that keep every cell's nearest neighbours
    within its time group, for one search over all cells.

    At most EXACT_CAND_DIM_MAX − 1 state dimensions: one column
    C·group, C² above every within-group squared distance; within a group
    it subtracts to exactly 0, so the distances are those of a search per
    group, and across groups they are at least C.  Above that the search
    selects candidates by the |x|² − 2x·y + |y|² form, and a one-hot of
    the group, scaled alike, keeps the norms' inflation the same in every
    group."""
    span2 = torch.sum(torch.square(states.max(dim=0).values - states.min(dim=0).values))
    if states.shape[1] + 1 <= EXACT_CAND_DIM_MAX:
        offset = 4.0 * torch.sqrt(torch.clamp_min(span2, 1.0))
        return torch.cat([states, (offset * group.to(states.dtype))[:, None]], dim=1)
    big = 16.0 * torch.clamp_min(span2, 1.0)
    onehot = torch.nn.functional.one_hot(group, n_times).to(states.dtype)
    return torch.cat([states, torch.sqrt(big / 2.0) * onehot], dim=1)


def compute_nn_distances_within_time_points(x, times=None, d=None, normalize=False):
    """1-NN distances of each cell within its time point, optionally
    scaled by (cells at its time / target cells) ** (1/d) to correct the
    sampling bias between time points (``normalize``: True for the
    average count, or a target per time point as a dict, list, array or
    tensor)."""
    x = validate_time_x(x, times)
    unique_times = torch.unique(x[:, -1])
    n_cells = x.shape[0]
    n_times = unique_times.shape[0]
    av_cells_per_tp = n_cells / n_times
    validate_normalize_parameter(normalize, unique_times)
    normalizing = normalize is not False and normalize is not None
    if normalizing:
        d = validate_float_or_iterable_numerical(d, "d", optional=False, positive=True)
        if isinstance(d, torch.Tensor):
            if d.ndim > 0 and len(d) != n_cells:
                raise ValueError(
                    f"If `d` (length={len(d):,}) is a vector then it needs to have "
                    f"one value per cell in x (x.shape[0]={n_cells:,})."
                )
            d = d.to(device=x.device, dtype=x.dtype)
        logger.info(
            "Normalizing nearest neighbor distances correcting sampling bias "
            f"for {n_times:,} different time points."
        )
    states = x[:, :-1]
    group = torch.searchsorted(unique_times, x[:, -1].contiguous())
    counts = torch.bincount(group, minlength=n_times)
    for time, count in zip(unique_times.tolist(), counts.tolist()):
        if count < 2:
            raise ValueError(
                f"Insufficient data: Only {int(count)} sample(s) found at "
                f"time point {time}. Nearest neighbors cannot be computed "
                "with less than two samples per time point. Please confirm if "
                "you have provided the correct time axis. If the time points "
                "indeed have very few samples, consider aggregating nearby "
                "time points for better results, or you may specify "
                "`nn_distances` manually."
            )
    if n_times <= MAX_ONEHOT_TIME_GROUPS:
        nn_distances = compute_nn_distances(within_time_augmented(states, group, n_times))
    else:
        nn_distances = states.new_zeros(n_cells)
        for i in range(n_times):
            mask = group == i
            nn_distances[mask] = compute_nn_distances(states[mask])
    if normalizing:
        targets = torch.tensor(
            [
                float(_get_target_cell_count(normalize, t, av_cells_per_tp, unique_times))
                for t in unique_times.tolist()
            ],
            dtype=x.dtype,
            device=x.device,
        )
        factor = (counts[group].to(x.dtype) / targets[group]) ** (1 / d)
        nn_distances = factor * nn_distances
    return nn_distances


def compute_Lp(x, cov_func, gp_type=None, landmarks=None, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """Cholesky factor Lp of the landmark covariance, or of the full
    covariance k(x, x) for the full GP type; None for the Nyström types,
    which factor in :func:`compute_L`."""
    x = ensure_2d(x)
    n_samples = x.shape[0]
    if landmarks is None:
        landmarks = x
        n_landmarks = n_samples
    else:
        landmarks = ensure_2d(landmarks)
        n_landmarks = landmarks.shape[0]
    gp_type = GaussianProcessType.from_string(gp_type, optional=True)
    if gp_type is None:
        gp_type = compute_gp_type(n_landmarks, 1.0, n_samples)
    if gp_type in (GaussianProcessType.FULL_NYSTROEM, GaussianProcessType.SPARSE_NYSTROEM):
        return None
    if gp_type == GaussianProcessType.FULL:
        logger.info("Computing Lp.")
        return _full_rank(x, cov_func, sigma=sigma, jitter=jitter)
    return _full_rank(landmarks, cov_func, sigma=sigma, jitter=jitter)


def validate_compute_L_input(x, cov_func, gp_type, landmarks, Lp, rank, sigma, jitter):
    """The checked inputs of :func:`compute_L`: ``(x, landmarks,
    n_landmarks, n_samples, gp_type, rank)``.  Lp must be (n, n) for the
    full type and (m, m) for the sparse-Cholesky and fixed types."""
    jitter = validate_positive_float(jitter, "jitter")
    rank = validate_float_or_int(rank, "rank", optional=True)
    n_samples = x.shape[0]
    n_landmarks = n_samples if landmarks is None else landmarks.shape[0]
    gp_type = GaussianProcessType.from_string(gp_type, optional=True)
    if rank is None:
        rank = compute_rank(gp_type)
    if gp_type is None:
        gp_type = compute_gp_type(n_landmarks, rank, n_samples)
    validate_params(rank, gp_type, n_samples, n_landmarks, landmarks)
    if gp_type == GaussianProcessType.FULL:
        size, what = n_samples, "samples"
    elif gp_type in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED):
        size, what = n_landmarks, "landmarks"
    else:
        size = None
    if size is not None and Lp is not None and tuple(Lp.shape) != (size, size):
        message = f" Wrong shape of Lp {tuple(Lp.shape)} for {gp_type} and {size:,} {what}."
        logger.error(message)
        raise ValueError(message)
    x = ensure_2d(x)
    if landmarks is not None:
        landmarks = ensure_2d(landmarks)
    return x, landmarks, n_landmarks, n_samples, gp_type, rank


def compute_L(x, cov_func, gp_type=None, landmarks=None, Lp=None, rank=None, sigma=DEFAULT_SIGMA, jitter=DEFAULT_JITTER):
    """Transformation L with L Lᵀ ≈ K: the Cholesky factor of k(x, x) for
    the full type (Lp itself where given), L = k(x, xu) Lp⁻ᵀ for the
    sparse-Cholesky and fixed types, the truncated eigendecomposition of
    k(x, x) for the full Nyström type and the improved Nyström factor for
    the sparse one (``rank``: the eigenpairs or eigenvalue mass kept)."""
    x, landmarks, _, _, gp_type, rank = validate_compute_L_input(
        x, cov_func, gp_type, landmarks, Lp, rank, sigma, jitter
    )
    if gp_type == GaussianProcessType.FULL:
        if Lp is None:
            return _full_rank(x, cov_func, sigma=sigma, jitter=jitter)
        return Lp
    if gp_type == GaussianProcessType.FULL_NYSTROEM:
        return _full_decomposition_low_rank(x, cov_func, rank=rank, sigma=sigma, jitter=jitter)
    if gp_type == GaussianProcessType.SPARSE_NYSTROEM:
        return _modified_low_rank(x, cov_func, landmarks, rank=rank, sigma=sigma, jitter=jitter)
    return _standard_low_rank(x, cov_func, landmarks, Lp=Lp, sigma=sigma, jitter=jitter)


def compute_initial_value(nn_distances, d, mu, L):
    """Ridge warm start: z minimizing ||Lz + mu - mle||² + ||z||²."""
    target = mle(nn_distances, d) - mu
    return ridge_solve(L, target, 1.0)


def compute_average_cell_count(x, normalize):
    """Cells per time point for the time predictor's normalization: the
    average over the data for a bool or None, else the average of the
    targets."""
    n_unique_times = torch.unique(x[:, -1]).shape[0]
    if normalize is None or isinstance(normalize, bool):
        return x.shape[0] / n_unique_times
    if isinstance(normalize, dict):
        return sum(normalize.values()) / n_unique_times
    if isinstance(normalize, NORMALIZE_SEQUENCES):
        return float(sum(float(v) for v in normalize)) / len(normalize)
    raise ValueError(f"Unrecognized type for 'normalize': {type(normalize)}")


def compute_time_derivatives(predictor, x, times=None):
    """d/dt of a time predictor at (x, times); zeros for a predictor
    without time."""
    if hasattr(predictor, "time_derivative"):
        return predictor.time_derivative(x, times)
    return torch.zeros(x.shape[0], dtype=predictor.dtype, device=predictor.device)


def compute_density_gradient(predictor, x, times=None):
    """The predictor's gradient at x (at (x, times) for a time predictor)."""
    if hasattr(predictor, "time_derivative"):
        return predictor.gradient(x, times)
    return predictor.gradient(x)


def compute_density_diffusion(predictor, x, times=None):
    """(sign, log|det|) of the predictor's Hessian at each point of x (at
    (x, times) for a time predictor)."""
    if hasattr(predictor, "time_derivative"):
        return predictor.hessian_log_determinant(x, times)
    return predictor.hessian_log_determinant(x)


def compute_initial_dimensionalities(x, mu_dim, mu_dens, L, nn_distances, d):
    """The dimensionality model's warm start, (2, k): the ridge fits of
    log d − mu_dim and of the density's MLE target."""
    d = torch.as_tensor(d, dtype=L.dtype, device=L.device)
    target = torch.log(d) - mu_dim
    if target.numel() == 1:
        target = target.reshape(()).expand(L.shape[0])
    initial_dims = ridge_solve(L, target, 1.0)
    initial_dens = compute_initial_value(nn_distances, d, mu_dens, L)
    return torch.stack([initial_dims, initial_dens])
