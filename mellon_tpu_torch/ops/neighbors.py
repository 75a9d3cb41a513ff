"""Exact k-nearest-neighbor search and the local fractal dimension
(counterpart of ``mellon_tpu/ops/neighbors.py``).

Blocked over query rows: each block forms a squared-distance tile against
all of x, picks ``n_cand`` candidates with ``torch.topk`` and re-ranks
them on exact coordinate differences, as the JAX package's
``_knn_blocked`` does.  The JAX package selects candidates with the TPU's
``lax.approx_min_k``, which is exact on the CPU; ``torch.topk`` is exact
everywhere, so the two agree index for index on the CPU.  A hand-written
fused distance + running top-k kernel is ROADMAP kernel K2.  The IVF
search (``knn_ivf``) is not ported.
"""

import logging

import torch

logger = logging.getLogger("mellon_tpu_torch")

DEFAULT_BATCH_SIZE = 1024
# feature-count bound for candidate selection on exact coordinate
# differences; above it the |q|² - 2q·x + |x|² tile selects the candidates
# (the same bound and reasons as the JAX package's EXACT_CAND_DIM_MAX)
EXACT_CAND_DIM_MAX = 16
# query rows per step of local_dimensionality: bounds its (rows, k(k-1)/2, d)
# neighbour-pair differences
LOCAL_DIM_CHUNK_ROWS = 2048


def _sq_dists(qb, x, xn):
    """Squared distances of a query block to all of x, used only to pick
    candidates.  At low d the coordinate-difference form (accumulated per
    dimension so the temporary stays (batch, n)) avoids the cancellation
    of the matmul form on dense data."""
    if x.shape[1] <= EXACT_CAND_DIM_MAX:
        d2 = None
        for j in range(x.shape[1]):
            diff = qb[:, j, None] - x[None, :, j]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return d2
    qn = torch.sum(qb * qb, dim=1, keepdim=True)
    return qn - 2.0 * (qb @ x.T) + xn[None, :]


def knn(x, k, query=None, batch_size=DEFAULT_BATCH_SIZE):
    """The k nearest rows of x for every query row (default: x itself, the
    self-neighbor included).  Returns (distances, indices), each (nq, k),
    ascending by distance."""
    x = x[:, None] if x.ndim == 1 else x
    query = x if query is None else (query[:, None] if query.ndim == 1 else query)
    k = int(k)
    n = x.shape[0]
    if k > n:
        raise ValueError(
            f"k={k} must not exceed the number of database points {n}."
        )
    n_cand = min(max(2 * k + 4, 32), n)
    xn = torch.sum(x * x, dim=1)
    dists, idx = [], []
    for start in range(0, query.shape[0], batch_size):
        qb = query[start : start + batch_size]
        _, cand = torch.topk(_sq_dists(qb, x, xn), n_cand, dim=1, largest=False)
        exact = torch.sqrt(torch.sum(torch.square(qb[:, None, :] - x[cand]), dim=-1))
        vals, order = torch.topk(exact, k, dim=1, largest=False, sorted=True)
        dists.append(vals)
        idx.append(torch.gather(cand, 1, order))
    return torch.cat(dists), torch.cat(idx)


def knn_distances(x, k, batch_size=DEFAULT_BATCH_SIZE):
    """Distances to the k nearest *other* points: ``knn(k + 1)`` with the
    first (self) column dropped, as in ``mellon_tpu/ops/neighbors.py:236``."""
    dists, _ = knn(x, k + 1, batch_size=batch_size)
    return dists[:, 1:]


def nn_distances(x, batch_size=DEFAULT_BATCH_SIZE):
    """Distance to the single nearest neighbor of each point."""
    return knn_distances(x, 1, batch_size=batch_size)[:, 0]


def local_dimensionality(x, k=30, x_query=None, neighbor_idx=None):
    """Local fractal dimension at each query row (default: every row of x):
    the least-squares slope of log(rank) on log(distance) over the
    k(k−1)/2 pairwise distances among its k nearest rows of x (the query
    row itself included, as the reference's tree query does), sorted.
    ``neighbor_idx`` (nq, k) gives the neighbours instead of a search.
    Runs over :data:`LOCAL_DIM_CHUNK_ROWS` query rows at a time."""
    x = x[:, None] if x.ndim == 1 else x
    if k > x.shape[0]:
        logger.warning(
            f"Number of nearest neighbors (k={k}) is greater than the "
            f"number of samples ({x.shape[0]}). Setting k to the number of samples."
        )
        k = x.shape[0]
    if neighbor_idx is None:
        _, neighbor_idx = knn(x, k, query=x if x_query is None else x_query)
    i, j = torch.triu_indices(k, k, offset=1, device=x.device)
    y = torch.log(torch.arange(1, i.numel() + 1, dtype=x.dtype, device=x.device))
    y = y - y.mean()
    slopes = []
    for start in range(0, neighbor_idx.shape[0], LOCAL_DIM_CHUNK_ROWS):
        neighbors = x[neighbor_idx[start : start + LOCAL_DIM_CHUNK_ROWS]]
        pair = torch.linalg.vector_norm(neighbors[:, i] - neighbors[:, j], dim=-1)
        a = torch.log(torch.sort(pair, dim=-1).values)
        a = a - a.mean(dim=-1, keepdim=True)
        slopes.append(torch.sum(a * y, dim=-1) / torch.sum(a * a, dim=-1))
    return torch.cat(slopes)
