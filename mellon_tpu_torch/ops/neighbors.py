"""k-nearest-neighbor search and the local fractal dimension
(counterpart of ``mellon_tpu/ops/neighbors.py``).

:func:`knn` is exact and blocked over query rows: each block forms a
squared-distance tile against x, picks ``n_cand`` candidates with
``torch.topk`` and re-ranks them on exact coordinate differences, as the
JAX package's ``_knn_blocked`` does.  Past ``col_block`` database rows the
tile is formed one column strip at a time with a running merge of the
candidates, so memory stays O(batch x col_block).  The JAX package selects
candidates with the TPU's ``lax.approx_min_k``, which is exact on the CPU;
``torch.topk`` is exact everywhere, so the two agree index for index on
the CPU.  A hand-written fused distance + running top-k kernel is ROADMAP
kernel K2.

:func:`knn_ivf` is the cluster-pruned approximate search (IVF): a coarse
k-means quantizer, a padded table of each cell's points, and per query the
``n_probe`` nearest cells searched exactly.  :func:`knn_distances` takes it
with ``method="ivf"``, and ``"auto"`` picks it only for a CPU tensor above
:data:`IVF_THRESHOLD` rows, as the JAX package picks it only on its CPU
backend: on the card the exact search stays the default.
"""

import logging

import torch

from ..utils.util import distance
from .cluster import _assign, k_means

logger = logging.getLogger("mellon_tpu_torch")

DEFAULT_BATCH_SIZE = 1024
# feature-count bound for candidate selection on exact coordinate
# differences; above it the |q|² - 2q·x + |x|² tile selects the candidates
# (the same bound and reasons as the JAX package's EXACT_CAND_DIM_MAX)
EXACT_CAND_DIM_MAX = 16
# database rows per distance strip: bounds the (batch, cols) tile to
# batch·cols·4 bytes (4 GB at the default batch in float32) before the
# column strips are streamed
DEFAULT_COL_BLOCK = 1 << 20
# above this many rows, knn_distances(method="auto") on a CPU tensor takes
# the IVF search (the JAX package's threshold for its CPU backend)
IVF_THRESHOLD = 500_000
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


def _candidates(qb, x, xn, n_cand, col_block):
    """Indices (batch, n_cand) of the smallest candidate distances of a
    query block, over strips of ``col_block`` columns of x (one strip up to
    ``col_block`` rows), each strip's smallest ``n_cand`` merged with the
    running ones (``mellon_tpu/ops/neighbors.py:115-150``).  The last strip
    is cut at n where the JAX package pads it with +inf columns: it offers
    at most its own width, which is all that the padding lets through."""
    run_d2 = run_idx = None
    for start in range(0, x.shape[0], col_block):
        d2 = _sq_dists(qb, x[start : start + col_block], xn[start : start + col_block])
        vals, local = torch.topk(d2, min(n_cand, d2.shape[1]), dim=1, largest=False)
        if run_d2 is not None:
            vals = torch.cat([run_d2, vals], dim=1)
            local = torch.cat([run_idx, start + local], dim=1)
            vals, pos = torch.topk(vals, n_cand, dim=1, largest=False)
            local = torch.gather(local, 1, pos)
        run_d2, run_idx = vals, local
    return run_idx


def knn(x, k, query=None, batch_size=DEFAULT_BATCH_SIZE, col_block=DEFAULT_COL_BLOCK):
    """The k nearest rows of x for every query row (default: x itself, the
    self-neighbor included).  Returns (distances, indices), each (nq, k),
    ascending by distance.  Past ``col_block`` rows of x the candidates
    are picked over column strips of that many rows."""
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
        cand = _candidates(qb, x, xn, n_cand, int(col_block))
        exact = torch.sqrt(torch.sum(torch.square(qb[:, None, :] - x[cand]), dim=-1))
        vals, order = torch.topk(exact, k, dim=1, largest=False, sorted=True)
        dists.append(vals)
        idx.append(torch.gather(cand, 1, order))
    return torch.cat(dists), torch.cat(idx)


def knn_distances(x, k, batch_size=DEFAULT_BATCH_SIZE, method="auto"):
    """Distances to the k nearest *other* points, (n, k): ``knn(k + 1)``
    with the first (self) column dropped.  ``method="ivf"`` forces
    :func:`knn_ivf`; ``"auto"`` takes it for a CPU tensor of more than
    :data:`IVF_THRESHOLD` rows (the JAX package's CPU backend), else the
    exact search, which any other value forces
    (``mellon_tpu/ops/neighbors.py:212-237``)."""
    x = x[:, None] if x.ndim == 1 else x
    if method == "ivf" or (
        method == "auto" and x.device.type == "cpu" and x.shape[0] > IVF_THRESHOLD
    ):
        logger.info("Using cluster-pruned (IVF) kNN for %s points.", f"{x.shape[0]:,}")
        return knn_ivf(x, k)[0]
    dists, _ = knn(x, k + 1, batch_size=batch_size)
    return dists[:, 1:]


def nn_distances(x, batch_size=DEFAULT_BATCH_SIZE, method="auto"):
    """Distance to the single nearest neighbor of each point."""
    return knn_distances(x, 1, batch_size=batch_size, method=method)[:, 0]


def _ivf_quantizer(x, n_clusters, seed):
    """The IVF search's coarse quantizer: random-init k-means (10 Lloyd
    steps) on min(n, 100,000) rows drawn without replacement, both from
    ``seed``.  For a quantizer of thousands of cells k-means++'s sequential
    seeding costs more than it buys."""
    n = x.shape[0]
    generator = torch.Generator(device=x.device).manual_seed(int(seed))
    sub = torch.randperm(n, generator=generator, device=x.device)[: min(n, 100_000)]
    return k_means(x[sub], n_clusters, n_iter=10, random_state=seed, init="random")


def _ivf_table(assign, n_clusters):
    """The (n_clusters, cap) table of each cell's point ids in a stable
    sort by cell, padded with the sentinel id n; cap = min(largest cell,
    8 × the average cell), and the points of a cell past the cap are left
    out.  Returns (table, cap, the number left out)."""
    n = assign.shape[0]
    order = torch.sort(assign, stable=True).indices
    assign_sorted = assign[order]
    counts = torch.bincount(assign, minlength=n_clusters)
    cap = int(min(int(counts.max()), 8 * max(n // n_clusters, 1)))
    n_truncated = int(torch.clamp_min(counts - cap, 0).sum())
    if n_truncated > 0:
        logger.info(
            "IVF table truncates %s points in oversized clusters (cap %d per cluster).",
            f"{n_truncated:,}", cap,
        )
    offsets = torch.cumsum(counts, 0) - counts
    rank_within = torch.arange(n, device=assign.device) - offsets[assign_sorted]
    keep = rank_within < cap
    table = torch.full((n_clusters * cap,), n, dtype=torch.int64, device=assign.device)
    table[assign_sorted[keep] * cap + rank_within[keep]] = order[keep]
    return table.reshape(n_clusters, cap), cap, n_truncated


def _smallest(v, k):
    """The k smallest entries of each row of v, ascending, and their
    positions; equal entries in the order of their positions, as
    ``lax.top_k`` gives them (duplicate cells tie)."""
    pos = torch.argsort(v, dim=1, stable=True)[:, :k]
    return torch.gather(v, 1, pos), pos


def _ivf_search(qb, centroids, table, x_padded, k, n_probe):
    """The k + 1 nearest table entries of each query row of a block among
    its ``n_probe`` nearest cells, exact on coordinate differences, with a
    running merge over the probes; missing entries are the sentinel id at
    +inf."""
    _, probe = _smallest(distance(qb, centroids), n_probe)
    run_d = qb.new_full((qb.shape[0], k + 1), float("inf"))
    run_idx = torch.full_like(run_d, x_padded.shape[0] - 1, dtype=torch.int64)
    for j in range(n_probe):
        cand = table[probe[:, j]]                                    # (B, cap)
        exact = torch.sqrt(torch.sum(torch.square(qb[:, None, :] - x_padded[cand]), dim=-1))
        exact = torch.where(torch.isfinite(exact), exact, torch.inf)
        vals, local = _smallest(exact, k + 1)
        run_d, pos = _smallest(torch.cat([run_d, vals], dim=1), k + 1)
        run_idx = torch.gather(torch.cat([run_idx, torch.gather(cand, 1, local)], dim=1), 1, pos)
    return run_d, run_idx


def knn_ivf(x, k, n_clusters=None, n_probe=8, batch_size=512, seed=0):
    """Cluster-pruned approximate k nearest neighbors (IVF) of every row of
    x, the self column dropped: (distances, indices), each (n, k).

    The rows are quantized into ``n_clusters`` k-means cells (default
    max(n // 256, 16)); each query searches only its ``n_probe`` nearest
    cells, exactly on coordinate differences.  A cell holds at most 8 ×
    the average cell in the table: a point past that is found by no query,
    not even its own, whose "1-NN" is then its second neighbour
    (``mellon_tpu/ops/neighbors.py:253-374``).  Indices past the probed
    cells' points are the sentinel n at distance +inf."""
    x = x[:, None] if x.ndim == 1 else x
    n, dim = x.shape
    if n_clusters is None:
        n_clusters = max(n // 256, 16)
    n_probe = min(n_probe, n_clusters)
    centroids = _ivf_quantizer(x, n_clusters, seed)
    table, _, _ = _ivf_table(_assign(x, centroids, 4096), n_clusters)
    x_padded = torch.cat([x, x.new_full((1, dim), float("inf"))])
    dists, idx = zip(*(
        _ivf_search(x[s : s + batch_size], centroids, table, x_padded, int(k), int(n_probe))
        for s in range(0, n, batch_size)
    ))
    return torch.cat(dists)[:, 1:], torch.cat(idx)[:, 1:]


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
