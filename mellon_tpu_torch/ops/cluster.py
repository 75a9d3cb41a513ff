"""Seeded k-means for landmark selection (counterpart of ``mellon_tpu/ops/cluster.py``).

k-means++ seeding draws on the device with ``torch.multinomial`` from a
``torch.Generator``, so the k sequential draws make no host round trip.
torch cannot reproduce JAX's threefry stream: the same seed gives other
centroids than the JAX package, of comparable quality.  Hand-written
assignment/update kernels are ROADMAP kernel K3.
"""

import torch

DEFAULT_N_ITER = 30
DEFAULT_ASSIGN_BLOCK = 4096


def _assign(x, centroids, block_size):
    """Nearest-centroid index per row of x, in row blocks of the
    ``|c|² - 2x·cᵀ`` form (the per-row |x|² cannot change the argmin)."""
    cn = torch.sum(centroids * centroids, dim=1)
    return torch.cat(
        [
            torch.argmin(cn[None, :] - 2.0 * (x[s : s + block_size] @ centroids.T), dim=1)
            for s in range(0, x.shape[0], block_size)
        ]
    )


def _kmeanspp_init(x, k, generator):
    """k-means++ seeding: k sequential D²-weighted draws, each one distance
    pass over x."""
    n, d = x.shape
    first = x[torch.randint(n, (1,), generator=generator, device=x.device)]
    centers = torch.empty((k, d), dtype=x.dtype, device=x.device)
    centers[0] = first[0]
    d2 = torch.sum(torch.square(x - first), dim=1)
    for i in range(1, k):
        idx = torch.multinomial(torch.clamp_min(d2, 1e-30), 1, generator=generator)
        c = x[idx]
        centers[i] = c[0]
        d2 = torch.minimum(d2, torch.sum(torch.square(x - c), dim=1))
    return centers


def _lloyd(x, init_centroids, k, n_iter, block_size):
    """``n_iter`` Lloyd steps; an empty cluster keeps its centroid."""
    centroids = init_centroids
    ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        idx = _assign(x, centroids, block_size)
        sums = torch.zeros_like(centroids).index_add_(0, idx, x)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, idx, ones)
        centroids = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), centroids
        )
    return centroids


def k_means(x, k, n_iter=DEFAULT_N_ITER, random_state=0, block_size=DEFAULT_ASSIGN_BLOCK):
    """Seeded k-means++ and Lloyd, returning the (k, d) centroids."""
    x = x[:, None] if x.ndim == 1 else x
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} must not exceed the number of points {n}.")
    generator = torch.Generator(device=x.device).manual_seed(int(random_state))
    init_centroids = _kmeanspp_init(x, int(k), generator)
    return _lloyd(x, init_centroids, int(k), int(n_iter), int(min(block_size, n)))
