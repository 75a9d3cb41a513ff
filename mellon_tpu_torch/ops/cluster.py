"""Seeded k-means for landmark selection (counterpart of ``mellon_tpu/ops/cluster.py``).

k-means++ seeding draws on the device from a ``torch.Generator``: each of
the k sequential D²-weighted draws is ``torch.multinomial``'s one-sample
draw written out (:func:`_weighted_draw`), which gives the same index for
the same generator state without the validity checks that
``torch.multinomial`` reads back on the host, so the draws make no host
round trip and can be captured in a CUDA graph; ``init="random"`` takes k
distinct rows from the same generator.  torch
cannot reproduce JAX's threefry stream: the same seed gives other
centroids than the JAX package, of comparable quality.  Hand-written
assignment/update kernels are ROADMAP kernel K3.

The same seed gives the same centroids on every run: Lloyd's update sorts
the points by cluster and sums each cluster's in that order, where a
scatter-add (``index_add_``) would add them in the order of the card's
float atomics (``scripts/cluster_sums_bench.py`` times both and a one-hot
product).
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


def _weighted_draw(weights, generator):
    """One index drawn with probability proportional to ``weights`` (1-d,
    non-negative, not all 0), as a one-element tensor on their device:
    argmax(w / q) with q ~ Exp(1), the form ``torch.multinomial(weights, 1,
    generator=generator)`` computes (the same draws for the same generator
    state), without its host-side checks of the weights."""
    q = torch.empty_like(weights).exponential_(1, generator=generator)
    return torch.argmax(weights / q, dim=-1, keepdim=True)


def _kmeanspp_init(x, k, generator):
    """k-means++ seeding: k sequential D²-weighted draws, each one distance
    pass over x."""
    n, d = x.shape
    first = x[torch.randint(n, (1,), generator=generator, device=x.device)]
    centers = torch.empty((k, d), dtype=x.dtype, device=x.device)
    centers[0] = first[0]
    d2 = torch.sum(torch.square(x - first), dim=1)
    for i in range(1, k):
        idx = _weighted_draw(torch.clamp_min(d2, 1e-30), generator)
        c = x[idx]
        centers[i] = c[0]
        d2 = torch.minimum(d2, torch.sum(torch.square(x - c), dim=1))
    return centers


def _cluster_sums(x_ones, idx, k):
    """Per-cluster sums of the rows of ``x_ones`` (x with a column of
    ones, whose sum is the count), (k, d + 1): the rows in a stable sort
    by cluster, then one segment sum per cluster, which adds its rows in
    that order (an empty cluster sums to 0).  Deterministic on the card."""
    sorted_idx, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(sorted_idx, torch.arange(k + 1, device=idx.device))
    return torch.segment_reduce(x_ones[order], "sum", offsets=offsets, axis=0, unsafe=True)


def _lloyd(x, init_centroids, k, n_iter, block_size):
    """``n_iter`` Lloyd steps; an empty cluster keeps its centroid."""
    centroids = init_centroids
    x_ones = torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)
    for _ in range(n_iter):
        idx = _assign(x, centroids, block_size)
        sums_counts = _cluster_sums(x_ones, idx, k)
        sums, counts = sums_counts[:, :-1], sums_counts[:, -1:]
        centroids = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centroids)
    return centroids


def k_means(x, k, n_iter=DEFAULT_N_ITER, random_state=0, block_size=DEFAULT_ASSIGN_BLOCK,
            init="k-means++"):
    """Seeded Lloyd k-means returning the (k, d) centroids.  ``init``:
    ``"k-means++"`` (D²-weighted seeding, sklearn's default) or
    ``"random"`` (k distinct rows drawn uniformly: cheaper for a large k,
    as in the IVF search's coarse quantizer)."""
    x = x[:, None] if x.ndim == 1 else x
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} must not exceed the number of points {n}.")
    generator = torch.Generator(device=x.device).manual_seed(int(random_state))
    if init == "k-means++":
        init_centroids = _kmeanspp_init(x, int(k), generator)
    elif init == "random":
        init_centroids = x[torch.randperm(n, generator=generator, device=x.device)[: int(k)]]
    else:
        raise ValueError(f"Unknown k-means init method: {init}")
    return _lloyd(x, init_centroids, int(k), int(n_iter), int(min(block_size, n)))
