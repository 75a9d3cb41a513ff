"""mellon_tpu_torch's kNN and k-means surface against mellon_tpu's: k-means
with a random init, the column-streamed exact search, the cluster-pruned
IVF search and the ``method=`` dispatch of the distance helpers.

The same numpy inputs go through both packages on the CPU in float64.
The IVF tests hand the port the JAX package's coarse quantizer (built by
JAX's own steps), through a monkeypatched ``neighbors._ivf_quantizer``:
torch cannot draw JAX's threefry stream.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import clustered, t64, to_np
from mellon_tpu import parameters as jparameters
from mellon_tpu.ops import cluster as jcluster
from mellon_tpu.ops import neighbors as jneighbors
from mellon_tpu_torch import parameters
from mellon_tpu_torch.ops import cluster, neighbors


def jax_quantizer(x, n_clusters, seed=0):
    """The JAX package's IVF quantizer by its own steps
    (``mellon_tpu/ops/neighbors.py:278-287``)."""
    n = x.shape[0]
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, shape=(min(n, 100_000),), replace=False)
    return np.asarray(jcluster.k_means(jnp.asarray(x)[idx], n_clusters, n_iter=10,
                                       random_state=seed, init="random"))


def hand_in(monkeypatch, centroids):
    """The port's IVF search takes ``centroids`` as its quantizer."""
    monkeypatch.setattr(neighbors, "_ivf_quantizer", lambda x, n_clusters, seed: t64(centroids))


def assert_ivf_matches_jax(x, k, **kwargs):
    """knn_ivf of both packages on x: equal indices (the sentinel n
    included), distances to 1e-12 (+inf where JAX's are).  Returns the
    port's (distances, indices) as numpy."""
    dj, ij = (np.asarray(a) for a in jneighbors.knn_ivf(jnp.asarray(x), k, **kwargs))
    dt, it = (to_np(a) for a in neighbors.knn_ivf(t64(x), k, **kwargs))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12)
    return dt, it


# --- k-means with a random init ------------------------------------------


def test_lloyd_from_jax_random_init_matches_jax():
    """From the rows JAX's init="random" draws (jax.random.choice without
    replacement), the port's Lloyd steps give JAX's centroids to 1e-12."""
    x = clustered(1500, 5, seed=30)
    init = x[np.asarray(jax.random.choice(jax.random.PRNGKey(7), 1500, shape=(40,), replace=False))]
    cj = jcluster._lloyd(jnp.asarray(x), jnp.asarray(init), 40, 10, 512)
    ct = cluster._lloyd(t64(x), t64(init), 40, 10, 512)
    np.testing.assert_allclose(to_np(ct), np.asarray(cj), rtol=0, atol=1e-12)


def test_random_init_takes_distinct_rows_per_seed():
    """init="random" (no Lloyd step) gives k distinct rows of x, the same
    rows for a seed, other rows for another seed."""
    x = t64(clustered(500, 3, seed=31))
    c = cluster.k_means(x, 20, n_iter=0, random_state=3, init="random")
    rows = torch.cdist(c, x).argmin(dim=1)
    assert torch.equal(c, x[rows]) and rows.unique().numel() == 20
    assert torch.equal(c, cluster.k_means(x, 20, n_iter=0, random_state=3, init="random"))
    assert not torch.equal(c, cluster.k_means(x, 20, n_iter=0, random_state=4, init="random"))
    full = cluster.k_means(x, 20, random_state=3, init="random")
    assert full.shape == (20, 3) and bool(torch.isfinite(full).all())


def test_unknown_init_raises_as_jax():
    x = clustered(100, 2, seed=32)
    with pytest.raises(ValueError, match="Unknown k-means init method: forgy"):
        jcluster.k_means(jnp.asarray(x), 5, init="forgy")
    with pytest.raises(ValueError, match="Unknown k-means init method: forgy"):
        cluster.k_means(t64(x), 5, init="forgy")


# --- the column-streamed exact search ------------------------------------


@pytest.mark.parametrize("col_block", [64, 333])
@pytest.mark.parametrize("d", [4, 20])
def test_knn_col_block_matches_jax_and_single_strip(d, col_block):
    """Both sides of EXACT_CAND_DIM_MAX, 1,000 rows in strips of 64 (a
    ragged 40-column tail) or 333 (a 1-column tail), query blocks of 256:
    indices equal to JAX's streamed search, distances to 1e-12; and equal
    to the port's single-strip call (tests/test_ops.py:323's check)."""
    x = clustered(1000, d, seed=33)
    dj, ij = jneighbors.knn(jnp.asarray(x), 5, batch_size=256, col_block=col_block)
    dt, it = neighbors.knn(t64(x), 5, batch_size=256, col_block=col_block)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=1e-12)
    d1, i1 = neighbors.knn(t64(x), 5, batch_size=256)
    assert torch.equal(it, i1)
    assert torch.equal(dt, d1)


def test_knn_col_block_with_query():
    """A query apart from the database, streamed against one strip: the
    same neighbours (float64, exact equality)."""
    x, q = clustered(700, 6, seed=34), clustered(90, 6, seed=35)
    d1, i1 = neighbors.knn(t64(x), 4, query=t64(q))
    d2, i2 = neighbors.knn(t64(x), 4, query=t64(q), col_block=100)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


# --- the IVF search ------------------------------------------------------


def test_knn_ivf_matches_jax(monkeypatch):
    """3,000 x 4 normal points, 48 cells, 8 probes, k = 3, JAX's quantizer
    handed in: JAX's distances to 1e-12 and its indices."""
    x = np.random.RandomState(36).randn(3000, 4)
    hand_in(monkeypatch, jax_quantizer(x, 48))
    dt, _ = assert_ivf_matches_jax(x, 3, n_clusters=48, n_probe=8)
    assert np.isfinite(dt).all()


def test_knn_ivf_truncating_cap_matches_jax(monkeypatch, caplog):
    """1,500 copies of one cell beside 1,500 normal points: JAX's random
    init puts many identical centroids on the copies, the first takes them
    all, and the table keeps 8 x the average (496) of them; the port logs
    the JAX package's truncation message, and both give the same ties in
    the same order."""
    rng = np.random.RandomState(37)
    x = np.concatenate([np.full((1500, 4), 5.0), rng.randn(1500, 4)])
    hand_in(monkeypatch, jax_quantizer(x, 48))
    with caplog.at_level(logging.INFO, logger="mellon_tpu_torch"):
        dt, _ = assert_ivf_matches_jax(x, 3, n_clusters=48, n_probe=8)
    assert ("IVF table truncates 1,004 points in oversized clusters (cap 496 per cluster)"
            in caplog.text)
    assert np.isfinite(dt).all()


def test_knn_ivf_truncated_point_reports_its_second_neighbour(monkeypatch):
    """A point left out of its cell's table is found by no query, its own
    included, and the dropped first column is then its nearest point in
    the table: its reported "1-NN" is its second, in both packages alike
    (the reference's behaviour, ROADMAP Queue 3).  A dense cell of 1,500
    distinct points beside 500 spread ones, one probe, on one centroid per
    population handed to both packages (16 cells, cap 8 x 125 = 1,000):
    every point of the dense cell reports the 2nd and 3rd smallest of its
    distances to the table's 1,000 points (1e-12), so a kept point its
    nearest other and a left-out point its second."""
    rng = np.random.RandomState(38)
    blob = 0.05 * rng.randn(1500, 3)
    spread = 4.0 + rng.rand(500, 3) * 6.0
    x = np.concatenate([blob, spread])
    centroids = np.concatenate([np.zeros((1, 3)), jax_quantizer(spread, 15)])
    hand_in(monkeypatch, centroids)
    monkeypatch.setattr(jcluster, "k_means", lambda *args, **kwargs: jnp.asarray(centroids))
    dt, it = assert_ivf_matches_jax(x, 2, n_clusters=16, n_probe=1)
    # the table keeps the cell's first 1,000 ids (a stable sort by cell)
    to_table = np.sort(np.sqrt(((blob[:, None] - blob[None, :1000]) ** 2).sum(-1)), axis=1)
    np.testing.assert_allclose(dt[:1500], to_table[:, 1:3], rtol=1e-12)
    assert (it[:1500] < 1000).all()
    left_out = slice(1000, 1500)
    assert (dt[left_out, 0] > to_table[left_out, 0]).all()
    exact = to_np(neighbors.knn_distances(t64(x), 1))[:, 0]
    assert (dt[left_out, 0] > exact[left_out]).all()


def test_knn_ivf_sentinel_where_probed_cells_are_short(monkeypatch):
    """200 points in 100 cells, one probe, k = 3: cells of fewer than 4
    points leave the sentinel id n at +inf, as in JAX."""
    x = np.random.RandomState(39).randn(200, 3)
    hand_in(monkeypatch, jax_quantizer(x, 100))
    dt, it = assert_ivf_matches_jax(x, 3, n_clusters=100, n_probe=1)
    assert (it == 200).any() and np.isinf(dt[it == 200]).all()
    assert np.isfinite(dt[it < 200]).all()


def test_knn_ivf_own_quantizer_recall():
    """The port's own quantizer at tests/test_ops.py:261's bars: recall
    over the 3 columns > 0.97, the 1-NN column > 0.999 (atol 1e-9)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(22), (3000, 4)))
    exact = to_np(neighbors.knn_distances(t64(x), 3))
    ivf, idx = neighbors.knn_ivf(t64(x), 3, n_clusters=48, n_probe=8)
    assert ivf.shape == idx.shape == (3000, 3)
    assert np.mean(np.isclose(to_np(ivf), exact, atol=1e-9)) > 0.97
    assert np.mean(np.isclose(to_np(ivf)[:, 0], exact[:, 0], atol=1e-9)) > 0.999


# --- method= dispatch -----------------------------------------------------


@pytest.fixture
def low_threshold(monkeypatch):
    """IVF_THRESHOLD at 1,000 in both packages; the port's IVF spied on."""
    monkeypatch.setattr(jneighbors, "IVF_THRESHOLD", 1000)
    monkeypatch.setattr(neighbors, "IVF_THRESHOLD", 1000)
    calls = []
    ivf = neighbors.knn_ivf

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return ivf(*args, **kwargs)

    monkeypatch.setattr(neighbors, "knn_ivf", spy)
    return calls


def test_auto_above_threshold_matches_jax(monkeypatch, low_threshold):
    """"auto" on 1,500 CPU rows takes IVF in both packages (JAX's CPU
    backend, the port's CPU tensor) and gives JAX's distances (1e-12)."""
    x = clustered(1500, 4, seed=40)
    hand_in(monkeypatch, jax_quantizer(x, 16))
    got = to_np(neighbors.knn_distances(t64(x), 2))
    want = np.asarray(jneighbors.knn_distances(jnp.asarray(x), 2))
    assert low_threshold == [1500]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_exact_and_ivf_are_forced(monkeypatch, low_threshold):
    """"exact" above the threshold is the exact search; "ivf" below it is
    the IVF search; any other value is exact, as in JAX."""
    x = clustered(1500, 4, seed=41)
    hand_in(monkeypatch, jax_quantizer(x, 16))
    exact = to_np(neighbors.knn(t64(x), 3)[0][:, 1:])
    np.testing.assert_array_equal(to_np(neighbors.knn_distances(t64(x), 2, method="exact")), exact)
    np.testing.assert_array_equal(to_np(neighbors.knn_distances(t64(x), 2, method="other")), exact)
    assert low_threshold == []
    small = x[:600]
    hand_in(monkeypatch, jax_quantizer(small, 16))
    got = to_np(neighbors.knn_distances(t64(small), 2, method="ivf"))
    want = np.asarray(jneighbors.knn_distances(jnp.asarray(small), 2, method="ivf"))
    assert low_threshold == [600]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_nn_distances_and_compute_nn_distances_pass_through(monkeypatch, low_threshold):
    """nn_distances(method=) and compute_nn_distances(seed=) reach the
    same search as JAX's (IVF above the threshold, exact when forced),
    1e-12."""
    x = clustered(1200, 3, seed=42)
    hand_in(monkeypatch, jax_quantizer(x, 16))
    for method in ("auto", "ivf", "exact"):
        np.testing.assert_allclose(
            to_np(neighbors.nn_distances(t64(x), method=method)),
            np.asarray(jneighbors.nn_distances(jnp.asarray(x), method=method)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        to_np(parameters.compute_nn_distances(t64(x), seed=9)),
        np.asarray(jparameters.compute_nn_distances(jnp.asarray(x), seed=9)), rtol=0, atol=1e-12)
    assert low_threshold == [1200, 1200, 1200]
