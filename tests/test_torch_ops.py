"""kNN, k-means and the landmark linear algebra of mellon_tpu_torch against
mellon_tpu, on the same numpy inputs at float64."""

import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import clustered, t64, to_np
from mellon_tpu.ops import cluster as jcluster
from mellon_tpu.ops import linalg as jlinalg
from mellon_tpu.ops import neighbors as jneighbors
from mellon_tpu.ops.kernels import Matern52 as JMatern52
from mellon_tpu.utils import validation as jvalidation
from mellon_tpu_torch.ops import cluster, linalg, neighbors
from mellon_tpu_torch.ops.kernels import Matern52
from mellon_tpu_torch.utils import profiling, validation
from torch.utils._python_dispatch import TorchDispatchMode


class _HostReads(TorchDispatchMode):
    """Counts reads of a tensor value on the host (``.item()``, ``int()``,
    indexing with a 0-d tensor): each is a device sync on the card."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("d", [4, 20])
def test_knn_matches_jax(d):
    """Both sides of the d <= 16 candidate rule.  The JAX search is exact
    on the CPU, so indices match one for one and distances to rtol 1e-12."""
    x = clustered(600, d, seed=1)
    dj, ij = jneighbors.knn(jnp.asarray(x), 3, batch_size=256)
    dt, it = neighbors.knn(t64(x), 3, batch_size=256)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=1e-12)
    np.testing.assert_allclose(
        to_np(neighbors.nn_distances(t64(x))),
        np.asarray(jneighbors.nn_distances(jnp.asarray(x))),
        rtol=1e-12,
    )


def test_nn_repair_on_duplicates_matches_jax(caplog):
    """Duplicated cells have a 0 nearest-neighbor distance; both packages
    replace it by the smallest valid distance and warn."""
    x = clustered(300, 3, seed=2)
    x[10] = x[11]
    x[50] = x[51]
    nn_j = jvalidation.validate_nn_distances(jneighbors.nn_distances(jnp.asarray(x)))
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        nn_t = validation.validate_nn_distances(neighbors.nn_distances(t64(x)))
    assert "4 invalid values" in caplog.text
    assert float(nn_t.min()) > 0
    np.testing.assert_allclose(to_np(nn_t), np.asarray(nn_j), rtol=1e-12)
    with pytest.raises(ValueError, match="All 3"):
        validation.validate_nn_distances(torch.zeros(3, dtype=torch.float64))


def test_lloyd_matches_jax_from_same_init():
    """Lloyd iterations from the same initial centroids: 1e-10 (only the
    summation order of the centroid means differs)."""
    x = clustered(1500, 5, seed=3)
    init = x[np.random.RandomState(4).choice(1500, 40, replace=False)]
    cj = jcluster._lloyd(jnp.asarray(x), jnp.asarray(init), 40, 10, 512)
    ct = cluster._lloyd(t64(x), t64(init), 40, 10, 512)
    np.testing.assert_allclose(to_np(ct), np.asarray(cj), rtol=0, atol=1e-10)


def _inertia(x, c):
    return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())


def test_k_means_inertia_within_ten_percent_of_jax():
    """End-to-end k-means++ and Lloyd: the random draws differ (threefry vs
    torch's generator), so the bar is the inertia, within 10% of JAX's."""
    x = clustered(2000, 5, seed=5, n_clusters=12)
    cj = np.asarray(jcluster.k_means(jnp.asarray(x), 60, random_state=0))
    ct = to_np(cluster.k_means(t64(x), 60, random_state=0))
    assert ct.shape == (60, 5)
    ij, it = _inertia(x, cj), _inertia(x, ct)
    assert abs(it - ij) <= 0.10 * ij, (it, ij)


def _landmark_gram(m, seed, ls):
    xu = clustered(m, 3, seed=seed, n_clusters=5, spread=0.05)
    return xu, np.asarray(JMatern52(ls=ls)(jnp.asarray(xu), jnp.asarray(xu)))


@pytest.mark.parametrize("max_rank", [None, 100])
def test_pivoted_cholesky_matches_jax(max_rank, monkeypatch):
    """Same pivots, the same stopping step and the same RANK_BUCKETS
    round-down on the same K; the host check every PIVOT_CHUNK steps (made
    small here so the check binds mid-run) changes nothing."""
    monkeypatch.setattr(linalg, "PIVOT_CHUNK", 7)
    _, K = _landmark_gram(400, seed=6, ls=1.0)
    cap = 400 if max_rank is None else max_rank
    pj, rj, Lj = jlinalg._pivoted_cholesky(jnp.asarray(K), 1e-6, cap)
    pt, rt, Lt = linalg._pivoted_cholesky(t64(K), 1e-6, cap)
    assert rt == int(rj)
    np.testing.assert_array_equal(to_np(pt)[:rt], np.asarray(pj)[:rt])
    np.testing.assert_allclose(to_np(Lt), np.asarray(Lj), rtol=0, atol=1e-10)
    sj = jlinalg.select_stable_landmarks(jnp.asarray(K), max_rank=max_rank)
    st = linalg.select_stable_landmarks(t64(K), max_rank=max_rank)
    assert 64 <= rt and len(st) == max(b for b in linalg.RANK_BUCKETS if b <= rt)
    np.testing.assert_array_equal(to_np(st), np.asarray(sj))


def _ranked_gram(m, rank, dtype, seed=0):
    """A PSD m x m gram of rank ``rank`` (A Aᵀ), or of full rank (I plus
    a tenth of one) where ``rank`` is m."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((m, rank), dtype=torch.float64, generator=gen) / rank**0.5
    K = A @ A.T if rank < m else torch.eye(m, dtype=torch.float64) + 0.1 * A @ A.T / m
    return K.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m, rank, binds", [(1100, 1100, 1), (2100, 1800, 1), (2100, 2100, 2)])
def test_continued_selection_equals_a_run_from_scratch(m, rank, binds, dtype):
    """The selection runs each step once and continues where the JAX
    package's cap of 1,024 doubles (binding once, or twice at 2,100 full
    rank): its pivots, count and RANK_BUCKETS bucket are those of one run
    from scratch to the final cap, and its steps number the count's chunks
    only."""
    K = _ranked_gram(m, rank, dtype)
    profiling.start()
    try:
        piv = linalg.select_stable_landmarks(K, quantize=False)
    finally:
        profiling.stop()
    steps = profiling.take()["counters"]["pivot.steps"]
    r = len(piv)
    caps = [c for c in (1024, 2048) if c <= r] + [m]
    cap = next(c for c in (1024, 2048, m) if r < c or c == m)
    assert len(caps) - 1 == binds and abs(r - rank) <= 0.05 * rank
    pt, rt, _ = linalg._pivoted_cholesky(K, linalg.PIVOT_REL_TOL, cap)
    assert rt == r and torch.equal(piv, pt[:r])
    assert steps == min(m, (r // linalg.PIVOT_CHUNK + 1) * linalg.PIVOT_CHUNK)
    bucket = max(b for b in linalg.RANK_BUCKETS if b <= r)
    assert torch.equal(linalg.select_stable_landmarks(K), pt[:bucket])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1000, 1100])
def test_pruned_pivots_continue_stage_one(m, dtype, monkeypatch):
    """Where stage 1's Cholesky attempt fails and its in-graph pivots reach
    their cap, ``_pruned_pivots`` continues from their L and residual
    diagonal: the landmarks ``select_stable_landmarks`` keeps from scratch,
    with only the steps past the cap run (none where the cap is m)."""
    from mellon_tpu_torch.models import fused

    K = _ranked_gram(m, m, dtype, seed=1)
    monkeypatch.setattr(fused, "_jittered_cholesky",
                        lambda K, jitter: (K * torch.nan, torch.tensor(False)))
    _, ok, piv, r, L, d = fused._chol_attempt_with_pivot(K, 1e-6)
    cap = min(m, fused.FUSED_PIVOT_CAP)
    assert not bool(ok) and int(r) == cap and L.shape == (m, cap)
    profiling.start()
    try:
        got = fused._pruned_pivots(K, piv, int(r), L, d)
    finally:
        profiling.stop()
    assert profiling.take()["counters"].get("pivot.steps", 0) == m - cap
    assert torch.equal(got, linalg.select_stable_landmarks(K))


@pytest.mark.parametrize("m, rank", [(1100, 1100), (2100, 1800), (2100, 2100)])
def test_continued_selection_matches_jax(m, rank, monkeypatch):
    """Where the JAX package's cap of 1,024 binds (once at 1,100 and at
    2,100 of rank 1,800, twice at 2,100 of full rank) it runs the
    selection again from step 0 at each doubled cap; the port continues
    it, from scratch and from stage 1's state at its cap
    (``_pruned_pivots``).  On the same float64 K both keep the same
    pivots, count and RANK_BUCKETS round-down."""
    from mellon_tpu_torch.models import fused

    K = _ranked_gram(m, rank, torch.float64)
    sj = np.asarray(jlinalg.select_stable_landmarks(jnp.asarray(to_np(K)), quantize=False))
    assert len(sj) == rank
    np.testing.assert_array_equal(to_np(linalg.select_stable_landmarks(K, quantize=False)), sj)
    monkeypatch.setattr(fused, "_jittered_cholesky",
                        lambda K, jitter: (K * torch.nan, torch.tensor(False)))
    _, ok, piv, r, L, d = fused._chol_attempt_with_pivot(K, 1e-6)
    assert not bool(ok) and int(r) == fused.FUSED_PIVOT_CAP
    bucket = max(b for b in linalg.RANK_BUCKETS if b <= rank)
    np.testing.assert_array_equal(to_np(fused._pruned_pivots(K, piv, int(r), L, d)), sj[:bucket])


def test_safe_cholesky_flag_semantics_match_jax():
    """An indefinite K gives a NaN factor and ok=False on both sides, and
    raises without escalation; a PSD K factors to rtol 1e-12."""
    K = np.array([[1.0, 2.0], [2.0, 1.0]])
    Lj, okj = jlinalg._jittered_cholesky(jnp.asarray(K), jnp.asarray(1e-6))
    Lt, okt = linalg._jittered_cholesky(t64(K), 1e-6)
    assert not bool(okj) and not bool(okt)
    assert np.isnan(np.asarray(Lj)).any() and torch.isnan(Lt).all()
    for safe, arr in ((jlinalg.safe_cholesky, jnp.asarray), (linalg.safe_cholesky, t64)):
        with pytest.raises(ValueError, match="not positively definite"):
            safe(arr(K), jitter=1e-6, max_tries=0)
    _, Kp = _landmark_gram(30, seed=7, ls=0.5)
    np.testing.assert_allclose(
        to_np(linalg.safe_cholesky(t64(Kp), 1e-6)),
        np.asarray(jlinalg.safe_cholesky(jnp.asarray(Kp), 1e-6)),
        rtol=1e-12,
        atol=1e-12,
    )


def test_safe_cholesky_f32_rescue_gives_a_factor():
    """At f32 the ladder ends in a float64 factorization on the device: a
    lower-triangular f32 factor that reproduces K to its jitter."""
    _, K = _landmark_gram(200, seed=8, ls=30.0)
    Kf = t64(K).float()
    assert not bool(linalg._jittered_cholesky(Kf, 1e-6)[1])
    L = linalg.safe_cholesky(Kf, jitter=1e-6, max_tries=1)
    assert L.dtype == torch.float32 and torch.isfinite(L).all()
    assert torch.equal(L, torch.tril(L))
    assert float((L @ L.T - Kf).abs().max()) < 1e-3


def test_whitening_and_ridge_match_jax():
    """L = k(x, xu) Lp⁻ᵀ and the ridge warm start at rtol 1e-10."""
    x = clustered(300, 4, seed=9)
    xu = x[::6]
    Kj = JMatern52(ls=2.0)
    Lpj = jlinalg._full_rank(jnp.asarray(xu), Kj)
    Lj = jlinalg._standard_low_rank(jnp.asarray(x), Kj, jnp.asarray(xu), Lpj)
    Lpt = linalg._full_rank(t64(xu), Matern52(ls=2.0))
    np.testing.assert_allclose(to_np(Lpt), np.asarray(Lpj), rtol=1e-10, atol=1e-13)
    Lt = linalg._standard_low_rank(t64(x), Matern52(ls=2.0), t64(xu), Lpt)
    np.testing.assert_allclose(to_np(Lt), np.asarray(Lj), rtol=1e-10, atol=1e-12)
    target = np.random.RandomState(10).randn(300)
    np.testing.assert_allclose(
        to_np(linalg.ridge_solve(Lt, t64(target), 1.0)),
        np.asarray(jlinalg.ridge_solve(Lj, jnp.asarray(target), 1.0)),
        rtol=1e-10,
        atol=1e-12,
    )


def test_sequential_loops_read_the_host_rarely():
    """The pivoted Cholesky reads its stopping rule once per PIVOT_CHUNK
    steps and k-means++ draws without any host read, so neither loop
    syncs the card per step."""
    _, K = _landmark_gram(400, seed=6, ls=1.0)
    with _HostReads() as reads:
        _, r, _ = linalg._pivoted_cholesky(t64(K), 1e-6, 400)
    assert r > 2 * linalg.PIVOT_CHUNK
    assert reads.n <= math.ceil(r / linalg.PIVOT_CHUNK) + 2
    x = t64(clustered(500, 4, seed=16))
    with _HostReads() as reads:
        cluster._kmeanspp_init(x, 50, torch.Generator().manual_seed(0))
    assert reads.n == 0
