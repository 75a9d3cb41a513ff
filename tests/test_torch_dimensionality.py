"""mellon_tpu_torch's DimensionalityEstimator, its loss and the local
dimensionality against mellon_tpu: the same seeded numpy inputs through
both packages, float64 on the CPU, the sparse fits on the JAX package's
k-means landmarks.  The loss, its gradient and the heuristics agree to
1e-10; the L-BFGS fits to corr >= 0.99999 and max |Δ| <= 1e-3 of the
spread, as tests/test_torch_slice.py holds the density fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu.inference import losses as jl
from mellon_tpu.inference.laplace import hessian_diagonal as jax_hessian_diagonal
from mellon_tpu.inference.optimizers import minimize_adam as jax_minimize_adam
from mellon_tpu.ops.neighbors import local_dimensionality as jax_local_dimensionality
from mellon_tpu_torch.inference import losses as tl
from mellon_tpu_torch.inference.optimizers import minimize_adam_value_and_grad
from mellon_tpu_torch.ops.neighbors import local_dimensionality

TOL = 1e-10


def _problem(seed):
    """A small dimensionality loss: L (n, m), unsorted k-NN distances and
    latents z (2, m)."""
    rng = np.random.RandomState(seed)
    n, m, k = 60, 12, 10
    L = 0.3 * rng.randn(n, m)
    distances = rng.rand(n, k) + 0.05
    z = 0.3 * rng.randn(2, m)
    return L, distances, z, 0.5, -1.0


def _agreement(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / np.ptp(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(seed):
    """The loss (with the JAX package's prior constant, k = z.shape[0] = 2)
    and its analytic gradient against jax.value_and_grad of
    mellon_tpu's dimensionality_loss, to 1e-10 (relative for the loss's
    thousands)."""
    L, dist, z, mu_dim, mu_dens = _problem(seed)
    want, want_grad = jax.value_and_grad(jl.dimensionality_loss)(
        jnp.asarray(z), jnp.asarray(L), jnp.asarray(dist), mu_dim, mu_dens
    )
    value_and_grad = tl.make_dimensionality_value_and_grad(t64(L), t64(dist), mu_dim, mu_dens)
    got, grad = value_and_grad(t64(z).reshape(-1))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(to_np(grad), np.asarray(want_grad).reshape(-1), rtol=0, atol=TOL)
    got2 = tl.dimensionality_loss(t64(z), t64(L), t64(dist), mu_dim, mu_dens)
    np.testing.assert_allclose(float(got2), float(want), rtol=TOL)


def test_hessian_diagonal_closed_form():
    """The closed-form Hessian diagonal against torch autograd's full
    Hessian of the batched loss (1e-10) and against mellon_tpu's chunked
    HVPs (1e-9 of its largest value: JAX's second derivative of gammaln,
    the trigamma, is off by up to 1.6e-10 from scipy's at these
    arguments, where torch's is off by 1e-15)."""
    L, dist, z, mu_dim, mu_dens = _problem(2)
    got = tl.dimensionality_hessian_diagonal(t64(z).reshape(-1), t64(L), t64(dist), mu_dim, mu_dens)
    loss_batch = tl.make_dimensionality_loss_batch(t64(L), t64(dist), mu_dim, mu_dens)
    H = torch.autograd.functional.hessian(lambda v: loss_batch(v[None])[0], t64(z).reshape(-1))
    np.testing.assert_allclose(to_np(got), to_np(torch.diagonal(H)), rtol=0, atol=TOL)
    want = np.asarray(jax_hessian_diagonal(
        jl.dimensionality_loss, jnp.asarray(z),
        loss_args=(jnp.asarray(L), jnp.asarray(dist), mu_dim, mu_dens),
    )).reshape(-1)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_hessian_diagonal_chunks_rows(monkeypatch):
    """Row chunks of L sum to the unchunked diagonal."""
    L, dist, z, mu_dim, mu_dens = _problem(3)
    args = (t64(z).reshape(-1), t64(L), t64(dist), mu_dim, mu_dens)
    whole = tl.dimensionality_hessian_diagonal(*args)
    monkeypatch.setattr(tl, "HESSIAN_CHUNK_ROWS", 7)
    np.testing.assert_allclose(to_np(tl.dimensionality_hessian_diagonal(*args)), to_np(whole), rtol=1e-13)


def test_loss_batch_and_closure_match_jax():
    """The batched loss (ADVI's) at each of four latent vectors, and the
    closure loss_func and transform, against mellon_tpu to 1e-10
    relative."""
    L, dist, z, mu_dim, mu_dens = _problem(4)
    args = (jnp.asarray(L), jnp.asarray(dist), mu_dim, mu_dens)
    Z = 0.3 * np.random.RandomState(5).randn(4, 2 * L.shape[1])
    want = [float(jl.dimensionality_loss(jnp.asarray(v.reshape(2, -1)), *args)) for v in Z]
    got = tl.make_dimensionality_loss_batch(t64(L), t64(dist), mu_dim, mu_dens)(t64(Z))
    np.testing.assert_allclose(to_np(got), want, rtol=TOL)
    jt = jl.compute_dimensionality_transform(mu_dim, mu_dens, jnp.asarray(L))
    tt = tl.compute_dimensionality_transform(mu_dim, mu_dens, t64(L))
    for a, b in zip(tt(t64(z)), jt(jnp.asarray(z))):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=TOL)
    jf = jl.compute_dimensionality_loss_func(jnp.asarray(dist), jt, 2)
    tf = tl.compute_dimensionality_loss_func(t64(dist), tt, 2)
    np.testing.assert_allclose(float(tf(t64(z))), float(jf(jnp.asarray(z))), rtol=TOL)


def test_adam_matches_jax():
    """30 adam steps on the dimensionality loss from the same latents: to
    1e-8 relative, as the density's adam."""
    L, dist, z, mu_dim, mu_dens = _problem(6)
    want = jax_minimize_adam(
        jl.dimensionality_loss, jnp.asarray(z), n_iter=30,
        loss_args=(jnp.asarray(L), jnp.asarray(dist), mu_dim, mu_dens),
    )
    got = minimize_adam_value_and_grad(
        tl.make_dimensionality_value_and_grad(t64(L), t64(dist), mu_dim, mu_dens),
        t64(z).reshape(-1), n_iter=30,
    )
    np.testing.assert_allclose(
        to_np(got.pre_transformation), np.asarray(want.pre_transformation).reshape(-1),
        rtol=1e-8, atol=1e-12,
    )


@pytest.mark.parametrize("case", ["all cells", "query rows", "given neighbours"])
def test_local_dimensionality_matches_jax(case):
    """The local fractal dimension (30 neighbours, the log-log slope over
    their 435 pair distances) at every cell, at query rows, and from given
    neighbour indices, to 1e-10."""
    x = clustered(200, 4, seed=11, spread=1.0)
    if case == "all cells":
        want = jax_local_dimensionality(jnp.asarray(x))
        got = local_dimensionality(t64(x))
    elif case == "query rows":
        q = x[::7]
        want = jax_local_dimensionality(jnp.asarray(x), k=10, x_query=jnp.asarray(q))
        got = local_dimensionality(t64(x), k=10, x_query=t64(q))
    else:
        idx = np.argsort(((x[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :12]
        want = jax_local_dimensionality(jnp.asarray(x), k=12, neighbor_idx=jnp.asarray(idx))
        got = local_dimensionality(t64(x), k=12, neighbor_idx=torch.tensor(idx))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=TOL)


def test_local_dimensionality_chunks_rows(monkeypatch):
    """Query chunks give the unchunked result."""
    from mellon_tpu_torch.ops import neighbors

    x = t64(clustered(150, 3, seed=12))
    whole = local_dimensionality(x)
    monkeypatch.setattr(neighbors, "LOCAL_DIM_CHUNK_ROWS", 16)
    np.testing.assert_allclose(to_np(local_dimensionality(x)), to_np(whole), rtol=0, atol=0)


def test_heuristics_match_jax():
    """compute_distances (k = 10) and the (2, m) warm start of
    compute_initial_dimensionalities, to 1e-10."""
    from mellon_tpu import parameters as jp
    from mellon_tpu_torch import parameters as tp

    x = clustered(150, 3, seed=13, spread=1.0)
    dj = jp.compute_distances(jnp.asarray(x), 10)
    dt = tp.compute_distances(t64(x), 10)
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=TOL)
    L = 0.2 * np.random.RandomState(14).randn(150, 20)
    d = np.asarray(jax_local_dimensionality(jnp.asarray(x)))
    want = jp.compute_initial_dimensionalities(
        jnp.asarray(x), 0.3, -2.0, jnp.asarray(L), dj[:, 0], jnp.asarray(d)
    )
    got = tp.compute_initial_dimensionalities(t64(x), 0.3, -2.0, t64(L), dt[:, 0], t64(d))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=TOL)


FITS = {
    # (cells, dims, landmarks, seed); 0 landmarks: the full GP type
    "sparse": (400, 4, 40, 8),
    "full": (300, 5, 0, 10),
}


@pytest.fixture(scope="module", params=sorted(FITS))
def fitted(request):
    n, d, m, seed = FITS[request.param]
    x = clustered(n, d, seed=seed, spread=1.0)
    jest = mellon_tpu.DimensionalityEstimator(n_landmarks=m)
    jest.fit(jnp.asarray(x))
    where = dict(landmarks=np.asarray(jest.landmarks)) if m else dict(n_landmarks=0)
    est = mt.DimensionalityEstimator(**where, **CPU64)
    est.fit(x)
    return request.param, x, jest, est


def test_estimator_matches_jax(fitted):
    """The prepared state to 1e-10 (k-NN distances, local dimensions,
    mu_dens, ls, the warm start), then the L-BFGS fit: the local
    dimensions and log densities at the cells and both predictors at new
    points to corr >= 0.99999 and max |Δ| <= 1e-3 of the spread."""
    kind, x, jest, est = fitted
    assert est.gp_type.value == jest.gp_type.value
    np.testing.assert_allclose(to_np(est.distances), np.asarray(jest.distances), rtol=0, atol=TOL)
    np.testing.assert_allclose(to_np(est.d), np.asarray(jest.d), rtol=0, atol=TOL)
    np.testing.assert_allclose(est.mu_dens, jest.mu_dens, rtol=TOL)
    np.testing.assert_allclose(est.ls, jest.ls, rtol=TOL)
    np.testing.assert_allclose(to_np(est.initial_value), np.asarray(jest.initial_value), rtol=0, atol=1e-8)
    x_new = clustered(30, x.shape[1], seed=99, spread=1.0)
    pairs = [
        (est.local_dim_x, jest.local_dim_x),
        (est.log_density_x, jest.log_density_x),
        (est.predict(x_new), jest.predict(jnp.asarray(x_new))),
        (est.predict_density(x_new), jest.predict_density(jnp.asarray(x_new))),
    ]
    for got, want in pairs:
        corr, err = _agreement(to_np(got), want)
        assert corr >= 0.99999 and err <= 1e-3, (kind, corr, err)
    expected = {"sparse": mt.ExpLandmarksConditionalCholesky, "full": mt.ExpFullConditional}[kind]
    assert type(est.predict) is expected


def test_laplace_uncertainty_on_jax_latents(fitted):
    """predictor_with_uncertainty after L-BFGS: on mellon_tpu's fitted
    latents, the Laplace stds (2, m) and both predictors' uncertainty at new
    points agree to 1e-8 relative (the trigamma of
    test_hessian_diagonal_closed_form is the gap)."""
    kind, x, jest, _ = fitted
    from mellon_tpu.inference.laplace import compute_laplace_std

    jz = jest.pre_transformation
    jstd = compute_laplace_std(jl.dimensionality_loss, jz, loss_args=jest._loss_args)
    est = mt.state_from_jax(jest, **CPU64)
    est.predictor_with_uncertainty = True
    jest.predictor_with_uncertainty = True
    jest.pre_transformation_std = jstd
    std = mt.inference.laplace.laplace_std_from_diagonal(
        est._hessian_diagonal(est.pre_transformation.reshape(-1))
    ).reshape(2, -1)
    np.testing.assert_allclose(to_np(std), np.asarray(jstd), rtol=1e-8)
    est.pre_transformation_std = std
    x_new = jnp.asarray(clustered(20, x.shape[1], seed=98, spread=1.0))
    jest.local_dim_func = jest.log_density_func = None
    for name in ("predict", "predict_density"):
        want = getattr(jest, name).uncertainty(x_new)
        got = getattr(est, name).uncertainty(np.asarray(x_new))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-8)


def test_uncertainty_estimator_runs_laplace():
    """DimensionalityEstimator(predictor_with_uncertainty=True) computes
    the (2, m) Laplace stds and both predictors' covariances."""
    x = clustered(200, 3, seed=15, spread=1.0)
    est = mt.DimensionalityEstimator(n_landmarks=30, predictor_with_uncertainty=True, **CPU64)
    est.fit(x)
    assert est.pre_transformation_std.shape == est.pre_transformation.shape == (2, 30)
    assert torch.isfinite(est.predict.uncertainty(x[:10])).all()
    assert (est.predict_density.mean_covariance(x[:10]) >= 0).all()


@pytest.mark.parametrize("optimizer", ["adam", "advi"])
def test_other_optimizers_run(optimizer):
    """adam and ADVI on the flattened (2, m) latents: the fitted latents
    keep their shape, ADVI gives stds, and the local dimensions stay
    finite and positive."""
    x = clustered(200, 3, seed=16, spread=1.0)
    est = mt.DimensionalityEstimator(n_landmarks=30, optimizer=optimizer, n_iter=40, **CPU64)
    ld = est.fit_predict(x)
    assert est.pre_transformation.shape == (2, 30)
    assert torch.isfinite(ld).all() and (ld > 0).all()
    if optimizer == "advi":
        assert est.pre_transformation_std.shape == (2, 30)


@pytest.mark.parametrize("optimizer", ["nuts", "smc"])
def test_samplers_raise(optimizer):
    """The samplers on the (2, m) latents: smc raises the JAX package's
    ValueError in both packages (it samples 1-d latents only) when the fit
    reaches it; nuts, which the port refused before it was ported, runs
    and keeps (chains, draws, 2, m) draws (test_nuts_shapes_replayed holds
    it to the JAX package)."""
    x = clustered(120, 3, seed=70)
    est = mt.DimensionalityEstimator(
        optimizer=optimizer, n_landmarks=15,
        sampler_options=dict(num_chains=2, num_warmup=5, num_samples=3), **CPU64
    )
    if optimizer == "smc":
        with pytest.raises(ValueError, match="1-d latent vectors"):
            mellon_tpu.DimensionalityEstimator(optimizer="smc", n_landmarks=15).fit(jnp.asarray(x))
        with pytest.raises(ValueError, match="1-d latent vectors"):
            est.fit(x)
        return
    est.fit(x)
    assert est.posterior_samples.shape == (2, 3, 2, 15)
    assert est.pre_transformation.shape == est.pre_transformation_std.shape == (2, 15)
    assert torch.isfinite(est.local_dim_x).all()


def test_batched_value_and_grad_matches_the_single_one():
    """The samplers' batched potential at each of four rows equals the
    single-row loss and gradient (1e-12), less n·offset with an offset."""
    L, dist, z, mu_dim, mu_dens = _problem(3)
    rng = np.random.RandomState(4)
    Z = t64(z.reshape(-1)[None] + 0.1 * rng.randn(4, z.size))
    single = tl.make_dimensionality_value_and_grad(t64(L), t64(dist), mu_dim, mu_dens)
    for offset in (0.0, 0.7):
        batch = tl.make_dimensionality_value_and_grad_batch(t64(L), t64(dist), mu_dim, mu_dens,
                                                            offset)
        values, grads = batch(Z)
        for i in range(4):
            v, g = single(Z[i])
            np.testing.assert_allclose(float(values[i]), float(v) - L.shape[0] * offset,
                                       rtol=1e-12)
            np.testing.assert_allclose(to_np(grads[i]), to_np(g), rtol=0, atol=1e-12)


def test_hessian_closed_form():
    """The (2m, 2m) Hessian in closed form against torch autograd (1e-10
    relative) and JAX's jax.hessian of its loss (1e-9 relative: JAX's
    gammaln second derivative, see test_hessian_diagonal_closed_form)."""
    L, dist, z, mu_dim, mu_dens = _problem(5)
    H = to_np(tl.dimensionality_hessian(t64(z).reshape(-1), t64(L), t64(dist), mu_dim, mu_dens))

    def loss(flat):
        return tl.dimensionality_loss(flat.reshape(2, -1), t64(L), t64(dist), mu_dim, mu_dens)

    auto = to_np(torch.autograd.functional.hessian(loss, t64(z).reshape(-1)))
    scale = np.abs(auto).max()
    np.testing.assert_allclose(H, auto, rtol=0, atol=1e-10 * scale)
    want = jax.hessian(lambda f: jl.dimensionality_loss(f.reshape(2, -1), jnp.asarray(L),
                                                        jnp.asarray(dist), mu_dim, mu_dens))(
        jnp.asarray(z).reshape(-1))
    np.testing.assert_allclose(H, np.asarray(want), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(np.diag(H), to_np(tl.dimensionality_hessian_diagonal(
        t64(z).reshape(-1), t64(L), t64(dist), mu_dim, mu_dens)), rtol=1e-12)


def test_zero_centered_potential_is_zero_at_z0():
    """loss(z0)/n as a float32 number; the centred potential ~0 at z0."""
    L, dist, z, mu_dim, mu_dens = _problem(6)
    z0 = t64(z).reshape(-1)
    vg, offset = tl.zero_centered_dimensionality_potential(z0, t64(L), t64(dist), mu_dim, mu_dens)
    v0 = float(tl.dimensionality_loss(t64(z), t64(L), t64(dist), mu_dim, mu_dens))
    assert offset == float(np.float32(v0 / L.shape[0]))
    assert abs(float(vg(z0[None])[0][0])) < 1e-4 * abs(v0)


def test_nuts_shapes_replayed(monkeypatch):
    """The estimator's NUTS on the flattened (2, m) latents, its draws
    taken from JAX's key schedule through the Draws seam: the chains equal
    (1e-8) mellon_tpu's run_mcmc of the flattening wrapper of its
    dimensionality loss from the same MAP (its potential not centred: the
    port's is lower by n·offset, a constant), with JAX's step count; the
    estimator's shapes: draws (chains, draws, 2, m), latents and stds (2,
    m), ESS per flattened latent."""
    from mellon_tpu.inference import mcmc as jax_mcmc
    from mellon_tpu_torch.inference import samplers

    from _torch_parity import JaxReplayDraws

    monkeypatch.setattr(samplers, "_subtree_steps",
                        lambda leaves, depth: torch.full_like(leaves, 2**depth))
    x = clustered(150, 3, seed=71)
    jest = mellon_tpu.DimensionalityEstimator(n_landmarks=12)
    jest.prepare_inference(jnp.asarray(x))
    run = dict(num_chains=3, num_warmup=10, num_samples=6, max_tree_depth=5)
    est = mt.DimensionalityEstimator(landmarks=np.asarray(jest.landmarks), optimizer="nuts",
                                     sampler_options=run, **CPU64)
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(est, "_sampler_generator", lambda: JaxReplayDraws(key))
    est.fit(x)
    res = est.mcmc_result
    assert est.posterior_samples.shape == (3, 6, 2, 12)
    assert est.pre_transformation.shape == est.pre_transformation_std.shape == (2, 12)
    assert est.ess.shape == (24,) and est.ess_per_second > 0

    z_map = minimize_lbfgs_flat(est)
    shape = (2, 12)

    def flat_loss(z, *args):
        return jl.dimensionality_loss(z.reshape(shape), *args)

    want = jax_mcmc.run_mcmc(flat_loss, jnp.asarray(to_np(z_map)), key,
                             potential_args=tuple(jnp.asarray(to_np(a)) if torch.is_tensor(a)
                                                  else a for a in est._loss_args),
                             target_accept=0.8, initial_step_size=0.1, **run)
    _, offset = tl.zero_centered_dimensionality_potential(z_map, *est._loss_args)
    np.testing.assert_allclose(to_np(res.samples), np.asarray(want.samples), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(to_np(res.potential) + x.shape[0] * offset,
                               np.asarray(want.potential), rtol=1e-8)
    np.testing.assert_array_equal(to_np(res.num_leapfrog), np.asarray(want.num_leapfrog))


def test_nuts_hessian_preconditioned():
    """precondition="hessian" on the dimensionality model: the Newton
    polish and the dense closed-form Hessian whiten the flattened latents;
    the draws come back in the model's coordinates, (chains, draws, 2, m),
    finite, each latent's mean within three of its draws' stds of the
    MAP (twenty draws; 100 warmup transitions: with 20 the windowed
    adaptation ends on an unsettled step size, in the JAX package's
    scheme too)."""
    x = clustered(150, 3, seed=72)
    est = mt.DimensionalityEstimator(
        n_landmarks=12, optimizer="nuts",
        sampler_options=dict(num_chains=2, num_warmup=100, num_samples=10, max_tree_depth=6,
                             precondition="hessian"),
        **CPU64,
    )
    est.fit(x)
    assert est.posterior_samples.shape == (2, 10, 2, 12)
    assert torch.isfinite(est.posterior_samples).all() and torch.isfinite(est.local_dim_x).all()
    z_map = minimize_lbfgs_flat(est).reshape(2, 12)
    gap = (est.pre_transformation - z_map).abs() / est.pre_transformation_std
    assert float(gap.max()) < 3.0


def minimize_lbfgs_flat(est):
    """The L-BFGS MAP the estimator's NUTS starts from."""
    from mellon_tpu_torch.inference.optimizers import minimize_lbfgs_value_and_grad

    return minimize_lbfgs_value_and_grad(est._value_and_grad, est.initial_value.reshape(-1)).pre_transformation


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_json_both_ways(fitted, direction):
    """Both predictors of a fitted model (ExpLandmarksConditionalCholesky or
    ExpFullConditional, and the log density's) through JSON into the other
    package: the same values at new points to 1e-10."""
    kind, x, jest, est = fitted
    x_new = clustered(10, x.shape[1], seed=97, spread=1.0)
    for name in ("predict", "predict_density"):
        if direction == "jax_to_torch":
            src = getattr(jest, name)
            back = mt.Predictor.from_json_str(src.to_json(), **CPU64)
            got, want = back(x_new), src(jnp.asarray(x_new))
        else:
            src = getattr(est, name)
            back = mellon_tpu.Predictor.from_json_str(src.to_json())
            got, want = back(jnp.asarray(x_new)), src(x_new)
        assert type(back).__name__ == type(src).__name__
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=TOL)


def test_exp_landmarks_conditional_json_both_ways():
    """The exp form of the landmarks conditional through JSON both ways."""
    from mellon_tpu.inference.conditionals import ExpLandmarksConditional as JaxELC
    from mellon_tpu.ops.kernels import Matern52 as JaxMatern52

    rng = np.random.RandomState(17)
    x, xu, x_new = rng.randn(50, 2), rng.randn(10, 2), rng.randn(8, 2)
    y = np.exp(0.3 * np.sin(x[:, 0]))
    jc = JaxELC(jnp.asarray(x), jnp.asarray(xu), jnp.log(jnp.asarray(y)), 0.0, JaxMatern52(ls=1.5), sigma=0.3)
    tc = mt.ExpLandmarksConditional(t64(x), t64(xu), torch.log(t64(y)), 0.0, mt.Matern52(ls=1.5), sigma=0.3)
    np.testing.assert_allclose(to_np(tc(x_new)), np.asarray(jc(jnp.asarray(x_new))), rtol=TOL)
    back = mt.Predictor.from_json_str(jc.to_json(), **CPU64)
    np.testing.assert_allclose(to_np(back(x_new)), np.asarray(jc(jnp.asarray(x_new))), rtol=TOL)
    jback = mellon_tpu.Predictor.from_json_str(tc.to_json())
    np.testing.assert_allclose(np.asarray(jback(jnp.asarray(x_new))), to_np(tc(x_new)), rtol=TOL)
    np.testing.assert_allclose(to_np(tc(x_new, logscale=True)), np.log(to_np(tc(x_new))), rtol=1e-12)


def test_state_from_jax(fitted):
    """A fitted mellon_tpu DimensionalityEstimator carried over: the same
    loss at its latents and the same predictors, to 1e-10."""
    kind, x, jest, _ = fitted
    est = mt.state_from_jax(jest, **CPU64)
    value, _ = est._value_and_grad(est.pre_transformation.reshape(-1))
    want = float(jl.dimensionality_loss(jest.pre_transformation, *jest._loss_args))
    np.testing.assert_allclose(float(value), want, rtol=TOL)
    x_new = clustered(10, x.shape[1], seed=96, spread=1.0)
    np.testing.assert_allclose(to_np(est.predict(x_new)), np.asarray(jest.predict(jnp.asarray(x_new))), rtol=TOL)
    np.testing.assert_allclose(to_np(est.local_dim_x), np.asarray(jest.local_dim_x), rtol=TOL)
