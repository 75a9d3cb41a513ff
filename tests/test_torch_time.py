"""The time-sensitive density model of mellon_tpu_torch against mellon_tpu.

Each test of ``tests/test_time_sensitive_density_estimator.py`` has a
counterpart here that feeds the same numpy inputs to both packages, plus
the pieces of the time path on their own: the within-time 1-NN search
(both augmentations and the per-group loop), the time-rescaled landmarks,
every configuration the batched ls_time fits decline, the float64 rescue
of a singular time group, JSON both ways, ``state_from_jax``, the time
derivative and the normalization advisory.

Tolerances: fits at the default length scale, their predictors and
derivatives, float64 on both sides, 1e-8 relative to the largest value
(their L-BFGS runs take the same steps there; measured ~1e-14).  The
batched per-time densities, 1e-10.  ls_time, 1e-5 relative: both
packages stop its one-parameter L-BFGS once |gradient| < 1e-5, which
leaves each ~|g|/curvature (a few 1e-6 here) from the optimum, and their
line searches interpolate differently.  float32 runs against mellon_tpu
in float32 (``jax_x64_off``), 1e-4 relative.
"""

import functools
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, jax_x64_off, t64, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu import parameters as jp
from mellon_tpu.inference import derivatives as jder
from mellon_tpu.models import ls_time as jlt
from mellon_tpu.ops.kernels import Matern52 as JaxMatern52
from mellon_tpu_torch import parameters as tp
from mellon_tpu_torch.inference import derivatives as tder
from mellon_tpu_torch.models import ls_time as tlt

FIT_REL = 1e-8
DENSITY_REL = 1e-10
LS_TIME_REL = 1e-5
F32_REL = 1e-4
TIMES = (0.0, 1.0, 2.0)


def _rel(got, want):
    got, want = to_np(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _time_data(seed=0, n_per=40, d=2):
    """Three time points of n_per cells each at d = 2, drifting by 0.5
    per unit of time (the JAX package's test data, drawn by numpy)."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(n_per, d) + 0.5 * t for t in TIMES])
    return x, np.repeat(np.asarray(TIMES), n_per)


def _ragged_data(seed, sizes, d=2):
    """Clustered cells over ragged time points (the ls_time fits' case)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(6, d) * 2.0
    n = int(np.sum(sizes))
    x = centers[rng.randint(0, 6, n)] + 0.4 * rng.randn(n, d)
    times = np.concatenate([np.full(s, float(i)) for i, s in enumerate(sizes)])
    return np.concatenate([x + 0.1 * times[:, None], times[:, None]], axis=1)


@pytest.fixture(scope="module")
def data():
    return _time_data()


@pytest.fixture(scope="module")
def fitted(data):
    """The same fit by both packages: ls_time = 1.5, float64."""
    x, times = data
    jest = mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.5)
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    est = mt.TimeSensitiveDensityEstimator(ls_time=1.5, **CPU64)
    est.fit(x, times)
    return jest, est


class _Records(logging.Handler):
    """Messages and levels of a logger's records."""

    def __init__(self, name):
        super().__init__(logging.DEBUG)
        self.records = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        self.records.append((record.levelname, record.getMessage()))

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def test_fit_shapes_and_state_match_jax(data, fitted):
    """The fit's shapes (time appended to x), its heuristics, L and the
    log density at the cells."""
    x, _ = data
    jest, est = fitted
    assert est.log_density_x.shape == (x.shape[0],)
    assert est.x.shape == (x.shape[0], 3)
    assert est.gp_type == mt.GaussianProcessType.FULL
    np.testing.assert_allclose(to_np(est.nn_distances), np.asarray(jest.nn_distances), rtol=1e-12)
    np.testing.assert_allclose([est.ls, est.mu, est.d], [jest.ls, jest.mu, jest.d], rtol=1e-12)
    assert _rel(est.L, jest.L) <= 1e-10
    assert _rel(est.log_density_x, jest.log_density_x) <= FIT_REL


def test_product_kernel(fitted):
    """The space × time product kernel: the state columns at ls, the time
    column at ls_time, as the JAX package builds it."""
    jest, est = fitted
    assert "*" in repr(est.cov_func)
    left, right = est.cov_func.left, est.cov_func.right
    assert (left.active_dims, right.active_dims) == (slice(None, -1), -1)
    assert (left.ls, right.ls) == pytest.approx((jest.cov_func.left.ls, 1.5), rel=1e-12)
    xj = np.random.RandomState(3).randn(6, 3)
    assert _rel(est.cov_func(t64(xj), t64(xj)), jest.cov_func(jnp.asarray(xj), jnp.asarray(xj))) <= 1e-12


def test_predict_at_time(data, fitted):
    """A scalar time is broadcast to every row; the values match JAX."""
    x, _ = data
    jest, est = fitted
    pred = est.predict(x[:10], time=0.0)
    assert pred.shape == (10,) and bool(torch.isfinite(pred).all())
    np.testing.assert_allclose(to_np(pred), to_np(est.predict(x[:10], time=np.zeros(10))), atol=1e-12)
    assert _rel(pred, jest.predict(jnp.asarray(x[:10]), time=0.0)) <= FIT_REL


def test_predictor_consistency(data, fitted):
    """The predictor at the training cells and times reproduces the fit."""
    x, times = data
    jest, est = fitted
    pred = to_np(est.predict(x, time=times))
    ld = to_np(est.log_density_x)
    assert np.max(np.abs(ld - pred)) / np.std(ld) < 1e-3
    assert _rel(pred, jest.predict(jnp.asarray(x), time=jnp.asarray(times))) <= FIT_REL


def test_multi_time(data, fitted):
    """multi_time stacks the grid on axis 1, one call over n·T rows, equal
    to the times one by one and to JAX's vmap; time with multi_time is
    refused with the JAX package's message."""
    x, _ = data
    jest, est = fitted
    grid = np.asarray(TIMES)
    preds = est.predict(x[:7], multi_time=grid)
    assert preds.shape == (7, 3)
    by_time = torch.stack([est.predict(x[:7], time=t) for t in TIMES], dim=1)
    np.testing.assert_allclose(to_np(preds), to_np(by_time), rtol=1e-14)
    assert _rel(preds, jest.predict(jnp.asarray(x[:7]), multi_time=jnp.asarray(grid))) <= FIT_REL
    for package, xs in ((est, x[:7]), (jest, jnp.asarray(x[:7]))):
        with pytest.raises(ValueError, match="Cannot specify both 'time' and 'multi_time'"):
            package.predict(xs, time=1.0, multi_time=grid)


def test_time_derivative(data, fitted):
    """d/dt of the prediction at one time and over a grid, against JAX."""
    x, _ = data
    jest, est = fitted
    td = est.predict.time_derivative(x[:9], 1.0)
    assert td.shape == (9,) and bool(torch.isfinite(td).all())
    assert _rel(td, jest.predict.time_derivative(jnp.asarray(x[:9]), 1.0)) <= FIT_REL
    grid = np.asarray([0.5, 1.5])
    tdm = est.predict.time_derivative(x[:9], multi_time=grid)
    assert tdm.shape == (9, 2)
    assert _rel(tdm, jest.predict.time_derivative(jnp.asarray(x[:9]), multi_time=jnp.asarray(grid))) <= FIT_REL


def test_gradient_at_time(data, fitted):
    """The gradient in the states at one time, against JAX."""
    x, _ = data
    jest, est = fitted
    g = est.predict.gradient(x[:5], 1.0)
    assert g.shape == (5, 2)
    assert _rel(g, jest.predict.gradient(jnp.asarray(x[:5]), 1.0)) <= FIT_REL


def test_n_obs_average_cell_count(fitted):
    """The predictor's n_obs is the average cell count per time point."""
    jest, est = fitted
    assert est.predict.n_obs == pytest.approx(40.0) == jest.predict.n_obs


def test_normalize_per_time_point(data):
    """normalize_per_time_point=True: finite, and JAX's fit."""
    x, times = data
    kw = dict(ls_time=1.5, normalize_per_time_point=True)
    ld = mt.TimeSensitiveDensityEstimator(**kw, **CPU64).fit_predict(x, times)
    ld_j = mellon_tpu.TimeSensitiveDensityEstimator(**kw).fit_predict(jnp.asarray(x), jnp.asarray(times))
    assert bool(torch.isfinite(ld).all())
    assert _rel(ld, ld_j) <= FIT_REL


def test_ls_time_heuristic(data):
    """The automatic ls_time (the batched per-time fits), and the fit on
    it, against JAX."""
    x, times = data
    jest = mellon_tpu.TimeSensitiveDensityEstimator()
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    est = mt.TimeSensitiveDensityEstimator(**CPU64)
    est.fit(x, times)
    assert est.ls_time > 0
    assert est.ls_time == pytest.approx(jest.ls_time, rel=LS_TIME_REL)
    # the fit on ls_time agrees as far as ls_time does
    assert _rel(est.log_density_x, jest.log_density_x) <= 1e-5


def test_too_few_samples_per_time_raises():
    """One cell at a time point: both packages refuse, with one message."""
    x = np.ones((5, 2))
    times = np.asarray([0.0, 0.0, 1.0, 1.0, 2.0])
    with pytest.raises(ValueError, match="Insufficient data: Only 1 sample") as port:
        mt.TimeSensitiveDensityEstimator(ls_time=1.0, **CPU64).fit(x, times)
    with pytest.raises(ValueError, match="Insufficient data") as ref:
        mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.0).fit(jnp.asarray(x), jnp.asarray(times))
    assert str(port.value) == str(ref.value)


def test_string_and_html_repr(fitted):
    _, est = fitted
    assert "ls_time=1.5" in str(est)
    html = est._repr_html_()
    assert "Time-Sensitive Density Estimator" in html and "Available" in html


def test_multi_time_hessian_semantics(data, fitted):
    """Hessian with multi_time: equal times give equal Hessians, distinct
    ones differ; the Hessian and its log-determinant match JAX away from
    the training cells (at a training cell the port keeps the kernel's
    whole curvature term, a recorded divergence: ROADMAP Queue 3)."""
    x, _ = data
    jest, est = fitted
    n, d = x.shape
    multi = np.asarray([1.0, 1.0, 2.0])
    hess = est.predict.hessian(x, multi_time=multi)
    assert hess.shape == (n, 3, d, d)
    np.testing.assert_array_equal(to_np(hess[:, 0]), to_np(hess[:, 1]))
    assert np.any(to_np(hess[:, 0]) != to_np(hess[:, 2]))
    x = x + 0.013
    hess = est.predict.hessian(x, multi_time=multi)
    assert _rel(hess, jest.predict.hessian(jnp.asarray(x), multi_time=jnp.asarray(multi))) <= FIT_REL
    sign, logdet = est.predict.hessian_log_determinant(x, 1.0)
    sign_j, logdet_j = jest.predict.hessian_log_determinant(jnp.asarray(x), 1.0)
    assert sign.shape == logdet.shape == (n,)
    np.testing.assert_array_equal(to_np(sign), np.asarray(sign_j))
    assert _rel(logdet, logdet_j) <= FIT_REL


@functools.lru_cache(maxsize=None)
def _jax_fit(rank, n_landmarks):
    """mellon_tpu's fit of the test data at (rank, n_landmarks), once."""
    x, times = _time_data()
    jest = mellon_tpu.TimeSensitiveDensityEstimator(rank=rank, n_landmarks=n_landmarks, ls_time=1.5)
    return jest.fit(jnp.asarray(x), jnp.asarray(times))


@pytest.mark.parametrize(
    "rank, n_landmarks, compress",
    [(1.0, 10, None), (0.99, 60, "gzip"), (0.99, 60, "bz2")],
)
def test_serialization_roundtrip(data, tmp_path, rank, n_landmarks, compress):
    """JSON both ways.  The port's fit (sparse Cholesky: the Nyström types
    of rank 0.99 are not ported, ROADMAP item 13b) through its own JSON and
    through mellon_tpu's; mellon_tpu's fit at (rank, n_landmarks) through
    its JSON into the port: the same values (1e-10)."""
    x, times = data
    suffix = {"gzip": ".json.gz", "bz2": ".json.bz2", None: ".json"}[compress]
    est = mt.TimeSensitiveDensityEstimator(n_landmarks=n_landmarks, ls_time=1.5, **CPU64)
    est.fit(x, times)
    assert type(est.predict) is mt.LandmarksConditionalCholeskyTime
    dens = est.predict(x, times)
    port_file = str(tmp_path / f"port{suffix}")
    est.predict.to_json(port_file, compress=compress)
    back = mt.Predictor.from_json(port_file, compress=compress, **CPU64)
    assert type(back) is mt.LandmarksConditionalCholeskyTime
    np.testing.assert_allclose(to_np(back(x, times)), to_np(dens), rtol=1e-12)
    in_jax = mellon_tpu.Predictor.from_json(port_file, compress=compress)
    assert _rel(in_jax(jnp.asarray(x), jnp.asarray(times)), to_np(dens)) <= DENSITY_REL

    jest = _jax_fit(rank, n_landmarks)
    jax_file = str(tmp_path / f"jax{suffix}")
    jest.predict.to_json(jax_file, compress=compress)
    loaded = mt.Predictor.from_json(jax_file, compress=compress, **CPU64)
    assert type(loaded).__name__ == type(jest.predict).__name__
    assert _rel(loaded(x, times), jest.predict(jnp.asarray(x), jnp.asarray(times))) <= DENSITY_REL


def test_serialization_with_uncertainty(data, tmp_path):
    """ADVI with uncertainty: the covariance surface's shapes and its JSON
    round trip in the port; mellon_tpu's ADVI predictor (rank 0.99) loaded
    in the port gives its covariance, mean covariance and uncertainty."""
    x, times = data
    n = x.shape[0]
    est = mt.TimeSensitiveDensityEstimator(
        n_landmarks=60, ls_time=1.5, optimizer="advi", predictor_with_uncertainty=True, **CPU64
    )
    est.fit(x, times)
    dens = est.predict(x, times)
    for method in ("covariance", "mean_covariance", "uncertainty"):
        assert getattr(est.predict, method)(x, times).shape == (n,)
    path = str(tmp_path / "port.json.gz")
    est.predict.to_json(path, compress="gzip")
    back = mt.Predictor.from_json(path, compress="gzip", **CPU64)
    np.testing.assert_allclose(to_np(back(x, times)), to_np(dens), rtol=1e-12)
    np.testing.assert_allclose(
        to_np(back.uncertainty(x, times)), to_np(est.predict.uncertainty(x, times)), rtol=1e-12
    )

    jest = mellon_tpu.TimeSensitiveDensityEstimator(
        rank=0.99, n_landmarks=60, ls_time=1.5, optimizer="advi", predictor_with_uncertainty=True
    )
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    jax_file = str(tmp_path / "jax.json.gz")
    jest.predict.to_json(jax_file, compress="gzip")
    loaded = mt.Predictor.from_json(jax_file, **CPU64)
    xj, tj = jnp.asarray(x), jnp.asarray(times)
    for method in ("mean", "covariance", "mean_covariance", "uncertainty"):
        got = getattr(loaded, method)(x, times)
        assert _rel(got, getattr(jest.predict, method)(xj, tj)) <= DENSITY_REL, method


def test_save_intermediate_ls_times(data):
    """_save_intermediate_ls_times keeps the per-time fits (the loop) and
    their densities, and ls_time matches JAX's loop."""
    x, times = data
    est = mt.TimeSensitiveDensityEstimator(n_landmarks=20, _save_intermediate_ls_times=True, **CPU64)
    est.fit(x, times)
    assert est.densities.shape == (3, x.shape[0])
    assert len(est.predictors) == 3 and all(isinstance(p, mt.DensityEstimator) for p in est.predictors)
    np.testing.assert_array_equal(to_np(est.numeric_stages), TIMES)
    assert est.landmarks.shape[0] == 20
    jest = mellon_tpu.TimeSensitiveDensityEstimator(n_landmarks=20, _save_intermediate_ls_times=True)
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    assert _rel(est.densities, jest.densities) <= FIT_REL
    assert est.ls_time == pytest.approx(jest.ls_time, rel=LS_TIME_REL)


def test_error_paths_and_staged_protocol(data):
    """Error semantics and the staged protocol of the JAX package."""
    x, times = data
    Xt = np.concatenate([x, times[:, None]], axis=1)
    wide = np.concatenate([x] * 26 + [times[:, None]], axis=1)
    est = mt.TimeSensitiveDensityEstimator(ls_time=1.5, **CPU64)
    with pytest.raises(ValueError):
        est.fit_predict()
    with pytest.raises(ValueError):
        est.fit(None)
    est.set_x(Xt)
    with pytest.raises(ValueError):
        est.prepare_inference(wide)
    loss_func, initial_value = est.prepare_inference(None)
    est.run_inference(loss_func, initial_value, "advi")
    est.process_inference(est.pre_transformation)
    with pytest.raises(ValueError, match="Wrong number of features"):
        est.predict(x[:, :-1], times)
    with pytest.raises(ValueError):
        est.fit_predict(wide)
    est.fit_predict()
    est.predict.n_obs = None
    with pytest.raises(ValueError, match="Cannot normalize without n_obs"):
        est.predict(x, time=times, normalize=True)
    with pytest.raises(ValueError, match="including 'times'"):
        est.predict(x)


@pytest.mark.parametrize(
    "normalization, different",
    [
        (False, False),
        (True, False),
        ([4, 1000, 4], True),
        (np.array([4, 1000, 4]), True),
        ({0.0: 4, 1.0: 1000, 2.0: 4}, True),
    ],
)
def test_normalization_forms(data, fitted, normalization, different):
    """normalize_per_time_point as bool, list, array or dict: the port's
    densities equal JAX's, and differ from the plain fit exactly where
    JAX's do."""
    x, times = data
    _, plain = fitted
    est = mt.TimeSensitiveDensityEstimator(ls_time=1.5, normalize_per_time_point=normalization, **CPU64)
    est.fit(x, times)
    dens = to_np(est.predict(x, times))
    jnorm = jnp.asarray(normalization) if isinstance(normalization, np.ndarray) else normalization
    jest = mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.5, normalize_per_time_point=jnorm)
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    # unequal targets scale the distances by up to (1000/4)^(1/2): there
    # the two L-BFGS runs part by ~1e-7 (one line search interpolates
    # differently)
    assert _rel(dens, jest.predict(jnp.asarray(x), jnp.asarray(times))) <= (1e-6 if different else FIT_REL)
    assert est.predict.n_obs == pytest.approx(jest.predict.n_obs)
    ref = to_np(plain.log_density_x)
    rel = np.std(dens - ref) / np.std(ref)
    assert (rel > 1e-2) if different else (rel < 1e-4)


def test_normalize_dict_missing_a_time_raises(data):
    """A normalization dict without every time point is refused, by the
    port and by JAX."""
    x, times = data
    bad = {0.0: 50.0}
    with pytest.raises(ValueError, match="lacks entries for time point"):
        mt.TimeSensitiveDensityEstimator(ls_time=1.5, normalize_per_time_point=bad, **CPU64).fit(x, times)
    with pytest.raises(ValueError, match="lacks entries for time point"):
        mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.5, normalize_per_time_point=bad).fit(
            jnp.asarray(x), jnp.asarray(times)
        )
    with pytest.raises(ValueError, match="counts must match"):
        tp.compute_nn_distances_within_time_points(
            np.concatenate([x, times[:, None]], axis=1), d=2, normalize=[1, 2]
        )


def _within_time_nn(xt):
    return (
        to_np(tp.compute_nn_distances_within_time_points(t64(xt))),
        np.asarray(jp.compute_nn_distances_within_time_points(jnp.asarray(xt))),
    )


@pytest.mark.parametrize("d", [2, 20])
def test_within_time_augmented_both_branches(d):
    """The scaled group column (d + 1 <= 16) and the one-hot form above
    it: the augmented states equal JAX's, and the within-time 1-NN
    distances equal a search per time point."""
    xt = _ragged_data(5, [30, 25, 41], d=d)
    states, group = xt[:, :-1], xt[:, -1].astype(np.int64)
    aug = tp.within_time_augmented(t64(states), torch.as_tensor(group), 3)
    aug_j = jp.within_time_augmented(jnp.asarray(states), jnp.asarray(group), 3)
    assert aug.shape[1] == (d + 1 if d + 1 <= 16 else d + 3)
    np.testing.assert_allclose(to_np(aug), np.asarray(aug_j), rtol=1e-14)
    got, want = _within_time_nn(xt)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for g in range(3):
        sel = group == g
        own = to_np(tp.compute_nn_distances(t64(states[sel])))
        np.testing.assert_allclose(got[sel], own, rtol=1e-12)


def test_many_time_points_search_per_group():
    """Above MAX_ONEHOT_TIME_GROUPS time points the search runs per group,
    with the same distances as JAX's."""
    xt = _ragged_data(6, [4] * (tp.MAX_ONEHOT_TIME_GROUPS + 2))
    got, want = _within_time_nn(xt)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_landmarks_rescale_time_with_jax_landmarks(monkeypatch):
    """compute_landmarks_rescale_time: the time column scaled by ls/ls_time
    before k-means and back after.  torch cannot replay threefry, so the
    port's k-means is handed JAX's centroids for the same scaled cells."""
    xt = _ragged_data(7, [60, 50, 70])
    seen = {}
    jax_compute = jp.compute_landmarks

    def record(x, **kw):
        out = jax_compute(x, **kw)
        seen["x"], seen["centroids"] = np.asarray(x), np.asarray(out)
        return out

    monkeypatch.setattr(jp, "compute_landmarks", record)
    want = np.asarray(jp.compute_landmarks_rescale_time(jnp.asarray(xt), 0.8, 2.0, n_landmarks=15))

    def handed_over(x, k, random_state=0):
        np.testing.assert_allclose(to_np(x), seen["x"], rtol=1e-14)
        return t64(seen["centroids"])

    monkeypatch.setattr(tp, "k_means", handed_over)
    got = tp.compute_landmarks_rescale_time(t64(xt), 0.8, 2.0, n_landmarks=15)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-14)
    assert tp.compute_landmarks_rescale_time(t64(xt), 0.8, 2.0, n_landmarks=0) is None


def test_batched_ls_time_matches_per_time_loop(data):
    """The batched masked fits give the per-time loop's ls_time; their
    densities equal JAX's batched densities."""
    x, times = data
    xt = np.concatenate([x, times[:, None]], axis=1)
    nn = tp.compute_nn_distances_within_time_points(t64(xt))
    ut = torch.unique(t64(times))
    dens = tlt._batched_ls_time_densities(t64(xt), nn, mt.Matern52, {}, ut, 0)
    dens_j = jlt._batched_ls_time_densities(
        jnp.asarray(xt), jnp.asarray(to_np(nn)), JaxMatern52, {}, jnp.asarray(TIMES), 0
    )
    assert _rel(dens, dens_j) <= DENSITY_REL
    ls_batched = tlt.compute_ls_time(nn, t64(xt), mt.Matern52)
    ls_loop = tlt.compute_ls_time(nn, t64(xt), mt.Matern52, return_data=True)[0]
    assert ls_batched == pytest.approx(ls_loop, rel=2e-3)
    assert ls_batched == pytest.approx(
        jlt.compute_ls_time(jnp.asarray(to_np(nn)), jnp.asarray(xt), JaxMatern52), rel=LS_TIME_REL
    )


def _composite(ls=1.0):
    return mt.Matern52(ls=ls) + mt.Matern32(ls=ls)


def _jax_composite(ls=1.0):
    from mellon_tpu.ops.kernels import Matern32

    return JaxMatern52(ls=ls) + Matern32(ls=ls)


def _decline_cases():
    """(label, port kwargs, JAX kwargs, port curry, JAX curry, patches):
    each configuration the batched fits decline."""
    from mellon_tpu.ops.kernels import Linear, RatQuad

    return [
        ("optimizer", {"optimizer": "adam"}, None, None, None),
        ("fractal d", {"d_method": "fractal"}, None, None, None),
        ("unknown key", {"n_landmarks": 10}, None, None, None),
        ("manual without d", {"d_method": "manual"}, None, None, None),
        ("composite kernel", {}, None, (_composite, _jax_composite), None),
        ("two-parameter kernel", {}, None, (mt.RatQuad, RatQuad), None),
        ("d above 50", {"d": 51}, None, None, None),
        ("bad jitter", {"jitter": -1.0}, None, None, None),
        ("group above the cap", {}, None, None, "cap"),
        ("accepted: Linear", {}, None, (mt.Linear, Linear), "accepted"),
        ("accepted: defaults", {}, None, None, "accepted"),
    ]


@pytest.mark.parametrize("case", _decline_cases(), ids=lambda c: c[0])
def test_batched_ls_time_declines_like_jax(data, monkeypatch, case):
    """Every configuration the batched fits decline (optimizer, fractal d,
    unknown keys, manual d without d, a composite or two-parameter kernel,
    d > 50, an invalid jitter, a group above BATCH_GROUP_CAP) returns None
    in both packages, and the single-length-scale kernels are accepted in
    both."""
    label, kw, _, curries, patch = case
    x, times = data
    xt = np.concatenate([x, times[:, None]], axis=1)
    nn = np.full(x.shape[0], 0.3)
    port_curry, jax_curry = curries or (mt.Matern52, JaxMatern52)
    if patch == "cap":
        monkeypatch.setattr(tlt, "BATCH_GROUP_CAP", 39)
        monkeypatch.setattr(jlt, "BATCH_GROUP_CAP", 39)
    got = tlt._batched_ls_time_densities(t64(xt), t64(nn), port_curry, kw, torch.unique(t64(times)), 0)
    want = jlt._batched_ls_time_densities(
        jnp.asarray(xt), jnp.asarray(nn), jax_curry, kw, jnp.asarray(TIMES), 0
    )
    assert (got is None) == (want is None) == (patch != "accepted"), label


def test_batched_ls_time_declines_small_groups_and_invalid_distances():
    """A time point of one cell, and a group whose distances are all
    invalid, go to the loop in both packages; a partly invalid group is
    repaired in both."""
    xt = _ragged_data(8, [30, 1, 30])
    nn = np.full(xt.shape[0], 0.2)
    ut = np.unique(xt[:, -1])
    args = lambda nn_: ((t64(xt), t64(nn_), mt.Matern52, {}, torch.as_tensor(ut), 0),  # noqa: E731
                        (jnp.asarray(xt), jnp.asarray(nn_), JaxMatern52, {}, jnp.asarray(ut), 0))
    port_args, jax_args = args(nn)
    assert tlt._batched_ls_time_densities(*port_args) is None
    assert jlt._batched_ls_time_densities(*jax_args) is None
    xt = _ragged_data(8, [30, 20, 30])
    ut = np.unique(xt[:, -1])
    nn = np.asarray(jp.compute_nn_distances_within_time_points(jnp.asarray(xt)))
    bad = nn.copy()
    bad[30:50] = -1.0
    port_args, jax_args = args(bad)
    assert tlt._batched_ls_time_densities(*port_args) is None
    assert jlt._batched_ls_time_densities(*jax_args) is None
    part = nn.copy()
    part[30:35] = np.nan
    port_args, jax_args = args(part)
    with _Records("mellon_tpu_torch") as port_log:
        got = tlt._batched_ls_time_densities(*port_args)
    assert any("Repairing 5 invalid nn_distances in time group 1.0" in m for _, m in port_log.records)
    assert _rel(got, jlt._batched_ls_time_densities(*jax_args)) <= 1e-8


def _near_duplicates(seed):
    """Tight triples around 20 base points per time point: kernels that
    need the jitter escalation and the float64 rescue."""
    rng = np.random.RandomState(seed)
    xs, ts = [], []
    for t in TIMES:
        base = rng.randn(20, 2) + 0.3 * t
        pts = (base[None] + 1e-4 * rng.randn(3, 20, 2)).reshape(-1, 2)
        xs.append(pts)
        ts.append(np.full(pts.shape[0], t))
    return np.concatenate([np.concatenate(xs), np.concatenate(ts)[:, None]], axis=1)


def test_batched_ls_time_rescue_ladder_matches_loop():
    """Near-duplicate cells: the batched fits take the jitter escalation
    and still match the per-time loop (5%, as the JAX package's test) and
    JAX's ls_time."""
    xt = _near_duplicates(4)
    nn = tp.compute_nn_distances_within_time_points(t64(xt))
    ls_batched = tlt.compute_ls_time(nn, t64(xt), mt.Matern52)
    ls_loop = tlt.compute_ls_time(nn, t64(xt), mt.Matern52, return_data=True)[0]
    assert np.isfinite(ls_batched) and ls_batched > 0
    assert ls_batched == pytest.approx(ls_loop, rel=0.05)
    ls_j = jlt.compute_ls_time(jnp.asarray(to_np(nn)), jnp.asarray(xt), JaxMatern52)
    assert ls_batched == pytest.approx(ls_j, rel=LS_TIME_REL)


def _singular_f32_groups():
    """Float32 clusters of near-duplicate cells: per-group kernels no
    jitter escalation from 1e-30 can factor."""
    rng = np.random.RandomState(0)
    groups = []
    for t in range(3):
        pts = np.repeat(rng.randn(4, 2).astype(np.float32), 10, axis=0)
        pts += 1e-4 * rng.randn(*pts.shape).astype(np.float32)
        groups.append(np.hstack([pts, np.full((40, 1), float(t), dtype=np.float32)]))
    nn = (np.abs(rng.rand(120)).astype(np.float32) * 0.01 + 1e-4)
    return np.vstack(groups), nn


def test_batched_ls_time_declines_a_curry_without_ls(data):
    """A kernel curry that takes no length scale (the JAX package's
    TypeError branch) goes to the loop in both packages."""
    x, times = data
    xt = np.concatenate([x, times[:, None]], axis=1)
    nn = np.full(x.shape[0], 0.3)

    def port_curry(alpha=1.0):
        return mt.Matern52()

    def jax_curry(alpha=1.0):
        return JaxMatern52()

    assert tlt._batched_ls_time_densities(t64(xt), t64(nn), port_curry, {}, torch.unique(t64(times)), 0) is None
    assert jlt._batched_ls_time_densities(
        jnp.asarray(xt), jnp.asarray(nn), jax_curry, {}, jnp.asarray(TIMES), 0) is None


def test_batched_ls_time_nonfinite_densities_go_to_the_loop(data, monkeypatch):
    """Densities that come out non-finite (here: a kernel that gives NaN
    between the cells and a group's cells) send the fits to the loop, in
    both packages."""
    import mellon_tpu.ops.kernels as jkernels

    x, times = data
    xt = np.concatenate([x, times[:, None]], axis=1)
    nn = np.asarray(jp.compute_nn_distances_within_time_points(jnp.asarray(xt)))
    at_length_scale = tlt._at_length_scale

    def nan_across(template, ls):
        kernel = at_length_scale(template, ls)

        class Nan(type(kernel)):
            def k(self, a, b):
                out = super().k(a, b)
                return out * torch.nan if a.shape[0] != b.shape[0] else out

        kernel.__class__ = Nan
        return kernel

    monkeypatch.setattr(tlt, "_at_length_scale", nan_across)
    assert tlt._batched_ls_time_densities(t64(xt), t64(nn), mt.Matern52, {}, torch.unique(t64(times)), 0) is None
    spec_eval = jkernels.eval_operand_spec

    def nan_spec(spec, params, a, b):
        out = spec_eval(spec, params, a, b)
        return out * jnp.nan if a.shape[0] != b.shape[0] else out

    monkeypatch.setattr(jkernels, "eval_operand_spec", nan_spec)
    assert jlt._batched_ls_time_densities(
        jnp.asarray(xt), jnp.asarray(nn), JaxMatern52, {}, jnp.asarray(TIMES), 0) is None


def test_batched_ls_time_float64_rescue_f32():
    """float32 kernels that defeat the jitter ladder: the singular groups
    are rebuilt, factored and predicted in float64, with the warnings of
    each step, and ls_time is finite, as in the JAX package (whose float32
    densities test_batched_ls_time_f32_matches_f64 holds the port's to)."""
    xt, nn = _singular_f32_groups()
    kw = {"ls": 30.0, "jitter": 1e-30}
    x32 = torch.as_tensor(xt)
    with _Records("mellon_tpu_torch") as log:
        ls = tlt.compute_ls_time(torch.as_tensor(nn), x32, mt.Matern52, warn_below=2,
                                 density_estimator_kwargs=kw)
    messages = [m for _, m in log.records]
    assert np.isfinite(ls) and ls > 0
    assert sum("retrying with escalated jitter" in m for m in messages) == 3
    assert any("factorizing those groups in float64 on the device" in m for m in messages)
    assert any("Float64 predict for 3 rescued time group(s)" in m for m in messages)


def test_batched_ls_time_unfactorizable_group_goes_to_the_loop(monkeypatch):
    """A group that float64 cannot factor either sends the fits to the
    loop, in both packages."""
    xt, nn = _singular_f32_groups()
    kw = {"ls": 30.0, "jitter": 1e-30}
    ut = np.unique(xt[:, -1])
    monkeypatch.setattr(tlt, "_cholesky_f64_rescue", lambda K, jitter: None)
    assert tlt._batched_ls_time_densities(torch.as_tensor(xt), torch.as_tensor(nn), mt.Matern52,
                                          kw, torch.as_tensor(ut), 0) is None

    def unfactorizable(K, jitter=None):
        raise np.linalg.LinAlgError("not positive definite")

    import mellon_tpu.ops.linalg as jlinalg

    monkeypatch.setattr(jlinalg, "host_cholesky_f64", unfactorizable)
    with jax_x64_off():
        assert jlt._batched_ls_time_densities(jnp.asarray(xt), jnp.asarray(nn), JaxMatern52, kw,
                                              jnp.asarray(ut), 0) is None


def test_float64_rebuild_matches_jax_host_cores():
    """The rescue's float64 kernel, rebuilt from the coordinates through
    the port's kernels, equals the JAX package's host float64 cores (1e-6:
    the port keeps the distance's floor of 1e-6 on the diagonal, where
    the exponential kernel is 1 − 2.9e-7)."""
    rs = np.random.RandomState(11)
    x = rs.randn(40, 3)
    ports = {"matern32": mt.Matern32, "matern52": mt.Matern52, "expquad": mt.ExpQuad,
             "exponential": mt.Exponential}
    for tag, host_core in jlt._HOST_F64_CORES.items():
        got = ports[tag](ls=1.7)(t64(x), t64(x))
        np.testing.assert_allclose(to_np(got), host_core(x, 1.7), rtol=0, atol=1e-6, err_msg=tag)


def test_batched_loss_finite_on_overflowing_latents():
    """Latents where exp(F + V) overflows float32: the loss and gradient
    stay finite and repelling, padded latents carry only the prior
    gradient, and both equal JAX's loss and jax.grad; in the sane regime
    the safe exp is exp."""
    T, n_pad = 2, 4
    rs = np.random.RandomState(0)
    L = np.stack([np.eye(n_pad), np.eye(n_pad)]).astype(np.float32)
    nng = rs.uniform(0.05, 0.2, (T, n_pad)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], dtype=np.float32)
    mu = np.asarray([-5.0, -5.0], dtype=np.float32)
    args = tuple(torch.as_tensor(a) for a in (L, nng, mask, mu)) + (2.0,)
    with jax_x64_off():
        jargs = tuple(jnp.asarray(a) for a in (L, nng, mask, mu)) + (jnp.asarray(2.0, jnp.float32),)
        for z in (np.full(T * n_pad, 500.0, np.float32), np.zeros(T * n_pad, np.float32)):
            val, grad = tlt._batched_density_value_and_grad(torch.as_tensor(z), *args)
            val_j, grad_j = jax.value_and_grad(jlt._batched_density_loss)(jnp.asarray(z), *jargs)
            assert np.isfinite(float(val)) and bool(torch.isfinite(grad).all())
            np.testing.assert_allclose(float(val), float(val_j), rtol=1e-5)
            np.testing.assert_allclose(to_np(grad), np.asarray(grad_j), rtol=1e-5, atol=1e-3)
    z_big = torch.full((T * n_pad,), 500.0)
    v1, g = tlt._batched_density_value_and_grad(z_big, *args)
    v2, _ = tlt._batched_density_value_and_grad(2 * z_big, *args)
    assert float(v2) > float(v1)
    g = to_np(g).reshape(T, n_pad)
    np.testing.assert_allclose(g[0, 3], 500.0, rtol=1e-5)
    np.testing.assert_allclose(g[1, 2:], 500.0, rtol=1e-5)


def test_batched_ls_time_nonfinite_falls_back_to_loop(data, monkeypatch):
    """A diverged joint L-BFGS is retried once from zero, then the fits go
    to the loop, with the JAX package's warnings."""
    x, times = data
    xt = np.concatenate([x, times[:, None]], axis=1)
    nn = tp.compute_nn_distances_within_time_points(t64(xt))
    calls = []
    real = tlt.minimize_lbfgs

    def diverged(fun, z0, **kwargs):
        calls.append(z0.clone())
        return real(fun, z0, max_iter=1)._replace(loss=float("nan"))

    monkeypatch.setattr(tlt, "minimize_lbfgs", diverged)
    with _Records("mellon_tpu_torch") as log:
        out = tlt._batched_ls_time_densities(t64(xt), nn, mt.Matern52, {}, torch.unique(t64(times)), 0)
    assert out is None and len(calls) == 2
    assert bool((calls[1] == 0).all())
    messages = [m for _, m in log.records]
    assert any("retrying from the zero initialization" in m for m in messages)
    assert any("falling back to the exact per-time loop" in m for m in messages)


def test_batched_ls_time_f32_matches_f64():
    """float32 groups that need the float64 rescue: the densities agree
    with the float64 batched fits (corr > 0.99 per group, the JAX
    package's bar for its double-single predict) and with mellon_tpu's
    float32 fits."""
    rs = np.random.RandomState(0)
    T, per, d = 4, 120, 2
    base = rs.randn(12, d) * 0.02
    xs, ts = [], []
    for t in range(T):
        xs.append(base[rs.randint(0, 12, per)] + 2e-4 * rs.randn(per, d) + 0.005 * t)
        ts.append(np.full(per, float(t)))
    xt32 = np.concatenate([np.concatenate(xs), np.concatenate(ts)[:, None]], axis=1).astype(np.float32)
    nn32 = tp.compute_nn_distances_within_time_points(torch.as_tensor(xt32))
    ut = torch.unique(torch.as_tensor(xt32[:, -1]))
    kw = dict(jitter=1e-15, ls=1.0)
    with _Records("mellon_tpu_torch") as log:
        dens32 = tlt._batched_ls_time_densities(torch.as_tensor(xt32), nn32, mt.Matern52, kw, ut, 500)
    assert any("Float64 predict" in m for _, m in log.records)
    assert dens32.dtype == torch.float32 and bool(torch.isfinite(dens32).all())
    dens64 = tlt._batched_ls_time_densities(t64(xt32), nn32.double(), mt.Matern52, kw, ut.double(), 500)
    with jax_x64_off():
        dens_j = np.asarray(jlt._batched_ls_time_densities(
            jnp.asarray(xt32), jnp.asarray(to_np(nn32)), JaxMatern52, kw, np.unique(xt32[:, -1]), 500))
    for g in range(T):
        assert np.corrcoef(to_np(dens32[g]), to_np(dens64[g]))[0, 1] > 0.99
        assert np.corrcoef(to_np(dens32[g]), dens_j[g])[0, 1] > 0.99


def test_float32_fit_matches_jax_float32(data):
    """The float32 fit (the port's default dtype) against mellon_tpu in
    float32."""
    x, times = data
    x32, t32 = x.astype(np.float32), times.astype(np.float32)
    est = mt.TimeSensitiveDensityEstimator(ls_time=1.5, device="cpu")
    ld = est.fit_predict(x32, t32)
    assert ld.dtype == torch.float32 and est.device.type == "cpu"
    assert mt.TimeSensitiveDensityEstimator().device.type == "cuda"
    with jax_x64_off():
        jest = mellon_tpu.TimeSensitiveDensityEstimator(ls_time=1.5)
        ld_j = jest.fit_predict(jnp.asarray(x32), jnp.asarray(t32))
        pred_j = jest.predict(jnp.asarray(x32[:9]), multi_time=jnp.asarray(TIMES, jnp.float32))
    assert _rel(ld, ld_j) <= F32_REL
    assert _rel(est.predict(x32[:9], multi_time=np.asarray(TIMES)), pred_j) <= F32_REL


def test_state_from_jax_carries_the_time_fit(data, fitted):
    """state_from_jax: the fitted time estimator (its product kernel with
    active_dims, ls_time, landmarks, L, Lp and latents) and its time
    predictor, on the same state as JAX: 1e-12."""
    x, times = data
    jest = mellon_tpu.TimeSensitiveDensityEstimator(n_landmarks=30, ls_time=1.5)
    jest.fit(jnp.asarray(x), jnp.asarray(times))
    est = mt.state_from_jax(jest, **CPU64)
    assert type(est) is mt.TimeSensitiveDensityEstimator
    assert est.ls_time == 1.5 and est.cov_func.right.active_dims == -1
    np.testing.assert_allclose(to_np(est.landmarks), np.asarray(jest.landmarks), rtol=1e-14)
    np.testing.assert_allclose(to_np(est.log_density_x), np.asarray(jest.log_density_x), rtol=1e-12)
    xj, tj = jnp.asarray(x), jnp.asarray(times)
    assert type(est.predict) is mt.LandmarksConditionalCholeskyTime
    assert est.predict.n_obs == jest.predict.n_obs
    assert _rel(est.predict(x, times), jest.predict(xj, tj)) <= 1e-12
    pred = mt.state_from_jax(jest.predict, **CPU64)
    assert type(pred) is mt.LandmarksConditionalCholeskyTime
    assert _rel(pred.time_derivative(x, 0.5), jest.predict.time_derivative(xj, 0.5)) <= 1e-10
    full = mt.state_from_jax(fitted[0].predict, **CPU64)
    assert type(full) is mt.FullConditionalTime


def test_derivative_on_a_time_grid(fitted):
    """derivative(f, grid): the scalar function's derivative at every grid
    point, with the JAX package's shapes, for a scalar and a vector
    output."""
    jest, est = fitted
    grid = np.asarray([0.2, 0.9, 1.7])
    cell = np.asarray([[0.1, -0.3]])
    got = tder.derivative(lambda t: est.predict(cell, t)[0], grid)
    want = jder.derivative(lambda t: jest.predict(jnp.asarray(cell), t)[0], jnp.asarray(grid))
    assert got.shape == want.shape == (3,)
    assert _rel(got, want) <= FIT_REL
    cells = np.asarray([[0.1, -0.3], [1.0, 0.5]])
    got = tder.derivative(lambda t: est.predict(cells, t), grid)
    want = jder.derivative(lambda t: jest.predict(jnp.asarray(cells), t), jnp.asarray(grid))
    assert got.shape == want.shape == (2, 3)
    assert _rel(got, want) <= FIT_REL
    assert _rel(tder.derivative(lambda t: t**3, 2.0), jder.derivative(lambda t: t**3, 2.0)) <= 1e-14
    assert tp.compute_time_derivatives(est.predict, cells, 1.0).shape == (2,)
    # A predictor without time: zeros in its own dtype and on its device.
    timeless = types.SimpleNamespace(dtype=torch.float32, device=torch.device("cpu"))
    zeros = tp.compute_time_derivatives(timeless, cells)
    assert zeros.dtype == torch.float32 and zeros.shape == (2,) and not zeros.any()


@pytest.mark.parametrize(
    "d_method, d", [("fractal", 2.3), ("manual", 2.0), ("embedding", 2), (None, 2), (None, 2.5)]
)
def test_normalization_advisory_matches_jax(fitted, d_method, d):
    """mean(normalize=True) logs the d/d_method advisory of the JAX
    package: the same level and message for each branch, on the plain
    and the time predictor."""
    jest, est = fitted
    x = np.asarray([[0.1, -0.3]])
    for port, ref, args in (
        (est.predict, jest.predict, (x, 1.0)),
        (mt.state_from_jax(jest.predict, **CPU64), jest.predict, (x, 1.0)),
    ):
        port.d, port.d_method = d, d_method
        ref.d, ref.d_method = d, d_method
        with _Records("mellon_tpu_torch") as got, _Records("mellon_tpu") as want:
            port.mean(*args, normalize=True)
            ref.mean(jnp.asarray(x), 1.0, normalize=True)
        advisory = [r for r in want.records if "ormalization" in r[1]]
        assert [r for r in got.records if "ormalization" in r[1]] == advisory
        assert len(advisory) == (0 if d_method == "fractal" or (d_method is None and d == 2.5) else 1)
    jest.predict.d, jest.predict.d_method = jest.d, jest.d_method
    est.predict.d, est.predict.d_method = est.d, est.d_method


def test_plain_predictor_normalization_advisory(caplog):
    """The density predictor (not time-aware) logs the advisory too."""
    x = np.random.RandomState(1).randn(60, 2)
    est = mt.DensityEstimator(**CPU64)
    est.fit(x)
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        est.predict(x[:3], normalize=True)
    assert 'Consider using d_method="fractal"' in caplog.text


@pytest.mark.parametrize("optimizer", ["adam", "advi", "nuts", "smc"])
def test_every_optimizer_of_the_density_model(data, optimizer):
    """The time model takes every optimizer of the density model: adam
    (exact arithmetic) equals JAX's adam fit to 1e-8; ADVI, NUTS and SMC
    (their draws cannot be JAX's) give finite latents, stds and a time
    predictor with uncertainty."""
    x, times = data
    kw = dict(ls_time=1.5, optimizer=optimizer, n_iter=20, predictor_with_uncertainty=True,
              sampler_options={"nuts": dict(num_chains=2, num_warmup=10, num_samples=10),
                               "smc": dict(num_particles=64)}.get(optimizer))
    est = mt.TimeSensitiveDensityEstimator(**kw, **CPU64)
    ld = est.fit_predict(x, times)
    assert bool(torch.isfinite(ld).all()) and bool(torch.isfinite(est.pre_transformation_std).all())
    assert bool(torch.isfinite(est.predict.uncertainty(x[:5], 1.0)).all())
    if optimizer == "adam":
        kw["predictor_with_uncertainty"] = False  # the fit does not depend on it
        jest = mellon_tpu.TimeSensitiveDensityEstimator(**kw)
        assert _rel(ld, jest.fit_predict(jnp.asarray(x), jnp.asarray(times))) <= FIT_REL
