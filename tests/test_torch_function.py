"""mellon_tpu_torch's FunctionEstimator and its conditionals against
mellon_tpu: the same seeded numpy inputs through both packages, float64
on the CPU (the kernel wrapper takes its plain version), the sparse fits
on the JAX package's k-means landmarks.  Closed-form results (predictions,
leverage, observation variance, LOO residuals, covariances) agree to 1e-10
absolute, scaled by the largest value where that exceeds 1 (a mean
covariance of a noise-free fit reaches ~200); the reference Mellon's own
published values to 1e-5."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, jax_x64_off, t64, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu.inference import conditionals as jc
from mellon_tpu.ops.kernels import Matern52 as JaxMatern52
from mellon_tpu_torch.inference import conditionals as tc

FIXTURES = Path(__file__).parent / "fixtures"
N, D, P, M = 60, 2, 3, 12
TOL = 1e-10
# a length scale half the heuristic's keeps the sparse systems well
# conditioned enough for float64 rounding to stay below TOL
LS_FACTOR = 0.3


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D)
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1]), x[:, 0] * x[:, 1]], axis=1)
    return x, y + 0.1 * rng.randn(N, P), rng.randn(15, D)


def _sigma(kind):
    rng = np.random.RandomState(1)
    return {
        "scalar": 0.7,
        "(p,)": np.array([0.6, 0.8, 1.0]),
        "(1,p)": np.array([[0.6, 0.8, 1.0]]),
        "(n,p)": 0.6 + 0.4 * rng.rand(N, P),
        "(n,)": 0.6 + 0.4 * rng.rand(N),
        "(n,1)": 0.6 + 0.4 * rng.rand(N, 1),
        # entrywise non-negative, as the estimators' σ validation asks
        "(n,n)": (lambda F: F @ F.T * 0.05 + np.eye(N))(rng.rand(N, 3)),
    }[kind]


def _fit_both(sparse, sigma, y=None, **kwargs):
    """The JAX package's estimator and the port's on the same data (and,
    sparse, the JAX landmarks), both fitted."""
    x, y_default, _ = _data()
    y = y_default if y is None else y
    jsig = sigma if np.ndim(sigma) == 0 else jnp.asarray(sigma)
    kwargs = {"ls_factor": LS_FACTOR, **kwargs}
    jest = mellon_tpu.FunctionEstimator(sigma=jsig, n_landmarks=M if sparse else 0, **kwargs)
    jest.fit(jnp.asarray(x), jnp.asarray(y))
    where = dict(landmarks=np.asarray(jest.landmarks)) if sparse else dict(n_landmarks=0)
    est = mt.FunctionEstimator(sigma=sigma, **where, **kwargs, **CPU64)
    est.fit(x, y)
    return jest, est


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=tol * scale)


# the reference Mellon's own values (tests/test_reference_results.py:91-126)
REF_PRED = np.array([
    [0.1591912, -0.01633006, -0.09774735],
    [0.22242522, 0.18020723, -0.02099988],
    [0.19622299, 0.13606965, -0.1066963],
    [0.11826687, -0.1078843, -0.31056051],
    [0.14248863, -0.03011926, -0.29908757],
    [0.19947812, 0.11085447, -0.00750686],
    [0.12869758, -0.0557435, -0.31332486],
    [0.18549478, -0.04098856, 0.07950502],
    [0.29005287, 0.17010726, 0.36455042],
    [0.32726478, 0.31220231, 0.21231073],
])
REF_LEV = np.array([
    0.0372332, 0.07869925, 0.12117246, 0.05443739, 0.07560143,
    0.05055196, 0.05284116, 0.03140333, 0.04589148, 0.12702225,
    0.02890246, 0.08439047, 0.02921787, 0.07780366, 0.05287561,
    0.09885388, 0.09658274, 0.0378513, 0.0336515, 0.04042638,
    0.04148647, 0.04255076, 0.06422805, 0.05231018, 0.04072847,
    0.05364099, 0.04714973, 0.03281598, 0.12303139, 0.03775613,
    0.10646143, 0.09640494, 0.02881728, 0.03010999, 0.09627312,
    0.0325684, 0.06231224, 0.0371162, 0.03548587, 0.13666944,
    0.05732545, 0.03451524, 0.02859058, 0.07310316, 0.03799797,
    0.08597798, 0.03010433, 0.09246368, 0.09796963, 0.0286806,
])
REF_OBSVAR = np.array([
    [0.95486132, 1.10382589, 1.09700611],
    [0.99352028, 1.09954301, 1.09154833],
    [1.07884384, 1.06994597, 1.12319011],
    [1.01419867, 0.87782108, 1.19101712],
    [1.18976692, 0.91071511, 1.20611143],
    [0.92173907, 1.14376553, 1.08436175],
    [1.14035324, 0.91377002, 1.20676145],
    [0.96502533, 1.00159358, 0.98472199],
    [0.48300975, 0.88916662, 0.78530785],
    [0.76511332, 0.98307023, 0.95662155],
])


def test_reproduces_reference_hardcoded_full_gp_values():
    """The reference Mellon's own golden arrays for the full-GP
    FunctionEstimator (tests/test_reference_results.py:71-130: σ = 1, no
    landmarks, obs_variance) to 1e-5, and mellon_tpu's to 1e-10."""
    key = jax.random.PRNGKey(42)
    k1, k2, k3 = jax.random.split(key, 3)
    X = np.asarray(jax.random.normal(k1, (50, 2)))
    y = np.asarray(jax.random.normal(k2, (50, 3)))
    X_test = np.asarray(jax.random.normal(k3, (10, 2)))
    est = mt.FunctionEstimator(sigma=1.0, n_landmarks=0, obs_variance=True, **CPU64)
    est.fit(X, y)
    pred, lev = est.predict(X_test), est.predict.leverage(X)
    obsvar = est.predict.obs_variance(X_test)
    np.testing.assert_allclose(to_np(pred), REF_PRED, atol=1e-5)
    np.testing.assert_allclose(to_np(lev), REF_LEV, atol=1e-5)
    np.testing.assert_allclose(to_np(obsvar), REF_OBSVAR, atol=1e-5)
    jest = mellon_tpu.FunctionEstimator(sigma=1.0, n_landmarks=0, obs_variance=True)
    jest.fit(jnp.asarray(X), jnp.asarray(y))
    _close(pred, jest.predict(jnp.asarray(X_test)))
    _close(lev, jest.predict.leverage(jnp.asarray(X)))
    _close(obsvar, jest.predict.obs_variance(jnp.asarray(X_test)))


@pytest.mark.parametrize("kind", ["full", "sparse"])
def test_golden_fits(kind):
    """mellon_tpu's golden FunctionEstimator values
    (tests/test_reference_results.py:13-59) to 1e-5: the full GP's
    predictions and leverage and its length scale, the sparse GP's
    predictions on its 15 k-means landmarks."""
    from test_reference_results import EXPECTED_LS, LEV_FULL, PRED_FULL, PRED_SPARSE

    key = jax.random.PRNGKey(535)
    Lc = jax.random.uniform(jax.random.split(key)[0], (2, 2))
    cov = Lc @ Lc.T + jnp.eye(2) * 0.1
    x = jax.random.multivariate_normal(jax.random.split(key)[1], jnp.zeros(2), cov, (50,))
    y = np.asarray(jnp.sin(x[:, 0]) * jnp.cos(x[:, 1]))
    if kind == "full":
        est = mt.FunctionEstimator(sigma=0.1, gp_type="full", **CPU64)
        pred = est.fit_predict(np.asarray(x), y)
        np.testing.assert_allclose(to_np(pred[:8]), PRED_FULL, atol=1e-5)
        np.testing.assert_allclose(to_np(est.leverage()[:8]), LEV_FULL, atol=1e-5)
        assert est.ls == pytest.approx(EXPECTED_LS, rel=1e-9)
    else:
        jest = mellon_tpu.FunctionEstimator(sigma=0.1, n_landmarks=15)
        jest.fit(x, jnp.asarray(y))
        est = mt.FunctionEstimator(sigma=0.1, landmarks=np.asarray(jest.landmarks), **CPU64)
        pred = est.fit_predict(np.asarray(x), y)
        np.testing.assert_allclose(to_np(pred[:8]), PRED_SPARSE, atol=1e-5)


def test_reference_function_predictor_fixture():
    """The reference Mellon's FullConditional (module mellon.conditional),
    loaded here, reproduces its own predictions to 1e-5."""
    data = np.load(FIXTURES / "reference_fixture_data.npz")
    pred = mt.Predictor.from_json(FIXTURES / "reference_function_predictor.json", **CPU64)
    assert type(pred) is mt.FullConditional
    np.testing.assert_allclose(to_np(pred(data["x"])), data["fe_pred"], atol=1e-5)


SIGMA_CASES = [
    ("full", "scalar"), ("full", "(p,)"), ("full", "(1,p)"), ("full", "(n,p)"),
    ("full", "(n,)"), ("full", "(n,1)"),
    ("sparse", "scalar"), ("sparse", "(p,)"), ("sparse", "(1,p)"), ("sparse", "(n,p)"),
    ("sparse", "(n,)"), ("sparse", "(n,1)"), ("sparse", "(n,n)"),
]


@pytest.mark.parametrize("gp,kind", SIGMA_CASES)
def test_sigma_shapes_match_jax(gp, kind):
    """Every σ shape: predictions at new points, the leverage at the
    training points, the observation variance and the LOO residuals to
    1e-10.  An (n, n) σ has no leverage: both packages refuse it."""
    sigma = _sigma(kind)
    full_cov = kind == "(n,n)"
    jest, est = _fit_both(gp == "sparse", sigma, obs_variance=not full_cov)
    _, y, x_new = _data()
    assert est.predict.per_feature_sigma == jest.predict.per_feature_sigma
    _close(est.predict(x_new), jest.predict(jnp.asarray(x_new)))
    if full_cov:
        with pytest.raises(NotImplementedError, match="full-covariance"):
            est.leverage()
        with pytest.raises(NotImplementedError, match="full-covariance"):
            jest.leverage()
        return
    _close(est.leverage(), jest.leverage())
    _close(est.get_obs_variance(x_new), jest.get_obs_variance(jnp.asarray(x_new)))
    _close(est.loo_residuals_squared(), jest.loo_residuals_squared())
    x = _data()[0]
    _close(est.loo_residuals_squared(x, y), jest.loo_residuals_squared(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("gp", ["full", "sparse"])
@pytest.mark.parametrize("y_is_mean", [False, True])
def test_uncertainty_matches_jax(gp, y_is_mean):
    """``predictor_with_uncertainty`` and ``y_is_mean``: the covariance
    (diagonal and full) and, where defined, the mean covariance and the
    uncertainty at new points, to 1e-10.  The full GP's noise-free
    interpolation (y_is_mean) solves with K + jitter I: there the length
    scale is a tenth of the heuristic's, so that its conditioning keeps
    float64 rounding below the tolerance."""
    ls_factor = 0.1 if y_is_mean and gp == "full" else LS_FACTOR
    jest, est = _fit_both(gp == "sparse", 0.5, y_is_mean=y_is_mean,
                          predictor_with_uncertainty=True, ls_factor=ls_factor)
    x_new = _data()[2]
    xj = jnp.asarray(x_new)
    p, jp = est.predict, jest.predict
    _close(p(x_new), jp(xj))
    _close(p.covariance(x_new), jp.covariance(xj))
    _close(p.covariance(x_new, diag=False), jp.covariance(xj, diag=False))
    if hasattr(jp, "W"):
        _close(p.mean_covariance(x_new), jp.mean_covariance(xj))
        _close(p.mean_covariance(x_new, diag=False), jp.mean_covariance(xj, diag=False))
        _close(p.uncertainty(x_new), jp.uncertainty(xj))
    else:
        with pytest.raises(ValueError, match="without uncertainty"):
            p.mean_covariance(x_new)


def test_per_feature_covariance_is_noise_free():
    """With a per-feature σ the covariance is noise-free: refused without
    ``noise_free=True``, equal to mellon_tpu's with it."""
    jest, est = _fit_both(True, _sigma("(p,)"), predictor_with_uncertainty=True)
    x_new = _data()[2]
    with pytest.raises(ValueError, match="noise_free=True"):
        est.predict.covariance(x_new)
    _close(est.predict.covariance(x_new, noise_free=True),
           jest.predict.covariance(jnp.asarray(x_new), noise_free=True))


@pytest.mark.parametrize("shape", [(), (N,), (N, 1), (N, P)])
def test_sigma_to_y_cov_factor_matches_jax(shape):
    """The noise factor of a scalar, (n,), (n, 1) and 2-d σ, the last the
    (n, *σ.shape) stack of the JAX package."""
    rng = np.random.RandomState(3)
    sigma = 0.5 if shape == () else 0.5 + rng.rand(*shape)
    want = jc._sigma_to_y_cov_factor(sigma if shape == () else jnp.asarray(sigma), None, N)
    got = tc._sigma_to_y_cov_factor(sigma if shape == () else t64(sigma), None, N, t64(np.zeros(1)))
    _close(got, want, tol=0)


def test_leverage_by_cholesky_is_closer_to_exact():
    """Deliberate divergence: the port factorizes M = σ² K_uu + BᵀB + jitter
    I by Cholesky where the JAX package inverts it.  With cond(K_uu) ~ 1e6
    (ls = 10) and σ = 0.1 the two differ by ~4e-10; against the leverage
    in 40-digit arithmetic the Cholesky's error is the smaller, by half at
    least (measured 9.3e-11 against 4.0e-10)."""
    mpmath = pytest.importorskip("mpmath")
    rng = np.random.RandomState(4)
    x, xu = rng.randn(40, 3), rng.randn(15, 3)
    cov = JaxMatern52(ls=10.0)
    B = np.asarray(cov(jnp.asarray(x), jnp.asarray(xu)))
    K = np.asarray(cov(jnp.asarray(xu), jnp.asarray(xu)))
    h_jax = np.asarray(jc._hat_diagonal(jnp.asarray(B), jnp.asarray(K), 0.1, 1e-6))
    h_port = to_np(tc._hat_diagonal(t64(B), t64(K), 0.1, 1e-6))
    mpmath.mp.dps = 40
    Mi = mpmath.matrix((0.01 * K + B.T @ B + 1e-6 * np.eye(15)).tolist()) ** -1
    Bm = mpmath.matrix(B.tolist())
    exact = np.array([float((Bm[i, :] * Mi * Bm[i, :].T)[0]) for i in range(40)])
    assert np.abs(h_port - exact).max() <= 0.5 * np.abs(h_jax - exact).max()


@pytest.fixture
def singular_f32():
    """float32 operands whose landmark kernel is singular at float32 (in
    both packages' Cholesky): a length scale far above the data's spread
    makes k(xu, xu) ~ all ones."""
    rs = np.random.RandomState(7)
    x = rs.randn(300, 3).astype(np.float32)
    xu = rs.randn(200, 3).astype(np.float32)
    return x, xu, np.sin(x[:, 0]).astype(np.float32)


def _f64_truth(x, xu, r, ls, s2):
    """The sparse weights' prediction at x[:40] in float64 from the
    float32 points, with the rescue's jitter escalation."""
    cov = mt.Matern52(ls=ls)
    K = to_np(cov(t64(xu), t64(xu)))
    Kuf = to_np(cov(t64(xu), t64(x)))
    m = K.shape[0]
    jit = 1e-12
    while True:
        try:
            Lp = np.linalg.cholesky(K + jit * np.eye(m))
            break
        except np.linalg.LinAlgError:
            jit *= 10
    A = np.linalg.solve(Lp, Kuf)
    L_B = np.linalg.cholesky(A @ A.T / s2 + np.eye(m))
    w = np.linalg.solve(Lp.T, np.linalg.solve(L_B.T, np.linalg.solve(L_B, A @ r / s2)))
    return Kuf.T[:40] @ w


def _conditional_f32(package, x, xu, y, **kwargs):
    """The package's float32 LandmarksConditional at ls = 40 and its mean at
    x[:40]; numpy keyword arguments (σ) become the package's arrays."""
    if package == "jax":
        kwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
        with jax_x64_off():
            c = jc.LandmarksConditional(
                jnp.asarray(x), jnp.asarray(xu), jnp.asarray(y), 0.0, JaxMatern52(ls=40.0),
                **kwargs,
            )
            return c, np.asarray(c._mean(jnp.asarray(x[:40])), dtype=np.float64)
    kwargs = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    c = mt.LandmarksConditional(
        torch.tensor(x), torch.tensor(xu), torch.tensor(y), 0.0, mt.Matern52(ls=40.0), **kwargs
    )
    return c, to_np(c._mean(torch.tensor(x[:40]))).astype(np.float64)


def test_f32_singular_kernel_takes_the_float64_weights(singular_f32, caplog):
    """The float64 rescue of a float32-singular landmark kernel (σ = 0.1,
    wide length scale): every landmark is kept, the weights solved in
    float64 on the tensors' device; the prediction is within 2e-3 of the
    float64 truth's scale (the JAX package's bar) and of mellon_tpu's own
    rescue."""
    x, xu, y = singular_f32
    c, got = _conditional_f32("torch", x, xu, y, sigma=0.1)
    assert c.landmarks.shape[0] == 200 and c.weights.dtype == torch.float32
    want = _f64_truth(x, xu, y.astype(np.float64), 40.0, 0.01)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-3 * scale
    _, jgot = _conditional_f32("jax", x, xu, y, sigma=0.1)
    assert np.abs(got - jgot).max() <= 2e-3 * scale


@pytest.mark.parametrize("trigger", ["noise-free mean", "over budget"])
def test_f32_singular_kernel_prunes(singular_f32, monkeypatch, trigger):
    """The other float32 rescue: the noise-free mean, or a Kuf above the
    float64 budget, prunes to the pivoted-Cholesky landmark subset, as in
    mellon_tpu; the prediction stays near the float64 truth."""
    x, xu, y = singular_f32
    if trigger == "over budget":
        monkeypatch.setattr(tc, "F64_RESCUE_BUDGET", 10)
        kwargs, s2, bar = dict(sigma=0.1), 0.01, 0.05
    else:
        kwargs, s2, bar = dict(sigma=None, y_is_mean=True), 1.0, 0.05
    c, got = _conditional_f32("torch", x, xu, y, **kwargs)
    assert c.landmarks.shape[0] < 200
    want = _f64_truth(x, xu, y.astype(np.float64), 40.0, s2)
    assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_f32_leverage_rescue_stays_physical(singular_f32, caplog):
    """The float32 leverage of a singular landmark kernel leaves [0, 1] (or
    is not finite); the float64 recomputation, on the same device, keeps
    it there, for a scalar and a per-feature σ, and the HC3 observation
    variance stays finite."""
    x, xu, y = singular_f32
    c, _ = _conditional_f32("torch", x, xu, y, sigma=0.1, obs_variance=True, with_uncertainty=True)
    h = c._leverage(torch.tensor(x[:50]), 0.1)
    assert h.dtype == torch.float32 and 0.0 <= float(h.min()) and float(h.max()) <= 1.0
    h2 = c._leverage(torch.tensor(x[:50]), torch.tensor([0.1, 0.3]))
    assert h2.shape == (50, 2) and 0.0 <= float(h2.min()) and float(h2.max()) <= 1.0
    assert torch.isfinite(c._obs_variance(torch.tensor(x[:20]))).all()


def test_hat_diagonal_float64_rescue_matches_float64():
    """An ill-conditioned float32 M: the range check sends the leverage to
    float64, which then equals the leverage computed in float64 from the
    same float32 operands (to float32 rounding)."""
    rs = np.random.RandomState(8)
    cov = mt.Matern52(ls=40.0)
    x, xu = torch.tensor(rs.randn(200, 3), dtype=torch.float32), torch.tensor(rs.randn(80, 3), dtype=torch.float32)
    B, K = cov(x, xu), cov(xu, xu)
    h = tc._hat_diagonal(B, K, 1e-3, 1e-6)
    h64 = tc._hat_diagonal(B.double(), K.double(), 1e-3, 1e-6)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(to_np(h), np.clip(to_np(h64), 0, 1 - 1e-6), atol=1e-6)


def _rescue_case(case, x, y):
    """σ and y of one σ shape on the float32-singular operands."""
    rs = np.random.RandomState(9)
    n = x.shape[0]
    y2 = np.stack([y, np.cos(x[:, 1])], axis=1).astype(np.float32)
    if case in ("(n,)", "(n,1)"):
        sigma = (0.1 + 0.05 * rs.rand(n)).astype(np.float32)
        return (sigma if case == "(n,)" else sigma[:, None]), y
    if case == "(p,)":
        return np.array([0.1, 0.2], dtype=np.float32), y2
    if case == "(n,p)":
        return (0.1 + 0.05 * rs.rand(n, 2)).astype(np.float32), y2
    if case == "(n,n)":
        G = rs.rand(n, 3)
        return (0.01 * np.eye(n) + 1e-3 * G @ G.T).astype(np.float32), y
    return 0.1, y


@pytest.mark.parametrize(
    "case", ["scalar", "(n,)", "(n,1)", "(p,)", "(n,p)", "(n,n)", "y_is_mean"]
)
def test_f32_rescue_every_sigma_shape_matches_jax(singular_f32, case):
    """The float64 rescue of a float32-singular landmark kernel for each σ
    shape it takes, and y_is_mean with uncertainty: every landmark kept,
    float32 results, the mean (and the mean covariance, whose W is solved
    in float64 too) within 2e-3 of the scale of mellon_tpu's host rescue
    (given the (n,) σ where the port takes (n, 1), which that refuses)."""
    x, xu, y = singular_f32
    sigma, y = _rescue_case(case, x, y)
    kwargs = dict(sigma=sigma)
    if case == "y_is_mean":
        kwargs.update(y_is_mean=True, with_uncertainty=True)
    c, got = _conditional_f32("torch", x, xu, y, **kwargs)
    jkwargs = {**kwargs, "sigma": sigma[:, 0]} if case == "(n,1)" else kwargs
    jc_, want = _conditional_f32("jax", x, xu, y, **jkwargs)
    assert c.landmarks.shape[0] == 200 and c.weights.dtype == torch.float32
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    if case == "y_is_mean":
        mc = to_np(c._mean_covariance(torch.tensor(x[:40]))).astype(np.float64)
        with jax_x64_off():
            jmc = np.asarray(jc_._mean_covariance(jnp.asarray(x[:40])), dtype=np.float64)
        assert np.abs(mc - jmc).max() <= 2e-3 * np.abs(jmc).max()


@pytest.mark.parametrize("sigma", ["(p,)", "(n,p)"])
def test_f32_leverage_leaves_float32_at_the_first_failing_chunk(singular_f32, monkeypatch, sigma):
    """A per-feature leverage in chunks of one feature whose float32 M is
    singular: the float32 pass stops at its first chunk, before any solve,
    and the float64 pass computes every chunk."""
    x, xu, _ = singular_f32
    cov = mt.Matern52(ls=5.0)
    B, K = cov(torch.tensor(x), torch.tensor(xu)), cov(torch.tensor(xu), torch.tensor(xu))
    p = 4
    s = torch.full((p,), 0.1) if sigma == "(p,)" else torch.full((x.shape[0], p), 0.1)
    monkeypatch.setattr(tc, "FEATURE_CHUNK_BYTES", 1)
    seen, chunk, solve = [], tc._hat_chunk, tc._solve
    solves = []

    def recording(M, *args):
        seen.append(M.dtype)
        return chunk(M, *args)

    def counting(A, *args, **kwargs):
        solves.append(A.dtype)
        return solve(A, *args, **kwargs)

    monkeypatch.setattr(tc, "_hat_chunk", recording)
    monkeypatch.setattr(tc, "_solve", counting)
    h = tc._hat_diagonal(B, K, s, 1e-6, per_feature=True)
    assert h.shape == (x.shape[0], p) and h.dtype == torch.float32
    assert seen == [torch.float32] + [torch.float64] * p
    assert torch.float32 not in solves


@pytest.mark.parametrize("cls", ["FullConditional", "LandmarksConditional"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_json_both_ways(cls, direction):
    """A fitted predictor with uncertainty and the observation variance
    through JSON into the other package: its mean, covariance and
    observation variance agree to 1e-10."""
    jest, est = _fit_both(cls == "LandmarksConditional", 0.5, obs_variance=True,
                          predictor_with_uncertainty=True, y_is_mean=True)
    x_new = _data()[2]
    if direction == "jax_to_torch":
        back = mt.Predictor.from_json_str(jest.predict.to_json(), **CPU64)
        src = jest.predict
        assert type(back).__name__ == cls
        got = [back(x_new), back.covariance(x_new), back.obs_variance(x_new)]
    else:
        back = mellon_tpu.Predictor.from_json_str(est.predict.to_json())
        src = est.predict
        assert type(back).__name__ == cls
        xj = jnp.asarray(x_new)
        got = [back(xj), back.covariance(xj), back.obs_variance(xj)]
    want = [src(x_new), src.covariance(x_new), src.obs_variance(x_new)]
    for g, w in zip(got, want):
        _close(g, to_np(w))


def test_state_from_jax_function_estimator():
    """A fitted mellon_tpu FunctionEstimator carried over: the port's
    estimator predicts, and re-fits on the carried y, the same."""
    jest = mellon_tpu.FunctionEstimator(sigma=0.5, n_landmarks=M, obs_variance=True)
    x, y, x_new = _data()
    jest.fit(jnp.asarray(x), jnp.asarray(y))
    est = mt.state_from_jax(jest, **CPU64)
    _close(est.predict(x_new), jest.predict(jnp.asarray(x_new)))
    _close(est.get_obs_variance(x_new), jest.get_obs_variance(jnp.asarray(x_new)))
    est.fit(y=est.y)
    _close(est.predict(x_new), jest.predict(jnp.asarray(x_new)))


def test_multi_fit_predict_and_errors():
    """multi_fit_predict transposes outputs given as rows; the Nyström
    types, a prediction before a fit and mismatched lengths are refused as
    in mellon_tpu."""
    x, y, x_new = _data()
    jest = mellon_tpu.FunctionEstimator(sigma=0.5, n_landmarks=0)
    want = np.asarray(jest.multi_fit_predict(jnp.asarray(x), jnp.asarray(y.T), jnp.asarray(x_new)))
    got = mt.FunctionEstimator(sigma=0.5, n_landmarks=0, **CPU64).multi_fit_predict(x, y.T, x_new)
    _close(got, want)
    with pytest.raises(ValueError, match="Nyström"):
        mt.FunctionEstimator(gp_type="sparse_nystroem", **CPU64)
    with pytest.raises(ValueError, match="not yet computed"):
        mt.FunctionEstimator(**CPU64).predict
    with pytest.raises(ValueError, match="should equal"):
        mt.FunctionEstimator(**CPU64).fit(x, y[:10])
